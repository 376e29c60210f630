"""Declarative parameter schemas (port of ``repro.models.schema``).

A model defines its parameters once, as a tree (dicts and lists) of
``TensorSpec``s with the same keys, shapes and leading ``n_stack`` axis as
the JAX schema. ``init_params`` materializes it on a device from an
explicit ``torch.Generator`` (seeded, scaled init; the draws differ from
``jax.random``'s, so cross-framework tests hand both sides numpy arrays).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis per dim (None = replicated)
    init: str = "normal"             # normal | zeros | ones | embed
    scale: Optional[float] = None    # stddev; default 1/sqrt(fan_in)
    dtype: Any = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"axes {self.axes} do not match shape {self.shape}")

    @property
    def std(self) -> float:
        if self.scale is not None:
            return self.scale
        if self.init == "embed":
            return 1.0
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        return fan_in ** -0.5


def tree_map(fn: Callable, tree):
    """Map over the leaves of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def leaves(tree):
    """Leaves of a tree of dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def init_params(schema, generator: torch.Generator, device, dtype=None):
    """Materialize a schema on ``device`` (the generator's device).

    Stacked leaves are drawn one stack entry at a time in float32, so a
    full-width model never holds more than one layer's float32 draw beside
    its weights.
    """
    device = torch.device(device)

    def make(spec: TensorSpec) -> torch.Tensor:
        dt = dtype or spec.dtype
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=device)
        out = torch.empty(spec.shape, dtype=dt, device=device)
        parts = [out] if len(spec.shape) < 3 else list(out)
        for part in parts:
            draw = torch.randn(part.shape, generator=generator,
                               dtype=torch.float32, device=device)
            part.copy_(draw * spec.std)
        return out

    return tree_map(make, schema)


def param_count(schema) -> int:
    return sum(math.prod(s.shape) for s in leaves(schema))
