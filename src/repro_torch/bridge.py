"""Weight bridge: JAX-schema parameter trees given as numpy arrays → the
port's tensors on a device.

The reference and the port share one parameter layout (same keys, same
leading ``n_stack`` axis), so a tree of numpy arrays feeds both: the JAX
side through ``jnp.asarray``, the port through ``params_from_numpy``.
Quantized serving parameters are not bridged from the reference: the port
re-quantizes the float tree itself (``qparams_from_numpy``), so its own
``quantize_params`` is what the cross-framework tests hold to the JAX one.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.schema import TensorSpec, tree_map


def numpy_params(schema, seed: int, dtype=np.float32):
    """A numpy tree for ``schema`` drawn from ``np.random.default_rng(seed)``
    with the schema's init rule (zeros/ones, or normal × its std)."""
    rng = np.random.default_rng(seed)

    def make(spec: TensorSpec) -> np.ndarray:
        if spec.init == "zeros":
            return np.zeros(spec.shape, dtype)
        if spec.init == "ones":
            return np.ones(spec.shape, dtype)
        return (rng.standard_normal(spec.shape, dtype=np.float32)
                * np.float32(spec.std)).astype(dtype)

    return tree_map(make, schema)


def params_from_numpy(tree, device: DeviceLike = None, dtype=None):
    """numpy tree → tensor tree on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)

    def conv(a) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=dev, dtype=dtype or t.dtype)

    return tree_map(conv, tree)


def qparams_from_numpy(tree, cfg: ModelConfig, device: DeviceLike = None):
    """The W8A8 serving tree for a numpy float tree, quantized by the
    port's ``transformer.quantize_params`` on ``device``."""
    from repro_torch.models.transformer import quantize_params

    return quantize_params(params_from_numpy(tree, device), cfg)
