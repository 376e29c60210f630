"""Legacy engine classes: thin shims over ``serve.api`` (port of
``repro.serve.engine``).

New code constructs ``LLMEngine(arch, params, EngineConfig(backend=...,
scheduler=...))``. Each class below pins the backend its old name implied,
keeps the config's scheduler, and returns the finished ``Request`` objects
from ``step()`` (the old contract); the rest of its surface (``slots``,
``queue``, counters, the backend's ``alloc`` / ``layout`` / ``cache`` and
ring tables) is ``LLMEngine``'s, so the shims are token-identical to it by
construction. Like ``LLMEngine`` they run on ``cuda`` unless
``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.core.device import DeviceLike
from repro_torch.models import registry
from repro_torch.serve.api import LLMEngine
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.request import Request


class _LegacyShim(LLMEngine):
    """Pins the execution backend; ``step()`` returns finished requests."""

    _backend_name: str = "arena"

    def __init__(self, arch: registry.Arch, params, ec: EngineConfig, *,
                 device: DeviceLike = None):
        super().__init__(arch, params,
                         dataclasses.replace(ec, backend=self._backend_name),
                         device=device)

    def step(self) -> List[Request]:  # legacy contract
        _, finished = self._step()
        return finished


class ServeEngine(_LegacyShim):
    """``LLMEngine(..., EngineConfig(backend="slot"))``: the sequential
    per-slot reference engine (batch-1 decode per slot, host argmax per
    token, greedy-only)."""

    _backend_name = "slot"


class BatchedServeEngine(_LegacyShim):
    """``LLMEngine(..., EngineConfig(backend="arena"))``: continuous
    batching over the dense per-slot arena."""

    _backend_name = "arena"


class PagedServeEngine(_LegacyShim):
    """``LLMEngine(..., EngineConfig(backend="paged"))``: continuous
    batching over the shared block-pool KV cache."""

    _backend_name = "paged"
