"""Serve layer: ``LLMEngine`` front-end, QoS traffic-class schedulers and
the ``slot`` / ``arena`` / ``paged`` execution backends (port of
``repro.serve``)::

    from repro_torch.serve import EngineConfig, LLMEngine
    eng = LLMEngine(arch, params, EngineConfig(backend="paged", slots=8))

The legacy engine classes (``ServeEngine`` / ``BatchedServeEngine`` /
``PagedServeEngine``) are importable from here and from
``repro_torch.serve.engine``.
"""

from repro_torch.serve.api import LLMEngine, metrics
from repro_torch.serve.backends import (
    ArenaBackend, PagedBackend, SlotBackend, make_backend,
    sample_tokens_per_slot, validate_paged_config,
)
from repro_torch.serve.config import BACKENDS, SCHEDULERS, EngineConfig
from repro_torch.serve.engine import (
    BatchedServeEngine, PagedServeEngine, ServeEngine,
)
from repro_torch.serve.request import (
    FinishReason, Request, RequestState, StepOutput,
)
from repro_torch.serve.scheduler import (
    BoundedPriorityScheduler, FCFSScheduler, QoSTrafficClassScheduler,
    Scheduler, make_scheduler,
)

__all__ = [
    "ArenaBackend", "BACKENDS", "SCHEDULERS", "BatchedServeEngine",
    "BoundedPriorityScheduler", "EngineConfig", "FCFSScheduler",
    "FinishReason", "LLMEngine", "PagedBackend", "PagedServeEngine",
    "QoSTrafficClassScheduler", "Request", "RequestState", "Scheduler",
    "ServeEngine", "SlotBackend", "StepOutput", "make_backend",
    "make_scheduler", "metrics", "sample_tokens_per_slot",
    "validate_paged_config",
]
