"""Serve layer: ``LLMEngine`` front-end, QoS traffic-class schedulers and
the paged execution backend (port of ``repro.serve``)::

    from repro_torch.serve import EngineConfig, LLMEngine
    eng = LLMEngine(arch, params, EngineConfig(slots=8))
"""

from repro_torch.serve.api import LLMEngine, metrics
from repro_torch.serve.backends import (
    PagedBackend, make_backend, sample_tokens_per_slot, validate_paged_config,
)
from repro_torch.serve.config import BACKENDS, SCHEDULERS, EngineConfig
from repro_torch.serve.request import (
    FinishReason, Request, RequestState, StepOutput,
)
from repro_torch.serve.scheduler import (
    BoundedPriorityScheduler, FCFSScheduler, QoSTrafficClassScheduler,
    Scheduler, make_scheduler,
)

__all__ = [
    "BACKENDS", "SCHEDULERS", "BoundedPriorityScheduler", "EngineConfig",
    "FCFSScheduler", "FinishReason", "LLMEngine", "PagedBackend",
    "QoSTrafficClassScheduler", "Request", "RequestState", "Scheduler",
    "StepOutput", "make_backend", "make_scheduler", "metrics",
    "sample_tokens_per_slot", "validate_paged_config",
]
