"""Engine configuration for the serve layer (port of ``repro.serve.config``).

``EngineConfig`` is the construction surface of
:class:`repro_torch.serve.api.LLMEngine`. It keeps the reference's fields,
defaults (``backend="arena"`` among them: every ported family serves on
``"arena"``, quantized ``serve_quant`` archs and ``embeds`` requests
too) and validation, with one difference: there is no ``attn_backend``
— the port has no per-op backend ladder, the device decides which
version of a kernel runs.

What the port does not implement yet (a mesh) is refused at engine
construction with ``NotImplementedError``. As in the reference, a
ring layout on the paged backend (sliding-window layers with
``local_window < max_len``) accepts ``prefix_cache``,
``prefill_chunk_tokens`` and ``spec_tokens`` and silently turns them off.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.serve.spec import SPEC_METHODS

# execution backends (the reference's set) and their legacy aliases
BACKENDS = ("slot", "arena", "paged")
_BACKEND_ALIASES = {
    "reference": "slot",
    "batched": "arena",
    "dense": "arena",
}

# admission schedulers (repro_torch.serve.scheduler)
SCHEDULERS = ("fcfs", "bounded", "qos")


def canonical_backend(name: str) -> str:
    name = _BACKEND_ALIASES.get(name, name)
    if name not in BACKENDS:
        raise ValueError(
            f"unknown serve backend {name!r} "
            f"(supported: {', '.join(BACKENDS)}; legacy aliases: "
            f"{', '.join(sorted(_BACKEND_ALIASES))})")
    return name


@dataclasses.dataclass
class EngineConfig:
    slots: int = 4               # decode batch size
    max_len: int = 256
    admit_window: int = 8        # bounded-priority window (see scheduler.py)
    admit_batch: int = 1         # max admissions per iteration
    greedy: bool = True
    temperature: float = 1.0     # used when greedy=False
    seed: int = 0                # sampling seed
    prefill_buckets: bool = True  # pad admission prompts to pow2 buckets
    min_bucket: int = 8
    # paged backend: KV block size and pool size. With num_blocks=None the
    # pool matches a dense arena's token budget (slots · max_len).
    block_len: int = 16
    num_blocks: Optional[int] = None
    # content-addressed prefix caching over the block pool: published
    # full blocks are shared across requests (refcounts, copy-on-write,
    # LRU reuse) and an admission prefills only its uncached suffix
    prefix_cache: bool = False
    # speculative decoding: up to spec_tokens drafts per running slot are
    # scored in one small-q verify dispatch; greedy acceptance keeps the
    # committed stream token-identical to spec_tokens=0
    spec_tokens: int = 0
    # draft method: "ngram" — prompt lookup over the request's own tokens
    spec_method: str = "ngram"
    # paged backend: chunked prefill co-scheduled with decode. An
    # admission's prefill runs as block-aligned chunks of at most this many
    # tokens an iteration (one budget shared by every in-flight prefill).
    # A multiple of block_len, >= it; None keeps monolithic prefills.
    prefill_chunk_tokens: Optional[int] = None
    # execution backend: "slot" (sequential per-slot reference), "arena"
    # (batched dense arena), "paged" (shared block pool)
    backend: str = "arena"
    # admission policy: "fcfs" | "bounded" | "qos" (see scheduler.py)
    scheduler: str = "bounded"
    rt_window: int = 2
    be_grant_window: int = 8
    be_token_share: Optional[float] = None
    # finished requests kept addressable by handle (None keeps all)
    retain_finished: Optional[int] = None

    def effective_temperature(self, temperature: Optional[float]) -> float:
        """Resolve a request's decode temperature against the engine
        defaults: the request's own when set, else 0 (greedy) under
        ``greedy=True``, else the engine ``temperature``."""
        if temperature is not None:
            return float(temperature)
        return 0.0 if self.greedy else float(self.temperature)

    def __post_init__(self):
        self.backend = canonical_backend(self.backend)
        if self.scheduler not in SCHEDULERS:
            raise ValueError(
                f"unknown scheduler {self.scheduler!r} "
                f"(supported: {', '.join(SCHEDULERS)})")
        if self.admit_batch < 1:
            raise ValueError(
                f"admit_batch must be >= 1, got {self.admit_batch}")
        if self.rt_window < 1:
            raise ValueError(f"rt_window must be >= 1, got {self.rt_window}")
        if self.be_grant_window < 1:
            raise ValueError(
                f"be_grant_window must be >= 1, got {self.be_grant_window}")
        if self.prefill_chunk_tokens is not None:
            c = self.prefill_chunk_tokens
            if c < self.block_len or c % self.block_len:
                raise ValueError(
                    f"prefill_chunk_tokens must be a multiple of block_len "
                    f"({self.block_len}) and >= it, got {c} — chunk "
                    f"boundaries must land on block boundaries so each "
                    f"chunk writes whole pool blocks and the suffix-resume "
                    f"reduction order is unchanged")
        if self.spec_tokens < 0:
            raise ValueError(
                f"spec_tokens must be >= 0, got {self.spec_tokens}")
        if self.spec_method not in SPEC_METHODS:
            raise ValueError(
                f"unknown spec_method {self.spec_method!r} "
                f"(supported: {', '.join(SPEC_METHODS)})")
        if self.be_token_share is not None and not (
                0.0 < self.be_token_share < 1.0):
            raise ValueError(
                f"be_token_share must be in (0, 1) when set, got "
                f"{self.be_token_share}")
