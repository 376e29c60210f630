"""Request lifecycle for the serve layer.

A :class:`Request` moves through an explicit state machine::

    WAITING ──admission──▶ PREFILL ──first token──▶ RUNNING ──finish──▶ DONE
       ▲                                              │
       └────────────── PREEMPTED (forced admission evicted the slot;
                        re-enters the queue and is re-prefilled from its
                        prompt + generated tokens, token-identically)

With chunked prefill (``EngineConfig.prefill_chunk_tokens``) the PREFILL
state is a *sub-state machine* of its own: a request may stay in PREFILL
across several iterations while its prompt is written chunk-by-chunk
(``prefill_pos`` is the cursor), co-scheduled with the batched decode.
Mid-chunk requests hold a slot and their full block reservation but are
excluded from the decode batch until the final chunk lands their first
token.

``abort()`` moves a request from any live state to ``ABORTED``.

When a request finishes, ``finish_reason`` records why:

  * ``"stop"``   — one of its ``stop_sequences`` matched at a committed
                   position (host-side check; the window may extend back
                   into the prompt, and every position of a multi-token
                   speculative commit is scanned — ``matched_stop``
                   records the sequence that fired);
  * ``"eos"``    — a committed token equals ``eos_token``;
  * ``"length"`` — ``max_new_tokens`` generated;
  * ``"abort"``  — the caller aborted the handle.

Every request carries a QoS *traffic class* mirroring the CHIMERA memory
island's two-lane arbiter: ``"rt"`` (latency-critical, the narrow-port
analog — bounded admission latency under the QoS scheduler) or ``"be"``
(best-effort bulk, the wide-DMA analog — fills whatever capacity is
left). Schedulers other than ``"qos"`` ignore the class.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


class RequestState:
    """Lifecycle states (plain strings for cheap comparison / JSON)."""

    WAITING = "waiting"        # queued, no slot
    PREFILL = "prefill"        # admission dispatched, first token in flight
    RUNNING = "running"        # holds a decode slot
    PREEMPTED = "preempted"    # evicted by a forced admission; re-queued
    DONE = "done"              # finished (see finish_reason)
    ABORTED = "aborted"        # caller aborted

    LIVE = (WAITING, PREFILL, RUNNING, PREEMPTED)
    FINISHED = (DONE, ABORTED)


class FinishReason:
    STOP = "stop"
    EOS = "eos"
    LENGTH = "length"
    ABORT = "abort"


# eq=False: requests are identities, not value tuples — two requests with
# identical prompts must not alias in queue membership tests / removal.
@dataclasses.dataclass(eq=False)
class Request:
    rid: int
    prompt: np.ndarray           # [S] int32
    max_new_tokens: int = 16
    # per-request decode-time sampling params (vectorized backends):
    # temperature None → the engine default (0 when ec.greedy, else
    # ec.temperature); 0 → greedy. top_k 0 → full vocab.
    temperature: Optional[float] = None
    top_k: int = 0
    # frame embeddings [enc_seq, d] for encoder-decoder archs (stub input)
    embeds: Optional[np.ndarray] = None
    # QoS traffic class: "rt" (latency-critical) | "be" (best-effort)
    qos: str = "be"
    # host-side finish conditions (checked once per iteration, riding the
    # single device→host token fetch): token-id sequences and EOS id
    stop_sequences: Optional[Sequence[Sequence[int]]] = None
    eos_token: Optional[int] = None
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None
    output: List[int] = dataclasses.field(default_factory=list)
    preemptions: int = 0         # times evicted by a forced admission
    state: str = RequestState.WAITING
    finish_reason: Optional[str] = None
    # the stop sequence that fired (finish_reason == "stop"), as submitted
    matched_stop: Optional[Tuple[int, ...]] = None
    # iterations spent waiting in the queue since submission / last
    # preemption (the QoS scheduler's admission-credit coordinate)
    waiting_iters: int = 0
    # chunked prefill (paged backend): the per-request chunk cursor —
    # tokens of the continuation already written into pool blocks while
    # ``state == PREFILL``. A request whose cursor is short of its
    # continuation length is *mid-chunk*: it holds a slot and its block
    # reservation but produces no tokens yet, and its remaining chunks are
    # co-scheduled with decode across later iterations. Always
    # block-aligned except at completion; reset to 0 whenever the slot is
    # released (preemption/abort re-prefills from scratch).
    prefill_pos: int = 0

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.output)

    @property
    def finished(self) -> bool:
        return self.state in RequestState.FINISHED

    def _stop_match_at(self, t: int) -> Optional[Tuple[int, ...]]:
        """First stop sequence whose match *ends* at output position ``t``.

        A sequence longer than the generated tail ``output[:t + 1]``
        windows back into the prompt — stop sequences match across the
        prompt/generation boundary (a one-token continuation of a phrase
        the prompt already started must still fire).
        """
        for seq in self.stop_sequences or ():
            n = len(seq)
            short = n - (t + 1)          # tokens needed from the prompt
            if short > len(self.prompt):
                continue
            if short > 0:
                window = [int(x) for x in self.prompt[-short:]]
                window += self.output[:t + 1]
            else:
                window = self.output[t + 1 - n:t + 1]
            if window == list(seq):
                return tuple(seq)
        return None

    def check_finish(self, new_tokens: int = 1) -> Optional[str]:
        """Finish reason implied by the last ``new_tokens`` committed
        tokens, else None.

        Every newly committed position is scanned in order (a multi-token
        speculative commit may bury the EOS / stop match mid-batch);
        at each position EOS wins over stop-sequence matches, which win
        over length. On a match, ``output`` is truncated right after the
        matching position — accepted draft tokens past the finish point
        are dropped — and ``matched_stop`` records the stop sequence that
        fired.
        """
        if not self.output:
            return None
        start = max(0, len(self.output) - new_tokens)
        for t in range(start, len(self.output)):
            if self.eos_token is not None and self.output[t] == self.eos_token:
                del self.output[t + 1:]
                return FinishReason.EOS
            hit = self._stop_match_at(t)
            if hit is not None:
                del self.output[t + 1:]
                self.matched_stop = hit
                return FinishReason.STOP
            if t + 1 >= self.max_new_tokens:
                del self.output[t + 1:]
                return FinishReason.LENGTH
        return None


@dataclasses.dataclass(frozen=True)
class StepOutput:
    """One request's progress from a single ``LLMEngine.step()``."""

    rid: int
    token: Optional[int]         # token appended this step (None: no token,
    #                              e.g. the terminal abort marker)
    state: str
    finish_reason: Optional[str] = None
    qos: str = "be"

    @property
    def finished(self) -> bool:
        return self.state in RequestState.FINISHED


def normalize_stop_sequences(
        stop: Optional[Sequence[Sequence[int]]]) -> Optional[Tuple[Tuple[int, ...], ...]]:
    """Validate + freeze stop sequences at submit time."""
    if stop is None:
        return None
    out = []
    for seq in stop:
        toks = tuple(int(t) for t in seq)
        if not toks:
            raise ValueError("empty stop sequence")
        out.append(toks)
    return tuple(out)
