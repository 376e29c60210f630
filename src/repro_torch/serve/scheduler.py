"""Pluggable admission schedulers — the software twins of the CHIMERA
shared-L2 island's arbiters (``repro.core.qos`` in the JAX package).

The engine (``repro_torch.serve.api.LLMEngine``) owns slots and the waiting
queue; a :class:`Scheduler` decides, each iteration,

  * the **order** in which waiting requests are considered for free
    slots (``admit_order`` — admission stops at the first request the
    backend cannot fit, preserving head-of-line capacity credit);
  * whether a waiting request must be **forced** in by preempting a
    running slot (``forced_request``), and
  * which slots to prefer as **victims** for that preemption
    (``victim_order``).

Three policies, mirroring ``repro.core.qos`` arbiter-for-arbiter:

  * ``fcfs``    — pure arrival order; never preempts. The round-robin
                  baseline: a latency-critical request queued behind bulk
                  traffic waits for the whole burst (Fig. 6b baseline).
  * ``bounded`` — arrival order, but after ``admit_window`` consecutive
                  decode-only iterations with a request waiting, one
                  admission is forced through by preempting the slot with
                  the most remaining work. This is the legacy engines'
                  policy, extracted verbatim.
  * ``qos``     — two traffic classes. ``"rt"`` (the narrow-port analog)
                  has admission priority and a *bounded* wait: the rt
                  lane head is forced in within ``rt_window`` iterations,
                  preferring ``"be"`` victims. ``"be"`` (the wide-DMA
                  analog) fills the remaining slots, and after
                  ``be_grant_window`` consecutive rt admissions with a
                  be request waiting, the next free-slot grant goes to
                  be — rt priority is bounded exactly like the arbiter's
                  narrow-grant window, so bulk traffic keeps flowing.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from repro_torch.serve.config import EngineConfig
from repro_torch.serve.request import Request

RT = "rt"
BE = "be"
QOS_CLASSES = (RT, BE)


def _by_remaining_work(running: Sequence[Tuple[int, Request]]) -> List[int]:
    """Victim preference: most remaining work first; ties prefer the
    highest slot index (the legacy engines' ``_pick_victim`` order)."""
    return [i for _, i in sorted(
        ((req.remaining, i) for i, req in running), reverse=True)]


class Scheduler:
    """Base policy: FCFS admission, no forced path.

    Subclasses override ``forced_request`` / ``admit_order`` /
    ``victim_order``; ``note_iteration`` ages the queue (every waiting
    request's ``waiting_iters`` advances once per engine iteration).
    """

    name = "fcfs"

    def __init__(self, ec: EngineConfig):
        self.ec = ec

    def admit_order(self, queue: Sequence[Request]) -> List[Request]:
        """Order in which waiting requests are offered free slots. The
        engine stops at the first request its backend cannot fit — a
        scheduler reorders, it never skips over a capacity-blocked head
        (head-of-line credit is what makes admission windows bounded)."""
        return list(queue)

    def forced_request(self, queue: Sequence[Request],
                       admitted: Sequence[Request]) -> Optional[Request]:
        """The request that must be admitted *now* via preemption, if any.
        Called after the free-slot admission pass; ``admitted`` is what
        that pass let in this iteration."""
        return None

    def victim_order(self,
                     running: Sequence[Tuple[int, Request]]) -> List[int]:
        """Slot eviction preference for a forced admission, best first."""
        return _by_remaining_work(running)

    def chunk_order(self,
                    chunking: Sequence[Tuple[int, Request]]) -> List[int]:
        """Order in which mid-chunk (PREFILL-in-progress) slots drain this
        iteration's prefill-chunk token budget. ``chunking`` is (slot,
        request) pairs in slot order; earlier slots get budget first, so
        the head finishes its prefill (and starts decoding) before later
        arrivals — admission-order completion, no chunk interleaving
        starvation."""
        return [i for i, _ in chunking]

    def note_iteration(self, admitted: Sequence[Request],
                       queue: Sequence[Request]) -> None:
        """Advance queue aging. ``admitted`` must contain only requests
        whose admission was actually *dispatched* this iteration (a
        chunked admission counts from its first chunk; a deferred forced
        admission — ``evict_for`` feasibility precheck returned no
        victims — must not appear, or grant-credit accounting
        double-counts it)."""
        for req in queue:
            req.waiting_iters += 1


class FCFSScheduler(Scheduler):
    """Arrival order, never preempts — the no-QoS baseline."""

    name = "fcfs"


class BoundedPriorityScheduler(Scheduler):
    """The legacy engines' bounded-priority policy.

    Decode (latency class) always has priority over admission (bulk
    class), but after ``admit_window`` consecutive iterations in which a
    request was left waiting *and nothing was admitted*, one admission is
    forced through — the direct software analog of
    ``repro.core.qos.BoundedPriorityArbiter`` with the roles flipped
    (here the *bulk* class holds the bounded credit)."""

    name = "bounded"

    def __init__(self, ec: EngineConfig):
        super().__init__(ec)
        self._decode_only_iters = 0

    def forced_request(self, queue, admitted):
        if (not admitted and queue
                and self._decode_only_iters >= self.ec.admit_window):
            return queue[0]
        return None

    def note_iteration(self, admitted, queue):
        super().note_iteration(admitted, queue)
        if admitted:
            self._decode_only_iters = 0
        elif queue:  # a request was left waiting this iteration
            self._decode_only_iters += 1
        else:
            self._decode_only_iters = 0


class QoSTrafficClassScheduler(Scheduler):
    """Two-class QoS admission — the island arbiter's software twin.

    ``"rt"`` requests are the narrow-port (latency-critical) lane: they
    are offered free slots first, and the rt lane head is *forced* in —
    preempting a best-effort slot — once it has waited ``rt_window``
    iterations. That bound holds regardless of what else was admitted
    this iteration, so rt admission latency is a guarantee, not a
    priority hint.

    ``"be"`` requests are the wide-DMA lane: they fill remaining slots in
    arrival order and are never preempted *by this scheduler's grant
    path* — but they can be evicted by an rt forced admission (be slots
    are preferred victims). To bound rt priority the way the arbiter
    bounds narrow grants, after ``be_grant_window`` consecutive rt
    admissions with a be request waiting, the be lane head is moved to
    the front of the next admission pass.

    **Token-rate shaping** (``ec.be_token_share``): when set, the be
    lane's share of *decode tokens* (not just admission grants) is
    bounded directly — while rt requests are waiting and the cumulative
    be-token fraction exceeds the share, be admissions are withheld from
    the admission pass (the guaranteed-grant rule included). With no rt
    demand the be lane always flows, so shaping throttles, it never
    starves.
    """

    name = "qos"

    def __init__(self, ec: EngineConfig):
        super().__init__(ec)
        self._consecutive_rt = 0
        # token-share accounting: live admitted requests are observed in
        # place (their .output grows as they decode); finished ones fold
        # into per-lane scalars so the map stays bounded
        self._live: dict = {}               # rid -> Request
        self._done_tokens = {RT: 0, BE: 0}

    @staticmethod
    def _lanes(queue: Sequence[Request]):
        rt = [r for r in queue if r.qos == RT]
        be = [r for r in queue if r.qos != RT]
        return rt, be

    def _token_counts(self) -> Tuple[int, int]:
        """Cumulative decode tokens per lane across everything this
        scheduler has admitted (live slots counted at their current
        length). Observing ``len(req.output)`` keeps the accounting
        correct under speculative decoding too — a multi-token commit
        advances the lane's count by every committed token, not by
        iterations."""
        totals = dict(self._done_tokens)
        for rid, req in list(self._live.items()):
            lane = RT if req.qos == RT else BE
            totals[lane] += len(req.output)
            if req.finished:
                self._done_tokens[lane] += len(req.output)
                del self._live[rid]
        return totals[RT], totals[BE]

    def _be_throttled(self, queue) -> bool:
        share = self.ec.be_token_share
        if share is None:
            return False
        if not any(r.qos == RT for r in queue):
            return False      # no rt demand → shaping never starves be
        rt_toks, be_toks = self._token_counts()
        total = rt_toks + be_toks
        return total > 0 and be_toks / total > share

    def admit_order(self, queue):
        rt, be = self._lanes(queue)
        if self._be_throttled(queue):
            return rt         # withhold be grants while over-share
        if be and self._consecutive_rt >= self.ec.be_grant_window:
            # guaranteed be grant: the bounded-narrow-priority rule
            return be[:1] + rt + be[1:]
        return rt + be

    def forced_request(self, queue, admitted):
        rt, _ = self._lanes(queue)
        if rt and rt[0].waiting_iters >= self.ec.rt_window:
            return rt[0]
        return None

    def victim_order(self, running):
        be = [(i, r) for i, r in running if r.qos != RT]
        rt = [(i, r) for i, r in running if r.qos == RT]
        return _by_remaining_work(be) + _by_remaining_work(rt)

    def chunk_order(self, chunking):
        """rt prefill chunks outrank be chunk work: the shared per-
        iteration token budget drains into latency-critical prefills
        first, so an rt TTFT is never extended by a long be prompt ahead
        of it in slot order (the decode dispatch itself is one batch —
        priority is expressed through budget order, the same way the
        island arbiter orders narrow grants before wide beats)."""
        rt = [i for i, r in chunking if r.qos == RT]
        be = [i for i, r in chunking if r.qos != RT]
        return rt + be

    def note_iteration(self, admitted, queue):
        super().note_iteration(admitted, queue)
        for r in admitted:
            self._live[r.rid] = r
        _, be_waiting = self._lanes(queue)
        if any(r.qos != RT for r in admitted):
            self._consecutive_rt = 0
        elif be_waiting and any(r.qos == RT for r in admitted):
            self._consecutive_rt += sum(r.qos == RT for r in admitted)
        elif not be_waiting:
            self._consecutive_rt = 0


_SCHEDULERS = {
    "fcfs": FCFSScheduler,
    "bounded": BoundedPriorityScheduler,
    "qos": QoSTrafficClassScheduler,
}

# config.SCHEDULERS is the single source of truth for valid names
# (EngineConfig validates against it at construction); this dispatch
# table must cover it exactly — drift fails at import, not at serve time
from repro_torch.serve.config import SCHEDULERS as _NAMES  # noqa: E402

if set(_SCHEDULERS) != set(_NAMES):
    raise ImportError(
        f"scheduler registry drift: config.SCHEDULERS={_NAMES} vs "
        f"dispatch table {tuple(_SCHEDULERS)}")


def make_scheduler(ec: EngineConfig) -> Scheduler:
    try:
        cls = _SCHEDULERS[ec.scheduler]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {ec.scheduler!r} "
            f"(supported: {', '.join(_NAMES)})") from None
    return cls(ec)
