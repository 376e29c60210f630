"""``LLMEngine`` — the serve front-end (port of ``repro.serve.api``).

::

    from repro_torch.serve import EngineConfig, LLMEngine
    eng = LLMEngine(arch, params, EngineConfig(slots=8))   # on cuda
    h = eng.add_request(prompt, max_new_tokens=32)
    for out in eng.stream(h):
        print(out.token, out.finish_reason)

The engine owns queue + slots + lifecycle (``serve.request``), delegates
when/who to admit or preempt to a ``Scheduler`` and where the decode state
lives / how tokens are computed to a backend (``slot``, ``arena`` or
``paged``; ``serve.backends``). One iteration (``step()``) is one batched
decode pass, at most ``admit_batch`` admission prefills (plus one forced
admission), and a single device→host fetch of the sampled tokens;
stop-sequence / EOS / length finishes are host-side checks on it. The
``slot`` backend instead decodes slot by slot, fetching each token as it
goes, and admits one request per iteration.
With ``spec_tokens = k > 0`` the decode pass becomes a verify pass over
each slot's last token plus up to ``k`` n-gram drafts (``serve.spec``);
greedy acceptance commits 1..k+1 tokens per slot per iteration, the same
tokens the plain decode would have produced. With ``prefill_chunk_tokens``
set (paged backend), admission prefills run as block-aligned chunks that
share one token budget an iteration, beside the decode pass.

The engine runs on ``cuda`` unless ``device="cpu"`` is passed; with no GPU
and no explicit device, construction raises.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models import registry
from repro_torch.models.schema import leaves
from repro_torch.serve.backends import continuation_tokens, make_backend
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.request import (
    FinishReason, Request, RequestState, StepOutput, normalize_stop_sequences,
)
from repro_torch.serve.scheduler import QOS_CLASSES, Scheduler, make_scheduler
from repro_torch.serve.spec import accept_tokens, ngram_propose

Handle = int


def _validate(ec: EngineConfig) -> None:
    """The reference's cross-field checks on the chosen backend. (The
    reference validates nothing else here: ``prefix_cache`` is read by the
    paged backend only, and the arena ignores it.)"""
    if ec.prefill_chunk_tokens is not None and ec.backend != "paged":
        raise ValueError(
            f"prefill_chunk_tokens={ec.prefill_chunk_tokens} applies "
            f"to the paged backend only — chunked prefill resumes at "
            f"block boundaries of the shared pool, which the dense "
            f"arenas don't have")
    if ec.spec_tokens > 0 and ec.backend != "paged":
        raise ValueError(
            f"spec_tokens={ec.spec_tokens} applies to the paged "
            f"backend only — draft verification writes through the "
            f"block pools and rollback rides the paged allocator")


class LLMEngine:
    """Continuous-batching serve engine with pluggable scheduler/backend."""

    def __init__(self, arch: registry.Arch, params,
                 config: Optional[EngineConfig] = None, *,
                 backend=None, scheduler: Optional[Scheduler] = None,
                 mesh=None, device: DeviceLike = None):
        """``backend`` / ``scheduler`` inject pre-built instances (any
        object honoring the protocols); normally both are built from
        ``config``. ``device`` (default ``cuda``) is where the backend
        keeps its pools; ``params`` must already live there."""
        ec = config if config is not None else EngineConfig()
        _validate(ec)
        if mesh is not None:
            raise NotImplementedError("not ported to repro_torch yet: mesh")
        self.arch = arch
        self.ec = ec
        self.params = params
        self.scheduler: Scheduler = (scheduler if scheduler is not None
                                     else make_scheduler(ec))
        if backend is None:
            dev = resolve_device(device)
            for leaf in leaves(params):
                if leaf.device.type != dev.type:
                    raise ValueError(
                        f"params live on {leaf.device}, engine device is "
                        f"{dev}: move them first (repro_torch.bridge)")
            backend = make_backend(ec.backend, arch, params, ec, dev)
        self.backend = backend
        self.queue: deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * ec.slots
        self.iterations = 0
        self.max_concurrent = 0           # peak active slots (capacity proof)
        # chunked prefill: active iff configured AND the backend supports
        # it (an injected backend may not)
        self._chunked = (ec.prefill_chunk_tokens is not None
                         and getattr(self.backend, "chunking", False))
        self._chunk_stalls = 0   # chunk or admission dispatches deferred by
        #                          an exhausted per-iteration token budget
        # speculative decoding: active iff configured AND the backend
        # supports it (an injected backend may not)
        self._spec = (ec.spec_tokens
                      if getattr(self.backend, "spec_supported", False)
                      else 0)
        self.spec_drafted = 0    # draft tokens proposed across iterations
        self.spec_accepted = 0   # drafts accepted (excludes bonus tokens)
        # per-iteration wall clock (bounded window) and committed tokens —
        # a speculative iteration commits several, so walls are also
        # reported per committed token
        self._iter_walls: deque = deque(maxlen=2048)
        self._iter_tokens: deque = deque(maxlen=2048)
        self._requests: Dict[int, Request] = {}
        self._finished_order: deque[int] = deque()
        self._next_rid = 0

    # backend observability (decode_dispatches, transfers, alloc, layout,
    # qparams, cache, ...) reads through the engine
    def __getattr__(self, name):
        backend = self.__dict__.get("backend")
        if backend is not None and hasattr(backend, name):
            return getattr(backend, name)
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")

    def _choose_slot(self, req, avail):
        chooser = getattr(self.backend, "choose_slot", None)
        if chooser is None:
            return avail[0] if avail else None
        return chooser(req, avail)

    # -- request intake ----------------------------------------------------

    def add_request(self, prompt, *, max_new_tokens: int = 16,
                    qos: str = "be", temperature: Optional[float] = None,
                    top_k: int = 0,
                    stop_sequences=None, eos_token: Optional[int] = None,
                    embeds: Optional[np.ndarray] = None,
                    rid: Optional[int] = None) -> Handle:
        """Queue a generation request; returns its handle (the rid)."""
        if rid is None:
            rid = self._next_rid
        req = Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens, qos=qos,
                      temperature=temperature, top_k=top_k,
                      stop_sequences=stop_sequences, eos_token=eos_token,
                      embeds=embeds)
        return self.submit(req)

    def submit(self, req: Request) -> Handle:
        """Queue a fully-built :class:`Request`; returns its handle."""
        if len(req.prompt) + req.max_new_tokens > self.ec.max_len:
            raise ValueError(
                f"request {req.rid}: prompt ({len(req.prompt)}) + "
                f"max_new_tokens ({req.max_new_tokens}) exceeds "
                f"max_len={self.ec.max_len}")
        if req.qos not in QOS_CLASSES:
            raise ValueError(
                f"request {req.rid}: unknown qos class {req.qos!r} "
                f"(supported: {', '.join(QOS_CLASSES)})")
        live = self._requests.get(req.rid)
        if live is not None and not live.finished and live is not req:
            raise ValueError(
                f"request id {req.rid} is already live on this engine")
        if live is not None and live.finished:
            try:
                self._finished_order.remove(req.rid)
            except ValueError:
                pass
        req.stop_sequences = normalize_stop_sequences(req.stop_sequences)
        self.backend.validate_request(req)
        req.state = RequestState.WAITING
        req.waiting_iters = 0
        req.submitted_at = time.perf_counter()
        self.queue.append(req)
        self._requests[req.rid] = req
        self._next_rid = max(self._next_rid, req.rid + 1)
        return req.rid

    def request(self, handle: Union[Handle, Request]) -> Request:
        if isinstance(handle, Request):
            return handle
        try:
            return self._requests[handle]
        except KeyError:
            raise KeyError(f"unknown request handle {handle!r}") from None

    # -- lifecycle ---------------------------------------------------------

    @property
    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.slots)

    def abort(self, handle: Union[Handle, Request]) -> bool:
        """Abort a request wherever it is; a running request's slot is
        vacated and its pool blocks return to the allocator immediately.
        Returns False if it already finished."""
        req = self.request(handle)
        if req.finished:
            return False
        if req in self.queue:
            self.queue.remove(req)
            self._backend_forget(req)
        else:
            for i, r in enumerate(self.slots):
                if r is req:
                    self.backend.release(i, req)
                    self.slots[i] = None
                    break
        req.state = RequestState.ABORTED
        req.finish_reason = FinishReason.ABORT
        req.done_at = time.perf_counter()
        self._note_finished(req)
        return True

    def _note_finished(self, req: Request) -> None:
        self._finished_order.append(req.rid)
        keep = self.ec.retain_finished
        if keep is None:
            return
        while len(self._finished_order) > keep:
            old = self._finished_order.popleft()
            stale = self._requests.get(old)
            if stale is not None and stale.finished:
                del self._requests[old]

    # -- sampling vectors --------------------------------------------------

    def _req_temperature(self, req: Request) -> float:
        return self.ec.effective_temperature(req.temperature)

    def _sampling_vectors(self, q: int = 1):
        """(per-row host (temps, topks, rids, steps), any_sampling) for this
        iteration's decode pass (``q = 1``) or verify pass (``q = k + 1``,
        flat [slots · q] rows). Row ``i·q + j`` carries slot ``i``'s
        coordinates with ``steps`` at the absolute output index
        ``len(output) + j`` of the token it would commit — so a sampled
        token is a function of (seed, rid, index), with speculation on or
        off."""
        n = self.ec.slots * q
        temps = np.zeros((n,), np.float32)
        topks = np.zeros((n,), np.int32)
        rids = np.zeros((n,), np.int32)
        steps = np.zeros((n,), np.int32)
        for i, r in enumerate(self.slots):
            # empty and mid-chunk rows are ignored host-side: greedy
            if r is None or r.state != RequestState.RUNNING:
                continue
            lo = i * q
            temps[lo:lo + q] = self._req_temperature(r)
            topks[lo:lo + q] = r.top_k
            rids[lo:lo + q] = r.rid
            steps[lo:lo + q] = len(r.output) + np.arange(q)
        return (temps, topks, rids, steps), bool(temps.max(initial=0.0) > 0)

    def _build_drafts(self, active):
        """Token matrix + spans + per-slot drafts for one verify pass.

        Row ``i`` of the [slots, k+1] matrix is the slot's last committed
        token followed by its n-gram drafts; unused columns stay 0 (their
        K/V lands past the frontier or in trash, their logits are
        ignored). Each slot drafts at most ``remaining - 1`` tokens, so a
        commit never exceeds ``max_new_tokens`` nor outgrows the block
        reservation; ``spans[i] = drafts + 1`` is its write extent."""
        k = self._spec
        mat = np.zeros((self.ec.slots, k + 1), np.int32)
        spans = [1] * self.ec.slots
        drafts: Dict[int, List[int]] = {}
        for i in active:
            r = self.slots[i]
            mat[i, 0] = r.output[-1]
            cap = min(k, r.max_new_tokens - len(r.output) - 1)
            d = ngram_propose(continuation_tokens(r), cap) if cap > 0 else []
            mat[i, 1:1 + len(d)] = d
            spans[i] = len(d) + 1
            drafts[i] = d
            self.spec_drafted += len(d)
        return mat, spans, drafts

    def _admission_vectors(self, req: Request):
        temp = self._req_temperature(req)
        vecs = (np.asarray([temp], np.float32),
                np.asarray([req.top_k], np.int32),
                np.asarray([req.rid], np.int32),
                np.asarray([len(req.output)], np.int32))
        return vecs, temp > 0

    # -- one iteration -----------------------------------------------------

    def _dispatch_admission(self, req: Request, slot: int, budget=None):
        """One admission dispatch for ``req`` into ``slot``. Monolithic
        backends run the whole prefill; under chunked prefill only the
        first chunk (within ``budget`` tokens) is dispatched and the
        request stays in PREFILL until later iterations finish it.
        Returns ``(tokens consumed, first token or None)``."""
        req.state = RequestState.PREFILL
        req.waiting_iters = 0
        if self.backend.vectorized:
            samp, any_sampling = self._admission_vectors(req)
        else:
            samp, any_sampling = None, False
        if self._chunked:
            self.backend.prefill_begin(req, slot)
            self.slots[slot] = req
            return self.backend.prefill_chunk(req, slot, budget, samp,
                                              any_sampling)
        tok = self.backend.prefill(req, slot, samp, any_sampling)
        self.slots[slot] = req
        return 0, tok

    def step(self) -> List[StepOutput]:
        """One engine iteration → every request's progress this step."""
        outputs, _ = self._step()
        return outputs

    def _step(self):
        """One engine iteration: one decode (or verify) pass over the
        running slots, up to ``admit_batch`` admission dispatches (plus at
        most one forced admission), then a single device→host fetch of the
        sampled tokens. Under chunked prefill the iteration is bounded: all
        prefill work (chunk continuations first, then new admissions)
        shares one ``prefill_chunk_tokens`` budget, so a long prompt no
        longer stalls every running decode behind a monolithic prefill.
        Requests finishing by length release their resources before this
        iteration's admissions; stop/EOS finishes release on the fetch."""
        self.iterations += 1
        it_t0 = time.perf_counter()
        outputs: List[StepOutput] = []
        # decode batches only RUNNING occupants; mid-chunk (PREFILL) slots
        # hold blocks but no token yet — their prefill continues below
        active = [i for i, r in enumerate(self.slots)
                  if r is not None and r.state == RequestState.RUNNING]
        chunking = [i for i, r in enumerate(self.slots)
                    if r is not None and r.state == RequestState.PREFILL]
        at_dispatch = list(self.slots)  # snapshot: who owns each decode row
        self.max_concurrent = max(self.max_concurrent,
                                  len(active) + len(chunking))
        # speculative path: drafts built host-side, and one verify pass
        # over [slots, k+1] positions replaces the decode pass
        spec_drafts = spec_mat = spans = None
        if self._spec and active:
            spec_mat, spans, spec_drafts = self._build_drafts(active)
        self.backend.begin_iteration(active, self.slots, spans=spans)

        dec_tok = None
        if spec_drafts is not None:
            samp, any_sampling = self._sampling_vectors(self._spec + 1)
            dec_tok = self.backend.verify(active, self.slots, spec_mat, samp,
                                          any_sampling)
        elif active and self.backend.vectorized:
            samp, any_sampling = self._sampling_vectors()
            dec_tok = self.backend.decode(active, self.slots, samp,
                                          any_sampling)
        elif active:
            dec_tok = self.backend.decode(active, self.slots, None, False)

        # chunked prefill: in-flight admissions continue first (they hold
        # their blocks already, and finishing one turns a dead slot into a
        # decode row), in the scheduler's chunk order (qos: rt before be)
        admitted: List[tuple] = []      # (request, slot, first token)
        granted: List[Request] = []     # dispatched admissions (for credit)
        granted_slots: set = set()
        budget = self.ec.prefill_chunk_tokens if self._chunked else None
        if chunking:
            pairs = [(i, self.slots[i]) for i in chunking]
            order_fn = getattr(self.scheduler, "chunk_order", None)
            order = (order_fn(pairs) if order_fn is not None
                     else [i for i, _ in pairs])
            for i in order:
                if budget is not None and budget < self.ec.block_len:
                    self._chunk_stalls += 1
                    break
                r = self.slots[i]
                samp, any_sampling = self._admission_vectors(r)
                used, tok = self.backend.prefill_chunk(r, i, budget, samp,
                                                       any_sampling)
                if budget is not None:
                    budget -= used
                if tok is not None:
                    admitted.append((r, i, tok))

        # length-determined finishes free their resources *now* so this
        # iteration's admissions can reuse them
        will_free = [i for i in active
                     if len(self.slots[i].output) + 1
                     >= self.slots[i].max_new_tokens]
        for i in will_free:
            self.backend.release(i, self.slots[i])
        pre_released = set(will_free)
        free = [i for i, r in enumerate(self.slots) if r is None]
        avail = free + will_free

        # an exhausted chunk budget blocks the queue head like a capacity
        # block does
        limit = min(self.ec.admit_batch,
                    self.backend.max_admit or self.ec.admit_batch)
        for req in self.scheduler.admit_order(list(self.queue)):
            if not avail or len(granted) >= limit:
                break
            if budget is not None and budget < self.ec.block_len:
                self._chunk_stalls += 1
                break
            if not self.backend.can_admit(req):
                break
            slot = self._choose_slot(req, avail)
            if slot is None:
                break
            avail.remove(slot)
            self.queue.remove(req)
            used, tok = self._dispatch_admission(req, slot, budget)
            if budget is not None:
                budget -= used
            granted.append(req)
            granted_slots.add(slot)
            if tok is not None:
                admitted.append((req, slot, tok))

        # forced admission (bounded-priority / QoS rt guarantee): a free
        # slot first — chunked, with a fresh one-chunk allowance (the
        # latency bound outranks the shared budget) — then preempt victims,
        # never a slot that is finishing or was admitted this iteration,
        # until the request fits
        forced_budget = (self.ec.prefill_chunk_tokens if self._chunked
                         else None)
        forced = self.scheduler.forced_request(list(self.queue), granted)
        if forced is not None and self.backend.can_admit(forced):
            slot = self._choose_slot(forced, avail)
            if slot is not None:
                avail.remove(slot)
                self.queue.remove(forced)
                used, tok = self._dispatch_admission(forced, slot,
                                                     forced_budget)
                granted.append(forced)
                granted_slots.add(slot)
                if tok is not None:
                    admitted.append((forced, slot, tok))
                forced = None
        if forced is not None:
            # nor a slot whose final chunk just completed (its first token
            # is in flight)
            taken = granted_slots | {s for _, s, _ in admitted}
            running = [(i, r) for i, r in enumerate(self.slots)
                       if r is not None and i not in pre_released
                       and i not in taken]
            if running:
                candidates = self.scheduler.victim_order(running)
                evict = self.backend.evict_for(forced, candidates,
                                               self.slots)
                victims: List[Request] = []
                for s in evict:
                    v = self.slots[s]
                    v.preemptions += 1
                    v.state = RequestState.PREEMPTED
                    v.waiting_iters = 0
                    self.slots[s] = None
                    victims.append(v)
                if victims:
                    for v in reversed(victims):
                        self.queue.appendleft(v)  # re-admitted at queue head
                    if self.backend.can_admit(forced):
                        self.queue.remove(forced)
                        slot = evict[0]
                        used, tok = self._dispatch_admission(forced, slot,
                                                             forced_budget)
                        granted.append(forced)
                        granted_slots.add(slot)
                        if tok is not None:
                            admitted.append((forced, slot, tok))

        finished = self._fetch_and_finish(dec_tok, active, at_dispatch,
                                          admitted, pre_released, outputs,
                                          spec_drafts)
        self.scheduler.note_iteration(granted, list(self.queue))
        self._iter_walls.append(time.perf_counter() - it_t0)
        self._iter_tokens.append(
            sum(1 for o in outputs if o.token is not None))
        return outputs, finished

    # -- fetch + host-side finish bookkeeping ------------------------------

    def _backend_forget(self, req: Request) -> None:
        fn = getattr(self.backend, "forget", None)
        if fn is not None:
            fn(req)

    def _finish(self, req: Request, slot: Optional[int], reason: str,
                now: float, already_released: bool,
                finished: List[Request]) -> None:
        req.finish_reason = reason
        req.state = RequestState.DONE
        req.done_at = now
        if slot is not None:
            if not already_released:
                self.backend.release(slot, req)
            if self.slots[slot] is req:
                self.slots[slot] = None
        else:
            self._backend_forget(req)
        self._note_finished(req)
        finished.append(req)

    def _fetch_and_finish(self, dec_tok, active, at_dispatch, admitted,
                          pre_released, outputs,
                          spec_drafts=None) -> List[Request]:
        """One device→host fetch of this iteration's sampled tokens (decode
        batch + every admitted request's first token), then the host-side
        finish bookkeeping: stop sequences, EOS, length.

        ``spec_drafts`` (speculation) maps slot → its drafts; ``dec_tok``
        is then the [slots, Q] verify choices, greedy acceptance commits
        the longest agreeing prefix per slot plus the bonus token, and the
        backend rolls rejected-draft blocks back. Every committed position
        is scanned for finishes — a stop/EOS match truncates the accepted
        tail behind it."""
        finished: List[Request] = []
        if self.backend.vectorized:
            parts = []
            if dec_tok is not None:
                parts.append(dec_tok.reshape(-1))
            parts += [tok.reshape(1) for _, _, tok in admitted]
            if not parts:
                return finished
            host = torch.cat(parts).tolist()      # the iteration's one fetch
            self.backend.transfers += 1
            n_dec = 0 if dec_tok is None else dec_tok.numel()
            dec_vals, adm_vals = host[:n_dec], host[n_dec:]
        else:
            # the slot backend returned host ints ({slot: token} for the
            # decode) and counted its own transfers
            if dec_tok is None and not admitted:
                return finished
            dec_vals = dec_tok
            adm_vals = [tok for _, _, tok in admitted]
        if spec_drafts is not None:
            q = self._spec + 1
            dec_vals = [dec_vals[i * q:(i + 1) * q]
                        for i in range(len(dec_vals) // q)]
        now = time.perf_counter()
        if dec_tok is not None:
            for i in active:
                r = at_dispatch[i]
                if spec_drafts is not None:
                    d = spec_drafts.get(i, [])
                    committed = accept_tokens(d, dec_vals[i][:len(d) + 1])
                    self.spec_accepted += len(committed) - 1
                    # roll back and advance the frontier — except for a slot
                    # already recycled this iteration (a length-finishing
                    # pre-release or a preemption victim): its rid left the
                    # allocator, and its tokens commit below anyway
                    if r.state != RequestState.PREEMPTED \
                            and i not in pre_released:
                        self.backend.commit(i, r, len(committed))
                else:
                    committed = [int(dec_vals[i])]
                before = len(r.output)
                r.output.extend(committed)
                reason = r.check_finish(new_tokens=len(committed))
                if reason:
                    # a victim preempted this very iteration may finish on
                    # the token it decoded before eviction: it holds no
                    # slot/blocks anymore — just pull it off the queue
                    if r.state == RequestState.PREEMPTED:
                        if r in self.queue:
                            self.queue.remove(r)
                        self._finish(r, None, reason, now, True, finished)
                    else:
                        self._finish(r, i, reason, now, i in pre_released,
                                     finished)
                # one StepOutput per surviving committed token; only the
                # last carries the finish reason
                tail = r.output[before:]
                for j, t in enumerate(tail):
                    last = j == len(tail) - 1
                    outputs.append(StepOutput(
                        rid=r.rid, token=t, state=r.state,
                        finish_reason=(r.finish_reason
                                       if reason and last else None),
                        qos=r.qos))
        for (req, slot, _), tok in zip(admitted, adm_vals):
            req.output.append(int(tok))
            if req.first_token_at is None:
                req.first_token_at = now
            req.state = RequestState.RUNNING
            reason = req.check_finish()
            if reason:
                self._finish(req, slot, reason, now, False, finished)
            outputs.append(StepOutput(
                rid=req.rid, token=req.output[-1], state=req.state,
                finish_reason=req.finish_reason if reason else None,
                qos=req.qos))
        return finished

    # -- observability -----------------------------------------------------

    def metrics(self) -> Dict[str, float]:
        """Engine-level serving counters, decode-iteration wall statistics
        (jitter = p99 − p50 iteration wall; per-token walls normalise each
        iteration by the tokens it committed), speculation counters and,
        with prefix caching, the cache economics."""
        b = self.backend
        walls = np.asarray(self._iter_walls, np.float64)
        p50 = float(np.percentile(walls, 50)) if walls.size else 0.0
        p99 = float(np.percentile(walls, 99)) if walls.size else 0.0
        toks = np.asarray(self._iter_tokens, np.float64)
        m = min(walls.size, toks.size)
        per_tok = (walls[-m:] / np.maximum(toks[-m:], 1.0)) if m else walls
        tp50 = float(np.percentile(per_tok, 50)) if per_tok.size else 0.0
        tp99 = float(np.percentile(per_tok, 99)) if per_tok.size else 0.0
        drafted = float(self.spec_drafted)
        out = {
            "iterations": float(self.iterations),
            "decode_dispatches": float(b.decode_dispatches),
            "transfers": float(b.transfers),
            "max_concurrent": float(self.max_concurrent),
            "iter_wall_p50_ms": p50 * 1e3,
            "iter_wall_p99_ms": p99 * 1e3,
            "decode_iter_jitter_ms": (p99 - p50) * 1e3,
            "iter_wall_per_token_p50_ms": tp50 * 1e3,
            "iter_wall_per_token_p99_ms": tp99 * 1e3,
            "spec_drafted": drafted,
            "spec_accepted": float(self.spec_accepted),
            "spec_accept_rate": (self.spec_accepted / drafted
                                 if drafted else 0.0),
            "prefill_chunks_in_flight": float(sum(
                1 for r in self.slots
                if r is not None and r.state == RequestState.PREFILL)),
            "prefill_chunks_dispatched": float(
                getattr(b, "prefill_chunk_dispatches", 0)),
            "prefill_chunk_stalls": float(self._chunk_stalls),
        }
        alloc = getattr(b, "alloc", None)
        if alloc is None or not getattr(b, "prefix_caching", False):
            return out
        looked = alloc.hit_blocks + alloc.miss_blocks
        total = b.prefill_tokens_total
        out.update({
            "prefix_cache_hit_blocks": float(alloc.hit_blocks),
            "prefix_cache_miss_blocks": float(alloc.miss_blocks),
            "prefix_cache_hit_rate": (alloc.hit_blocks / looked
                                      if looked else 0.0),
            "prefix_cache_evictions": float(alloc.evictions),
            "prefix_cache_cow_copies": float(alloc.cow_copies),
            "prefix_cached_blocks": float(alloc.cached_blocks),
            "prefill_tokens_total": float(total),
            "prefill_tokens_skipped": float(b.prefill_tokens_skipped),
            "prefill_skip_rate": (b.prefill_tokens_skipped / total
                                  if total else 0.0),
        })
        return out

    # -- run loops ---------------------------------------------------------

    def run_until_drained(self, max_iters: int = 10_000) -> List[Request]:
        done: List[Request] = []
        for _ in range(max_iters):
            _, finished = self._step()
            done.extend(finished)
            if self.idle:
                break
        return done

    def stream(self, handle: Union[Handle, Request]) -> Iterator[StepOutput]:
        """Step the engine and yield ``handle``'s tokens as they land.
        Terminates after the final token (its ``finish_reason`` set), or
        with a token-less terminal StepOutput if the request was aborted
        between tokens."""
        req = self.request(handle)
        cursor = 0
        reason_delivered = False
        while True:
            while cursor < len(req.output):
                cursor += 1
                final = req.finished and cursor == len(req.output)
                if final:
                    reason_delivered = True
                yield StepOutput(
                    rid=req.rid, token=req.output[cursor - 1],
                    state=req.state,
                    finish_reason=req.finish_reason if final else None,
                    qos=req.qos)
            if req.finished:
                if not reason_delivered:
                    yield StepOutput(rid=req.rid, token=None,
                                     state=req.state,
                                     finish_reason=req.finish_reason,
                                     qos=req.qos)
                return
            if self.idle:
                return
            self.step()


def metrics(done: List[Request]) -> Dict[str, float]:
    finished = [r for r in done if r.done_at is not None]
    if not finished:
        return {"requests": 0, "ttft_avg_s": 0.0, "latency_avg_s": 0.0,
                "tokens_per_s": 0.0}
    ttft = [r.first_token_at - r.submitted_at
            for r in finished if r.first_token_at is not None]
    lat = [r.done_at - r.submitted_at for r in finished]
    toks = sum(len(r.output) for r in finished)
    wall = (max(r.done_at for r in finished)
            - min(r.submitted_at for r in finished))
    return {
        "requests": len(finished),
        "ttft_avg_s": float(np.mean(ttft)) if ttft else 0.0,
        "latency_avg_s": float(np.mean(lat)) if lat else 0.0,
        "tokens_per_s": toks / wall if wall > 0 else 0.0,
    }
