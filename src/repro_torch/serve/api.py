"""``LLMEngine`` — the serve front-end (port of ``repro.serve.api``).

::

    from repro_torch.serve import EngineConfig, LLMEngine
    eng = LLMEngine(arch, params, EngineConfig(slots=8))   # on cuda
    h = eng.add_request(prompt, max_new_tokens=32)
    for out in eng.stream(h):
        print(out.token, out.finish_reason)

The engine owns queue + slots + lifecycle (``serve.request``), delegates
when/who to admit or preempt to a ``Scheduler`` and where KV lives / how
tokens are computed to the paged backend. One iteration (``step()``) is
one batched decode pass, at most ``admit_batch`` admission prefills (plus
one forced admission), and a single device→host fetch of the sampled
tokens; stop-sequence / EOS / length finishes are host-side checks on it.

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
from repro_torch.serve.backends import make_backend
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.request import (
    FinishReason, Request, RequestState, StepOutput, normalize_stop_sequences,
)
from repro_torch.serve.scheduler import QOS_CLASSES, Scheduler, make_scheduler

Handle = int


def _refuse_unported(ec: EngineConfig, mesh) -> None:
    """Settings the port does not implement yet fail here, by name."""
    unported = []
    if ec.prefix_cache:
        unported.append("prefix_cache=True")
    if ec.prefill_chunk_tokens is not None:
        unported.append(f"prefill_chunk_tokens={ec.prefill_chunk_tokens}")
    if ec.spec_tokens > 0:
        unported.append(f"spec_tokens={ec.spec_tokens}")
    if mesh is not None:
        unported.append("mesh")
    if ec.backend != "paged":
        unported.append(f"backend={ec.backend!r}")
    if unported:
        raise NotImplementedError(
            f"not ported to repro_torch yet: {', '.join(unported)}")


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
        _refuse_unported(ec, mesh)
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
        # per-iteration wall clock (bounded window) and committed tokens
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
        if req.embeds is not None:
            raise NotImplementedError(
                f"request {req.rid}: embeds inputs are not ported yet")
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

    def _sampling_vectors(self):
        """(per-slot host (temps, topks, rids, steps), any_sampling) for
        this iteration's decode pass; ``steps`` is each request's output
        index (the sampling coordinate)."""
        n = self.ec.slots
        temps = np.zeros((n,), np.float32)
        topks = np.zeros((n,), np.int32)
        rids = np.zeros((n,), np.int32)
        steps = np.zeros((n,), np.int32)
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            temps[i] = self._req_temperature(r)
            topks[i] = r.top_k
            rids[i] = r.rid
            steps[i] = len(r.output)
        return (temps, topks, rids, steps), bool(temps.max(initial=0.0) > 0)

    def _admission_vectors(self, req: Request):
        temp = self._req_temperature(req)
        vecs = (np.asarray([temp], np.float32),
                np.asarray([req.top_k], np.int32),
                np.asarray([req.rid], np.int32),
                np.asarray([len(req.output)], np.int32))
        return vecs, temp > 0

    # -- one iteration -----------------------------------------------------

    def _dispatch_admission(self, req: Request, slot: int):
        req.state = RequestState.PREFILL
        req.waiting_iters = 0
        samp, any_sampling = self._admission_vectors(req)
        tok = self.backend.prefill(req, slot, samp, any_sampling)
        self.slots[slot] = req
        return tok

    def step(self) -> List[StepOutput]:
        """One engine iteration → every request's progress this step."""
        outputs, _ = self._step()
        return outputs

    def _step(self):
        self.iterations += 1
        it_t0 = time.perf_counter()
        outputs: List[StepOutput] = []
        active = [i for i, r in enumerate(self.slots)
                  if r is not None and r.state == RequestState.RUNNING]
        at_dispatch = list(self.slots)  # snapshot: who owns each decode row
        self.max_concurrent = max(self.max_concurrent, len(active))
        self.backend.begin_iteration(active, self.slots)

        dec_tok = None
        if active:
            samp, any_sampling = self._sampling_vectors()
            dec_tok = self.backend.decode(active, self.slots, samp,
                                          any_sampling)

        admitted: List[tuple] = []      # (request, slot, first token)
        granted: List[Request] = []     # dispatched admissions (for credit)
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

        limit = min(self.ec.admit_batch,
                    self.backend.max_admit or self.ec.admit_batch)
        for req in self.scheduler.admit_order(list(self.queue)):
            if not avail or len(granted) >= limit:
                break
            if not self.backend.can_admit(req):
                break
            slot = self._choose_slot(req, avail)
            if slot is None:
                break
            avail.remove(slot)
            self.queue.remove(req)
            tok = self._dispatch_admission(req, slot)
            granted.append(req)
            admitted.append((req, slot, tok))

        # forced admission (bounded-priority / QoS rt guarantee): a free
        # slot first, then preempt victims — never a slot that is finishing
        # or was admitted this iteration — until the request fits
        forced = self.scheduler.forced_request(list(self.queue), granted)
        if forced is not None and self.backend.can_admit(forced):
            slot = self._choose_slot(forced, avail)
            if slot is not None:
                avail.remove(slot)
                self.queue.remove(forced)
                tok = self._dispatch_admission(forced, slot)
                granted.append(forced)
                admitted.append((forced, slot, tok))
                forced = None
        if forced is not None:
            taken = {s for _, s, _ in admitted}
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
                        tok = self._dispatch_admission(forced, slot)
                        granted.append(forced)
                        admitted.append((forced, slot, tok))

        finished = self._fetch_and_finish(dec_tok, active, at_dispatch,
                                          admitted, pre_released, outputs)
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
                          pre_released, outputs) -> List[Request]:
        """One device→host fetch of this iteration's sampled tokens (decode
        batch + every admitted request's first token), then the host-side
        finish bookkeeping: stop sequences, EOS, length."""
        finished: List[Request] = []
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
        now = time.perf_counter()
        if dec_tok is not None:
            for i in active:
                r = at_dispatch[i]
                r.output.append(int(dec_vals[i]))
                reason = r.check_finish()
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
                outputs.append(StepOutput(
                    rid=r.rid, token=r.output[-1], state=r.state,
                    finish_reason=r.finish_reason if reason else None,
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
        """Engine-level serving counters and decode-iteration wall
        statistics (jitter = p99 − p50 iteration wall)."""
        b = self.backend
        walls = np.asarray(self._iter_walls, np.float64)
        p50 = float(np.percentile(walls, 50)) if walls.size else 0.0
        p99 = float(np.percentile(walls, 99)) if walls.size else 0.0
        toks = np.asarray(self._iter_tokens, np.float64)
        m = min(walls.size, toks.size)
        per_tok = (walls[-m:] / np.maximum(toks[-m:], 1.0)) if m else walls
        tp50 = float(np.percentile(per_tok, 50)) if per_tok.size else 0.0
        tp99 = float(np.percentile(per_tok, 99)) if per_tok.size else 0.0
        return {
            "iterations": float(self.iterations),
            "decode_dispatches": float(b.decode_dispatches),
            "transfers": float(b.transfers),
            "max_concurrent": float(self.max_concurrent),
            "iter_wall_p50_ms": p50 * 1e3,
            "iter_wall_p99_ms": p99 * 1e3,
            "decode_iter_jitter_ms": (p99 - p50) * 1e3,
            "iter_wall_per_token_p50_ms": tp50 * 1e3,
            "iter_wall_per_token_p99_ms": tp99 * 1e3,
        }

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
