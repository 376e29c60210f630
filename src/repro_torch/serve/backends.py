"""Execution backends behind the ``CacheBackend`` protocol.

Port of ``repro.serve.backends``. A backend owns where the decode state
lives and how a token gets computed; queues, lifecycle and policy are the
engine's (``serve.api``) and the scheduler's. Three implementations,
selected by ``EngineConfig.backend``:

  * ``slot``  — :class:`SlotBackend`: the sequential per-slot reference.
    One batch-1 decode per slot with a host argmax per token; greedy-only.
  * ``arena`` — :class:`ArenaBackend`: one batched cache with the slot
    dimension (``arch.init_cache``), one batched decode over every slot per
    iteration, admission prefill (right-padded to a power-of-two length
    bucket where the family allows it) spliced into the slot with
    ``models.cache.cache_insert``, and the engine's single device→host token
    fetch per iteration.
  * ``paged`` — :class:`PagedBackend`: continuous batching over a shared
    pool of fixed-size KV blocks (``models.cache.PagedLayout``) with
    host-owned block tables, paged prefill straight into pool blocks, int8
    block storage for quantized archs, ring-block pools for sliding-window
    layers whose window is shorter than ``max_len``, prefix caching
    (content-addressed block sharing with copy-on-write and suffix-resume
    prefill), speculative decoding (small-q verify, commit and block
    rollback) and chunked prefill (block-aligned chunks under a token
    budget). Ring layouts opt out of the last three, silently, as in the
    reference.

Which families serve on which backend is ``registry.Arch.serve_backends``:
in the port every family serves on ``slot``/``arena``, and the dense,
vlm-dense, ``moe`` and ``encdec`` families also on ``paged``. On
``slot``/``arena`` a ``serve_quant`` arch of those families runs the
reference's int8 arena step (int8 K/V in the compute-dtype cache, the ITA
integer ``decode_attention_int8``, W8A8 projections for the dense
families). A request's ``embeds`` (vlm-dense: the prompt's embeddings;
encdec: the encoder's frame embeddings) reach every prefill whole, as in
the reference. Not ported yet (refused with ``NotImplementedError``): mesh
sharding.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models import registry
from repro_torch.models.cache import (
    BlockAllocator, PagedLayout, blocks_for, bucket_for, cache_insert,
    chain_key, chain_seed, copy_block, pool_leaves, prefix_chain_keys,
    ring_blocks_for, ring_table_row,
)
from repro_torch.serve.config import BACKENDS, EngineConfig
from repro_torch.serve.request import Request


def _row_seed(seed: int, rid: int, step: int) -> int:
    """63-bit generator seed from (engine seed, request id, output index)."""
    digest = hashlib.sha256(f"{seed}/{rid}/{step}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def sample_tokens_per_slot(logits: torch.Tensor, temps, topks, rids, steps,
                           seed: int, *, any_sampling: bool = True
                           ) -> torch.Tensor:
    """[B, V] logits + per-slot sampling vectors → [B] int32 tokens.

    ``temps[i] <= 0`` decodes row ``i`` greedily (``argmax``, first index
    on ties, as in the reference). A sampled row keeps ``topks[i] > 0``
    top logits (ties at the threshold kept), divides by its temperature and
    draws with the Gumbel-max trick from a ``torch.Generator`` seeded by
    ``(seed, rids[i], steps[i])`` — ``steps[i]`` is the request's output
    index, so a request's tokens are a function of (seed, rid, index)
    whatever batch it decodes in. (The draws differ from the reference's
    ``jax.random`` stream; the contract is the same.) The sampling vectors
    are host numpy arrays; ``any_sampling=False`` is the all-greedy path.
    """
    f = logits.float()
    greedy_tok = torch.argmax(f, dim=-1).to(torch.int32)
    if not any_sampling:
        return greedy_tok
    out = greedy_tok.clone()
    vocab = f.shape[-1]
    for i in np.flatnonzero(np.asarray(temps) > 0):
        row = f[i]
        k = int(topks[i])
        k_eff = min(max(k, 1), vocab) if k > 0 else vocab
        thresh = torch.topk(row, k_eff).values[-1]
        masked = torch.where(row >= thresh, row, -torch.inf)
        scaled = masked / max(float(temps[i]), 1e-6)
        gen = torch.Generator(device=row.device)
        gen.manual_seed(_row_seed(seed, int(rids[i]), int(steps[i])))
        u = torch.rand(vocab, generator=gen, device=row.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        out[i] = torch.argmax(scaled + gumbel).to(torch.int32)
    return out


def _build_qparams(arch: registry.Arch, params):
    if arch.cfg.serve_quant and arch.quantize_params is not None and (
            arch.cfg.family in ("dense", "vlm-dense")):
        return arch.quantize_params(params)
    return None


def request_embeds(req: Request, device: torch.device):
    """``req.embeds`` as a batch-1 tensor on ``device`` (None without)."""
    if req.embeds is None:
        return None
    return torch.as_tensor(np.asarray(req.embeds))[None].to(device)


def continuation_tokens(req: Request) -> np.ndarray:
    """Prompt plus already-generated tokens — the re-prefill input after a
    preemption (greedy decode resumes token-identically)."""
    return np.concatenate([np.asarray(req.prompt, np.int32),
                           np.asarray(req.output, np.int32)])


class _BackendBase:
    """State + counters shared by all backends."""

    vectorized = True                 # False: decode/prefill return host ints
    max_admit: Optional[int] = None   # None → EngineConfig.admit_batch
    chunking = False                  # chunked-prefill admission path

    def __init__(self, arch: registry.Arch, params, ec: EngineConfig,
                 device: torch.device):
        self.arch = arch
        self.params = params
        self.ec = ec
        self.device = device
        self.qparams = _build_qparams(arch, params)
        self.decode_dispatches = 0
        self.transfers = 0

    def _qkw(self):
        """``qparams`` for a model step, when the backend built them."""
        return {} if self.qparams is None else {"qparams": self.qparams}

    # -- protocol defaults -------------------------------------------------

    def validate_request(self, req: Request) -> None:
        """Submit-time backend checks (engine already checked max_len)."""

    def begin_iteration(self, active: List[int],
                        slots: Sequence[Optional[Request]],
                        spans=None) -> None:
        """Host bookkeeping before this iteration's decode dispatch."""

    def can_admit(self, req: Request) -> bool:
        return True

    def choose_slot(self, req: Request,
                    avail: Sequence[int]) -> Optional[int]:
        """Pick the slot ``req`` is admitted into (first listed)."""
        return avail[0] if avail else None

    def release(self, slot: int, req: Request) -> None:
        """Recycle ``slot``'s resources (finish, preemption, abort)."""

    def forget(self, req: Request) -> None:
        """Drop per-rid state of a request that never held a slot."""

    def evict_for(self, req: Request, candidates: List[int],
                  slots: Sequence[Optional[Request]]) -> List[int]:
        victim = candidates[0]
        self.release(victim, slots[victim])
        return [victim]


def validate_paged_config(arch: registry.Arch, ec: EngineConfig) -> None:
    """Construction-time checks for the paged backend: the family must
    page (recurrent state has no growing KV cache), and quantized archs
    need int8 block-pool support."""
    cfg = arch.cfg
    if not arch.supports_paged:
        bad = "".join(sorted(set(cfg.pattern) - set("GLB")))
        why = (f"layer kinds {bad!r} keep recurrent state, which has no "
               f"growing KV cache to page" if bad else
               "the family does not implement paged_decode_step")
        raise ValueError(
            f"paged serving: family {cfg.family!r} (layer pattern "
            f"{cfg.pattern!r}) has no paged decode path — {why}; use "
            f"the arena backend for this arch")
    if not arch.supports_paged_prefill:
        raise ValueError(
            f"paged serving: family {cfg.family!r} has a paged decode path "
            f"but no paged prefill")
    if cfg.serve_quant and not arch.supports_paged_int8:
        raise ValueError(
            f"paged serving: arch {cfg.name!r} is quantized (serve_quant) "
            f"but the family does not support int8 block pools")


class ArenaBackend(_BackendBase):
    """Vectorized dense-arena backend.

    One batched float cache from ``arch.init_cache(slots, max_len,
    quantized=False)`` with a per-slot position vector; one batched decode
    over the whole batch per iteration, empty slots included (their rows
    are ignored host-side and overwritten by the next admission); per-slot
    sampling on the device. Admission prefills the continuation as a
    batch-1 cache and splices it into the slot (``cache_insert``, in
    place; the cache may be a nested tree, as the hybrid family's is).

    Length-bucketed admission, as in the reference: where the family takes
    right-padded prompts (``arch.supports_padded_prefill``, the dense
    family) and ``prefill_buckets`` is on, the prompt is zero-padded to
    ``bucket_for(n, min_bucket, max_len)`` and prefilled with ``true_len
    = n``, unless the bucket would pass a sliding-window ring
    (``_bucket_ok``); otherwise the exact prompt. Eager PyTorch has no
    trace to save, but the bucket sets ``chunked_attention``'s query
    chunk, so the port pads exactly where the reference does and its float
    sums match. Under ``serve_quant`` the cache stays in the compute
    dtype, as the reference's does, and holds the requantized integers;
    the decode passes ``qparams`` (W8A8, the dense families) when the
    backend built them.
    """

    name = "arena"

    def __init__(self, arch: registry.Arch, params, ec: EngineConfig,
                 device: torch.device):
        super().__init__(arch, params, ec, device)
        self.cache = arch.init_cache(ec.slots, ec.max_len, quantized=False,
                                     device=device)
        self.last_tok = torch.zeros((ec.slots,), dtype=torch.int32,
                                    device=device)
        self._bucketing = ec.prefill_buckets and arch.supports_padded_prefill

    def _bucket_ok(self, bucket: int) -> bool:
        # a ring (sliding-window) cache drops leading positions once the
        # prefill is longer than the window: only bucket under it
        cfg = self.arch.cfg
        return "L" not in cfg.pattern or bucket <= cfg.local_window

    def decode(self, active, slots, samp, any_sampling):
        logits, self.cache = self.arch.decode_step(
            self.params, self.cache, self.last_tok, **self._qkw())
        tok = sample_tokens_per_slot(logits, *samp, self.ec.seed,
                                     any_sampling=any_sampling)
        # a copy: this iteration's admissions write their first token into
        # last_tok in place, and ``tok`` is still to be fetched
        self.last_tok = tok.clone()
        self.decode_dispatches += 1
        return tok

    def prefill(self, req: Request, slot: int, samp, any_sampling):
        """Prefill ``req``'s continuation into ``slot``; returns the
        on-device sampled first token (fetched later, with the batch)."""
        toks = continuation_tokens(req)
        n = toks.size
        embeds = request_embeds(req, self.device)
        bucket = bucket_for(n, self.ec.min_bucket, self.ec.max_len)
        if self._bucketing and self._bucket_ok(bucket):
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :n] = toks
            logits, single = self.arch.prefill(
                self.params, torch.from_numpy(padded).to(self.device),
                self.ec.max_len, true_len=n, embeds=embeds)
        else:
            logits, single = self.arch.prefill(
                self.params, torch.from_numpy(toks[None]).to(self.device),
                self.ec.max_len, embeds=embeds)
        cache_insert(self.cache, single, slot)
        tok = sample_tokens_per_slot(logits, *samp, self.ec.seed,
                                     any_sampling=any_sampling)  # [1]
        self.last_tok[slot] = tok[0]
        return tok[0]


class SlotBackend(_BackendBase):
    """Sequential per-slot reference backend (the pre-batching baseline).

    Decodes each slot with a batch-1 call and syncs to the host for the
    argmax of every token of every slot — the numerical reference for the
    vectorized backends. Greedy-only; admits at most one request per
    iteration.
    """

    name = "slot"
    vectorized = False
    max_admit = 1

    def __init__(self, arch: registry.Arch, params, ec: EngineConfig,
                 device: torch.device):
        super().__init__(arch, params, ec, device)
        if not ec.greedy:
            raise NotImplementedError(
                "reference engine is greedy-only; use the arena backend")
        self.caches: List[Optional[dict]] = [None] * ec.slots

    def validate_request(self, req: Request) -> None:
        # greedy-only reference: refuse rather than silently decode a
        # sampling request with argmax
        if self.ec.effective_temperature(req.temperature) > 0 \
                or req.top_k > 0:
            raise NotImplementedError(
                f"reference engine is greedy-only and would ignore request "
                f"{req.rid}'s temperature/top_k; use the arena backend")

    def decode(self, active, slots, samp, any_sampling):
        """Batch-1 decode per active slot, host argmax per token — returns
        ``{slot: host token}``."""
        out = {}
        for slot in active:
            last = torch.tensor([slots[slot].output[-1]], dtype=torch.int32,
                                device=self.device)
            logits, self.caches[slot] = self.arch.decode_step(
                self.params, self.caches[slot], last, **self._qkw())
            self.decode_dispatches += 1
            out[slot] = int(torch.argmax(logits[0]))   # host sync (counted)
            self.transfers += 1
        return out

    def prefill(self, req: Request, slot: int, samp, any_sampling):
        toks = torch.from_numpy(continuation_tokens(req)[None]).to(
            self.device)
        logits, self.caches[slot] = self.arch.prefill(
            self.params, toks, self.ec.max_len,
            embeds=request_embeds(req, self.device))
        tok = int(torch.argmax(logits[0]))             # host sync (counted)
        self.transfers += 1
        return tok

    def release(self, slot: int, req: Request) -> None:
        self.caches[slot] = None


class PagedBackend(_BackendBase):
    """Continuous batching over a paged block-pool KV cache.

    KV state lives in a shared pool of fixed-size blocks; each slot holds a
    row of the host-owned block table mapping position ``p`` to pool block
    ``table[slot, p // block_len]``. The host-side ``BlockAllocator`` admits
    against worst-case block reservations, grows slots lazily at block
    boundaries, and recycles blocks on completion, preemption and abort.
    Empty rows decode against the trash block and are ignored host-side.

    **Prefix caching** (``prefix_cache=True``): full blocks are published
    under chained content keys as prefill writes them and as decode
    completes them; an admission maps the longest published prefix of its
    continuation straight into its table (shared, refcounted — never
    rewritten) and prefills only the uncached suffix. A writer about to
    touch a shared block gets a private copy first (copy-on-write).

    **Speculative decoding** (``spec_tokens > 0``): the engine replaces the
    decode pass with ``verify`` — one small-q pass over each slot's last
    committed token plus its drafts — and ``commit``s the accepted count
    per slot, rolling rejected blocks back to the allocator.

    **Chunked prefill** (``prefill_chunk_tokens``): an admission's prefill
    runs as block-aligned chunks, each within the engine's per-iteration
    token budget; every chunk resumes after the blocks already written,
    the same suffix-resume path a prefix-cache hit takes.

    **Ring blocks** (a sliding-window layer whose window is shorter than
    ``max_len``): L layers store K/V in a separate ring arena where each
    slot owns ``ring_blocks`` blocks, reserved at admission from
    ``ring_alloc``; the host rotates the slot's ``ring_table`` row and
    ``ring_start`` as the window slides, and the decode step gets the dict
    ``{"full", "ring", "start"}`` of device tables. A ring layout turns
    prefix caching, chunked prefill and speculation off (a ring cannot
    resume mid-history, and its rotation assumes one position an
    iteration); the engine then runs monolithic prefills and plain decode.
    """

    name = "paged"

    def __init__(self, arch: registry.Arch, params, ec: EngineConfig,
                 device: torch.device):
        super().__init__(arch, params, ec, device)
        validate_paged_config(arch, ec)
        num_blocks = ec.num_blocks
        if num_blocks is None:  # match the dense arena's token budget
            num_blocks = blocks_for(ec.slots * ec.max_len, ec.block_len) + 1
        cfg = arch.cfg
        # ring blocks when sliding-window layers can't hold full history
        self.ring = ("L" in cfg.pattern and cfg.local_window < ec.max_len
                     and cfg.family != "encdec")
        wb = ring_blocks_for(cfg.local_window, ec.block_len) if self.ring \
            else 0
        self.layout = PagedLayout(
            ec.block_len, num_blocks, ec.max_len,
            window=cfg.local_window if self.ring else None,
            ring_num_blocks=(1 + ec.slots * wb) if self.ring else 0)
        # prefix caching on full-history layouts only: a ring layout
        # skipping its prefix prefill would leave the sliding-window pools
        # unwritten for in-window prefix positions
        self.prefix_caching = bool(ec.prefix_cache) and not self.ring
        self.alloc = BlockAllocator(self.layout,
                                    prefix_cache=self.prefix_caching)
        # full-history blocks are consumed by non-L layers only; an all-L
        # pattern reserves none of them
        self._has_full = not self.ring or any(k != "L" for k in cfg.pattern)
        self.table = np.zeros((ec.slots, self.layout.max_blocks), np.int32)
        if self.ring:
            # the ring arena always fits every slot's ring (sized above),
            # but runs through an allocator so leaks and double frees show
            self.ring_alloc = BlockAllocator(PagedLayout(
                ec.block_len, self.layout.ring_num_blocks, ec.max_len))
            self.ring_table = np.zeros((ec.slots, wb), np.int32)
            self.ring_start = np.zeros((ec.slots,), np.int32)
            self._ring_first = [0] * ec.slots   # abs block index of entry 0
            self._ring_ids: List[Optional[np.ndarray]] = [None] * ec.slots
        self._slot_len = [0] * ec.slots   # host mirror of active rows' len
        self._tables_dev = None           # device copy of the tables
        # prefix cache: per-slot chain keys of the full blocks written so
        # far (prompt at prefill, decode blocks as they complete), and a
        # bounded per-rid chain-key memo — can_admit() re-keys every queued
        # request every iteration, and the sha256 chain over a long shared
        # prefix would otherwise be recomputed each time
        self._slot_keys: List[List[bytes]] = [[] for _ in range(ec.slots)]
        self._key_memo: "OrderedDict[int, Tuple[int, List[bytes]]]" = \
            OrderedDict()
        self.prefill_tokens_skipped = 0
        self.prefill_tokens_total = 0
        # chunked prefill: admissions split into block-aligned chunks
        # co-scheduled with decode; rings opt out (a ring arena cannot
        # resume mid-history) and the engine prefills whole prompts
        self.chunking = ec.prefill_chunk_tokens is not None and not self.ring
        # per-slot admission state between prefill_begin and the final
        # prefill_chunk
        self._chunk: Dict[int, dict] = {}
        self.prefill_chunk_dispatches = 0
        # speculation: rings opt out (ring rotation assumes one position an
        # iteration) and the engine runs plain decode
        self.spec_supported = arch.supports_spec_decode and not self.ring
        self.quantized = bool(arch.cfg.serve_quant)
        self.cache = arch.init_paged_cache(ec.slots, self.layout,
                                           device=device)
        self.last_tok = torch.zeros((ec.slots,), dtype=torch.int32,
                                    device=device)
        self._bucketing = ec.prefill_buckets and arch.supports_padded_prefill

    # -- capacity bookkeeping ----------------------------------------------

    def _pre_len(self, req: Request) -> int:
        """Prefill cache length for ``req``'s continuation (block multiple;
        pow2 bucket when bucketing), capped at the request's worst-case
        decode extent so the block reservation is invariant across
        preemptions."""
        blk = self.ec.block_len
        n = len(req.prompt) + len(req.output)
        if self._bucketing:
            bucket = bucket_for(n, max(self.ec.min_bucket, blk),
                                self.ec.max_len)
        else:
            bucket = n
        cap = blocks_for(len(req.prompt) + req.max_new_tokens - 1, blk) * blk
        return max(blocks_for(n, blk) * blk,
                   blocks_for(min(bucket, cap), blk) * blk)

    def _max_blocks_needed(self, req: Request) -> int:
        """Worst-case full-history block reservation: the prefill extent
        now, or the final decode position, whichever is larger. An all-L
        pattern consumes no full-history blocks (its ring reservation is a
        fixed ``ring_blocks`` a slot, accounted separately)."""
        if not self._has_full:
            return 0
        final_pos = len(req.prompt) + req.max_new_tokens - 1
        return blocks_for(max(self._pre_len(req), final_pos),
                          self.ec.block_len)

    # -- content-addressed prefix keys -------------------------------------

    @staticmethod
    def _chain_salt(req: Request) -> bytes:
        """Per-request hash-chain salt: requests whose K/V depends on more
        than the token prefix (conditioning inputs) must never share
        blocks across different conditioning."""
        if req.embeds is None:
            return b""
        arr = np.ascontiguousarray(np.asarray(req.embeds, np.float32))
        return hashlib.sha256(arr.tobytes()).digest()

    _KEY_MEMO_CAP = 256

    def _chain_keys(self, req: Request) -> List[bytes]:
        """Chained content keys for every full block of ``req``'s
        continuation (uncapped — slice with ``_hit_limit`` for lookup),
        memoised per rid on continuation length."""
        n = len(req.prompt) + len(req.output)
        hit = self._key_memo.get(req.rid)
        if hit is not None and hit[0] == n:
            self._key_memo.move_to_end(req.rid)
            return hit[1]
        keys = prefix_chain_keys(continuation_tokens(req), self.ec.block_len,
                                 salt=self._chain_salt(req))
        self._key_memo[req.rid] = (n, keys)
        self._key_memo.move_to_end(req.rid)
        while len(self._key_memo) > self._KEY_MEMO_CAP:
            self._key_memo.popitem(last=False)
        return keys

    def _hit_limit(self, req: Request) -> int:
        """Max cache-hit blocks: the suffix must keep ≥ 1 real token (the
        last-position logits are computed, never looked up)."""
        n = len(req.prompt) + len(req.output)
        return max(0, (n - 1) // self.ec.block_len)

    def _admit_keys(self, req: Request) -> Sequence[bytes]:
        if not self.prefix_caching:
            return ()
        return self._chain_keys(req)[:self._hit_limit(req)]

    def validate_request(self, req: Request) -> None:
        need = self._max_blocks_needed(req)
        usable = self.layout.usable_blocks
        if need > usable:
            raise ValueError(
                f"request {req.rid} needs {need} blocks; pool has {usable}")

    def can_admit(self, req: Request) -> bool:
        if not self.alloc.can_admit(self._max_blocks_needed(req),
                                    self._admit_keys(req)):
            return False
        return not self.ring or self.ring_alloc.can_admit(
            self.layout.ring_blocks)

    def release(self, slot: int, req: Request) -> None:
        """Recycle a slot's blocks (full and ring) and point its table rows
        at trash. Also the ``abort()`` path. With prefix caching the
        release decrefs: shared blocks survive under their other
        references, and published sole-owned blocks move to the cached LRU
        (reusable K/V)."""
        self.alloc.release(req.rid)
        self.table[slot, :] = 0
        if self.ring:
            self.ring_alloc.release(req.rid)
            self.ring_table[slot, :] = 0
            self.ring_start[slot] = 0
            self._ring_first[slot] = 0
            self._ring_ids[slot] = None
        self._touch_tables()
        self._slot_len[slot] = 0
        self._slot_keys[slot] = []
        self._key_memo.pop(req.rid, None)
        self._chunk.pop(slot, None)
        req.prefill_pos = 0

    def forget(self, req: Request) -> None:
        """Drop the chain-key memo of a request that never reached
        ``release`` (queued abort, finish before re-admission): a reused
        rid must not inherit its predecessor's keys."""
        self._key_memo.pop(req.rid, None)

    def evict_for(self, req, candidates, slots):
        """Evict victims (in the scheduler's preference order) until the
        request's reservation fits; nothing when even all candidates could
        not make room."""
        need = self._max_blocks_needed(req)
        if need > self.alloc.available_blocks + sum(
                self.alloc.reservation(slots[i].rid) for i in candidates):
            return []
        single = next(
            (i for i in candidates if self.alloc.can_admit_after_release(
                need, slots[i].rid)), None)
        order = [single] if single is not None else candidates
        evicted: List[int] = []
        for victim_slot in order:
            if evicted and self.can_admit(req):
                break
            self.release(victim_slot, slots[victim_slot])
            evicted.append(victim_slot)
        return evicted

    def _touch_tables(self) -> None:
        """Invalidate the cached device copy of the tables (after any host
        write to ``table``, ``ring_table`` or ``ring_start``)."""
        self._tables_dev = None

    def _tables(self):
        """Device copy of the host-owned block table (on a ring layout the
        dict ``{"full", "ring", "start"}``), re-uploaded only after a host
        write (growth touches one slot every block_len tokens, a ring
        rotation one slot every block_len tokens). Each upload is a
        synchronous copy, never a view of the host arrays: the host
        rewrites them right after a dispatch."""
        if self._tables_dev is None:
            def upload(a):
                return torch.tensor(a, device=self.device)

            self._tables_dev = upload(self.table) if not self.ring else {
                "full": upload(self.table), "ring": upload(self.ring_table),
                "start": upload(self.ring_start)}
        return self._tables_dev

    @property
    def pool_bytes(self) -> int:
        """Resident bytes of the KV block pools (the full-history and ring
        arenas, scale vectors included; per-slot leaves such as the encdec
        cross K/V excluded) — what the ring layout bounds by the window
        and the int8 layout halves."""
        return int(sum(leaf.numel() * leaf.element_size()
                       for leaf in pool_leaves(self.cache)))

    # -- iteration hooks ---------------------------------------------------

    def begin_iteration(self, active, slots, spans=None):
        """Host bookkeeping before the decode (or verify) pass. ``spans``
        (speculation): slot ``i`` writes positions ``_slot_len[i] ..
        _slot_len[i] + spans[i] - 1`` this iteration; ``None`` is the
        one-position decode. Grows any slot whose span crosses a block
        boundary (from its admission-time reservation — can never fail),
        publishes completed blocks, and copies a shared block before this
        iteration writes into it."""
        blk = self.ec.block_len
        for i in active:
            req = slots[i]
            span = 1 if spans is None else spans[i]
            last_pos = self._slot_len[i] + span - 1
            if self._has_full:
                needed = last_pos // blk + 1
                owned = self.alloc.owned(req.rid)
                while len(owned) < needed:
                    b = self.alloc.grow(req.rid)
                    self.table[i, len(owned)] = b
                    self._touch_tables()
                    owned.append(b)
            if self.prefix_caching:
                self._publish_and_guard(i, req, last_pos)
            if self.ring:
                # rotate the ring table when the next write enters a block
                # past the ring: the evicted oldest block lies wholly below
                # the window by construction
                wb = self.layout.ring_blocks
                next_bi = self._slot_len[i] // blk
                if next_bi > self._ring_first[i] + wb - 1:
                    first = next_bi - (wb - 1)
                    self._ring_first[i] = first
                    self.ring_table[i, :] = ring_table_row(
                        self._ring_ids[i], first)
                    self.ring_start[i] = first * blk
                    self._touch_tables()

    def _publish_and_guard(self, i: int, req: Request, last_pos: int) -> None:
        """Prefix caching, before slot ``i`` writes up to ``last_pos``:
        publish its decode blocks as they complete (position p holds the
        K/V of seq[p], and the engine appends fetched tokens before the
        next begin_iteration, so seq always covers _slot_len), then copy
        any shared block in the write span first (copy-on-write)."""
        blk = self.ec.block_len
        n_full = self._slot_len[i] // blk
        keys = self._slot_keys[i]
        if len(keys) < n_full:
            seq = continuation_tokens(req)
            salt = self._chain_salt(req)
            while len(keys) < n_full:
                idx = len(keys)
                prev = keys[idx - 1] if idx else chain_seed(blk, salt)
                key = chain_key(prev, seq[idx * blk:(idx + 1) * blk])
                keys.append(key)
                self.alloc.register(req.rid, idx, key)
        for tail in range(self._slot_len[i] // blk, last_pos // blk + 1):
            moved = self.alloc.ensure_writable(req.rid, tail)
            if moved is not None:
                old, new = moved
                copy_block(self.cache, old, new)
                self.table[i, tail] = new
                self._touch_tables()

    def decode(self, active, slots, samp, any_sampling):
        logits, self.cache = self.arch.paged_decode_step(
            self.params, self.cache, self.last_tok, self._tables(),
            qparams=self.qparams)
        tok = sample_tokens_per_slot(logits, *samp, self.ec.seed,
                                     any_sampling=any_sampling)
        # a copy: this iteration's admissions write their first token into
        # last_tok in place, and ``tok`` is still to be fetched
        self.last_tok = tok.clone()
        self.decode_dispatches += 1
        for i in active:
            self._slot_len[i] += 1
        return tok

    def verify(self, active, slots, tokens, samp, any_sampling):
        """One speculative verify pass — the decode replacement under
        ``spec_tokens > 0``. ``tokens`` [slots, Q] carries each row's last
        committed token in column 0 and its drafts after; ``samp`` are the
        flat [slots · Q] per-position sampling vectors. Returns the chosen
        tokens [slots, Q] on the device. ``_slot_len`` is not advanced
        here: the engine's acceptance drives ``commit`` per slot."""
        packed = np.concatenate(
            [np.asarray(self._slot_len, np.int32)[:, None],
             np.asarray(tokens, np.int32)], axis=1)
        dev = torch.from_numpy(packed).to(self.device)  # one upload
        # the position vector is host-owned under speculation: inject this
        # iteration's committed lengths; the verify step never advances it
        self.cache["len"] = dev[:, 0]
        logits, self.cache = self.arch.paged_verify_step(
            self.params, self.cache, dev[:, 1:], self._tables(),
            qparams=self.qparams)
        b, qlen, vocab = logits.shape
        # flat per-position sampling: row i·Q + j carries slot i's
        # coordinates with the absolute output index of position j
        tok = sample_tokens_per_slot(logits.reshape(b * qlen, vocab), *samp,
                                     self.ec.seed, any_sampling=any_sampling)
        self.decode_dispatches += 1
        return tok.reshape(b, qlen)

    def commit(self, slot: int, req: Request, accepted: int) -> None:
        """Commit ``accepted`` tokens from the last verify pass and roll the
        rejected tail back at block granularity: blocks grown past the new
        frontier return to the allocator (published keys retracted) and
        their table entries re-point at trash. K/V written past the accept
        point inside kept blocks stays as garbage that is never attended
        and is overwritten before the frontier reaches it."""
        self._slot_len[slot] += accepted
        keep = (self._slot_len[slot] - 1) // self.ec.block_len + 1
        dropped = self.alloc.shrink(req.rid, keep)
        if dropped:
            self.table[slot, keep:keep + len(dropped)] = 0
            self._touch_tables()

    def prefill(self, req: Request, slot: int, samp, any_sampling):
        """Admission: ``prefill_begin`` plus one unbounded
        ``prefill_chunk``; returns the on-device sampled first token."""
        self.prefill_begin(req, slot)
        _, tok = self.prefill_chunk(req, slot, None, samp, any_sampling)
        return tok

    def prefill_begin(self, req: Request, slot: int) -> None:
        """Admission bookkeeping: reserve the request's worst-case block
        set, map any cached prefix hit (shared blocks, increfed), and set
        the prefill cursor past the mapped prefix. No device work."""
        blk = self.ec.block_len
        toks = continuation_tokens(req)
        n = toks.size
        pre_len = self._pre_len(req)
        j = 0
        keys_full: List[bytes] = []
        if self.prefix_caching:
            keys_full = self._chain_keys(req)
            j = len(self.alloc.lookup(keys_full[:self._hit_limit(req)]))
        block_ids = np.asarray(
            self.alloc.admit(req.rid, pre_len // blk if self._has_full else 0,
                             self._max_blocks_needed(req),
                             keys=keys_full[:j]), np.int32)
        # the table row stays at trash until the prefill completes
        self.table[slot, :] = 0
        self._touch_tables()
        ring_ids = None
        if self.ring:
            wb = self.layout.ring_blocks
            try:
                ring_ids = np.asarray(
                    self.ring_alloc.admit(req.rid, wb, wb), np.int32)
            except Exception:
                # admission is all or nothing: a failed ring reservation
                # hands the full-history reservation back
                self.alloc.release(req.rid)
                raise
            first = max(0, (n - 1) // blk - (wb - 1))
            self._ring_first[slot] = first
            self._ring_ids[slot] = ring_ids
            self.ring_table[slot, :] = ring_table_row(ring_ids, first)
            self.ring_start[slot] = first * blk
        self._key_memo.pop(req.rid, None)
        req.prefill_pos = j * blk
        self.prefill_tokens_total += j * blk
        self.prefill_tokens_skipped += j * blk
        self._chunk[slot] = dict(toks=toks, n=n, pre_len=pre_len,
                                 block_ids=block_ids, keys=keys_full,
                                 ring_ids=ring_ids)

    def prefill_chunk(self, req: Request, slot: int, budget, samp,
                      any_sampling):
        """One prefill-chunk dispatch for the admission started by
        ``prefill_begin``. ``budget`` bounds the chunk's token count
        (``None``: the whole remaining suffix, the monolithic path).
        Returns ``(tokens_consumed, first token)``; the token is ``None``
        mid-prefill (the prompt itself is the next input), and
        ``(0, None)`` comes back without a dispatch when the budget is
        under one block (the engine counts a stall).

        Mid-chunks are whole blocks of exact tokens, so every chunk writes
        whole pool blocks with ``start`` at the cursor and attends the
        blocks already written as its prefix — the suffix-resume path a
        prefix-cache hit takes, token-identical to the monolithic pass on
        float pools. The table row is filled on the final chunk only: a
        mid-chunk slot's (ignored) decode row writes into the trash block
        through its zeroed row."""
        st = self._chunk[slot]
        blk = self.ec.block_len
        c = req.prefill_pos
        n = st["n"]
        rem = n - c
        final = budget is None or budget >= rem
        if final:
            length = rem
        else:
            length = (budget // blk) * blk
            if length <= 0:
                return 0, None
        toks = st["toks"]
        block_ids = st["block_ids"]
        pb = c // blk                      # resume depth in blocks
        if final and self._bucketing:
            if budget is None:
                # the full admission bucket, padded
                width = st["pre_len"] - c
            else:
                # a budgeted final chunk pads to its own bucket only,
                # never past the reservation
                bucket = bucket_for(length, max(self.ec.min_bucket, blk),
                                    max(budget, blk))
                width = min(blocks_for(bucket, blk) * blk, st["pre_len"] - c)
            tokens = np.zeros((1, width), np.int32)
            tokens[0, :length] = toks[c:]
            true_len = n
        else:
            width = length
            tokens = toks[None, c:c + length]
            true_len = None
        suffix_ids = block_ids[pb:blocks_for(c + width, blk)]
        prefix_ids = (torch.from_numpy(block_ids[:pb]).to(self.device)
                      if pb else None)
        ring_ids = (None if st["ring_ids"] is None
                    else torch.from_numpy(st["ring_ids"]).to(self.device))
        logits, self.cache = self.arch.paged_prefill(
            self.params, torch.from_numpy(tokens).to(self.device), self.cache,
            slot, torch.from_numpy(suffix_ids).to(self.device),
            ring_ids=ring_ids, true_len=true_len,
            embeds=request_embeds(req, self.device), prefix_ids=prefix_ids,
            start=c)
        # only budgeted (chunking) dispatches count: 0 on monolithic engines
        if self.chunking:
            self.prefill_chunk_dispatches += 1
        self.prefill_tokens_total += length
        end = c + length
        req.prefill_pos = end
        if self.prefix_caching:
            # publish every freshly written full block as its chunk
            # completes (first-wins on a key collision: the duplicate stays
            # private), so a concurrent admission can hit a request that is
            # still mid-flight
            for idx in range(pb, end // blk):
                self.alloc.register(req.rid, idx, st["keys"][idx])
        if not final:
            return length, None
        tok = sample_tokens_per_slot(logits, *samp, self.ec.seed,
                                     any_sampling=any_sampling)  # [1]
        self.last_tok[slot] = tok[0]
        if self.prefix_caching:
            self._slot_keys[slot] = list(st["keys"][:n // blk])
        # the slot becomes a decode row: fill its table
        self.table[slot, :block_ids.size] = block_ids
        self._touch_tables()
        self._slot_len[slot] = n
        del self._chunk[slot]
        return length, tok[0]


_BACKENDS = {
    "slot": SlotBackend,
    "arena": ArenaBackend,
    "paged": PagedBackend,
}

# config.BACKENDS is the single source of truth for valid names; this
# dispatch table must cover it exactly — drift fails at import, not at
# serve time
if set(_BACKENDS) != set(BACKENDS):
    raise ImportError(
        f"backend registry drift: config.BACKENDS={BACKENDS} vs "
        f"dispatch table {tuple(_BACKENDS)}")


def make_backend(name: str, arch: registry.Arch, params, ec: EngineConfig,
                 device: torch.device) -> _BackendBase:
    try:
        cls = _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown serve backend {name!r} "
            f"(supported: {', '.join(BACKENDS)})") from None
    cfg = arch.cfg
    if cls is not PagedBackend and name not in arch.serve_backends:
        raise NotImplementedError(
            f"backend={name!r}: family {cfg.family!r} has no ported "
            f"dense-arena entry points (prefill/decode_step/init_cache) in "
            f"repro_torch yet; it serves on "
            f"{', '.join(arch.serve_backends) or 'no backend'}")
    return cls(arch, params, ec, device)
