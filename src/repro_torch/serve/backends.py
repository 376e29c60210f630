"""The paged execution backend behind the ``CacheBackend`` protocol.

Port of the paged part of ``repro.serve.backends``: continuous batching
over a shared pool of fixed-size KV blocks (``models.cache.PagedLayout``)
with host-owned block tables, paged prefill straight into pool blocks, and
int8 block storage (+ per-block scales) for quantized archs. One decode
pass over all slots per iteration, admission prefills, and the engine's
single device→host token fetch per iteration.

Not ported yet (refused at construction with ``NotImplementedError``):
the ``slot``/``arena`` backends, ring blocks for sliding-window layers,
prefix caching, chunked prefill, speculative decoding and mesh sharding.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models import registry
from repro_torch.models.cache import (
    BlockAllocator, PagedLayout, blocks_for, bucket_for,
)
from repro_torch.serve.config import EngineConfig
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


def continuation_tokens(req: Request) -> np.ndarray:
    """Prompt plus already-generated tokens — the re-prefill input after a
    preemption (greedy decode resumes token-identically)."""
    return np.concatenate([np.asarray(req.prompt, np.int32),
                           np.asarray(req.output, np.int32)])


class _BackendBase:
    """State + counters shared by all backends."""

    max_admit: Optional[int] = None   # None → EngineConfig.admit_batch

    def __init__(self, arch: registry.Arch, params, ec: EngineConfig,
                 device: torch.device):
        self.arch = arch
        self.params = params
        self.ec = ec
        self.device = device
        self.qparams = _build_qparams(arch, params)
        self.decode_dispatches = 0
        self.transfers = 0

    # -- protocol defaults -------------------------------------------------

    def validate_request(self, req: Request) -> None:
        """Submit-time backend checks (engine already checked max_len)."""

    def begin_iteration(self, active: List[int],
                        slots: Sequence[Optional[Request]]) -> None:
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
    page, quantized archs need int8 block-pool support, and layouts the
    port has not implemented are refused by name."""
    cfg = arch.cfg
    if not (arch.supports_paged and arch.supports_paged_prefill):
        raise ValueError(
            f"paged serving: family {cfg.family!r} has no paged decode/"
            f"prefill path")
    if cfg.serve_quant and not arch.supports_paged_int8:
        raise ValueError(
            f"paged serving: arch {cfg.name!r} is quantized (serve_quant) "
            f"but the family does not support int8 block pools")
    if "L" in cfg.pattern and cfg.local_window < ec.max_len:
        raise NotImplementedError(
            f"ring layout: arch {cfg.name!r} has sliding-window layers "
            f"(local_window={cfg.local_window} < max_len={ec.max_len}), "
            f"whose ring-block pools are not ported yet")


class PagedBackend(_BackendBase):
    """Continuous batching over a paged block-pool KV cache.

    KV state lives in a shared pool of fixed-size blocks; each slot holds a
    row of the host-owned block table mapping position ``p`` to pool block
    ``table[slot, p // block_len]``. The host-side ``BlockAllocator`` admits
    against worst-case block reservations, grows slots lazily at block
    boundaries, and recycles blocks on completion, preemption and abort.
    Empty rows decode against the trash block and are ignored host-side.
    """

    name = "paged"

    def __init__(self, arch: registry.Arch, params, ec: EngineConfig,
                 device: torch.device):
        super().__init__(arch, params, ec, device)
        validate_paged_config(arch, ec)
        num_blocks = ec.num_blocks
        if num_blocks is None:  # match the dense arena's token budget
            num_blocks = blocks_for(ec.slots * ec.max_len, ec.block_len) + 1
        self.layout = PagedLayout(ec.block_len, num_blocks, ec.max_len)
        self.alloc = BlockAllocator(self.layout)
        self.table = np.zeros((ec.slots, self.layout.max_blocks), np.int32)
        self._slot_len = [0] * ec.slots   # host mirror of active rows' len
        self._tables_dev: Optional[torch.Tensor] = None
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
        """Worst-case block reservation: the prefill extent now, or the
        final decode position, whichever is larger."""
        final_pos = len(req.prompt) + req.max_new_tokens - 1
        return blocks_for(max(self._pre_len(req), final_pos),
                          self.ec.block_len)

    def validate_request(self, req: Request) -> None:
        need = self._max_blocks_needed(req)
        usable = self.layout.usable_blocks
        if need > usable:
            raise ValueError(
                f"request {req.rid} needs {need} blocks; pool has {usable}")

    def can_admit(self, req: Request) -> bool:
        return self.alloc.can_admit(self._max_blocks_needed(req))

    def release(self, slot: int, req: Request) -> None:
        """Recycle a slot's blocks and point its table row at trash. Also
        the ``abort()`` path."""
        self.alloc.release(req.rid)
        self.table[slot, :] = 0
        self._touch_tables()
        self._slot_len[slot] = 0
        req.prefill_pos = 0

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
        """Invalidate the cached device copy of the block table."""
        self._tables_dev = None

    def _tables(self) -> torch.Tensor:
        """Device copy of the host-owned block table, re-uploaded only
        after a host write (growth touches one slot every block_len
        tokens)."""
        if self._tables_dev is None:
            self._tables_dev = torch.from_numpy(self.table).to(self.device)
        return self._tables_dev

    # -- iteration hooks ---------------------------------------------------

    def begin_iteration(self, active, slots):
        """Grow any slot whose next write position crosses into a new block
        (drawn from its admission-time reservation — can never fail)."""
        blk = self.ec.block_len
        for i in active:
            req = slots[i]
            needed = self._slot_len[i] // blk + 1
            owned = self.alloc.owned(req.rid)
            while len(owned) < needed:
                b = self.alloc.grow(req.rid)
                self.table[i, len(owned)] = b
                self._touch_tables()
                owned.append(b)

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

    def prefill(self, req: Request, slot: int, samp, any_sampling):
        """Reserve blocks, run one paged prefill (K/V written straight into
        pool blocks), fill the slot's table row; returns the on-device
        sampled first token."""
        blk = self.ec.block_len
        toks = continuation_tokens(req)
        n = toks.size
        pre_len = self._pre_len(req)
        block_ids = np.asarray(
            self.alloc.admit(req.rid, pre_len // blk,
                             self._max_blocks_needed(req)), np.int32)
        self.table[slot, :] = 0
        self._touch_tables()
        if self._bucketing:
            width = pre_len
            padded = np.zeros((1, width), np.int32)
            padded[0, :n] = toks
            tokens, true_len = padded, n
        else:
            width = n
            tokens, true_len = toks[None, :], None
        suffix_ids = block_ids[:blocks_for(width, blk)]
        logits, self.cache = self.arch.paged_prefill(
            self.params, torch.from_numpy(tokens).to(self.device), self.cache,
            slot, torch.from_numpy(suffix_ids).to(self.device),
            true_len=true_len)
        tok = sample_tokens_per_slot(logits, *samp, self.ec.seed,
                                     any_sampling=any_sampling)  # [1]
        self.last_tok[slot] = tok[0]
        req.prefill_pos = n
        self.table[slot, :block_ids.size] = block_ids
        self._touch_tables()
        self._slot_len[slot] = n
        return tok[0]


def make_backend(name: str, arch: registry.Arch, params, ec: EngineConfig,
                 device: torch.device) -> _BackendBase:
    if name != "paged":
        raise NotImplementedError(
            f"backend={name!r}: only the 'paged' backend is ported to "
            f"repro_torch yet")
    return PagedBackend(arch, params, ec, device)
