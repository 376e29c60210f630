"""Paged KV block pool: layout, host-side allocator and device writes.

Port of the paged half of ``repro.models.cache``. The allocator and the
content keys are numpy/hashlib host code and are carried over verbatim; the
device helpers write into the pool **in place** (the JAX functions return
updated arrays; the port mutates the pool tensors it is given, which saves
a pool copy per write).
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.quant import recip32


def bucket_for(n: int, min_bucket: int = 8, cap: int | None = None) -> int:
    """Smallest power-of-two bucket ≥ n (≥ min_bucket, clamped to cap)."""
    b = max(min_bucket, 1 << max(0, n - 1).bit_length())
    if cap is not None:
        b = min(b, cap)
    return max(b, n)


# Pool block 0 is a write-off "trash" block: decode rows whose slot is
# empty still execute (constant shapes beat masked dispatch) and their
# cache writes land here. The allocator never hands out block 0.
TRASH_BLOCK = 0


def quantize_kv(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Symmetric int8 KV quantization used by every serving write path.

    Round-half-to-even (``torch.round``, like ``jnp.round``) of
    ``x / scale``; the division is the f32 reciprocal multiply the traced
    reference performs (see ``core.quant``).
    """
    q = torch.round(x.float() * recip32(scale))
    return torch.clamp(q, -127, 127).to(torch.int8)


def dequantize_kv(q: torch.Tensor, scale) -> torch.Tensor:
    """int8 K/V → f32; ``scale`` broadcasts like in ``quantize_kv``."""
    return q.float() * scale


def blocks_for(n_tokens: int, block_len: int) -> int:
    """Blocks needed to hold ``n_tokens`` positions."""
    return max(1, -(-n_tokens // block_len))


def ring_blocks_for(window: int, block_len: int) -> int:
    """Ring-table width for a sliding-window layer: enough blocks to hold
    the window plus one write-ahead block."""
    return blocks_for(window, block_len) + 1


@dataclasses.dataclass
class PagedLayout:
    """Static shape plan for a paged KV pool.

    ``num_blocks`` counts pool rows *including* the trash block, so usable
    capacity is ``(num_blocks - 1) * block_len`` tokens. ``max_blocks`` is
    the block-table width — the per-slot worst case ``ceil(max_len /
    block_len)``. ``window``/``ring_num_blocks`` describe the reference's
    ring-block layout for sliding-window layers, which this port's serving
    path does not implement yet (the backend refuses it).
    """

    block_len: int
    num_blocks: int
    max_len: int
    window: Optional[int] = None       # L layers go ring-block when set
    ring_num_blocks: int = 0           # L-layer pool rows incl. trash

    def __post_init__(self):
        if self.block_len & (self.block_len - 1):
            raise ValueError(f"block_len {self.block_len} not a power of two")
        if self.num_blocks < 2:
            raise ValueError("need at least one usable block beside trash")
        if self.window is not None:
            if self.window < 1:
                raise ValueError(f"window {self.window} must be >= 1")
            if self.ring_num_blocks < self.ring_blocks + 1:
                raise ValueError(
                    f"ring pool ({self.ring_num_blocks} rows) smaller than "
                    f"one ring ({self.ring_blocks} blocks) + trash")

    @property
    def max_blocks(self) -> int:
        return blocks_for(self.max_len, self.block_len)

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1

    @property
    def usable_tokens(self) -> int:
        return self.usable_blocks * self.block_len

    @property
    def ring_blocks(self) -> int:
        """Per-slot ring-table width (0 when ring blocks are disabled)."""
        if self.window is None:
            return 0
        return ring_blocks_for(self.window, self.block_len)


# ---------------------------------------------------------------------------
# Content-addressed prefix keys: each *full* block of a token sequence gets
# a chained digest key(b) = sha256(key(b-1) ++ tokens[b·blk : (b+1)·blk]),
# so a key identifies the block's content AND its entire token prefix.
# ---------------------------------------------------------------------------


def chain_seed(block_len: int, salt: bytes = b"") -> bytes:
    """Root digest of the per-block-size hash chain (block size is part of
    the chain identity: the same tokens split differently share nothing).
    ``salt`` folds per-request conditioning into the chain — the encdec
    family salts with the encoder input digest, since decoder K/V depends
    on the cross-attended encoder states, not just the token prefix."""
    return hashlib.sha256(
        f"repro-prefix/{block_len}/".encode() + salt).digest()


def chain_key(prev: bytes, block_tokens) -> bytes:
    """Extend a chain digest by one full block of token ids."""
    return hashlib.sha256(
        prev + np.asarray(block_tokens, np.int32).tobytes()).digest()


def prefix_chain_keys(tokens, block_len: int, limit: Optional[int] = None,
                      salt: bytes = b"") -> List[bytes]:
    """Chained content keys for every *full* block of ``tokens`` (partial
    tail blocks are mutable and never shareable). ``limit`` caps the number
    of keys — admission caps at ``(n-1)//block_len`` so the prefill suffix
    always keeps at least one real token (the last-position logits must be
    computed, not looked up)."""
    toks = np.asarray(tokens, np.int32)
    n_full = toks.size // block_len
    if limit is not None:
        n_full = min(n_full, limit)
    keys: List[bytes] = []
    d = chain_seed(block_len, salt)
    for b in range(n_full):
        d = chain_key(d, toks[b * block_len:(b + 1) * block_len])
        keys.append(d)
    return keys


class BlockAllocator:
    """Host-side refcounted block allocator with per-request worst-case
    reservation and (optionally) a content-addressed prefix cache.

    Admission reserves a request's *maximum* block extent up front
    (``blocks_for(prompt + max_new_tokens)``), then draws physical blocks
    lazily (``grow``) as the sequence crosses block boundaries. Because the
    reclaimable pool always covers every outstanding reservation, a growing
    request can never hit exhaustion mid-decode — exhaustion surfaces only
    at admission time, where the engine defers (or preempts) instead.

    Every allocated block carries a refcount. With ``prefix_cache=False``
    (the default) refcounts are always 1 and the allocator behaves exactly
    like the legacy free-list version. With ``prefix_cache=True``:

      * ``register`` publishes a full, immutable block under its chained
        content key (see ``prefix_chain_keys``); ``lookup`` finds the
        longest cached prefix of a key chain.
      * ``admit`` takes the chain keys and maps hits straight into the new
        request's block list (incref — shared physical blocks, one copy).
      * ``release`` decrefs; a block whose refcount reaches 0 moves to an
        LRU of *cached* blocks (still holding reusable K/V) if it is
        published, else back to the free list.
      * Cached blocks count as reclaimable capacity: when the free list
        runs dry, the LRU-oldest cached block is evicted (its key
        retracted) and reused.
      * ``ensure_writable`` is the copy-on-write guard: writing into a
        shared block first detaches a private copy (the caller copies the
        device-side pool contents); writing into a sole-owned published
        block retracts its key and writes in place.

    Pool partition invariant (every step): ``{live (ref>0)} ⊎ {cached
    (ref=0, published, LRU)} ⊎ {free}`` covers exactly the non-trash pool.

    Invariants enforced (and unit-tested): no double-allocation, no
    double-free/decref, no block freed while referenced, reservations
    never exceeded, reserved blocks never oversubscribed.
    """

    def __init__(self, layout: PagedLayout, *, prefix_cache: bool = False):
        self.layout = layout
        self.prefix_cache = bool(prefix_cache)
        self._free: List[int] = list(
            range(layout.num_blocks - 1, TRASH_BLOCK, -1))  # pop() → low ids
        self._owned: Dict[int, List[int]] = {}    # rid → allocated block ids
        self._reserved: Dict[int, int] = {}       # rid → max blocks reserved
        self._ref: Dict[int, int] = {}            # block → refcount (> 0)
        self._hash_of: Dict[int, bytes] = {}      # published block → key
        self._block_of: Dict[bytes, int] = {}     # key → published block
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # ref-0 cached
        # observability (LLMEngine.metrics / bench)
        self.hit_blocks = 0
        self.miss_blocks = 0
        self.evictions = 0
        self.cow_copies = 0

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def cached_blocks(self) -> int:
        """Unreferenced blocks still holding published (reusable) K/V."""
        return len(self._lru)

    @property
    def live_blocks(self) -> int:
        """Blocks referenced by at least one admitted request."""
        return len(self._ref)

    @property
    def reclaimable_blocks(self) -> int:
        """Free + cached: what a fresh draw may consume."""
        return len(self._free) + len(self._lru)

    @property
    def reserved_unallocated(self) -> int:
        return sum(self._reserved[r] - len(self._owned[r])
                   for r in self._reserved)

    @property
    def available_blocks(self) -> int:
        """Blocks admittable *without* touching outstanding reservations
        (cached-but-unreferenced blocks count — they are evictable)."""
        return self.reclaimable_blocks - self.reserved_unallocated

    def ref_of(self, block: int) -> int:
        return self._ref.get(block, 0)

    def is_cached(self, block: int) -> bool:
        return block in self._lru

    # -- content-addressed lookup ------------------------------------------

    def lookup(self, keys: Sequence[bytes]) -> List[int]:
        """Longest-prefix cache hit: published block ids for the leading
        run of ``keys`` present in the index (no state change)."""
        out: List[int] = []
        for k in keys:
            b = self._block_of.get(k)
            if b is None:
                break
            out.append(b)
        return out

    def _live_hits(self, keys: Sequence[bytes]) -> int:
        """Hits that cost no reclaimable capacity (still-referenced blocks;
        LRU hits consume a reclaimable block just like a fresh draw)."""
        return sum(1 for b in self.lookup(keys) if b in self._ref)

    # -- admission ---------------------------------------------------------

    def can_admit(self, max_blocks: int, keys: Sequence[bytes] = ()) -> bool:
        return max_blocks - self._live_hits(keys) <= self.available_blocks

    def can_admit_after_release(self, max_blocks: int, rid: int) -> bool:
        """Would ``max_blocks`` fit if ``rid`` (a preemption victim) were
        released first? Deliberately ignores prefix hits: a hit on the
        victim's own sole-owned block would be double-counted (once as a
        live-hit discount, once in the release gain), so the check stays
        pessimistic — ``admit`` itself still gets the hit discount."""
        return max_blocks <= self.available_blocks + self.reservation(rid)

    def reservation(self, rid: int) -> int:
        """What releasing ``rid`` returns to the available pool: its
        unallocated reservation plus its sole-owned blocks (shared blocks
        survive the release under their other references)."""
        owned = self._owned.get(rid)
        if owned is None:
            return 0
        sole = sum(1 for b in owned if self._ref[b] == 1)
        return self._reserved[rid] - len(owned) + sole

    def admit(self, rid: int, now_blocks: int, max_blocks: int,
              keys: Sequence[bytes] = ()) -> List[int]:
        """Reserve ``max_blocks`` for ``rid`` and allocate the first
        ``now_blocks`` of them; the leading cached run of ``keys`` maps to
        shared (incref'd) blocks, the rest are drawn fresh. Returns the
        block ids (hits first, in chain order)."""
        if rid in self._reserved:
            raise ValueError(f"request {rid} already admitted")
        if now_blocks > max_blocks:
            raise ValueError(f"now_blocks {now_blocks} > max {max_blocks}")
        hit = self.lookup(keys)[:now_blocks]
        if not self.can_admit(max_blocks, keys[:len(hit)]):
            raise RuntimeError(
                f"pool exhausted: need {max_blocks} blocks, "
                f"{self.available_blocks} available")
        blocks: List[int] = []
        for b in hit:
            self._incref(b)
            blocks.append(b)
        for _ in range(now_blocks - len(hit)):
            b = self._draw_fresh()
            self._ref[b] = 1
            blocks.append(b)
        self._reserved[rid] = max_blocks
        self._owned[rid] = blocks
        self.hit_blocks += len(hit)
        self.miss_blocks += now_blocks - len(hit)
        return list(blocks)

    def grow(self, rid: int) -> int:
        """Allocate one more block from ``rid``'s reservation."""
        owned = self._owned.get(rid)
        if owned is None:
            raise KeyError(f"request {rid} not admitted")
        if len(owned) >= self._reserved[rid]:
            raise RuntimeError(
                f"request {rid} exceeded its reservation "
                f"of {self._reserved[rid]} blocks")
        blk = self._draw_fresh()  # reservation math guarantees success
        self._ref[blk] = 1
        owned.append(blk)
        return blk

    def release(self, rid: int) -> List[int]:
        """Decref all of ``rid``'s blocks and drop its reservation
        (completion, preemption or abort); returns the block ids. Blocks
        reaching refcount 0 rejoin the free list, or the cached LRU if
        published (their K/V stays reusable until evicted)."""
        owned = self._owned.pop(rid, None)
        if owned is None:
            raise KeyError(f"request {rid} not admitted (double release?)")
        del self._reserved[rid]
        for blk in owned:
            self.decref(blk)
        return owned

    def owned(self, rid: int) -> List[int]:
        return list(self._owned.get(rid, ()))

    def shrink(self, rid: int, keep: int) -> List[int]:
        """Speculative-decode rollback: return ``rid``'s blocks past index
        ``keep`` to the pool, newest first, keeping the reservation intact
        (the committed frontier may cross the same boundary again next
        iteration). Rolled-back blocks hold garbage K/V past the accept
        point, so any content key they were published under is retracted
        before the decref — the cache must never serve them. Returns the
        dropped block ids (newest first).

        In practice dropped blocks are always private (they were grown
        fresh past the committed frontier, and ``register`` only publishes
        committed full blocks), so the retraction is a guard, not a hot
        path.
        """
        owned = self._owned.get(rid)
        if owned is None:
            raise KeyError(f"request {rid} not admitted")
        if keep < 0:
            raise ValueError(f"keep {keep} must be >= 0")
        dropped: List[int] = []
        while len(owned) > keep:
            blk = owned.pop()
            if blk in self._hash_of:
                del self._block_of[self._hash_of.pop(blk)]
            self.decref(blk)
            dropped.append(blk)
        return dropped

    # -- refcounts ---------------------------------------------------------

    def incref(self, block: int) -> None:
        """Add one reference to a live block (fork hook: beam search /
        speculative branches share a table entry; tests use it to force
        the copy-on-write path)."""
        if block not in self._ref:
            raise KeyError(f"block {block} is not live (ref 0)")
        self._ref[block] += 1

    def decref(self, block: int) -> None:
        """Drop one reference; at 0 the block returns to the cached LRU
        (if published) or the free list."""
        ref = self._ref.get(block)
        if ref is None:
            raise RuntimeError(
                f"double free/decref of block {block} (refcount already 0)")
        if ref > 1:
            self._ref[block] = ref - 1
            return
        del self._ref[block]
        if block in self._hash_of:
            self._lru[block] = None          # newest-released → LRU tail
        else:
            self._free.append(block)

    def _incref(self, block: int) -> None:
        """Internal: incref a published block, reviving it from the cached
        LRU when its refcount is 0."""
        if block in self._ref:
            self._ref[block] += 1
        else:
            self._lru.pop(block)             # KeyError = internal corruption
            self._ref[block] = 1

    def _draw_fresh(self) -> int:
        """One writable block: the free list first, else evict the
        LRU-oldest cached block (retracting its published key)."""
        if self._free:
            return self._free.pop()
        if self._lru:
            blk, _ = self._lru.popitem(last=False)
            del self._block_of[self._hash_of.pop(blk)]
            self.evictions += 1
            return blk
        raise RuntimeError(
            "pool exhausted mid-draw: reservation accounting violated")

    # -- publishing + copy-on-write ----------------------------------------

    def register(self, rid: int, index: int, key: bytes) -> int:
        """Publish ``rid``'s ``index``-th block under content ``key`` (the
        block must be full and will never be written again while the key
        stands). First-wins: if another block already holds this key, the
        duplicate stays private. Returns the block now serving the key."""
        if not self.prefix_cache:
            raise RuntimeError("register() requires prefix_cache=True")
        owned = self._owned.get(rid)
        if owned is None:
            raise KeyError(f"request {rid} not admitted")
        block = owned[index]
        if block in self._hash_of:           # already published (idempotent)
            return block
        if key in self._block_of:            # duplicate content stays private
            return self._block_of[key]
        self._hash_of[block] = key
        self._block_of[key] = block
        return block

    def ensure_writable(self, rid: int, index: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write guard before writing into ``rid``'s ``index``-th
        block. A shared block (ref > 1) is detached: ``rid`` gets a fresh
        private block and the caller must copy the device-side pool
        contents old → new (returned as ``(old, new)``). A sole-owned
        published block has its key retracted and is written in place
        (returns ``None``, like the plain private case)."""
        owned = self._owned.get(rid)
        if owned is None:
            raise KeyError(f"request {rid} not admitted")
        block = owned[index]
        if self._ref[block] > 1:
            new = self._draw_fresh()
            self._ref[new] = 1
            self._ref[block] -= 1            # still > 0: others hold it
            owned[index] = new
            self.cow_copies += 1
            return block, new
        if block in self._hash_of:
            del self._block_of[self._hash_of.pop(block)]
        return None


def _pad_to_blocks(kv: torch.Tensor, n_blocks: int, block_len: int) -> torch.Tensor:
    """Right-pad a ``[..., S, D]`` prefill KV leaf to ``n_blocks·block_len``
    positions (pad rows are garbage-by-construction: masked by ``len``)."""
    s = kv.shape[-2]
    target = n_blocks * block_len
    if s > target:
        raise ValueError(f"prefill length {s} exceeds {n_blocks} blocks "
                         f"× {block_len}")
    if s == target:
        return kv
    return torch.nn.functional.pad(kv, (0, 0, 0, target - s))


def prefill_write_kv(pool: torch.Tensor, single: torch.Tensor,
                     block_ids: torch.Tensor) -> None:
    """Paged-prefill write for a full-history layer, in place.

    ``pool`` [N, Hkv, blk, D] (one layer's block pool), ``single``
    [1, Hkv, S, D] prefill K or V, ``block_ids`` [nb] int. Position ``p``
    lands in pool block ``block_ids[p // blk]`` at offset ``p % blk``; the
    partially-valid last block is padded to ``block_len`` and written whole
    (pad rows are masked by ``len``).
    """
    _, hkv, blk, d = pool.shape
    nb = block_ids.shape[0]
    src = _pad_to_blocks(single, nb, blk)
    # [1, Hkv, nb·blk, D] → [nb, Hkv, blk, D]
    src = src[0].reshape(hkv, nb, blk, d).transpose(0, 1)
    pool[block_ids.long()] = src.to(pool.dtype)
