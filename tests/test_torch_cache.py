"""PyTorch port vs JAX reference: the paged pool's host state and writes.

Randomized admit / grow / release sequences (plus the prefix-cache surface:
register, shared admits, copy-on-write, shrink, LRU eviction) are replayed
through both ``BlockAllocator``s, and their whole state is compared after
every step — results and raised exceptions included. The device-side
helpers are held bit-exact on the same numpy inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cache as jcache
from repro_torch.models import cache as tcache

torch.set_num_threads(1)


def _state(a):
    return dict(
        free=list(a._free), owned={r: list(b) for r, b in a._owned.items()},
        reserved=dict(a._reserved), ref=dict(a._ref),
        hash_of=dict(a._hash_of), block_of=dict(a._block_of),
        lru=list(a._lru), hit=a.hit_blocks, miss=a.miss_blocks,
        evictions=a.evictions, cow=a.cow_copies,
        props=(a.free_blocks, a.cached_blocks, a.live_blocks,
               a.reclaimable_blocks, a.reserved_unallocated,
               a.available_blocks))


def _call(a, op, args):
    try:
        return ("ok", getattr(a, op)(*args))
    except (IndexError, KeyError, RuntimeError, ValueError) as e:
        return ("raise", type(e).__name__)


def _random_op(rng, block_len, prefix):
    """One random allocator call (many deliberately invalid, so the error
    paths are replayed too)."""
    rid = int(rng.integers(0, 8))
    ops = ["admit", "grow", "release", "can_admit", "reservation",
           "can_admit_after_release"]
    if prefix:
        ops += ["register", "ensure_writable", "shrink", "lookup", "incref",
                "decref"]
    op = ops[int(rng.integers(0, len(ops)))]
    if op == "admit":
        mx = int(rng.integers(1, 6))
        now = int(rng.integers(0, mx + 1))
        keys = ()
        if prefix:
            toks = rng.integers(0, 3, (mx + 1) * block_len)
            keys = tuple(tcache.prefix_chain_keys(toks, block_len))
        return op, (rid, now, mx, keys)
    if op == "can_admit":
        return op, (int(rng.integers(0, 8)),)
    if op == "can_admit_after_release":
        return op, (int(rng.integers(0, 8)), rid)
    if op == "register":
        toks = rng.integers(0, 3, block_len)
        key = tcache.chain_key(b"root", toks)
        return op, (rid, int(rng.integers(0, 3)), key)
    if op == "ensure_writable":
        return op, (rid, int(rng.integers(0, 3)))
    if op == "shrink":
        return op, (rid, int(rng.integers(0, 4)))
    if op == "lookup":
        toks = rng.integers(0, 3, 3 * block_len)
        return op, (tcache.prefix_chain_keys(toks, block_len),)
    if op in ("incref", "decref"):
        return op, (int(rng.integers(0, 10)),)
    return op, (rid,)


@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_allocator_replay_matches_reference(prefix, seed):
    layout_args = dict(block_len=4, num_blocks=10, max_len=32)
    ja = jcache.BlockAllocator(jcache.PagedLayout(**layout_args),
                               prefix_cache=prefix)
    ta = tcache.BlockAllocator(tcache.PagedLayout(**layout_args),
                               prefix_cache=prefix)
    rng = np.random.default_rng(seed)
    n_raised = 0
    for step in range(400):
        op, args = _random_op(rng, 4, prefix)
        rj, rt = _call(ja, op, args), _call(ta, op, args)
        assert rj == rt, (step, op, args)
        n_raised += rj[0] == "raise"
        assert _state(ja) == _state(ta), (step, op, args)
    assert 0 < n_raised < 400  # both the success and the error paths ran


def test_layout_and_sizing_helpers_match():
    for n in (0, 1, 7, 8, 9, 100, 1000):
        assert tcache.bucket_for(n) == jcache.bucket_for(n)
        assert tcache.bucket_for(n, 16, 64) == jcache.bucket_for(n, 16, 64)
        assert tcache.blocks_for(n, 16) == jcache.blocks_for(n, 16)
    jl = jcache.PagedLayout(16, 33, 500)
    tl = tcache.PagedLayout(16, 33, 500)
    for attr in ("max_blocks", "usable_blocks", "usable_tokens",
                 "ring_blocks"):
        assert getattr(jl, attr) == getattr(tl, attr)
    with pytest.raises(ValueError):
        tcache.PagedLayout(12, 33, 500)
    toks = np.arange(50) % 7
    assert tcache.prefix_chain_keys(toks, 8) == jcache.prefix_chain_keys(
        toks, 8)


def test_quantize_kv_bit_exact_with_traced_reference():
    """The serving write paths quantize inside ``jit``, where XLA turns
    ``x / scale`` into a reciprocal multiply; the port mirrors that."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(200_000) * 2.0).astype(np.float32)
    scale = 4.0 / 127
    j = jax.jit(lambda a: jcache.quantize_kv(a, scale))(jnp.asarray(x))
    t = tcache.quantize_kv(torch.from_numpy(x), scale)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())
    np.testing.assert_array_equal(
        np.asarray(jcache.dequantize_kv(j, scale)),
        tcache.dequantize_kv(t, scale).numpy())


@pytest.mark.parametrize("s", [16, 21, 5])
def test_prefill_write_kv_matches_reference(s):
    rng = np.random.default_rng(s)
    pool = rng.standard_normal((9, 2, 8, 4)).astype(np.float32)
    single = rng.standard_normal((1, 2, s, 4)).astype(np.float32)
    ids = np.asarray([3, 7, 1][:tcache.blocks_for(s, 8)], np.int32)
    j = jcache.prefill_write_kv(jnp.asarray(pool), jnp.asarray(single),
                                jnp.asarray(ids))
    tp = torch.from_numpy(pool.copy())
    tcache.prefill_write_kv(tp, torch.from_numpy(single), torch.from_numpy(ids))
    np.testing.assert_array_equal(np.asarray(j), tp.numpy())
