"""PyTorch port vs JAX reference: ring-block pools for sliding-window layers
on the paged path.

``gemma3-4b-smoke`` (pattern ``LLLLLG``, window 16) at ``block_len`` 4 and
``max_len`` 64, ``dtype="float32"``: each L layer's pool is a ring arena of
``1 + slots · 5`` rows, each slot's ring 5 blocks wide.

* ``ring_table_row`` and ``ring_prefill_write_kv`` equal the reference's
  bit for bit, on float and int8 pools, for prompts below the ring, at the
  window, past it, and right-padded past ``true_len``.
* ``init_paged_cache`` gives the reference's leaf shapes and dtypes;
  ``paged_prefill`` with ``ring_ids`` leaves int8 pools bit-equal to the
  reference's and float pools within 1e-5 of them (f32 products summed in
  another order), and bit-equal to the reference's ring write of the port's
  own K/V; ``paged_decode_step`` over the ring dict gives the reference's
  logits within rtol = atol = 1e-4 (the same f32 reordering).

The engine on ring layouts is held to the reference in
``test_torch_ring_serve.py`` (the two files split the reference's traces
between two test workers).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cache as jcache
from repro_torch.models import cache as tcache

from test_torch_serve import setup_pair

torch.set_num_threads(1)

NAME = "gemma3-4b"
BLK, MAX_LEN, SLOTS = 4, 64, 4
WB = tcache.ring_blocks_for(16, BLK)          # ring width at window 16: 5


def ring_layouts(window, slots=SLOTS, num_blocks=40, max_len=MAX_LEN):
    """The same ring layout in both packages (sized as the backend sizes
    it: one ring a slot plus trash)."""
    kw = dict(window=window, ring_num_blocks=1 + slots * WB)
    return (jcache.PagedLayout(BLK, num_blocks, max_len, **kw),
            tcache.PagedLayout(BLK, num_blocks, max_len, **kw))


# ---------------------------------------------------------------------------
# Cache helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("first", [0, 1, 4, 5, 13])
def test_ring_table_row_matches_reference(first):
    ids = [7, 2, 11, 4, 9]
    assert tcache.ring_table_row(ids, first) == \
        jcache.ring_table_row(ids, first)
    assert tcache.ring_table_row(np.int32(ids), first) == \
        jcache.ring_table_row(np.int32(ids), first)


@pytest.mark.parametrize("true_len,width", [
    (7, 7),      # below the ring: two live blocks, three entries to trash
    (16, 16),    # at the window: four blocks
    (20, 20),    # one ring exactly
    (37, 37),    # past the ring: the last five of ten blocks, wrapped
    (21, 32),    # right-padded to a bucket past true_len
    (45, 64),    # padded, and past the ring
])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_ring_prefill_write_kv_bit_equal(true_len, width, int8):
    rng = np.random.default_rng(true_len * 7 + width)
    hkv, d, rows = 2, 16, 12
    if int8:
        pool = rng.integers(-127, 128, (rows, hkv, BLK, d)).astype(np.int8)
        single = rng.integers(-127, 128, (1, hkv, width, d)).astype(np.int8)
    else:
        pool = rng.standard_normal((rows, hkv, BLK, d)).astype(np.float32)
        single = rng.standard_normal((1, hkv, width, d)).astype(np.float32)
    ring_ids = (rng.permutation(rows - 1)[:WB] + 1).astype(np.int32)
    want = jcache.ring_prefill_write_kv(
        jnp.asarray(pool), jnp.asarray(single), jnp.asarray(ring_ids),
        jnp.int32(true_len))
    got = torch.from_numpy(pool.copy())
    tcache.ring_prefill_write_kv(got, torch.from_numpy(single),
                                 torch.from_numpy(ring_ids), true_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_init_paged_cache_ring_leaves_match_reference(quant):
    jarch, _, tarch, _ = setup_pair(NAME, quant)
    jl, tl = ring_layouts(tarch.cfg.local_window)
    assert tl.ring_blocks == jl.ring_blocks == WB
    j = jarch.init_paged_cache(SLOTS, jl)
    t = tarch.init_paged_cache(SLOTS, tl, device="cpu")
    assert len(t["stacks"]) == len(j["stacks"]) and "tail" not in t
    for kind, jc, tc in zip(tarch.cfg.pattern, j["stacks"], t["stacks"]):
        assert set(tc) == set(jc)
        for key in jc:
            assert tuple(tc[key].shape) == jc[key].shape, (kind, key)
            assert str(tc[key].dtype).split(".")[-1] == str(jc[key].dtype)
            np.testing.assert_array_equal(tc[key].numpy(),
                                          np.asarray(jc[key]))
        rows = tl.ring_num_blocks if kind == "L" else tl.num_blocks
        assert tc["k"].shape[1] == rows
    assert tuple(t["len"].shape) == j["len"].shape


# (true_len, width): below the window, at it, past the ring (20 tokens),
# each right-padded to one admission bucket (one reference trace), and one
# exact prompt past the ring
PROMPTS = [(7, 32), (16, 32), (32, 32), (27, 32)]
RINGS = [[1, 2, 3, 4, 5], [10, 7, 6, 9, 8], [15, 11, 12, 13, 14],
         [20, 16, 18, 17, 19]]


@pytest.fixture(scope="module", params=[False, True], ids=["float", "int8"])
def prefilled(request):
    """Both packages prefill ``PROMPTS`` into their ring caches, slot ``i``
    with ring ``RINGS[i]`` (logits at rtol = atol = 1e-4). Returns (quant,
    JAX arch, params, cache, port arch, params, cache); a test that writes
    the port's cache clones it first."""
    quant = request.param
    jarch, jparams, tarch, tparams = setup_pair(NAME, quant)
    cfg = tarch.cfg
    jl, tl = ring_layouts(cfg.local_window)
    jc = jarch.init_paged_cache(SLOTS, jl)
    tc = tarch.init_paged_cache(SLOTS, tl, device="cpu")
    rng = np.random.default_rng(3)
    jpre = jax.jit(jarch.paged_prefill)
    next_block = 1
    for slot, ((n, width), ring_ids) in enumerate(zip(PROMPTS, RINGS)):
        toks = np.zeros((1, width), np.int32)
        toks[0, :n] = rng.integers(0, cfg.vocab, n)
        nb = -(-width // BLK)
        bids = np.arange(next_block, next_block + nb, dtype=np.int32)
        next_block += nb
        rid = np.int32(ring_ids)
        jlog, jc = jpre(jparams, jnp.asarray(toks), jc, slot,
                        jnp.asarray(bids), ring_ids=jnp.asarray(rid),
                        true_len=jnp.int32(n))
        tlog, tc = tarch.paged_prefill(
            tparams, torch.from_numpy(toks), tc, slot,
            torch.from_numpy(bids), ring_ids=torch.from_numpy(rid),
            true_len=n)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=1e-4, atol=1e-4)
    return quant, jarch, jparams, jc, tarch, tparams, tc


def test_paged_prefill_ring_pools_match_reference(prefilled):
    quant, _, _, jc, tarch, tparams, tc = prefilled
    for kind, j, t in zip(tarch.cfg.pattern, jc["stacks"], tc["stacks"]):
        for key in j:
            if quant:
                np.testing.assert_array_equal(t[key].numpy(),
                                              np.asarray(j[key]), err_msg=key)
            else:   # f32 projections reordered: 1e-5 on values near 1
                np.testing.assert_allclose(t[key].numpy(), np.asarray(j[key]),
                                           rtol=1e-5, atol=1e-5, err_msg=key)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    if quant:
        return
    # float pools bit for bit: the port's ring pools are the reference's
    # ring writes, slot after slot, of the port's own K/V (read back from a
    # full-history prefill of the same prompts)
    full = tarch.init_paged_cache(SLOTS, tcache.PagedLayout(BLK, 40, MAX_LEN),
                                  device="cpu")
    rng = np.random.default_rng(3)
    bids, next_block = [], 1
    for slot, (n, width) in enumerate(PROMPTS):
        toks = np.zeros((1, width), np.int32)
        toks[0, :n] = rng.integers(0, tarch.cfg.vocab, n)
        nb = -(-width // BLK)
        bids.append(torch.arange(next_block, next_block + nb))
        next_block += nb
        tarch.paged_prefill(tparams, torch.from_numpy(toks), full, slot,
                            bids[-1], true_len=n)
    for kind, fc, rc in zip(tarch.cfg.pattern, full["stacks"], tc["stacks"]):
        if kind != "L":
            continue
        for key in ("k", "v"):
            for g in range(fc[key].shape[0]):
                want = jnp.zeros(rc[key][g].shape, jnp.float32)
                for (n, _), ring_ids, ids in zip(PROMPTS, RINGS, bids):
                    seq = tcache.gather_prefix_kv(fc[key][g], ids)
                    want = jcache.ring_prefill_write_kv(
                        want, jnp.asarray(seq.numpy()),
                        jnp.asarray(np.int32(ring_ids)), jnp.int32(n))
                np.testing.assert_array_equal(rc[key][g].numpy(),
                                              np.asarray(want))


def test_paged_decode_step_ring_table_logits_allclose(prefilled):
    """Four prefilled slots decode six steps over rotating ring tables (the
    host rotation of the reference's backend); logits at rtol = atol =
    1e-4 (f32 reordering)."""
    quant, jarch, jparams, jc, tarch, tparams, tc = prefilled
    tc = {k: [{n: t.clone() for n, t in c.items()} for c in v]
          if isinstance(v, list) else v.clone() for k, v in tc.items()}
    jq = jarch.quantize_params(jparams) if quant else None
    tq = tarch.quantize_params(tparams) if quant else None
    full = np.zeros((SLOTS, MAX_LEN // BLK), np.int32)
    next_block = 1
    for slot, (_, width) in enumerate(PROMPTS):
        nb = -(-width // BLK)
        full[slot, :nb] = np.arange(next_block, next_block + nb)
        next_block += nb
    lens = [n for n, _ in PROMPTS]
    first = [max(0, (n - 1) // BLK - (WB - 1)) for n in lens]
    jdec = jax.jit(functools.partial(
        jarch.paged_decode_step,
        attn_backend="interpret" if quant else "xla"))
    toks = np.int32([11, 22, 33, 44])
    for step in range(6):
        for s in range(SLOTS):        # the backend's begin_iteration
            nxt = lens[s] // BLK
            if nxt >= first[s] + WB:
                first[s] = nxt - (WB - 1)
            if full[s, nxt] == 0:
                full[s, nxt] = next_block
                next_block += 1
        ring = np.int32([tcache.ring_table_row(RINGS[s], first[s])
                         for s in range(SLOTS)])
        start = np.int32(first) * BLK
        jlog, jc = jdec(jparams, jc, jnp.asarray(toks), dict(
            full=jnp.asarray(full), ring=jnp.asarray(ring),
            start=jnp.asarray(start)), qparams=jq)
        tlog, tc = tarch.paged_decode_step(
            tparams, tc, torch.from_numpy(toks), dict(
                full=torch.from_numpy(full), ring=torch.from_numpy(ring),
                start=torch.from_numpy(start)), qparams=tq)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=1e-4, atol=1e-4, err_msg=str(step))
        toks = np.array(jnp.argmax(jlog, -1), np.int32)
        lens = [n + 1 for n in lens]
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_prefix_resume_with_ring_ids_raises_as_the_reference():
    _, _, tarch, tparams = setup_pair(NAME, False)
    _, tl = ring_layouts(tarch.cfg.local_window)
    tc = tarch.init_paged_cache(SLOTS, tl, device="cpu")
    with pytest.raises(ValueError, match="prefix-cache resume is "
                       "incompatible with ring"):
        tarch.paged_prefill(tparams, torch.zeros((1, 4), dtype=torch.int32),
                            tc, 0, torch.tensor([2]),
                            ring_ids=torch.arange(1, 6),
                            prefix_ids=torch.tensor([1]), start=4)
