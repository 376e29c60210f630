"""PyTorch port vs JAX reference: the int8 arena step (``serve_quant``) of
the dense family, float32.

``attention.decode_attention_int8`` (the ITA integer decode attention) is
held bit for bit to ``jax.jit`` of the reference's, as the engines run it:
GQA groups of 1, 8 and 16; per-row ``cache_len`` from 0 to ``S_cache``;
``window`` and ``start``; caches holding the integers in float32 (the
serving arena's) and true int8 caches; a saturated row; a row of equal
logits whose AV sums pass 2^24 (where an f32 product would round); bf16 q;
and q values where rounding ``q · d^-½ · (1/Q_SCALE)`` in two steps would
differ from the one folded constant XLA multiplies by.

``decode_step`` with W8A8 ``qparams`` (and with float projections) over a
batch-2 arena whose rows sit at different positions: logits allclose at
``rtol = atol = 1e-5`` and every cache integer bit-equal after each of
four steps (glm4-9b, phi3-mini-3.8b, gemma3-4b whose 16-row rings wrap).
The tail config and the sliding-window engine cells are in
``test_torch_ring_int8_arena.py``.

Engine level: the port's ``arena`` (length buckets on and off; the
``bounded``, ``fcfs`` and ``qos`` schedulers) and ``slot`` backends give
the JAX engines' greedy streams, preemptions (re-prefills of int8 slots
included) and every shared metric on ``glm4-9b-smoke`` and
``phi3-mini-3.8b-smoke``. The vlm-dense and moe configs' cells are in
``test_torch_moe_int8_arena.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models.cache import cache_insert as jcache_insert
from repro_torch.core.quant import recip32
from repro_torch.models import attention as tattn
from repro_torch.models.cache import cache_insert as tcache_insert

from test_torch_dense_arena import identity_cell, tokens
from test_torch_serve import setup_pair

torch.set_num_threads(1)

TOL = 1e-5          # the int8 decode step's logits
FLOAT_TOL = 1e-4    # the float prefill's (test_torch_dense_arena.py)
_JCFG = jconfigs.smoke_config("glm4-9b")   # the reference reads no field


def jax_int8_attention(q, k, v, cache_len, window=None, start=None):
    """The reference's ``decode_attention_int8`` under ``jax.jit``, as the
    engines run it (``window`` static)."""
    fn = jax.jit(functools.partial(jattn.decode_attention_int8, cfg=_JCFG,
                                   window=window))
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(cache_len),
                         start=None if start is None else jnp.asarray(start)))


def port_int8_attention(q, k, v, cache_len, window=None, start=None):
    got = tattn.decode_attention_int8(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.as_tensor(cache_len), window=window,
        start=None if start is None else torch.from_numpy(start))
    return got.float().numpy()


def assert_bits_equal(got, want, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    diff = got.view(np.int32) != want.view(np.int32)
    assert not diff.any(), (what, int(diff.sum()),
                            float(np.abs(got - want).max()))


def attention_inputs(seed, b, hkv, group, s, d, q_sigma=2.0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, hkv * group, 1, d)) * q_sigma
         ).astype(np.float32)
    k = rng.integers(-127, 128, (b, hkv, s, d)).astype(np.float32)
    v = rng.integers(-127, 128, (b, hkv, s, d)).astype(np.float32)
    return rng, q, k, v


@pytest.mark.parametrize("cache", ["float", "int8"])
@pytest.mark.parametrize("group", [1, 8, 16])
def test_decode_attention_int8_bit_exact(group, cache):
    """Rows at cache_len 0 (every row attended alike), S_cache and between;
    row 3's q saturates (|q8| = 127 everywhere, its logits clamp)."""
    b, hkv, s, d = 5, 2, 37, 32
    rng, q, k, v = attention_inputs(group, b, hkv, group, s, d)
    q[3] = np.where(q[3] >= 0, 40.0, -40.0)
    lens = np.int32([0, s, 1, 30, 17])
    want = jax_int8_attention(q, k, v, lens)
    if cache == "int8":
        k, v = k.astype(np.int8), v.astype(np.int8)
    assert_bits_equal(port_int8_attention(q, k, v, lens), want)


@pytest.mark.parametrize("mask", ["window", "start", "window+start"])
def test_decode_attention_int8_window_and_start(mask):
    """``window`` masks entries before ``cache_len − window``; ``start``
    moves the masks to absolute positions (row ``j`` at ``start + j``)."""
    b, hkv, group, s, d = 4, 2, 4, 24, 16
    rng, q, k, v = attention_inputs(7, b, hkv, group, s, d)
    window = 9 if "window" in mask else None
    start = np.int32([0, 5, 40, 3]) if "start" in mask else None
    lens = np.int32([1, 24, 13, 7]) + (0 if start is None else start)
    want = jax_int8_attention(q, k, v, lens, window=window, start=start)
    got = port_int8_attention(q, k, v, lens, window=window, start=start)
    assert_bits_equal(got, want)


def test_decode_attention_int8_av_sums_past_2_24():
    """One row of equal logits over 1100 valid entries (every p8 = 127) and
    V at ±127: AV sums up to 127 · 127 · 1100 > 2^24, odd ones among them,
    which an f32 product would round; the integer route keeps them exact."""
    b, hkv, group, s, d = 2, 1, 2, 1100, 16
    rng, q, k, v = attention_inputs(8, b, hkv, group, s, d)
    k[0] = 0                                    # equal logits on row 0
    v[0] = np.where(rng.random(v[0].shape) < 0.995, 127, -127)
    lens = np.int32([s, 700])
    want = jax_int8_attention(q, k, v, lens)
    assert_bits_equal(port_int8_attention(q, k, v, lens), want)
    exact = (v[0, 0].astype(np.int64).sum(0) * 127)
    assert int(np.abs(exact).max()) > 2 ** 24


def test_decode_attention_int8_q_rounds_on_the_folded_constant():
    """At D = 48 a few q values round differently through ``q · d^-½`` then
    ``· (1/Q_SCALE)`` than through their one folded f32 constant, which is
    what the jitted reference multiplies by; the port rounds as it does."""
    d = 48
    x = np.random.default_rng(11).standard_normal(2_000_000).astype(
        np.float32) * 10
    xt = torch.from_numpy(x)
    two_step = torch.round(xt * (d ** -0.5) * recip32(tattn.Q_SCALE))
    folded = torch.round(xt * tattn._q_to_int8_scale(d))
    picks = x[(two_step != folded).numpy()]
    assert picks.size >= 1
    b, hkv, group, s = 1, 1, 4, 12
    rng, q, k, v = attention_inputs(12, b, hkv, group, s, d, q_sigma=10.0)
    q.reshape(-1)[:picks.size] = picks
    lens = np.int32([s])
    want = jax_int8_attention(q, k, v, lens)
    assert_bits_equal(port_int8_attention(q, k, v, lens), want)


def test_decode_attention_int8_bf16_q_and_scalar_len():
    """A bf16 q (the card's serving dtype; the output comes back bf16) and
    a scalar ``cache_len`` broadcast to every row."""
    b, hkv, group, s, d = 3, 2, 8, 20, 64
    rng, q, k, v = attention_inputs(13, b, hkv, group, s, d)
    qb = jnp.asarray(q, jnp.bfloat16)
    fn = jax.jit(functools.partial(jattn.decode_attention_int8, cfg=_JCFG))
    want = fn(qb, jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
              jnp.int32(11))
    got = tattn.decode_attention_int8(
        torch.from_numpy(np.array(qb.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16(), 11)
    assert got.dtype == torch.bfloat16
    assert_bits_equal(got.float().numpy(),
                      np.asarray(want.astype(jnp.float32)))


def tree_bits_equal(got, want, what="cache"):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            tree_bits_equal(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            tree_bits_equal(g, w, f"{what}[{i}]")
    else:
        assert tuple(got.shape) == tuple(want.shape), what
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=what)


def close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def step_both(jarch, jparams, jq, tarch, tparams, tq, jcache, tcache, tok,
              steps):
    """``steps`` decode steps on both sides, fed the reference's greedy
    tokens: logits allclose, the cache integers bit-equal after each."""
    jdec = jax.jit(jarch.decode_step)
    for step in range(steps):
        jl, jcache = jdec(jparams, jcache, jnp.asarray(tok), qparams=jq)
        tl, tcache = tarch.decode_step(tparams, tcache, torch.from_numpy(tok),
                                       qparams=tq)
        close(tl, jl, f"decode step {step} logits")
        tree_bits_equal(tcache, jcache, f"decode step {step} cache")
        tok = np.array(jnp.argmax(jl, axis=-1), np.int32)
    return tcache


def prefill_pair(jarch, jparams, tarch, tparams, lens, max_len):
    """One prompt a length of ``lens`` prefilled on both sides (logits at
    the float prefill's tolerance, cache integers bit-equal) and spliced
    into a batch arena (``cache_insert``); returns both arenas and the
    reference's greedy first tokens."""
    jcache = jarch.init_cache(len(lens), max_len, quantized=False)
    tcache = tarch.init_cache(len(lens), max_len, quantized=False,
                              device="cpu")
    last = []
    for slot, n in enumerate(lens):
        t = tokens(tarch.cfg.vocab, n, seed=n)
        jl, jc1 = jax.jit(jarch.prefill, static_argnums=2)(
            jparams, jnp.asarray(t[None]), max_len)
        tl, tc1 = tarch.prefill(tparams, torch.from_numpy(t[None]), max_len)
        close(tl, jl, f"prefill logits, {n} tokens", tol=FLOAT_TOL)
        tree_bits_equal(tc1, jc1, f"prefill cache, {n} tokens")
        jcache = jcache_insert(jcache, jc1, slot)
        tcache_insert(tcache, tc1, slot)
        last.append(int(jnp.argmax(jl[0])))
    return jcache, tcache, np.int32(last)


@pytest.mark.parametrize("name,w8a8", [
    ("glm4-9b", True), ("glm4-9b", False), ("phi3-mini-3.8b", True),
    ("gemma3-4b", True)], ids=lambda v: str(v))
def test_int8_decode_step_matches_reference(name, w8a8):
    """Prompts of 21 and 12 tokens (gemma3-4b-smoke's rings take the rolled
    fill of the first and wrap on the second's decode) spliced into a
    batch-2 float arena, then four decode steps; with ``w8a8`` the seven
    projections run through ``quantize_params``' W8A8 weights, else float
    ones beside the int8 K/V (the moe family's combination)."""
    jarch, jparams, tarch, tparams = setup_pair(name, True)
    jq = jarch.quantize_params(jparams) if w8a8 else None
    tq = tarch.quantize_params(tparams) if w8a8 else None
    jcache, tcache, last = prefill_pair(jarch, jparams, tarch, tparams,
                                        [21, 12], max_len=40)
    tcache = step_both(jarch, jparams, jq, tarch, tparams, tq, jcache,
                       tcache, last, steps=4)
    k = tcache["stacks"][0]["k"]
    assert k.dtype == torch.float32 and torch.equal(k, k.round())
    assert float(k.abs().max()) <= 127


def test_int8_decode_step_on_a_true_int8_cache():
    """``init_cache``'s default under ``serve_quant`` is an int8 cache; the
    step writes and attends it as it does the float-held one."""
    jarch, jparams, tarch, tparams = setup_pair("glm4-9b", True)
    jq, tq = jarch.quantize_params(jparams), tarch.quantize_params(tparams)
    jcache = jarch.init_cache(2, 16)
    tcache = tarch.init_cache(2, 16, device="cpu")
    assert tcache["stacks"][0]["k"].dtype == torch.int8
    tcache = step_both(jarch, jparams, jq, tarch, tparams, tq, jcache,
                       tcache, np.int32([5, 9]), steps=4)
    assert tcache["len"].tolist() == [4, 4]


@pytest.mark.parametrize("scheduler", ["bounded", "fcfs", "qos"])
@pytest.mark.parametrize("buckets", [True, False], ids=["buckets", "exact"])
def test_arena_streams_match_reference(buckets, scheduler):
    """glm4-9b-smoke; the bounded cells force a preemption, so a slot's int8
    cache is rebuilt by a re-prefill of prompt and output."""
    identity_cell("glm4-9b", "arena", buckets, scheduler, quant=True)


@pytest.mark.parametrize("name", ["glm4-9b", "phi3-mini-3.8b"])
def test_slot_streams_match_reference(name):
    identity_cell(name, "slot", True, "bounded", quant=True)


@pytest.mark.parametrize("scheduler", ["bounded", "fcfs"])
def test_phi3_arena_streams_match_reference(scheduler):
    identity_cell("phi3-mini-3.8b", "arena", True, scheduler, quant=True)
