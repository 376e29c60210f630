"""PyTorch port vs JAX reference: the encdec family (whisper-style).

The same numpy weights and frame embeddings (``repro_torch.bridge``) go
through ``repro.models.encdec`` and ``repro_torch.models.encdec`` on
``whisper-small`` smoke configs (2 + 2 layers, 4 query heads on 2 kv heads
of 16, 24 encoder frames):

* the schemas agree leaf for leaf, at smoke and full width, and
  ``layers.layer_norm`` equals the reference's;
* ``encode``, ``forward`` and ``prefill`` (logits and every cache leaf)
  are allclose in float32 (``rtol = 1e-5``, ``atol = 1e-5 · max|ref|``:
  summation order only) and bfloat16 (``3e-2``: both round the same f32
  products, about eight bf16 ulps), with ``serve_quant`` on and off; the
  requantized self K/V integers are equal in float32 (up to one step
  where the float K/V sits on a rounding tie, ``int8_equal``);
* the arena ``decode_step`` (float, and the ITA integer attention under
  ``serve_quant``) and the paged ``paged_prefill`` / ``paged_decode_step``
  / ``paged_verify_step`` over float and int8 pools match the reference
  (int8 pools against ``attn_backend="interpret"``, the kernel contract),
  with every pool leaf and the per-slot cross K/V equal;
* a prefix-cache resume gives the reference's suffix logits and pools;
* the verify step's cross-attention folds its Q rows into the head axis:
  each row equals the decode path's single-query attention bit for bit,
  and row 0 of a verify step gives the decode step's logits;
* ``paged_insert`` splices an arena prefill into pool blocks as the
  reference does, and refuses a prefill that is not whole blocks;
* ``forward`` at ``whisper-tiny-enc``'s full width (4 + 4 layers, 6 heads
  of 64 — a GQA group of 1 — and 1500 frames) in float32.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import encdec as jencdec
from repro.models import registry as jregistry
from repro.models.cache import PagedLayout as JLayout
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import encdec as tencdec
from repro_torch.models import registry as tregistry
from repro_torch.models.cache import PagedLayout as TLayout

torch.set_num_threads(1)

NAME = "whisper-small"
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
BLK, NBLOCKS, MAX_LEN = 4, 24, 32


def setup(dtype="float32", quant=True, name=NAME, smoke=True):
    """(JAX arch, JAX params, port arch, port params) on the same numpy
    weights."""
    get = "smoke_config" if smoke else "get_config"
    kw = dict(dtype=dtype, serve_quant=quant)
    jc = dataclasses.replace(getattr(jconfigs, get)(name), **kw)
    tc = dataclasses.replace(getattr(tconfigs, get)(name), **kw)
    tarch = tregistry.build(tc)
    npp = bridge.numpy_params(tarch.schema(), seed=0)
    return (jregistry.build(jc), jax.tree.map(jnp.asarray, npp), tarch,
            bridge.params_from_numpy(npp, "cpu"))


def frames(cfg, b, seed=3):
    """[b, enc_seq, d_model] frame embeddings, 0.1 · standard normal."""
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((b, cfg.enc_seq, cfg.d_model))
            ).astype(np.float32)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want, dtype="float32", msg=""):
    want = to_np(want)
    tol = TOL[dtype]
    np.testing.assert_allclose(to_np(got), want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()), 1e-6),
                               err_msg=msg)


def equal(got, want, msg=""):
    np.testing.assert_array_equal(to_np(got), to_np(want), err_msg=msg)


def int8_equal(got, want, msg=""):
    """Requantized K/V integers: equal, but for values whose float K/V
    sits on a rounding tie (``x / KV_SCALE`` within f32 reordering of
    ``n + 0.5``, e.g. 7.500002 on one side and 7.4999995 on the other),
    which land one step apart; at most one in a thousand."""
    d = np.abs(to_np(got) - to_np(want))
    assert d.max(initial=0) <= 1, (msg, d.max())
    assert np.count_nonzero(d) <= max(1, d.size // 1000), (
        msg, np.count_nonzero(d))


@pytest.mark.parametrize("name,smoke", [(NAME, True), (NAME, False),
                                        ("whisper-tiny-enc", False)])
def test_schema_matches_reference(name, smoke):
    get = "smoke_config" if smoke else "get_config"
    js = jencdec.schema(getattr(jconfigs, get)(name))
    ts = tencdec.schema(getattr(tconfigs, get)(name))
    assert js.keys() == ts.keys()
    for key in js:
        if isinstance(js[key], dict):
            assert js[key].keys() == ts[key].keys(), key
            for k in js[key]:
                assert js[key][k].shape == ts[key][k].shape, (key, k)
        else:
            assert js[key].shape == ts[key].shape, key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    """``layers.layer_norm`` (f32 statistics, the input's dtype out), which
    the encdec family keeps beside ``rms_norm`` as the reference does."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers

    rng = np.random.default_rng(7)
    x, g, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((3, 5, 48), (48,), (48,)))
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    got = tlayers.layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(g),
                             torch.from_numpy(b))
    want = jlayers.layer_norm(jnp.asarray(x).astype(dtype), jnp.asarray(g),
                              jnp.asarray(b))
    assert got.dtype == tdt
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_forward_match_reference(dtype):
    jarch, jparams, tarch, tparams = setup(dtype)
    cfg = tarch.cfg
    emb = frames(cfg, 2)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 11))
    close(tencdec.encode(tparams, torch.from_numpy(emb), cfg),
          jencdec.encode(jparams, jnp.asarray(emb), jarch.cfg), dtype)
    close(tarch.forward(tparams, torch.from_numpy(toks),
                        embeds=torch.from_numpy(emb)),
          jarch.forward(jparams, jnp.asarray(toks), embeds=jnp.asarray(emb)),
          dtype)
    for fn in (tarch.forward, functools.partial(tarch.prefill, max_len=16)):
        with pytest.raises(ValueError, match="frame embeddings"):
            fn(tparams, torch.from_numpy(toks))


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8kv"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype, quant):
    """The arena path: prefill (logits and every cache leaf), then three
    decode steps at per-row positions (float attention, or the ITA integer
    ``decode_attention_int8`` under ``serve_quant``)."""
    jarch, jparams, tarch, tparams = setup(dtype, quant)
    cfg = tarch.cfg
    emb = frames(cfg, 2)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 13))
    jl, jcache = jax.jit(functools.partial(jarch.prefill, max_len=MAX_LEN))(
        jparams, jnp.asarray(toks), embeds=jnp.asarray(emb))
    tl, tcache = tarch.prefill(tparams, torch.from_numpy(toks), MAX_LEN,
                               embeds=torch.from_numpy(emb))
    close(tl, jl, dtype)
    assert tcache.keys() == jcache.keys()
    for k in ("k", "v", "xk", "xv"):
        assert tuple(tcache[k].shape) == jcache[k].shape, k
        if quant and dtype == "float32" and k in ("k", "v"):
            int8_equal(tcache[k], jcache[k], k)   # requantized integers
        else:
            close(tcache[k], jcache[k], dtype, k)
    equal(tcache["len"], jcache["len"])
    # rows at different positions: shift row 1 back by 4
    jcache = dict(jcache, len=jnp.int32([13, 9]))
    tcache["len"] = torch.tensor([13, 9], dtype=torch.int32)
    jdec = jax.jit(jarch.decode_step)
    tok = np.int32([5, 7])
    for step in range(3):
        jl, jcache = jdec(jparams, jcache, jnp.asarray(tok))
        tl, tcache = tarch.decode_step(tparams, tcache, torch.from_numpy(tok))
        close(tl, jl, dtype, f"step {step}")
        for k in ("k", "v"):
            if quant and dtype == "float32":
                int8_equal(tcache[k], jcache[k], f"{k} step {step}")
            else:
                close(tcache[k], jcache[k], dtype, f"{k} step {step}")
        equal(tcache["len"], jcache["len"])
        tok = np.array(jnp.argmax(jl, -1), np.int32)


def assert_paged_caches_match(tcache, jcache, int8, dtype="float32"):
    assert tcache.keys() == jcache.keys()
    for k in ("k", "v", "kscale", "vscale"):
        if k in jcache:
            if k.endswith("scale"):
                equal(tcache[k], jcache[k], k)
            elif int8:
                int8_equal(tcache[k], jcache[k], k)
            else:
                close(tcache[k], jcache[k], dtype, k)
    for k in ("xk", "xv"):
        close(tcache[k], jcache[k], dtype, k)
    equal(tcache["len"], jcache["len"])


def continue_from(tcache, jcache, int8):
    """On int8 pools, carry on from the reference's integers: a K/V value
    on a rounding tie (``int8_equal``) would otherwise move every later
    logit of its row by the one step."""
    if int8:
        for k in ("k", "v"):
            tcache[k].copy_(torch.from_numpy(np.array(jcache[k])))


def paged_prefill_both(jarch, jparams, tarch, tparams, jcache, tcache,
                       prompts, ids, emb):
    jpre = jax.jit(jarch.paged_prefill)
    for slot, (p, bid) in enumerate(zip(prompts, ids)):
        e = emb[slot:slot + 1]
        jl, jcache = jpre(jparams, jnp.asarray(p[None]), jcache, slot,
                          jnp.asarray(bid), embeds=jnp.asarray(e))
        tl, tcache = tarch.paged_prefill(
            tparams, torch.from_numpy(p[None]), tcache, slot,
            torch.from_numpy(bid), embeds=torch.from_numpy(e))
        close(tl, jl, msg=f"prefill slot {slot}")
    return jcache, tcache


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_paged_steps_match_reference(quant):
    """Two slots prefilled into pool blocks, three decode steps, then two
    verify steps of Q = 4 at host-owned lengths crossing block boundaries:
    logits allclose, every pool leaf and the cross K/V equal after each."""
    jarch, jparams, tarch, tparams = setup("float32", quant)
    cfg = tarch.cfg
    assert tarch.serve_backends == ("slot", "arena", "paged")
    assert tarch.supports_spec_decode and tarch.supports_paged_int8
    jcache = jarch.init_paged_cache(2, JLayout(BLK, NBLOCKS, MAX_LEN))
    tcache = tarch.init_paged_cache(2, TLayout(BLK, NBLOCKS, MAX_LEN),
                                    device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (15, 6)]
    ids = [np.int32([3, 5, 9, 11]), np.int32([7, 2])]
    emb = frames(cfg, 2)
    jcache, tcache = paged_prefill_both(jarch, jparams, tarch, tparams,
                                        jcache, tcache, prompts, ids, emb)
    assert_paged_caches_match(tcache, jcache, quant)
    continue_from(tcache, jcache, quant)
    table = np.zeros((2, MAX_LEN // BLK), np.int32)
    table[0, :4], table[1, :2] = ids[0], ids[1]
    table[0, 4], table[1, 2:4] = 18, (17, 19)
    backend = "interpret" if quant else "xla"
    jdec = jax.jit(functools.partial(jarch.paged_decode_step,
                                     attn_backend=backend))
    toks = np.int32([11, 22])
    for step in range(3):
        jlog, jcache = jdec(jparams, jcache, jnp.asarray(toks),
                            jnp.asarray(table))
        tlog, tcache = tarch.paged_decode_step(
            tparams, tcache, torch.tensor(toks), torch.from_numpy(table))
        close(tlog, jlog, msg=f"decode {step}")
        assert_paged_caches_match(tcache, jcache, quant)
        continue_from(tcache, jcache, quant)
        toks = np.array(jnp.argmax(jlog, -1), np.int32)
    jver = jax.jit(functools.partial(jarch.paged_verify_step,
                                     attn_backend=backend))
    lens = np.int32([18, 9])
    for step in range(2):
        vt = rng.integers(0, cfg.vocab, (2, 4)).astype(np.int32)
        jlog, jcache = jver(jparams, dict(jcache, len=jnp.asarray(lens)),
                            jnp.asarray(vt), jnp.asarray(table))
        tcache["len"] = torch.from_numpy(lens)
        tlog, tcache = tarch.paged_verify_step(
            tparams, tcache, torch.from_numpy(vt), torch.from_numpy(table))
        close(tlog, jlog, msg=f"verify {step}")
        assert_paged_caches_match(tcache, jcache, quant)
        continue_from(tcache, jcache, quant)
        lens = lens + np.int32([1, 2])


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_prefix_resume_matches_reference(quant):
    """A 14-token decoder prompt whose first two blocks are cached: the
    suffix resume (``prefix_ids``, ``start = 8``) gives the reference's
    logits and pools; the encoder and cross K/V rerun in full."""
    jarch, jparams, tarch, tparams = setup("float32", quant)
    cfg = tarch.cfg
    jcache = jarch.init_paged_cache(2, JLayout(BLK, NBLOCKS, MAX_LEN))
    tcache = tarch.init_paged_cache(2, TLayout(BLK, NBLOCKS, MAX_LEN),
                                    device="cpu")
    prompt = np.random.default_rng(6).integers(0, cfg.vocab, 14
                                               ).astype(np.int32)
    emb = frames(cfg, 2)
    jcache, tcache = paged_prefill_both(
        jarch, jparams, tarch, tparams, jcache, tcache, [prompt[:8]],
        [np.int32([4, 6])], emb)
    pre, suf = np.int32([4, 6]), np.int32([8, 12])
    jl, jcache = jax.jit(functools.partial(jarch.paged_prefill, start=8))(
        jparams, jnp.asarray(prompt[None, 8:]), jcache, 1, jnp.asarray(suf),
        embeds=jnp.asarray(emb[1:]), prefix_ids=jnp.asarray(pre))
    tl, tcache = tarch.paged_prefill(
        tparams, torch.from_numpy(prompt[None, 8:]), tcache, 1,
        torch.from_numpy(suf), embeds=torch.from_numpy(emb[1:]),
        prefix_ids=torch.from_numpy(pre), start=8)
    close(tl, jl)
    assert_paged_caches_match(tcache, jcache, quant)
    assert int(tcache["len"][1]) == 14
    with pytest.raises(ValueError, match="ring_ids must be None"):
        tarch.paged_prefill(tparams, torch.from_numpy(prompt[None]), tcache,
                            0, torch.from_numpy(suf),
                            embeds=torch.from_numpy(emb[:1]),
                            ring_ids=torch.from_numpy(pre))


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_verify_rows_equal_decode(quant):
    """The verify step's cross-attention folds (head, query) rows into the
    head axis of ``decode_attention``: every row equals the single-query
    attention of the decode path bit for bit; and row 0 of a verify step
    over the pools gives the decode step's logits (allclose at 1e-6: the
    projections' products at Q rows and at one row sum in their own
    orders on the CPU; the attention itself is per row)."""
    _, _, tarch, tparams = setup("float32", quant)
    cfg = tarch.cfg
    p = tencdec._at(tparams["dec_stack"], 1)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5, cfg.d_model), generator=g)
    xk = torch.randn((3, cfg.n_kv_heads, cfg.enc_seq, cfg.hd), generator=g)
    xv = torch.randn((3, cfg.n_kv_heads, cfg.enc_seq, cfg.hd), generator=g)
    folded = tencdec._cross_decode(x, p, xk, xv, cfg)
    for j in range(5):
        one = tencdec._cross_decode(x[:, j:j + 1], p, xk, xv, cfg)
        assert torch.equal(folded[:, j:j + 1], one), j

    cache = tarch.init_paged_cache(2, TLayout(BLK, NBLOCKS, MAX_LEN),
                                   device="cpu")
    emb = torch.from_numpy(frames(cfg, 2))
    rng = np.random.default_rng(8)
    ids = [np.int32([3, 5, 9]), np.int32([7, 2])]
    for slot, n in enumerate((10, 7)):
        tarch.paged_prefill(tparams, torch.from_numpy(
            rng.integers(0, cfg.vocab, (1, n))), cache, slot,
            torch.from_numpy(ids[slot]), embeds=emb[slot:slot + 1])
    table = torch.zeros((2, MAX_LEN // BLK), dtype=torch.int32)
    table[0, :3], table[1, :2] = torch.from_numpy(ids[0]), \
        torch.from_numpy(ids[1])
    vt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 4)).astype(np.int32))
    snap = {k: v.clone() for k, v in cache.items()}
    vlog, _ = tarch.paged_verify_step(tparams, cache, vt, table)
    dlog, _ = tarch.paged_decode_step(tparams, snap, vt[:, 0].contiguous(),
                                      table)
    torch.testing.assert_close(vlog[:, 0], dlog, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_paged_insert_matches_reference(quant):
    """An arena prefill of ``max_len`` = 3 blocks spliced into pool blocks
    and slot 1's cross rows: the reference's pools, bit for bit on int8
    pools; a prefill that is not whole blocks is refused by both."""
    jarch, jparams, tarch, tparams = setup("float32", quant)
    cfg = tarch.cfg
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (1, 7))
    emb = frames(cfg, 1)
    n = 3 * BLK
    _, jsingle = jarch.prefill(jparams, jnp.asarray(toks), n,
                               embeds=jnp.asarray(emb))
    _, tsingle = tarch.prefill(tparams, torch.from_numpy(toks), n,
                               embeds=torch.from_numpy(emb))
    jcache = jarch.init_paged_cache(2, JLayout(BLK, NBLOCKS, MAX_LEN))
    tcache = tarch.init_paged_cache(2, TLayout(BLK, NBLOCKS, MAX_LEN),
                                    device="cpu")
    bid = np.int32([5, 1, 8])
    jcache = jarch.paged_insert(jcache, jsingle, 1, jnp.asarray(bid))
    out = tarch.paged_insert(tcache, tsingle, 1, torch.from_numpy(bid))
    assert out is tcache
    assert_paged_caches_match(tcache, jcache, quant)
    assert int(tcache["len"][1]) == 7
    short = torch.from_numpy(bid[:2])
    with pytest.raises(ValueError, match="12 != 2 blocks"):
        tarch.paged_insert(tcache, tsingle, 1, short)
    with pytest.raises(ValueError, match="12 != 2 blocks"):
        jarch.paged_insert(jcache, jsingle, 1, jnp.asarray(bid[:2]))


def test_forward_at_whisper_tiny_enc_full_width():
    """whisper-tiny-enc at its published widths (4 encoder and 4 decoder
    layers, d_model 384, 6 query and 6 kv heads of 64: a GQA group of 1,
    1500 frames, vocab 51865), float32, batch 1, an 8-token decoder
    input."""
    jarch, jparams, tarch, tparams = setup("float32", name="whisper-tiny-enc",
                                           smoke=False)
    cfg = tarch.cfg
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.enc_seq) == \
        (6, 6, 64, 1500)
    emb = frames(cfg, 1)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (1, 8))
    close(tarch.forward(tparams, torch.from_numpy(toks),
                        embeds=torch.from_numpy(emb)),
          jax.jit(jarch.forward)(jparams, jnp.asarray(toks),
                                 embeds=jnp.asarray(emb)))
