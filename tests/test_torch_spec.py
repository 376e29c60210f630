"""PyTorch port vs JAX reference: speculative decoding on the paged path.

* The n-gram drafter and greedy acceptance (``serve/spec.py``, pure Python)
  agree with the reference's on random and periodic token lists.
* The verify plain versions (what kernels B4/B5 are held to on the card)
  agree with the reference's verify oracles and Pallas verify kernels run
  in interpret mode, at atol 1e-5 in float32 (f32 reordering only), with
  GQA groups, sliding windows and per-row start offsets; at ``Q == 1`` they
  are exactly the port's decode plain versions. Their split-KV model (the
  kernels' flash decoding) agrees with them at the same 1e-5, and its row
  0 equals the decode's split model bit for bit.
* End to end, the port's greedy streams equal the (synchronised) JAX
  engine's with ``spec_tokens`` in {1, 3}, float and int8 pools (int8
  anchored on ``attn_backend="interpret"``, the kernel contract), prefix
  cache off here and on in ``test_torch_prefix_cache.py``; and within the port spec on equals spec off for greedy
  and sampled requests, with the block partition and frontier invariants
  holding after every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.kernel import (
    paged_attention_verify_int8_pallas, paged_attention_verify_pallas,
)
from repro.kernels.paged_attention.ref import (
    paged_attention_verify_int8_dequant_ref as j_verify_int8_ref,
)
from repro.kernels.paged_attention.ref import (
    paged_attention_verify_ref as j_verify_ref,
)
from repro.models.attention import Q_SCALE as J_Q_SCALE
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import LLMEngine as JEngine
from repro.serve.spec import accept_tokens as j_accept_tokens
from repro.serve.spec import ngram_propose as j_ngram_propose
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_int8_dequant_ref, paged_attention_ref,
    paged_attention_verify_int8_dequant_ref, paged_attention_verify_ref,
)
from repro_torch.serve import EngineConfig, LLMEngine, RequestState
from repro_torch.serve.spec import accept_tokens, ngram_propose

from test_torch_paged_attention import SPLIT_M, split_case
from test_torch_serve import CONFIGS, setup_pair, sync_reference_decode

torch.set_num_threads(1)

ATOL = 1e-5  # f32 flash reordering only
BLK = 8


# ---------------------------------------------------------------------------
# Drafter and acceptance
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "periodic"])
def test_ngram_propose_matches_reference(kind):
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    if kind == "random":
        tokens = st.lists(st.integers(0, 6), max_size=40)
    else:
        tokens = st.builds(
            lambda period, n, noise: (np.tile(period, n)[:n * len(period)
                                                        - noise]).tolist(),
            st.lists(st.integers(0, 50), min_size=1, max_size=4),
            st.integers(1, 12), st.integers(0, 3))

    @settings(max_examples=300, deadline=None, derandomize=True)
    @given(toks=tokens, k=st.integers(0, 6), max_n=st.integers(1, 4),
           min_n=st.integers(1, 2))
    def check(toks, k, max_n, min_n):
        assert ngram_propose(toks, k, max_n=max_n, min_n=min_n) == \
            j_ngram_propose(toks, k, max_n=max_n, min_n=min_n)

    check()


def test_accept_tokens_matches_reference():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=300, deadline=None, derandomize=True)
    @given(draft=st.lists(st.integers(0, 2), max_size=6), data=st.data())
    def check(draft, data):
        chosen = data.draw(st.lists(st.integers(0, 2), min_size=len(draft) + 1,
                                    max_size=len(draft) + 1))
        got = accept_tokens(draft, chosen)
        assert got == j_accept_tokens(draft, chosen)
        assert 1 <= len(got) <= len(draft) + 1

    check()
    with pytest.raises(ValueError, match="len\\(draft\\) \\+ 1"):
        accept_tokens([1, 2], [1, 2])


# ---------------------------------------------------------------------------
# Verify plain versions (kernels B4 and B5)
# ---------------------------------------------------------------------------


def _verify_case(seed, *, int8, qlen, b=4, hq=8, hkv=2, blk=8, d=16, n=14,
                 m=5, start=False):
    """Pools, table, lens ≥ 1 (row 0 of one batch row on a single key) and
    an optional start; the last row's last query reaches the table's end."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, hq, qlen, d)) * 2.0).astype(np.float32)
    shape = (n, hkv, blk, d)
    if int8:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
    table = np.stack([rng.permutation(np.arange(1, n))[:m]
                      for _ in range(b)]).astype(np.int32)
    st = np.zeros(b, np.int32)
    if start:
        st = (rng.integers(0, 3, b) * blk).astype(np.int32)
        st[0] = 0
    lens = np.asarray([1, 7, 23, m * blk - qlen + 1], np.int32)[:b] + st
    ks = rng.uniform(0.01, 0.05, n).astype(np.float32)
    vs = rng.uniform(0.01, 0.05, n).astype(np.float32)
    return q, k, v, table, lens, (st if start else None), ks, vs


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("qlen", [1, 3])
@pytest.mark.parametrize("window,start", [(None, False), (10, True)],
                         ids=["full", "window-start"])
@pytest.mark.parametrize("group", [1, 4])
def test_verify_plain_float_matches_reference(qlen, window, start, group):
    q, k, v, table, lens, st, _, _ = _verify_case(
        1, int8=False, qlen=qlen, hq=2 * group, start=start)
    t = paged_attention_verify_ref(_t(q), _t(k), _t(v), _t(table), _t(lens),
                                   window=window, start=_t(st))
    jr = j_verify_ref(_j(q), _j(k), _j(v), _j(table), _j(lens),
                      window=window, start=_j(st))
    np.testing.assert_allclose(t.numpy(), np.asarray(jr), atol=ATOL, rtol=0)
    jk = paged_attention_verify_pallas(
        _j(q), _j(k), _j(v), _j(table), _j(lens), window=window,
        start=_j(st), interpret=True)
    np.testing.assert_allclose(t.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
    # the public op on a CPU tensor is exactly the plain version
    o = ops.paged_attention_verify(_t(q), _t(k), _t(v), _t(table), _t(lens),
                                   window=window, start=_t(st))
    assert torch.equal(o, t)
    if qlen == 1:  # Q = 1 is the decode step, exactly
        dec = paged_attention_ref(_t(q), _t(k), _t(v), _t(table), _t(lens),
                                  window=window, start=_t(st))
        assert torch.equal(t, dec)


@pytest.mark.parametrize("qlen", [1, 3])
@pytest.mark.parametrize("window,start", [(None, False), (10, True)],
                         ids=["full", "window-start"])
@pytest.mark.parametrize("group", [1, 4])
def test_verify_plain_int8_matches_reference(qlen, window, start, group):
    q, k, v, table, lens, st, ks, vs = _verify_case(
        2, int8=True, qlen=qlen, hq=2 * group, start=start)
    t = paged_attention_verify_int8_dequant_ref(
        _t(q), _t(k), _t(v), _t(table), _t(lens), k_scale=_t(ks),
        v_scale=_t(vs), window=window, start=_t(st))
    jr = j_verify_int8_ref(_j(q), _j(k), _j(v), _j(table), _j(lens),
                           k_scale=_j(ks), v_scale=_j(vs), window=window,
                           start=_j(st))
    np.testing.assert_allclose(t.numpy(), np.asarray(jr), atol=ATOL, rtol=0)
    jk = paged_attention_verify_int8_pallas(
        _j(q), _j(k), _j(v), _j(table), _j(lens), _j(ks), _j(vs),
        q_scale=J_Q_SCALE, window=window, start=_j(st), interpret=True)
    np.testing.assert_allclose(t.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
    o = ops.paged_attention_verify_int8(
        _t(q), _t(k), _t(v), _t(table), _t(lens), k_scale=_t(ks),
        v_scale=_t(vs), window=window, start=_t(st))
    assert torch.equal(o, t)
    if qlen == 1:
        dec = paged_attention_int8_dequant_ref(
            _t(q), _t(k), _t(v), _t(table), _t(lens), k_scale=_t(ks),
            v_scale=_t(vs), window=window, start=_t(st))
        assert torch.equal(t, dec)


@pytest.mark.parametrize("split_entries", [1, 2, 3, SPLIT_M])
@pytest.mark.parametrize("qlen", [1, 5])
@pytest.mark.parametrize("window,start", [(None, False), (10, True)],
                         ids=["full", "window-start"])
@pytest.mark.parametrize("pool", ["f32", "int8"])
def test_verify_split_model_matches_dense_and_decode(pool, window, start,
                                                     qlen, split_entries):
    """The split model of verify (kernels B4/B5) equals the dense verify
    plain version up to f32 reordering, with lens on and beside split
    boundaries; and row 0 of it — all of it at Q = 1 — equals the split
    model of decode at the same lens bit for bit, as the kernels must."""
    int8 = pool == "int8"
    args, kw = split_case(6, int8=int8, qlen=qlen, start=start)
    kw["window"] = window
    ver = (paged_attention_verify_int8_dequant_ref if int8
           else paged_attention_verify_ref)
    dec = paged_attention_int8_dequant_ref if int8 else paged_attention_ref
    split = ver(*args, **kw, split_entries=split_entries)
    torch.testing.assert_close(split, ver(*args, **kw), atol=ATOL, rtol=0)
    q1 = args[0][:, :, :1].contiguous()
    d1 = dec(q1, *args[1:], **kw, split_entries=split_entries)
    assert torch.equal(split[:, :, :1], d1)
    if qlen == 1:
        assert torch.equal(split, d1)


def test_verify_row_j_is_decode_at_lens_plus_j():
    """Each verify row equals the decode plain version run at that row's
    effective length (the per-row mask contract)."""
    q, k, v, table, lens, _, _, _ = _verify_case(3, int8=False, qlen=4)
    t = paged_attention_verify_ref(_t(q), _t(k), _t(v), _t(table), _t(lens))
    for j in range(4):
        dec = paged_attention_ref(_t(q[:, :, j:j + 1]), _t(k), _t(v),
                                  _t(table), _t(lens + j))
        torch.testing.assert_close(t[:, :, j:j + 1], dec, atol=ATOL, rtol=0)


def test_verify_ops_reject_bad_inputs():
    q, k, v, table, lens, _, ks, vs = _verify_case(4, int8=True, qlen=2)
    with pytest.raises(ValueError, match="float pools"):
        ops.paged_attention_verify(_t(q), _t(k), _t(v), _t(table), _t(lens))
    qf, kf, vf, *_ = _verify_case(4, int8=False, qlen=2)
    with pytest.raises(ValueError, match="int8 pools"):
        ops.paged_attention_verify_int8(_t(qf), _t(kf), _t(vf), _t(table),
                                        _t(lens))
    with pytest.raises(ValueError, match=r"\[B, Hq, 1, D\]"):
        ops.paged_attention(_t(qf), _t(kf), _t(vf), _t(table), _t(lens))
    # glm4-9b's verify at k = 4 (80 folded rows) and its decode (16) each
    # run in one row chunk; past a block's 112 rows, balanced chunks
    assert ops.row_chunks(16, 5, 128) == (80, 1)
    assert ops.row_chunks(16, 1, 128) == (16, 1)
    assert ops.row_chunks(16, 8, 128) == (64, 2)


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------


def spec_prompts(vocab, n=6, seed=1):
    """A shared two-block system prompt plus per-request period-3 suffixes,
    so the drafter always finds a trailing match and admissions hit the
    prefix cache."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 2 * BLK + 3)
    out = []
    for _ in range(n):
        period = rng.integers(0, vocab, 3)
        suffix = np.tile(period, 10)[:int(rng.integers(4, 20))]
        out.append(np.concatenate([shared, suffix]).astype(np.int32))
    return out


def assert_partition(eng):
    a = eng.alloc
    assert (a.free_blocks + a.live_blocks + a.cached_blocks
            == eng.layout.usable_blocks)
    assert a.reserved_unallocated >= 0


def assert_frontier_blocks(eng):
    """Every running slot covers its committed frontier and never holds
    blocks past its worst-case reservation."""
    blk = eng.ec.block_len
    for i, r in enumerate(eng.slots):
        if r is None or r.state != RequestState.RUNNING:
            continue
        n = eng.backend._slot_len[i]
        need = (n - 1) // blk + 1
        cap = (len(r.prompt) + r.max_new_tokens - 2) // blk + 1
        owned = len(eng.alloc.owned(r.rid))
        assert need <= owned <= cap, (i, owned, n)


ENGINE_KW = dict(slots=4, max_len=64, admit_window=2, block_len=BLK)


def spec_identity_cell(name, k, quant, prefix, **overrides):
    """One cell of the identity matrix: the port and the synchronised JAX
    engine serve the same shared-prefix workload with ``spec_tokens=k``;
    greedy streams, preemptions and the spec / prefix counters agree, and
    the port's invariants hold after every step. ``overrides`` replace
    config fields on both sides."""
    jarch, jparams, tarch, tparams = setup_pair(name, quant, **overrides)
    kw = dict(ENGINE_KW, spec_tokens=k, prefix_cache=prefix)
    je = sync_reference_decode(JEngine(jarch, jparams, JEngineConfig(
        backend="paged", attn_backend="interpret" if quant else "xla",
        **kw)))
    te = LLMEngine(tarch, tparams, EngineConfig(backend="paged", **kw),
                   device="cpu")
    prompts = spec_prompts(tarch.cfg.vocab)
    jh = [je.add_request(p, max_new_tokens=10) for p in prompts]
    th = [te.add_request(p, max_new_tokens=10) for p in prompts]
    je.run_until_drained()
    while not te.idle:
        te.step()
        assert_partition(te)
        assert_frontier_blocks(te)
    jreqs = [je.request(h) for h in jh]
    treqs = [te.request(h) for h in th]
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [r.preemptions for r in treqs] == [r.preemptions for r in jreqs]
    assert sum(r.preemptions for r in treqs) >= 1
    assert all(len(r.output) == 10 for r in treqs)
    m, jm = te.metrics(), je.metrics()
    assert m["spec_drafted"] == jm["spec_drafted"] > 0
    assert m["spec_accepted"] == jm["spec_accepted"]
    if prefix:
        assert m["prefix_cache_hit_blocks"] == jm["prefix_cache_hit_blocks"] > 0
        assert m["prefill_tokens_skipped"] == jm["prefill_tokens_skipped"]
    assert te.alloc.live_blocks == 0


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("name", CONFIGS)
def test_spec_greedy_identity_with_reference(name, k, quant):
    """Prefix cache off (the cache-on cells are in
    ``test_torch_prefix_cache.py``)."""
    spec_identity_cell(name, k, quant, prefix=False)


@pytest.mark.parametrize("prefix", [False, True], ids=["cache-off", "cache-on"])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_port_spec_on_equals_spec_off(quant, prefix):
    """Within the port: greedy and sampled requests (keyed by seed, rid and
    absolute output index) commit the same streams with spec on and off;
    invariants hold after every step and a rejected draft's grown block
    is rolled back."""
    _, _, tarch, tparams = setup_pair("phi3-mini-3.8b", quant)
    prompts = spec_prompts(tarch.cfg.vocab, n=6, seed=4)

    def run(k):
        eng = LLMEngine(tarch, tparams, EngineConfig(
            backend="paged", **ENGINE_KW, spec_tokens=k, prefix_cache=prefix,
            seed=3),
            device="cpu")
        dropped = []
        commit = eng.backend.commit

        def spy(slot, req, accepted):
            before = len(eng.alloc.owned(req.rid))
            commit(slot, req, accepted)
            dropped.append(before - len(eng.alloc.owned(req.rid)))

        eng.backend.commit = spy
        for rid, p in enumerate(prompts):
            eng.add_request(p, max_new_tokens=12, rid=rid,
                            temperature=0.9 if rid % 2 else None,
                            top_k=5 if rid % 2 else 0)
        while not eng.idle:
            eng.step()
            assert_partition(eng)
            assert_frontier_blocks(eng)
        assert eng.alloc.live_blocks == 0
        return eng, {rid: eng.request(rid).output for rid in range(6)}, dropped

    _, base, _ = run(0)
    eng, out, dropped = run(3)
    assert out == base
    assert all(len(o) == 12 for o in out.values())
    m = eng.metrics()
    assert m["spec_drafted"] > 0 and 0 <= m["spec_accepted"] <= m["spec_drafted"]
    assert m["decode_dispatches"] <= m["iterations"]
    assert any(dropped)   # some rejected draft span crossed a block boundary
