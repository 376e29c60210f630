"""PyTorch port vs JAX reference: the dense family on the arena and slot
backends, float caches (``serve_quant=False``), float32.

Function level, on one numpy weight tree for both packages
(``test_torch_serve.setup_pair``): ``forward`` logits, ``prefill`` logits
and every cache leaf (exact prompts, a right-padded prompt with
``true_len``, ``embeds`` in place of tokens, a prompt longer than
gemma3-4b-smoke's 16-row ring), ``init_cache`` shapes and dtypes, and a
few ``decode_step``s over a batch-2 arena whose rows sit at different
positions (one of them wrapping the ring), all allclose at
``rtol = atol = 1e-4`` (float32 reordering between XLA and PyTorch).

Engine level: the port's ``LLMEngine(backend="arena")`` and
``LLMEngine(backend="slot")`` give the JAX engines' greedy streams,
preemptions and every metric not read off the host clock on
``glm4-9b-smoke``, ``phi3-mini-3.8b-smoke`` and ``gemma3-4b-smoke``
(prompts of 1–39 tokens, so gemma3's rings take the rolled fill and wrap
in decode), with length-bucketed admission on and off, under the
``bounded`` (with a forced preemption) and ``fcfs`` schedulers. Seeded
sampled rows are reproducible; the port's arena gives its own paged
backend's greedy tokens; a ``serve_quant`` arch (glm4-9b, and
llava-next-34b on token prompts) serves on ``arena`` and ``slot`` with the
JAX engines' streams (the int8 arena step; its own files are
``test_torch_int8_arena.py``, ``test_torch_moe_int8_arena.py`` and
``test_torch_ring_int8_arena.py``).

A config with a tail layer is anchored on the port's own ``forward``, not
on the JAX arena: the reference's dense ``prefill`` writes a tail layer's
cache with the stacked ``[1, B, Hkv, S, hd]`` leaf where its ``fill``
reads ``shape[2]`` as the cache length
(``src/repro/models/transformer.py:931``). Smallest input:
``gemma3-4b-smoke`` with ``n_layers=10`` (layout ``('LLLLLG', 1,
'LLLL')``), a 20-token prompt, ``max_len`` 64: its tail ``k`` comes back
``(1, 2, 2, 16)`` where ``init_cache`` gives ``(1, 1, 2, 16, 16)``, and the
next ``decode_step`` raises ``ValueError: not enough values to unpack
(expected 4, got 3)`` (ROADMAP Queue C).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.cache import cache_insert as jcache_insert
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import LLMEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.models.cache import cache_insert as tcache_insert
from repro_torch.serve import EngineConfig, LLMEngine

from test_torch_chunked import shared_metrics_equal
from test_torch_serve import setup_pair, sync_reference_decode

torch.set_num_threads(1)

TOL = 1e-4
CONFIGS = ["glm4-9b", "phi3-mini-3.8b", "gemma3-4b"]
ENGINE_KW = dict(slots=4, max_len=64, admit_window=2)


def close(got, want, what=""):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert tuple(got.shape) == want.shape, (what, tuple(got.shape),
                                            want.shape)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL,
                               atol=TOL, err_msg=what)


def tree_close(got, want, what="cache"):
    """Every leaf of a port cache allclose to the JAX cache's."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            tree_close(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            tree_close(g, w, f"{what}[{i}]")
    else:
        close(got, want, what)


def tokens(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


def check_prefill_and_decode(name, lens, max_len=40, steps=4, **overrides):
    """Prefill one prompt a length of ``lens`` on both sides, splice each
    into a batch arena (``cache_insert``), then ``steps`` decode steps fed
    the reference's greedy tokens: logits and every cache leaf allclose
    after each call. Returns the port's arch."""
    jarch, jparams, tarch, tparams = setup_pair(name, False, **overrides)
    vocab = tarch.cfg.vocab
    jcache = jarch.init_cache(len(lens), max_len, quantized=False)
    tcache = tarch.init_cache(len(lens), max_len, quantized=False,
                              device="cpu")
    last = []
    for slot, n in enumerate(lens):
        t = tokens(vocab, n, seed=n)
        jl, jc1 = jax.jit(jarch.prefill, static_argnums=2)(
            jparams, jnp.asarray(t[None]), max_len)
        tl, tc1 = tarch.prefill(tparams, torch.from_numpy(t[None]), max_len)
        close(tl, jl, f"prefill logits, {n} tokens")
        tree_close(tc1, jc1, f"prefill cache, {n} tokens")
        jcache = jcache_insert(jcache, jc1, slot)
        tcache_insert(tcache, tc1, slot)
        last.append(int(jnp.argmax(jl[0])))
    jdec = jax.jit(jarch.decode_step)
    tok = np.int32(last)
    for step in range(steps):
        jl, jcache = jdec(jparams, jcache, jnp.asarray(tok))
        tl, tcache = tarch.decode_step(tparams, tcache,
                                       torch.from_numpy(tok))
        close(tl, jl, f"decode step {step} logits")
        tree_close(tcache, jcache, f"decode step {step} cache")
        tok = np.array(jnp.argmax(jl, axis=-1), np.int32)
    return tarch


@pytest.mark.parametrize("name", ["glm4-9b", "gemma3-4b"])
def test_forward_allclose(name):
    jarch, jparams, tarch, tparams = setup_pair(name, False)
    t = np.stack([tokens(tarch.cfg.vocab, 21, seed=s) for s in (1, 2)])
    want = jax.jit(jarch.forward)(jparams, jnp.asarray(t))
    close(tarch.forward(tparams, torch.from_numpy(t)), want, "forward")


def test_prefill_and_decode_steps_allclose():
    """Rows at 13 and 9 tokens: per-row positions through the decode."""
    check_prefill_and_decode("glm4-9b", [13, 9])


def test_ring_prefill_and_decode_steps_allclose():
    """gemma3-4b-smoke's 16-row rings: a 20-token prompt takes the rolled
    fill, a 14-token one wraps the ring on its third decode step."""
    tarch = check_prefill_and_decode("gemma3-4b", [20, 14], max_len=48)
    assert tarch.cfg.local_window == 16


@pytest.mark.parametrize("name", ["glm4-9b", "gemma3-4b"])
def test_prefill_true_len_and_embeds_allclose(name):
    """A 13-token prompt right-padded to 16 with ``true_len`` (pad entries
    included in the compared cache), and an ``embeds`` prompt."""
    jarch, jparams, tarch, tparams = setup_pair(name, False)
    cfg = tarch.cfg
    padded = np.zeros((1, 16), np.int32)
    padded[0, :13] = tokens(cfg.vocab, 13, seed=3)
    jl, jc = jax.jit(jarch.prefill, static_argnums=2)(
        jparams, jnp.asarray(padded), 32, true_len=jnp.int32(13))
    tl, tc = tarch.prefill(tparams, torch.from_numpy(padded), 32,
                           true_len=13)
    close(tl, jl, "padded logits")
    tree_close(tc, jc, "padded cache")
    assert tc["len"].tolist() == [13]
    # the pad tokens do not reach the real positions
    exact, _ = tarch.prefill(tparams, torch.from_numpy(padded[:, :13]), 32)
    torch.testing.assert_close(tl, exact, rtol=TOL, atol=TOL)

    emb = np.random.default_rng(4).standard_normal(
        (1, 11, cfg.d_model)).astype(np.float32)
    jl, jc = jax.jit(jarch.prefill, static_argnums=2)(
        jparams, None, 32, embeds=jnp.asarray(emb))
    tl, tc = tarch.prefill(tparams, None, 32, embeds=torch.from_numpy(emb))
    close(tl, jl, "embeds logits")
    tree_close(tc, jc, "embeds cache")
    jd, _ = jax.jit(jarch.decode_step)(jparams, jc, None,
                                       embeds=jnp.asarray(emb[:, :1]))
    td, _ = tarch.decode_step(tparams, tc, None,
                              embeds=torch.from_numpy(emb[:, :1]))
    close(td, jd, "embeds decode logits")


def test_prefill_requantizes_under_serve_quant():
    """A ``serve_quant`` arch's prefill stores the requantized integers in
    its float cache, as the reference's does; its decode step (W8A8
    projections, the ITA integer attention) follows the reference's."""
    jarch, jparams, tarch, tparams = setup_pair("glm4-9b", True)
    t = tokens(tarch.cfg.vocab, 12, seed=5)[None]
    jl, jc = jax.jit(jarch.prefill, static_argnums=2)(
        jparams, jnp.asarray(t), 32)
    tl, tc = tarch.prefill(tparams, torch.from_numpy(t), 32)
    close(tl, jl, "logits")
    tree_close(tc, jc)
    k = tc["stacks"][0]["k"]
    assert k.dtype == torch.float32 and torch.equal(k, k.round())
    tok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    jd, jc = jax.jit(jarch.decode_step)(jparams, jc, tok,
                                        qparams=jarch.quantize_params(jparams))
    td, tc = tarch.decode_step(tparams, tc, torch.from_numpy(np.array(tok)),
                               qparams=tarch.quantize_params(tparams))
    close(td, jd, "decode logits")
    tree_close(tc, jc)
    assert torch.equal(k, k.round())


@pytest.mark.parametrize("quantized", [False, True])
def test_init_cache_shapes_and_dtypes(quantized):
    jarch, _, tarch, _ = setup_pair("gemma3-4b", False, n_layers=10)
    want = jarch.init_cache(3, 40, quantized=quantized)
    got = tarch.init_cache(3, 40, quantized=quantized, device="cpu")
    wl, wdef = jax.tree_util.tree_flatten(want)
    gl, gdef = jax.tree_util.tree_flatten(got)
    assert gdef == wdef
    assert [(tuple(g.shape), str(g.dtype).split(".")[-1]) for g in gl] == \
        [(w.shape, str(w.dtype)) for w in wl]
    # L layers keep a ring of the window's rows, G layers max_len
    assert got["stacks"][0]["k"].shape[3] == 16
    assert got["stacks"][5]["k"].shape[3] == 40
    assert got["tail"][0]["k"].shape == (1, 3, 2, 16, 16)


def prompts_for(vocab, n=6, seed=1):
    """1–39-token prompts, with a 1- and a 2-token one among them."""
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, vocab, int(rng.integers(3, 40))).astype(np.int32)
           for _ in range(n)]
    out[2:2] = [np.int32([7]), np.int32([7, 9])]
    return out


def identity_cell(name, backend, buckets, scheduler, max_new=10,
                  quant=False, engine=None, **overrides):
    """The port and the JAX engine serve the same prompts on ``backend``:
    equal streams, preemptions and shared metrics (``quant``: the
    ``serve_quant`` arch, W8A8 where the family quantizes its weights;
    ``engine`` replaces ``ENGINE_KW``). Returns the port's requests."""
    jarch, jparams, tarch, tparams = setup_pair(name, quant, **overrides)
    kw = dict(engine or ENGINE_KW, backend=backend, scheduler=scheduler,
              prefill_buckets=buckets)
    je = JEngine(jarch, jparams, JEngineConfig(**kw))
    if backend == "arena":  # the slot backend syncs to the host a token
        sync_reference_decode(je)
    te = LLMEngine(tarch, tparams, EngineConfig(**kw), device="cpu")
    assert (te.qparams is not None) == (
        quant and tarch.quantize_params is not None)
    prompts = prompts_for(tarch.cfg.vocab)
    jh = [je.add_request(p, max_new_tokens=max_new) for p in prompts]
    th = [te.add_request(p, max_new_tokens=max_new) for p in prompts]
    je.run_until_drained()
    te.run_until_drained()
    jreqs = [je.request(h) for h in jh]
    treqs = [te.request(h) for h in th]
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [r.preemptions for r in treqs] == [r.preemptions for r in jreqs]
    assert all(len(r.output) == max_new and r.finish_reason == "length"
               for r in treqs)
    if scheduler == "bounded":
        assert sum(r.preemptions for r in treqs) >= 1
    shared_metrics_equal(te.metrics(), je.metrics())
    return treqs


@pytest.mark.parametrize("scheduler", ["bounded", "fcfs"])
@pytest.mark.parametrize("buckets", [True, False], ids=["buckets", "exact"])
@pytest.mark.parametrize("name", CONFIGS)
def test_arena_streams_match_reference(name, buckets, scheduler):
    identity_cell(name, "arena", buckets, scheduler)


@pytest.mark.parametrize("name", CONFIGS)
def test_slot_streams_match_reference(name):
    identity_cell(name, "slot", True, "bounded")


def test_bucketed_admission_pads_where_the_reference_does():
    """The arena prefills a bucket-padded prompt with ``true_len`` unless
    the bucket passes a ring window (gemma3-4b-smoke: 16), and the exact
    prompt with ``prefill_buckets`` off."""
    seen = {}
    for name in ("glm4-9b", "gemma3-4b"):
        for buckets in (True, False):
            _, _, tarch, tparams = setup_pair(name, False)
            calls = []
            prefill = tarch.prefill

            def spy(params, toks, max_len, **kw):
                calls.append((toks.shape[1], kw.get("true_len")))
                return prefill(params, toks, max_len, **kw)

            eng = LLMEngine(dataclasses.replace(tarch, prefill=spy), tparams,
                            EngineConfig(backend="arena", prefill_buckets=
                                         buckets, **ENGINE_KW), device="cpu")
            for n in (1, 5, 13, 16, 17, 30):
                eng.add_request(tokens(tarch.cfg.vocab, n, n),
                                max_new_tokens=2)
            eng.run_until_drained()
            seen[name, buckets] = calls
    assert seen["glm4-9b", True] == [(8, 1), (8, 5), (16, 13), (16, 16),
                                     (32, 17), (32, 30)]
    assert seen["gemma3-4b", True] == [(8, 1), (8, 5), (16, 13), (16, 16),
                                       (17, None), (30, None)]
    for name in ("glm4-9b", "gemma3-4b"):
        assert seen[name, False] == [(n, None) for n in (1, 5, 13, 16, 17,
                                                         30)]


def test_sampled_rows_reproducible_and_greedy_rows_unchanged():
    _, _, tarch, tparams = setup_pair("glm4-9b", False)
    prompts = prompts_for(tarch.cfg.vocab, n=2, seed=3)

    def serve(sample):
        eng = LLMEngine(tarch, tparams, EngineConfig(
            backend="arena", slots=4, max_len=64, admit_batch=4, seed=7),
            device="cpu")
        hs = []
        for rid, p in enumerate(prompts):
            temp, top_k = (0.9, 20) if rid % 2 and sample else (None, 0)
            hs.append(eng.add_request(p, max_new_tokens=8, temperature=temp,
                                      top_k=top_k, rid=rid))
        eng.run_until_drained()
        return [eng.request(h).output for h in hs]

    first, second, greedy = serve(True), serve(True), serve(False)
    assert first == second
    assert [first[i] for i in (0, 2)] == [greedy[i] for i in (0, 2)]
    assert [first[i] for i in (1, 3)] != [greedy[i] for i in (1, 3)]


@pytest.mark.parametrize("name", ["glm4-9b", "gemma3-4b"])
def test_arena_matches_own_paged_backend(name):
    """The identity the reference asserts for itself
    (``test_paged_dense_identity_matrix``): float32 greedy streams of the
    arena and the paged backend (ring pools for gemma3-4b) are equal."""
    _, _, tarch, tparams = setup_pair(name, False)
    prompts = prompts_for(tarch.cfg.vocab, seed=6)
    out = {}
    for backend in ("arena", "paged"):
        eng = LLMEngine(tarch, tparams, EngineConfig(
            backend=backend, scheduler="fcfs", block_len=8, **ENGINE_KW),
            device="cpu")
        hs = [eng.add_request(p, max_new_tokens=12) for p in prompts]
        eng.run_until_drained()
        out[backend] = [eng.request(h).output for h in hs]
    assert out["arena"] == out["paged"]


def greedy_by_forward(tarch, tparams, prompt, max_new):
    """Greedy decoding by re-running ``forward`` on the whole sequence."""
    seq = list(prompt)
    for _ in range(max_new):
        logits = tarch.forward(tparams, torch.tensor([seq]))
        seq.append(int(torch.argmax(logits[0, -1])))
    return seq[len(prompt):]


def test_tail_config_serves_as_its_own_forward():
    """``gemma3-4b-smoke`` with ``n_layers=10`` (four tail layers): arena
    and slot tokens equal greedy decoding with the port's ``forward`` on a
    20-token prompt (past the 16-row ring) and a 9-token one."""
    _, _, tarch, tparams = setup_pair("gemma3-4b", False, n_layers=10)
    assert tarch.cfg.layer_layout() == ("LLLLLG", 1, "LLLL")
    prompts = [tokens(tarch.cfg.vocab, 20, 8), tokens(tarch.cfg.vocab, 9, 9)]
    want = [greedy_by_forward(tarch, tparams, p, 10) for p in prompts]
    for backend in ("arena", "slot"):
        eng = LLMEngine(tarch, tparams, EngineConfig(backend=backend,
                                                     **ENGINE_KW),
                        device="cpu")
        hs = [eng.add_request(p, max_new_tokens=10) for p in prompts]
        eng.run_until_drained()
        assert [eng.request(h).output for h in hs] == want, backend


def test_tail_config_prefill_cache_has_init_cache_shapes():
    """Where the reference's prefill drops the tail leaf's leading axis,
    the port's keeps ``init_cache``'s shapes, and its decode runs."""
    _, _, tarch, tparams = setup_pair("gemma3-4b", False, n_layers=10)
    t = torch.from_numpy(tokens(tarch.cfg.vocab, 20, 10)[None])
    _, cache = tarch.prefill(tparams, t, 64)
    want = tarch.init_cache(1, 64, quantized=False, device="cpu")
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), (cache, want))
    assert shapes[0] == shapes[1]
    assert cache["tail"][0]["k"].shape == (1, 1, 2, 16, 16)
    logits, cache = tarch.decode_step(tparams, cache, t[:, -1])
    assert logits.shape == (1, tarch.cfg.vocab)
    assert cache["len"].tolist() == [21]


# two slots, a shorter max_len: a smaller arena than the int8 files' cells
SMALL_ENGINE = dict(slots=2, max_len=48, admit_window=1)


@pytest.mark.parametrize("backend", ["arena", "slot"])
@pytest.mark.parametrize("name", ["glm4-9b", "llava-next-34b"])
def test_serve_quant_serves_on_arena_and_slot(name, backend):
    """The configs' default ``serve_quant`` (the int8 arena step, W8A8
    weights built by the backend) on two slots: the JAX engines'
    streams."""
    assert tconfigs.smoke_config(name).serve_quant
    identity_cell(name, backend, True, "fcfs", max_new=6, quant=True,
                  engine=SMALL_ENGINE)
