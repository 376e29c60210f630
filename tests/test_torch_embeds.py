"""PyTorch port vs JAX reference: ``embeds`` requests on the vlm-dense
family, and the cache utilities of the non-paged surface.

``llava-next-34b-smoke`` (float32) requests carry their prompt's
embeddings (``embeds`` [n, d_model], the stubbed vision frontend) beside
placeholder token ids; the generated tokens go through the token
embedding. Against the synchronised JAX engines:

* where the reference is well defined — every prefill of a request sees
  its whole prompt from position 0 — the port's greedy streams equal the
  reference's on ``arena``, ``slot`` and ``paged``, float and int8
  (``serve_quant``), and in float both equal the model's own ``forward``
  over the prompt embeddings followed by the generated tokens;
* where the reference writes every row of ``embeds`` into fewer blocks (a
  prefix-cache hit, a chunk shorter than the prompt), both raise the same
  ``ValueError``;
* where the reference computes something else than its own ``forward``
  (ROADMAP Queue C: a preempted request's re-prefill, which carries its
  generated tokens after the prompt, and a prefix-cache hit with room to
  spare in the admission bucket), the fault is pinned on the reference and
  the port follows its own ``forward``;

and ``cache.paged_insert_kv`` (stacked and unstacked pools, a length that
is not whole blocks refused), ``transformer.paged_insert`` and
``cache.cache_reset`` equal the reference's; ``registry.build`` takes every
config.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cache as jcache_mod
from repro.models.cache import PagedLayout as JLayout
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import LLMEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.models import cache as tcache_mod
from repro_torch.models import registry as tregistry
from repro_torch.models.cache import PagedLayout as TLayout
from repro_torch.serve import EngineConfig, LLMEngine

from test_torch_serve import setup_pair, sync_reference_decode

torch.set_num_threads(1)

NAME = "llava-next-34b"
MAX_NEW = 6


def vlm_requests(cfg, lens, seed=1):
    """(placeholder prompt, prompt embeddings) pairs of the given lengths."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab, n).astype(np.int32),
             (0.5 * rng.standard_normal((n, cfg.d_model))).astype(np.float32))
            for n in lens]


def own_forward_greedy(tarch, tparams, emb, n_new=MAX_NEW):
    """Greedy tokens of the port's ``forward`` over the prompt embeddings
    followed by the token embeddings of what it generated so far."""
    x = torch.from_numpy(emb)[None]
    out = []
    for _ in range(n_new):
        t = int(torch.argmax(tarch.forward(tparams, None, embeds=x)[0, -1]))
        out.append(t)
        x = torch.cat([x, tparams["embed"][[t]][None].to(x.dtype)], 1)
    return out


def serve_pair(quant, reqs, name=NAME, **engine_kw):
    """The requests through the JAX engine and the port (same config);
    returns (JAX outputs or the exception it raised, port outputs or the
    exception, port requests, port arch and params)."""
    jarch, jparams, tarch, tparams = setup_pair(name, quant)
    kw = dict(dict(slots=2, max_len=48, admit_window=2), **engine_kw)
    jkw = dict(kw)
    if kw["backend"] == "paged":
        jkw["attn_backend"] = "interpret" if quant else "xla"
    je = JEngine(jarch, jparams, JEngineConfig(**jkw))
    if kw["backend"] != "slot":    # the JAX slot backend has no cache
        sync_reference_decode(je)
    te = LLMEngine(tarch, tparams, EngineConfig(**kw), device="cpu")
    outs, treqs = [], None
    for eng in (je, te):
        try:
            hs = [eng.add_request(p, max_new_tokens=MAX_NEW, embeds=e)
                  for p, e in reqs]
            eng.run_until_drained()
            outs.append([eng.request(h).output for h in hs])
            treqs = [eng.request(h) for h in hs]
        except ValueError as e:
            outs.append(e)
    return outs[0], outs[1], treqs, tarch, tparams


def test_forward_with_embeds_matches_reference():
    for name in (NAME, "dinov2-s"):
        jarch, jparams, tarch, tparams = setup_pair(name, False)
        (_, emb), = vlm_requests(tarch.cfg, [13])
        want = jarch.forward(jparams, None, embeds=jnp.asarray(emb)[None])
        got = tarch.forward(tparams, None, embeds=torch.from_numpy(emb)[None])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("backend", ["arena", "slot", "paged"])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_embeds_streams_match_reference(quant, backend):
    """Four requests on four slots (no preemption), length-bucketed
    admission on arena and paged."""
    cfg = tconfigs.smoke_config(NAME)
    reqs = vlm_requests(cfg, [5, 11, 20, 9])
    jout, tout, treqs, tarch, tparams = serve_pair(
        quant, reqs, backend=backend, slots=4, block_len=4)
    assert tout == jout
    assert all(r.preemptions == 0 for r in treqs)
    if not quant:
        assert tout == [own_forward_greedy(tarch, tparams, e)
                        for _, e in reqs]


@pytest.mark.parametrize("backend,kw", [
    ("arena", {}), ("arena", dict(prefill_buckets=False)),
    ("paged", dict(block_len=4)), ("paged", dict(block_len=4, spec_tokens=2))],
    ids=["arena", "arena-exact", "paged", "paged-spec"])
def test_preempted_reprefill_follows_own_forward(backend, kw):
    """ROADMAP Queue C: two slots, six requests; request 1 (11 tokens) is
    preempted after four tokens. Its re-prefill carries prompt and output:
    the reference attends the prompt's 11 embedding rows only and repeats
    itself after the boundary; the port continues the prompt embeddings
    with the generated tokens' and gives its own ``forward``'s stream, as
    every other request does on both."""
    cfg = tconfigs.smoke_config(NAME)
    reqs = vlm_requests(cfg, [5, 11, 20, 9, 10, 14])
    jout, tout, treqs, tarch, tparams = serve_pair(False, reqs,
                                                   backend=backend, **kw)
    want = [own_forward_greedy(tarch, tparams, e) for _, e in reqs]
    assert [r.preemptions for r in treqs] == [0, 1, 0, 0, 0, 0]
    assert tout == want
    assert jout[1] != want[1] and jout[1][:4] == want[1][:4]
    assert [o for i, o in enumerate(jout) if i != 1] == \
        [w for i, w in enumerate(want) if i != 1]


@pytest.mark.parametrize("kw", [
    dict(prefix_cache=True), dict(prefix_cache=True, prefill_buckets=False),
    dict(prefill_chunk_tokens=8)], ids=["prefix-hit", "prefix-hit-exact",
                                        "chunk8"])
def test_block_short_prefills_raise_as_reference(kw):
    """The reference writes every row of ``embeds`` into the blocks of the
    call: a prefix-cache resume (here the preempted request's, over its
    own published blocks) or a chunk shorter than the prompt raises; the
    port raises the same error."""
    cfg = tconfigs.smoke_config(NAME)
    reqs = vlm_requests(cfg, [5, 11, 20, 9, 10, 14])
    jout, tout, _, _, _ = serve_pair(False, reqs, backend="paged",
                                     block_len=4, **kw)
    assert isinstance(jout, ValueError) and isinstance(tout, ValueError)
    assert str(tout) == str(jout)
    assert "exceeds" in str(tout)


def test_prefix_hit_with_bucket_room_follows_own_forward():
    """ROADMAP Queue C: one slot, the same 6-token request twice with the
    prefix cache, ``min_bucket`` 16 and an ``admit_window`` that lets the
    first finish unpreempted: the second admission hits the first's
    block and resumes at position 4 over two suffix blocks, room for all
    6 embedding rows; the reference writes the whole prompt's embeddings
    from position 4 and its stream leaves its ``forward``'s, the port's
    does not."""
    cfg = tconfigs.smoke_config(NAME)
    reqs = vlm_requests(cfg, [6]) * 2
    jout, tout, _, tarch, tparams = serve_pair(
        False, reqs, backend="paged", slots=1, block_len=4,
        prefix_cache=True, min_bucket=16, admit_window=16)
    want = own_forward_greedy(tarch, tparams, reqs[0][1])
    assert tout == [want, want]
    assert jout[0] == want and jout[1] != want


@pytest.mark.parametrize("stacked", [True, False])
def test_paged_insert_kv_matches_reference(stacked):
    rng = np.random.default_rng(0)
    lead = (3,) if stacked else ()
    pool = rng.standard_normal(lead + (10, 2, 4, 8)).astype(np.float32)
    single = rng.standard_normal(lead + (1, 2, 12, 8)).astype(np.float32)
    ids = np.int32([7, 2, 5])
    want = jcache_mod.paged_insert_kv(jnp.asarray(pool), jnp.asarray(single),
                                      jnp.asarray(ids))
    tpool = torch.from_numpy(pool.copy())
    got = tcache_mod.paged_insert_kv(tpool, torch.from_numpy(single),
                                     torch.from_numpy(ids))
    assert got is tpool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for bad in (ids[:2], np.int32([7, 2, 5, 1])):
        with pytest.raises(ValueError) as jerr:
            jcache_mod.paged_insert_kv(jnp.asarray(pool), jnp.asarray(single),
                                       jnp.asarray(bad))
        with pytest.raises(ValueError) as terr:
            tcache_mod.paged_insert_kv(tpool, torch.from_numpy(single),
                                       torch.from_numpy(bad))
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_dense_paged_insert_matches_reference(quant):
    """A glm4-9b-smoke arena prefill (``max_len`` three blocks) spliced
    into pool blocks of every layer and slot 1's position."""
    jarch, jparams, tarch, tparams = setup_pair("glm4-9b", quant)
    toks = np.random.default_rng(2).integers(0, tarch.cfg.vocab, (1, 9))
    _, js = jarch.prefill(jparams, jnp.asarray(toks), 12)
    _, ts = tarch.prefill(tparams, torch.from_numpy(toks), 12)
    jc = jarch.init_paged_cache(2, JLayout(4, 10, 32))
    tc = tarch.init_paged_cache(2, TLayout(4, 10, 32), device="cpu")
    ids = np.int32([3, 8, 1])
    jc = jarch.paged_insert(jc, js, 1, jnp.asarray(ids))
    assert tarch.paged_insert(tc, ts, 1, torch.from_numpy(ids)) is tc
    for i, (t, j) in enumerate(zip(tc["stacks"], jc["stacks"])):
        assert t.keys() == j.keys()
        for k in t:
            if quant or k.endswith("scale"):
                np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                              err_msg=f"{i}.{k}")
            else:
                np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=f"{i}.{k}")
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_cache_reset_matches_reference():
    lens = np.int32([4, 9, 2])
    want = jcache_mod.cache_reset({"len": jnp.asarray(lens)}, 1)
    cache = {"len": torch.from_numpy(lens.copy()), "k": torch.zeros(2)}
    assert tcache_mod.cache_reset(cache, 1) is cache
    np.testing.assert_array_equal(cache["len"].numpy(),
                                  np.asarray(want["len"]))


def test_registry_builds_every_config():
    """Every config builds; the families serve on the reference's
    backends; the attention-cache families bind ``paged_insert``."""
    for name, cfg in tconfigs.all_configs().items():
        arch = tregistry.build(cfg)
        paged = cfg.family not in ("ssm", "hybrid")
        assert arch.serve_backends == (("slot", "arena", "paged") if paged
                                       else ("slot", "arena")), name
        assert (arch.paged_insert is not None) == paged, name
    for name in ("whisper-small", "whisper-tiny-enc", "dinov2-s",
                 "llava-next-34b"):
        assert tregistry.build_by_name(name).forward is not None
