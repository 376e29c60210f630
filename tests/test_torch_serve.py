"""PyTorch port vs JAX reference: paged serving end to end, float pools.

Greedy token identity of the port's ``LLMEngine`` with the JAX
``LLMEngine(backend="paged")`` on the dense smoke configs (float32), under
the ``bounded`` scheduler (with a forced preemption) and ``fcfs``; model
level ``paged_prefill`` / ``paged_decode_step`` logits at allclose; the
sampling contract; and the settings the port refuses by name.

Both engines get the same numpy weights (``repro_torch.bridge``). The JAX
engine's decode is made to finish before the host touches its block table
again (``sync_reference_decode``): the reference uploads the host-owned
table per dispatch and rewrites table rows right after dispatching, and
with CPU async dispatch that race makes its streams vary run to run (see
ROADMAP Queue C).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.models.cache import PagedLayout as JLayout
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import LLMEngine as JEngine
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import registry as tregistry
from repro_torch.models.cache import PagedLayout as TLayout
from repro_torch.serve import EngineConfig, LLMEngine

torch.set_num_threads(1)

CONFIGS = ["glm4-9b", "phi3-mini-3.8b"]


def setup_pair(name, quant):
    """(JAX arch, JAX params, port arch, port params) on the same weights."""
    jc = dataclasses.replace(jconfigs.smoke_config(name), dtype="float32",
                             serve_quant=quant)
    tc = dataclasses.replace(tconfigs.smoke_config(name), dtype="float32",
                             serve_quant=quant)
    tarch = tregistry.build(tc)
    npp = bridge.numpy_params(tarch.schema(), seed=0)
    return (jregistry.build(jc), jax.tree.map(jnp.asarray, npp), tarch,
            bridge.params_from_numpy(npp, "cpu"))


def sync_reference_decode(engine):
    """Wait for the reference's decode dispatch before returning, so its
    host-side table writes cannot race the dispatch still reading them."""
    orig = engine.backend.decode

    def decode(*args, **kw):
        tok = orig(*args, **kw)
        jax.block_until_ready(tok)
        return tok

    engine.backend.decode = decode
    return engine


def prompts_for(vocab, n=6, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(3, 40))
                         ).astype(np.int32) for _ in range(n)]


def serve_both(name, quant, scheduler, max_new=10):
    jarch, jparams, tarch, tparams = setup_pair(name, quant)
    kw = dict(slots=4, max_len=64, admit_window=2, scheduler=scheduler)
    je = sync_reference_decode(JEngine(jarch, jparams, JEngineConfig(
        backend="paged", attn_backend="interpret" if quant else "xla",
        **kw)))
    te = LLMEngine(tarch, tparams, EngineConfig(**kw), device="cpu")
    prompts = prompts_for(tarch.cfg.vocab)
    jh = [je.add_request(p, max_new_tokens=max_new) for p in prompts]
    th = [te.add_request(p, max_new_tokens=max_new) for p in prompts]
    je.run_until_drained()
    te.run_until_drained()
    return ([je.request(h) for h in jh], [te.request(h) for h in th], te)


@pytest.mark.parametrize("scheduler", ["bounded", "fcfs"])
@pytest.mark.parametrize("name", CONFIGS)
def test_greedy_identity_float_pools(name, scheduler):
    jreqs, treqs, te = serve_both(name, quant=False, scheduler=scheduler)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [r.preemptions for r in treqs] == [r.preemptions for r in jreqs]
    assert all(len(r.output) == 10 and r.finish_reason == "length"
               for r in treqs)
    if scheduler == "bounded":
        assert sum(r.preemptions for r in treqs) >= 1
    # one batched decode dispatch and one fetch per iteration
    m = te.metrics()
    assert m["transfers"] <= m["iterations"]
    assert te.alloc.live_blocks == 0  # every block came back


@pytest.mark.parametrize("quant", [False, True])
def test_paged_prefill_and_decode_logits_allclose(quant):
    """Model level: two slots prefilled (one right-padded to a bucket, one
    exact), then three decode steps; logits at allclose (f32 reordering)."""
    jarch, jparams, tarch, tparams = setup_pair("glm4-9b", quant)
    cfg = tarch.cfg
    blk, nblocks, max_len = 8, 20, 64
    jcache = jarch.init_paged_cache(2, JLayout(blk, nblocks, max_len))
    tcache = tarch.init_paged_cache(2, TLayout(blk, nblocks, max_len),
                                    device="cpu")
    jq = jarch.quantize_params(jparams) if quant else None
    tq = tarch.quantize_params(tparams) if quant else None
    rng = np.random.default_rng(5)
    p0 = rng.integers(0, cfg.vocab, 13).astype(np.int32)
    p1 = rng.integers(0, cfg.vocab, 9).astype(np.int32)
    padded = np.zeros((1, 16), np.int32)
    padded[0, :13] = p0
    ids0, ids1 = np.int32([3, 5]), np.int32([7, 2])
    jpre = jax.jit(jarch.paged_prefill)
    jl0, jcache = jpre(jparams, jnp.asarray(padded), jcache, 0,
                       jnp.asarray(ids0), true_len=jnp.int32(13))
    jl1, jcache = jpre(jparams, jnp.asarray(p1[None]), jcache, 1,
                       jnp.asarray(ids1))
    tl0, tcache = tarch.paged_prefill(tparams, torch.from_numpy(padded),
                                      tcache, 0, torch.from_numpy(ids0),
                                      true_len=13)
    tl1, tcache = tarch.paged_prefill(tparams, torch.from_numpy(p1[None]),
                                      tcache, 1, torch.from_numpy(ids1))
    for j, t in ((jl0, tl0), (jl1, tl1)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4,
                                   rtol=1e-4)
    table = np.zeros((2, max_len // blk), np.int32)
    table[0, :2], table[1, :2] = ids0, ids1
    jdec = jax.jit(functools.partial(
        jarch.paged_decode_step,
        attn_backend="interpret" if quant else "xla"))
    toks = np.int32([11, 22])
    for step in range(3):
        jlog, jcache = jdec(jparams, jcache, jnp.asarray(toks),
                            jnp.asarray(table), qparams=jq)
        tlog, tcache = tarch.paged_decode_step(
            tparams, tcache, torch.tensor(toks), torch.from_numpy(table),
            qparams=tq)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=1e-4, rtol=1e-4, err_msg=str(step))
        toks = np.asarray(jnp.argmax(jlog, -1), np.int32)
    np.testing.assert_array_equal(tcache["len"].numpy(),
                                  np.asarray(jcache["len"]))


def test_sampling_is_a_function_of_seed_rid_and_index():
    """A sampled request draws the same tokens alone as in a mixed batch
    (greedy rows beside it unchanged), keyed by (seed, rid, output index)."""
    _, _, tarch, tparams = setup_pair("glm4-9b", False)
    prompts = prompts_for(tarch.cfg.vocab, n=4, seed=3)

    def run(batch, sample=True):
        eng = LLMEngine(tarch, tparams, EngineConfig(
            slots=4, max_len=64, admit_batch=4, seed=7), device="cpu")
        hs = {}
        for rid in batch:
            temp, top_k = (0.9, 20) if rid % 2 and sample else (None, 0)
            hs[rid] = eng.add_request(prompts[rid], max_new_tokens=8,
                                      temperature=temp, top_k=top_k, rid=rid)
        eng.run_until_drained()
        return {rid: eng.request(h).output for rid, h in hs.items()}

    alone = {rid: run([rid])[rid] for rid in range(4)}
    mixed = run([0, 1, 2, 3])
    assert mixed == alone
    greedy = run([0, 1, 2, 3], sample=False)
    assert [greedy[r] for r in (0, 2)] == [mixed[r] for r in (0, 2)]
    assert [greedy[r] for r in (1, 3)] != [mixed[r] for r in (1, 3)]


@pytest.mark.parametrize("setting,kw", [
    ("prefix_cache", dict(prefix_cache=True)),
    ("prefill_chunk_tokens", dict(prefill_chunk_tokens=16)),
    ("spec_tokens", dict(spec_tokens=2)),
    ("backend", dict(backend="arena")),
])
def test_unported_settings_raise_by_name(setting, kw):
    _, _, tarch, tparams = setup_pair("glm4-9b", False)
    with pytest.raises(NotImplementedError, match=setting):
        LLMEngine(tarch, tparams, EngineConfig(**kw), device="cpu")


def test_mesh_and_ring_layouts_raise_by_name():
    _, _, tarch, tparams = setup_pair("glm4-9b", False)
    with pytest.raises(NotImplementedError, match="mesh"):
        LLMEngine(tarch, tparams, EngineConfig(), mesh=object(), device="cpu")
    # gemma3's sliding-window layers need ring-block pools
    cfg = dataclasses.replace(tconfigs.smoke_config("gemma3-4b"),
                              dtype="float32")
    arch = tregistry.build(cfg)
    params = bridge.params_from_numpy(bridge.numpy_params(arch.schema(), 0),
                                      "cpu")
    with pytest.raises(NotImplementedError, match="ring"):
        LLMEngine(arch, params, EngineConfig(max_len=64), device="cpu")
