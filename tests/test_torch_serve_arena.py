"""PyTorch port vs JAX reference: serving the Mamba-2 family on the arena
and slot backends.

Greedy streams of the port's ``LLMEngine(backend="arena")`` are identical
to the JAX arena engine's on ``mamba2-2.7b-smoke`` (float32, one numpy
weight tree), with more requests than slots, under the ``fcfs`` and
``bounded`` schedulers, on prompts of at least ``d_conv - 1 = 3`` tokens
(shorter ones hit a reference-side fault, ROADMAP Queue C). The port's
``slot`` backend gives its ``arena`` streams; sampled rows are a function
of the seed; and the settings that do not apply are refused by name.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import LLMEngine as JEngine
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import registry as tregistry
from repro_torch.serve import EngineConfig, LLMEngine

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    """(JAX arch, JAX params, port arch, port params) on the same weights."""
    jc = dataclasses.replace(jconfigs.smoke_config("mamba2-2.7b"),
                             dtype="float32")
    tc = dataclasses.replace(tconfigs.smoke_config("mamba2-2.7b"),
                             dtype="float32")
    tarch = tregistry.build(tc)
    npp = bridge.numpy_params(tarch.schema(), seed=0)
    return (jregistry.build(jc), jax.tree.map(jnp.asarray, npp), tarch,
            bridge.params_from_numpy(npp, "cpu"))


def prompts_for(vocab, n=6, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(3, 40))
                         ).astype(np.int32) for _ in range(n)]


def run(engine, prompts, max_new=8, **kw):
    hs = [engine.add_request(p, max_new_tokens=max_new, **kw)
          for p in prompts]
    engine.run_until_drained()
    return [engine.request(h) for h in hs]


@pytest.mark.parametrize("scheduler", ["fcfs", "bounded"])
def test_arena_greedy_streams_match_reference_arena(pair, scheduler):
    jarch, jparams, tarch, tparams = pair
    kw = dict(slots=4, max_len=64, admit_window=2, scheduler=scheduler)
    prompts = prompts_for(tarch.cfg.vocab)
    jreqs = run(JEngine(jarch, jparams, JEngineConfig(backend="arena", **kw)),
                prompts)
    te = LLMEngine(tarch, tparams, EngineConfig(backend="arena", **kw),
                   device="cpu")
    treqs = run(te, prompts)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [r.preemptions for r in treqs] == [r.preemptions for r in jreqs]
    assert all(len(r.output) == 8 and r.finish_reason == "length"
               for r in treqs)
    if scheduler == "bounded":
        assert sum(r.preemptions for r in treqs) >= 1
    m = te.metrics()
    # one batched decode pass and one fetch per iteration
    assert m["transfers"] <= m["iterations"]
    assert m["decode_dispatches"] <= m["iterations"]


def test_slot_backend_matches_arena(pair):
    _, _, tarch, tparams = pair
    prompts = prompts_for(tarch.cfg.vocab, n=6, seed=4) + [np.int32([7, 9])]
    out = {}
    for backend in ("arena", "slot"):
        eng = LLMEngine(tarch, tparams, EngineConfig(
            backend=backend, slots=3, max_len=64), device="cpu")
        reqs = run(eng, prompts, max_new=6)
        out[backend] = [r.output for r in reqs]
        if backend == "slot":
            # a host fetch per token, one admission per iteration
            assert eng.metrics()["transfers"] == sum(len(o) for o in out[backend])
    assert out["slot"] == out["arena"]


def test_short_prompt_is_independent_of_the_slot_history(pair):
    """The reference-side conv-tail fault does not reach the port: prompt
    [7, 9] gives the same stream in a fresh 1-slot arena and after a
    20-token request used the slot."""
    _, _, tarch, tparams = pair
    short = np.int32([7, 9])
    fresh = run(LLMEngine(tarch, tparams, EngineConfig(
        backend="arena", slots=1, max_len=64), device="cpu"), [short])
    eng = LLMEngine(tarch, tparams, EngineConfig(
        backend="arena", slots=1, max_len=64), device="cpu")
    rng = np.random.default_rng(9)
    run(eng, [rng.integers(0, tarch.cfg.vocab, 20).astype(np.int32)])
    after = run(eng, [short])
    assert after[0].output == fresh[0].output


def test_sampled_rows_reproducible_and_greedy_rows_unchanged(pair):
    _, _, tarch, tparams = pair
    prompts = prompts_for(tarch.cfg.vocab, n=4, seed=3)

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


@pytest.mark.parametrize("kw,match", [
    (dict(spec_tokens=2), "spec_tokens"),
    (dict(prefill_chunk_tokens=16), "prefill_chunk_tokens"),
])
def test_paged_only_settings_refused_on_arena(pair, kw, match):
    _, _, tarch, tparams = pair
    with pytest.raises(ValueError, match=match):
        LLMEngine(tarch, tparams, EngineConfig(backend="arena", **kw),
                  device="cpu")


def test_backend_refusals_name_the_family(pair):
    _, _, tarch, tparams = pair
    assert tarch.serve_backends == ("slot", "arena")
    with pytest.raises(ValueError, match="'ssm'.*'M'"):
        LLMEngine(tarch, tparams, EngineConfig(backend="paged"), device="cpu")
    # a dense arch serves on every backend, quantized (the int8 arena step,
    # W8A8 weights built by the backend) or float
    dense = tregistry.build(dataclasses.replace(
        tconfigs.smoke_config("glm4-9b"), dtype="float32"))
    assert dense.cfg.serve_quant
    assert dense.serve_backends == ("slot", "arena", "paged")
    dparams = bridge.params_from_numpy(bridge.numpy_params(dense.schema(), 0),
                                       "cpu")
    dense_f = tregistry.build(dataclasses.replace(dense.cfg,
                                                  serve_quant=False))
    for backend in ("arena", "slot"):
        eng = LLMEngine(dense, dparams, EngineConfig(backend=backend),
                        device="cpu")
        assert eng.backend.name == backend and eng.qparams is not None
        assert LLMEngine(dense_f, dparams, EngineConfig(backend=backend),
                         device="cpu").backend.name == backend
    # the greedy-only reference refuses a sampling request, and a
    # non-greedy engine outright
    eng = LLMEngine(tarch, tparams, EngineConfig(backend="slot"),
                    device="cpu")
    with pytest.raises(NotImplementedError, match="greedy-only"):
        eng.add_request([1, 2, 3], temperature=0.8)
    with pytest.raises(NotImplementedError, match="greedy-only"):
        LLMEngine(tarch, tparams, EngineConfig(backend="slot", greedy=False),
                  device="cpu")
