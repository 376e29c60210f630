"""PyTorch port vs JAX reference: serving the Griffin hybrid family on the
arena and slot backends.

Greedy streams of the port's ``LLMEngine(backend="arena")`` are identical
to the JAX arena engine's on ``recurrentgemma-9b-smoke`` (float32, one
numpy weight tree), with more requests than slots, under the ``fcfs`` and
``bounded`` schedulers (the latter with preemptions), on prompts of 3–40
tokens that with 12 new tokens cross the 16-token window, so every ring
wraps. Prompts are at least ``d_conv - 1 = 3`` tokens: shorter ones hit a
reference-side fault (ROADMAP Queue C). The port's ``slot`` backend gives
its ``arena`` streams, and the paged backend is refused by name.
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

from test_torch_serve import sync_reference_decode

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    """(JAX arch, JAX params, port arch, port params) on the same weights."""
    jc = dataclasses.replace(jconfigs.smoke_config("recurrentgemma-9b"),
                             dtype="float32")
    tc = dataclasses.replace(tconfigs.smoke_config("recurrentgemma-9b"),
                             dtype="float32")
    tarch = tregistry.build(tc)
    npp = bridge.numpy_params(tarch.schema(), seed=0)
    return (jregistry.build(jc), jax.tree.map(jnp.asarray, npp), tarch,
            bridge.params_from_numpy(npp, "cpu"))


def prompts_for(vocab, n=6, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(3, 41))
                         ).astype(np.int32) for _ in range(n)]


def run(engine, prompts, max_new=12, **kw):
    hs = [engine.add_request(p, max_new_tokens=max_new, **kw)
          for p in prompts]
    engine.run_until_drained()
    return [engine.request(h) for h in hs]


@pytest.mark.parametrize("scheduler", ["fcfs", "bounded"])
def test_arena_greedy_streams_match_reference_arena(pair, scheduler):
    jarch, jparams, tarch, tparams = pair
    kw = dict(slots=4, max_len=64, admit_window=2, scheduler=scheduler)
    prompts = prompts_for(tarch.cfg.vocab)
    win = tarch.cfg.local_window
    assert all(len(p) + 12 > win for p in prompts)    # every ring wraps
    assert {7, 16, 17} <= {len(p) for p in prompts}   # s < win, = win, > win
    jeng = sync_reference_decode(
        JEngine(jarch, jparams, JEngineConfig(backend="arena", **kw)))
    jreqs = run(jeng, prompts)
    te = LLMEngine(tarch, tparams, EngineConfig(backend="arena", **kw),
                   device="cpu")
    treqs = run(te, prompts)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [r.preemptions for r in treqs] == [r.preemptions for r in jreqs]
    assert all(len(r.output) == 12 and r.finish_reason == "length"
               for r in treqs)
    if scheduler == "bounded":
        assert sum(r.preemptions for r in treqs) >= 1
    m = te.metrics()
    # one batched decode pass and one fetch per iteration
    assert m["transfers"] <= m["iterations"]
    assert m["decode_dispatches"] <= m["iterations"]


def test_slot_backend_matches_arena(pair):
    """Including a 2-token prompt, which the port's prefill handles."""
    _, _, tarch, tparams = pair
    prompts = prompts_for(tarch.cfg.vocab, n=5, seed=4) + [np.int32([7, 9])]
    out = {}
    for backend in ("arena", "slot"):
        eng = LLMEngine(tarch, tparams, EngineConfig(
            backend=backend, slots=3, max_len=64), device="cpu")
        reqs = run(eng, prompts, max_new=10)
        out[backend] = [r.output for r in reqs]
        if backend == "slot":
            # a host fetch per token, one admission per iteration
            assert eng.metrics()["transfers"] == sum(len(o) for o in out[backend])
    assert out["slot"] == out["arena"]


def test_backends_and_refusals_name_the_family(pair):
    _, _, tarch, tparams = pair
    assert tarch.serve_backends == ("slot", "arena")
    with pytest.raises(ValueError, match="'hybrid'.*'RRL'.*'R' keep recurrent"):
        LLMEngine(tarch, tparams, EngineConfig(backend="paged"), device="cpu")
    eng = LLMEngine(tarch, tparams, EngineConfig(backend="arena", slots=2,
                                                 max_len=40), device="cpu")
    ring = eng.cache["stacks"][2]
    assert tuple(ring["k"].shape) == (2, 2, 1, 16, 16)
    assert eng.cache["stacks"][0]["h"].dtype == torch.float32
