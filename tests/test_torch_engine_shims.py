"""The legacy engine classes of ``repro_torch.serve`` and the default
backend.

``ServeEngine``, ``BatchedServeEngine`` and ``PagedServeEngine`` pin the
``slot``, ``arena`` and ``paged`` backends over ``LLMEngine`` (port of
``repro.serve.engine``): on ``glm4-9b-smoke`` (float32, float and
``serve_quant``) and ``whisper-small-smoke`` (``embeds`` requests) each is
token-identical to ``LLMEngine`` with that backend, whatever backend the
config names, and its ``step()`` returns the finished requests. The
default backend is ``"arena"``, as in the reference.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.serve import EngineConfig as JEngineConfig
from repro_torch.serve import (
    BatchedServeEngine, EngineConfig, LLMEngine, PagedServeEngine, Request,
    ServeEngine,
)
from repro_torch.serve import engine as engine_mod

from test_torch_serve import setup_pair

torch.set_num_threads(1)

SHIMS = {"slot": ServeEngine, "arena": BatchedServeEngine,
         "paged": PagedServeEngine}


def work(eng, cfg, legacy):
    """Three requests of 4, 7 and 10 tokens (with frame embeddings on an
    encdec arch); returns {rid: output}."""
    rng = np.random.default_rng(0)
    emb = None
    if cfg.family == "encdec":
        emb = (0.1 * rng.standard_normal((cfg.enc_seq, cfg.d_model))
               ).astype(np.float32)
    for rid in range(3):
        eng.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab, 4 + 3 * rid).astype(np.int32), max_new_tokens=4,
            embeds=emb))
    if not legacy:
        return {r.rid: list(r.output) for r in eng.run_until_drained()}
    done = []
    while not eng.idle:
        out = eng.step()
        assert all(isinstance(r, Request) and r.finished for r in out)
        done += out
    return {r.rid: list(r.output) for r in done}


@pytest.mark.parametrize("name,quant", [("glm4-9b", False), ("glm4-9b", True),
                                        ("whisper-small", True)],
                         ids=["glm4-float", "glm4-int8", "whisper-int8"])
@pytest.mark.parametrize("backend", ["slot", "arena", "paged"])
def test_shims_match_llm_engine(name, quant, backend):
    _, _, tarch, tparams = setup_pair(name, quant)
    other = "paged" if backend != "paged" else "slot"
    ec = EngineConfig(slots=2, max_len=48, block_len=8, backend=other)
    want = work(LLMEngine(tarch, tparams, dataclasses.replace(
        ec, backend=backend), device="cpu"), tarch.cfg, legacy=False)
    shim = SHIMS[backend](tarch, tparams, ec, device="cpu")
    assert isinstance(shim, LLMEngine) and shim.backend.name == backend
    assert shim.ec.backend == backend and ec.backend == other
    assert work(shim, tarch.cfg, legacy=True) == want
    assert len(want) == 3


def test_default_backend_is_arena():
    assert EngineConfig().backend == JEngineConfig().backend == "arena"
    _, _, tarch, tparams = setup_pair("glm4-9b", True)
    eng = LLMEngine(tarch, tparams, EngineConfig(), device="cpu")
    assert eng.backend.name == "arena"
    assert engine_mod.ServeEngine is ServeEngine
