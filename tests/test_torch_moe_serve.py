"""PyTorch port vs JAX reference: the moe family served on the paged backend.

Greedy streams, preemptions and every metric not read off the host clock
of the port's ``LLMEngine(backend="paged", device="cpu")`` equal the
synchronised JAX engine's on ``qwen3-moe-30b-a3b-smoke`` in float32 (int8
pools anchored on ``attn_backend="interpret"``, the kernel contract), at
the default ``moe_capacity`` 1.25, where prefill drops slots, unless a cell
says otherwise:

* float and int8 pools under the ``bounded`` (with a forced preemption)
  and ``fcfs`` schedulers;
* speculative decoding with ``spec_tokens`` 1 and 3, prefix cache off and
  on;
* the prefix cache alone, chunked prefill and the ``GL`` ring layout
  (``test_torch_moe_prefix.py`` and ``test_torch_moe_chunked.py``, which
  share ``identity_cell``; split so that each file takes about a minute).

The family's arena and slot paths are held to the reference in
``test_torch_moe_arena.py`` (float caches) and
``test_torch_moe_int8_arena.py`` (the int8 arena step); here a
``serve_quant`` arch serves two short prompts on each beside the JAX
engine.
"""

import pytest
import torch

from repro.serve import EngineConfig as JEngineConfig
from repro.serve import LLMEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.models import moe as tmoe
from repro_torch.serve import EngineConfig, LLMEngine

from test_torch_chunked import shared_metrics_equal
from test_torch_serve import (
    serve_both, serve_quant_beside_reference, setup_pair,
    sync_reference_decode,
)
from test_torch_spec import (
    assert_frontier_blocks, assert_partition, spec_identity_cell,
)

torch.set_num_threads(1)

NAME = "qwen3-moe-30b-a3b"
# the smoke config's expert count: at this capacity no slot ever drops
N_EXPERTS = float(tconfigs.smoke_config(NAME).n_experts)


def identity_cell(quant, prompts, engine_kw, max_new=10, **overrides):
    """The port and the synchronised JAX engine serve ``prompts``: equal
    streams, preemptions and shared metrics, with the port's invariants
    holding after every step. Returns the port's engine, its metrics and
    the number of routing slots its expert layers dropped."""
    jarch, jparams, tarch, tparams = setup_pair(NAME, quant, **overrides)
    dropped = []
    route = tmoe.route

    def spy(*args):
        out = route(*args)
        dropped.append(int((~out[3]).sum()))
        return out

    je = sync_reference_decode(JEngine(jarch, jparams, JEngineConfig(
        backend="paged", attn_backend="interpret" if quant else "xla",
        **engine_kw)))
    te = LLMEngine(tarch, tparams, EngineConfig(backend="paged", **engine_kw),
                   device="cpu")
    jh = [je.add_request(p, max_new_tokens=max_new) for p in prompts]
    th = [te.add_request(p, max_new_tokens=max_new) for p in prompts]
    je.run_until_drained()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmoe, "route", spy)
        while not te.idle:
            te.step()
            assert_partition(te)
            if not te.backend.ring:
                assert_frontier_blocks(te)
    assert [te.request(h).output for h in th] == \
        [je.request(h).output for h in jh]
    assert [te.request(h).preemptions for h in th] == \
        [je.request(h).preemptions for h in jh]
    assert all(len(te.request(h).output) == max_new for h in th)
    m = te.metrics()
    shared_metrics_equal(m, je.metrics())
    assert te.alloc.live_blocks == 0
    return te, m, sum(dropped)


@pytest.mark.parametrize("scheduler", ["bounded", "fcfs"])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_greedy_identity_with_reference(quant, scheduler):
    jreqs, treqs, te = serve_both(NAME, quant, scheduler)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [r.preemptions for r in treqs] == [r.preemptions for r in jreqs]
    assert all(len(r.output) == 10 for r in treqs)
    if scheduler == "bounded":
        assert sum(r.preemptions for r in treqs) >= 1
    assert te.alloc.live_blocks == 0


@pytest.mark.parametrize("k,quant,prefix", [
    (1, False, False), (1, True, False), (3, False, False), (3, True, False),
    (3, False, True), (1, True, True)], ids=lambda v: str(v))
def test_spec_identity_with_reference(k, quant, prefix):
    spec_identity_cell(NAME, k, quant, prefix)


@pytest.mark.parametrize("backend", ["arena", "slot"])
def test_non_paged_backends_serve_quant(backend):
    serve_quant_beside_reference(NAME, backend)
