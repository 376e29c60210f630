"""PyTorch port vs JAX reference: the int8 arena step (``serve_quant``) of
the vlm-dense and moe configs, float32.

Engine level, as in ``test_torch_int8_arena.py``: the port's ``arena`` and
``slot`` greedy streams, preemptions and every shared metric equal the JAX
engines' on

* ``llava-next-34b-smoke`` (the vlm-dense family on token prompts; W8A8
  projections);
* ``qwen3-moe-30b-a3b-smoke`` at the default ``moe_capacity`` 1.25, where
  admission prefills drop routing slots (counted through ``moe.route``):
  float weights beside the int8 K/V, as in the reference, on its ``G`` and
  ``GL`` (ring) layouts.

Function level: the moe ``decode_step`` under ``serve_quant`` (``qparams``
ignored, as in the reference) over a batch-2 arena: logits allclose at
``rtol = atol = 1e-5`` and the cache integers bit-equal after every step.
The sliding-window config's cells are in ``test_torch_ring_int8_arena.py``
(split so that each file takes about a minute).
"""

import pytest
import torch

from repro_torch.models import moe as tmoe

from test_torch_dense_arena import identity_cell
from test_torch_int8_arena import prefill_pair, step_both
from test_torch_serve import setup_pair

torch.set_num_threads(1)

MOE = "qwen3-moe-30b-a3b"
GL = dict(pattern="GL", n_layers=3)


@pytest.fixture
def dropped(monkeypatch):
    """Routing slots the port's expert layers drop, one entry a call."""
    out = []
    route = tmoe.route

    def spy(*args):
        r = route(*args)
        out.append(int((~r[3]).sum()))
        return r

    monkeypatch.setattr(tmoe, "route", spy)
    return out


@pytest.mark.parametrize("backend,buckets", [
    ("arena", True), ("arena", False), ("slot", True)],
    ids=["arena-buckets", "arena-exact", "slot"])
def test_llava_token_prompts_match_reference(backend, buckets):
    reqs = identity_cell("llava-next-34b", backend, buckets, "bounded",
                         quant=True)
    assert sum(r.preemptions for r in reqs) >= 1


@pytest.mark.parametrize("scheduler", ["bounded", "fcfs", "qos"])
def test_moe_arena_streams_match_reference(scheduler, dropped):
    identity_cell(MOE, "arena", True, scheduler, quant=True)
    assert sum(dropped) > 0          # admission prefills drop slots


def test_moe_gl_arena_streams_match_reference(dropped):
    identity_cell(MOE, "arena", False, "bounded", quant=True, **GL)
    assert sum(dropped) > 0


def test_moe_slot_streams_match_reference():
    identity_cell(MOE, "slot", True, "bounded", quant=True)


@pytest.mark.parametrize("overrides", [{}, GL], ids=["G", "GL"])
def test_moe_int8_decode_step_matches_reference(overrides):
    """Prompts of 21 and 12 tokens (the GL layout's 16-row ring takes the
    rolled fill of the first), then four decode steps; ``qparams`` is
    ignored by both families (float weights)."""
    jarch, jparams, tarch, tparams = setup_pair(MOE, True, **overrides)
    assert tarch.quantize_params is None and jarch.quantize_params is None
    jcache, tcache, last = prefill_pair(jarch, jparams, tarch, tparams,
                                        [21, 12], max_len=40)
    tcache = step_both(jarch, jparams, None, tarch, tparams, None, jcache,
                       tcache, last, steps=4)
    k = tcache["stacks"][0]["k"]
    assert torch.equal(k, k.round()) and float(k.abs().max()) <= 127
