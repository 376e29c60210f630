"""PyTorch port vs JAX reference: the moe family on the arena and slot
backends, float caches (``serve_quant=False``), float32, at the default
``moe_capacity`` 1.25, where prefill drops routing slots.

Function level, on one numpy weight tree for both packages: ``forward``
logits (two rows, each its own routing group), ``prefill`` logits and
every cache leaf, ``embeds`` in place of tokens, and a few
``decode_step``s over a batch-2 arena whose rows sit at different
positions, all allclose at ``rtol = atol = 1e-4`` (float32 reordering), on
``qwen3-moe-30b-a3b-smoke`` and on its ``GL`` layout with ``n_layers=3``
(a tail layer, which the reference's moe ``prefill`` writes correctly).

Engine level: the port's ``arena`` and ``slot`` greedy streams,
preemptions and every metric not read off the host clock equal the JAX
engines' under the ``bounded`` (with a forced preemption) and ``fcfs``
schedulers, with ``prefill_buckets`` on and off (the family prefills the
exact prompt either way: pad tokens would change the routing capacity);
the port's arena gives its own paged backend's greedy tokens; a
``serve_quant`` arch (int8 K/V beside the float weights) serves on
``arena`` and ``slot`` with the JAX engines' streams
(``test_torch_moe_int8_arena.py`` holds that step's own cells).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tdense
from repro_torch.serve import EngineConfig, LLMEngine

from test_torch_dense_arena import (
    ENGINE_KW, SMALL_ENGINE, check_prefill_and_decode, close, identity_cell,
    prompts_for, tokens, tree_close,
)
from test_torch_serve import setup_pair

torch.set_num_threads(1)

NAME = "qwen3-moe-30b-a3b"
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


@pytest.mark.parametrize("overrides", [{}, GL], ids=["G", "GL"])
def test_forward_allclose(overrides, dropped):
    jarch, jparams, tarch, tparams = setup_pair(NAME, False, **overrides)
    t = np.stack([tokens(tarch.cfg.vocab, 39, seed=s) for s in (1, 2)])
    want = jax.jit(jarch.forward)(jparams, jnp.asarray(t))
    close(tarch.forward(tparams, torch.from_numpy(t)), want, "forward")
    assert sum(dropped) > 0          # the capacity binds: slots drop


@pytest.mark.parametrize("overrides", [{}, GL], ids=["G", "GL"])
def test_prefill_and_decode_steps_allclose(overrides):
    """Prompts of 21 and 12 tokens (the GL layout's L layer keeps a
    16-row ring: the 21-token prompt takes the rolled fill)."""
    tarch = check_prefill_and_decode(NAME, [21, 12], **overrides)
    assert tarch.init_cache is not None and tmoe.init_cache is \
        tdense.init_cache


def test_prefill_embeds_allclose():
    jarch, jparams, tarch, tparams = setup_pair(NAME, False)
    emb = np.random.default_rng(4).standard_normal(
        (1, 17, tarch.cfg.d_model)).astype(np.float32)
    jl, jc = jax.jit(jarch.prefill, static_argnums=2)(
        jparams, None, 32, embeds=jnp.asarray(emb))
    tl, tc = tarch.prefill(tparams, None, 32, embeds=torch.from_numpy(emb))
    close(tl, jl, "embeds logits")
    tree_close(tc, jc, "embeds cache")
    assert not tarch.supports_padded_prefill


@pytest.mark.parametrize("scheduler", ["bounded", "fcfs"])
@pytest.mark.parametrize("buckets", [True, False], ids=["buckets", "exact"])
@pytest.mark.parametrize("overrides", [{}, GL], ids=["G", "GL"])
def test_arena_streams_match_reference(overrides, buckets, scheduler,
                                      dropped):
    identity_cell(NAME, "arena", buckets, scheduler, **overrides)
    assert sum(dropped) > 0          # admission prefills drop slots


@pytest.mark.parametrize("overrides", [{}, GL], ids=["G", "GL"])
def test_slot_streams_match_reference(overrides):
    identity_cell(NAME, "slot", True, "bounded", **overrides)


def test_arena_matches_own_paged_backend():
    _, _, tarch, tparams = setup_pair(NAME, False)
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


@pytest.mark.parametrize("backend", ["arena", "slot"])
def test_serve_quant_serves_on_arena_and_slot(backend, dropped):
    """The configs' default ``serve_quant`` (float weights, int8 K/V and
    the ITA integer decode attention) on two slots: the JAX engines'
    streams, with routing slots dropped at 1.25."""
    assert tconfigs.smoke_config(NAME).serve_quant
    identity_cell(NAME, backend, True, "fcfs", max_new=6, quant=True,
                  engine=SMALL_ENGINE)
    assert sum(dropped) > 0
