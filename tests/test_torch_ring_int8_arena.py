"""PyTorch port vs JAX reference: the int8 arena step (``serve_quant``) on
sliding-window layers, float32 (``gemma3-4b-smoke``: 16-row rings, W8A8
projections).

Engine level, as in ``test_torch_int8_arena.py``: the port's ``arena`` and
``slot`` greedy streams, preemptions and every shared metric equal the JAX
engines' on prompts of 1–39 tokens, so the rings take the rolled fill and
wrap in decode, where ``decode_attention_int8`` runs without a window and
every row turns valid; length buckets stay under the window.

The tail config (``gemma3-4b-smoke`` with ``n_layers=10``, layout
``('LLLLLG', 1, 'LLLL')``) cannot go through the reference's ``prefill``,
which mis-shapes tail caches (ROADMAP Queue C): its cache comes from the
port's prefill, laid out as the JAX ``init_cache`` lays it out, and the
JAX ``decode_step`` with ``qparams`` steps beside the port's, logits
allclose and the cache integers bit-equal after every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models.cache import cache_insert as tcache_insert

from test_torch_dense_arena import identity_cell, tokens
from test_torch_int8_arena import step_both
from test_torch_serve import setup_pair

torch.set_num_threads(1)


@pytest.mark.parametrize("backend,scheduler", [
    ("arena", "bounded"), ("arena", "fcfs"), ("slot", "bounded")],
    ids=["arena-bounded", "arena-fcfs", "slot"])
def test_gemma3_ring_streams_match_reference(backend, scheduler):
    identity_cell("gemma3-4b", backend, True, scheduler, quant=True)


def test_tail_config_steps_beside_the_reference_decode_step():
    """``gemma3-4b-smoke`` with ``n_layers=10`` (layout ``('LLLLLG', 1,
    'LLLL')``): prompts of 20 (past the 16-row ring) and 9 tokens
    prefilled by the port into a batch-2 arena, the same cache handed to
    the JAX ``decode_step`` with ``qparams`` (the shapes of the JAX
    ``init_cache``), then five steps side by side."""
    jarch, jparams, tarch, tparams = setup_pair("gemma3-4b", True,
                                                n_layers=10)
    assert tarch.cfg.layer_layout() == ("LLLLLG", 1, "LLLL")
    jq, tq = jarch.quantize_params(jparams), tarch.quantize_params(tparams)
    max_len, lens = 48, [20, 9]
    tcache = tarch.init_cache(len(lens), max_len, quantized=False,
                              device="cpu")
    last = []
    for slot, n in enumerate(lens):
        t = torch.from_numpy(tokens(tarch.cfg.vocab, n, seed=n + 30)[None])
        tl, tc1 = tarch.prefill(tparams, t, max_len)
        tcache_insert(tcache, tc1, slot)
        last.append(int(torch.argmax(tl[0])))
    want = jarch.init_cache(len(lens), max_len, quantized=False)
    jcache = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tcache)
    assert jax.tree.map(lambda a: a.shape, jcache) == \
        jax.tree.map(lambda a: a.shape, want)
    step_both(jarch, jparams, jq, tarch, tparams, tq, jcache, tcache,
              np.int32(last), steps=5)
