"""PyTorch port vs JAX reference: gradient accumulation over microbatches,
bfloat16 compute and ``cast_params_bf16``.

With ``microbatches = 2`` the port's accumulated gradient is held to the
mean of ``jax.value_and_grad`` over the two slices (each leaf at
``rtol = 1e-4``, ``atol = 1e-5 · max|g|``), and its loss and gradient norm
to the metrics of the reference's own ``make_train_step``, which
accumulates through ``lax.scan``. In bfloat16 the two frameworks round at
different places, so those cases compare the loss only, at
``rtol = 2e-2``, for one config of each family; ``cast_params_bf16``
(bfloat16 weights in the forward, float32 gradients) likewise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.train.checkpointing import flatten_with_paths

from test_torch_train_grads import (
    FAMILIES, GRAD_RTOL, LOSS_RTOL, assert_grads_close, port_loss_and_grads,
    reference_value_and_grad, setup_train_pair,
)

torch.set_num_threads(1)

BF16_RTOL = 2e-2


@pytest.mark.parametrize("name", ["phi3-mini-3.8b", "whisper-small",
                                  "qwen3-moe-30b-a3b"])
def test_two_microbatches_match_reference_accumulation(name):
    jarch, tarch, npp, toks, emb = setup_train_pair(name, batch=4)
    tl, tg = port_loss_and_grads(tarch, npp, toks, emb, microbatches=2)
    halves = [reference_value_and_grad(
        jarch, npp, toks[i:i + 2], None if emb is None else emb[i:i + 2])
        for i in (0, 2)]
    want = jax.tree.map(lambda a, b: a / 2 + b / 2,
                        halves[0][1], halves[1][1])
    assert_grads_close(tg, want)
    # the reference's own microbatched step: its loss and gradient norm
    tc = jtrainer.TrainConfig(model=jarch.cfg, opt=jopt.OptConfig(),
                              global_batch=4, microbatches=2)
    jparams = jax.tree.map(jnp.asarray, npp)
    _, _, m = jtrainer.make_train_step(jarch, tc)(
        jparams, jopt.init(tc.opt, jparams), jnp.asarray(toks),
        None if emb is None else jnp.asarray(emb))
    np.testing.assert_allclose(float(tl), float(m["loss"]), rtol=LOSS_RTOL)
    norm = float(torch.sqrt(sum(torch.sum(t * t) for t in
                                flatten_with_paths(tg).values())))
    np.testing.assert_allclose(norm, float(m["grad_norm"]), rtol=GRAD_RTOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_loss_matches_reference(name):
    jarch, tarch, npp, toks, emb = setup_train_pair(name, dtype="bfloat16")
    jl, _ = reference_value_and_grad(jarch, npp, toks, emb)
    tl, tg = port_loss_and_grads(tarch, npp, toks, emb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=BF16_RTOL)
    assert all(t.dtype == torch.float32 and bool(torch.isfinite(t).all())
               for t in flatten_with_paths(tg).values())


def test_cast_params_bf16_loss_matches_reference():
    jarch, tarch, npp, toks, emb = setup_train_pair("phi3-mini-3.8b",
                                                    dtype="bfloat16")
    jl, _ = reference_value_and_grad(jarch, npp, toks, emb, cast_bf16=True)
    tl, tg = port_loss_and_grads(tarch, npp, toks, emb, cast_bf16=True)
    np.testing.assert_allclose(float(tl), float(jl), rtol=BF16_RTOL)
    _, plain = port_loss_and_grads(tarch, npp, toks, emb)
    flat, flat_plain = flatten_with_paths(tg), flatten_with_paths(plain)
    # float32 gradients of the float32 master weights, through the cast
    assert all(t.dtype == torch.float32 for t in flat.values())
    assert not all(torch.equal(flat[k], flat_plain[k]) for k in flat)
