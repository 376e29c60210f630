"""PyTorch port vs JAX reference: the optimizers (``optim/optimizer.py``).

``update`` is held to the reference's on identical numpy parameters and
gradients, for AdamW and Adafactor, clipping on and off, the three
schedules, over five chained steps (each step's gradients drawn anew from
a seed): parameters, every state leaf, ``lr`` and ``grad_norm`` at
``rtol = 1e-6``, ``atol = 1e-7`` in float32. The tree has a stacked leaf
(three dims, updated one stack entry at a time in the port), a stacked
vector (two dims), a matrix and a vector, so every branch of both
optimizers runs. Also ``lr_at`` at several steps, ``state_axes`` on a
model schema, and the quadratic of the reference's trainer tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro.models import schema as jschema
from repro.optim import optimizer as jopt
from repro.train.checkpointing import (
    _flatten_with_paths as jflatten_with_paths,
)
from repro_torch import configs as tconfigs
from repro_torch.models import registry as tregistry
from repro_torch.models.schema import leaves, tree_map
from repro_torch.optim import optimizer as topt
from repro_torch.train.checkpointing import flatten_with_paths

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-7


def _draw(rng, scale):
    def a(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"embed": a(16, 8), "norm": a(8),
            "stacks": [{"w": a(3, 8, 6), "ln": a(3, 8)}]}


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _close_trees(got, want, what):
    """Leaf by leaf, matched by tree path (the checkpoint keys)."""
    g, w = flatten_with_paths(got), jflatten_with_paths(want)
    assert g.keys() == w.keys(), what
    for k in w:
        _close(g[k].numpy(), w[k], f"{what} {k}")


@pytest.mark.parametrize("schedule", ["cosine", "linear", "const"])
@pytest.mark.parametrize("clip", [1.0, None])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_update_matches_reference_over_five_steps(name, clip, schedule):
    oc = dict(name=name, lr=1e-2, warmup_steps=2, total_steps=6,
              clip_norm=clip, schedule=schedule)
    joc, toc = jopt.OptConfig(**oc), topt.OptConfig(**oc)
    rng = np.random.default_rng(7)
    p0 = _draw(rng, 0.5)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = _to_torch(p0)
    js, ts = jopt.init(joc, jp), topt.init(toc, tp)
    jstep = jax.jit(lambda s, p, g: jopt.update(joc, s, p, g))
    for step in range(5):
        # gradient norms around 1, so clipping binds on some steps only
        g = _draw(rng, 0.05 * (step + 1))
        jp, js, jm = jstep(js, jp, jax.tree.map(jnp.asarray, g))
        tp2, ts, tm = topt.update(toc, ts, tp, _to_torch(g))
        assert tp2 is tp  # updated in place
        what = f"{name} step {step + 1}"
        _close_trees(tp, jp, f"{what} params")
        _close_trees(ts, js, f"{what} state")
        assert int(ts.step) == int(js.step) == step + 1
        assert ts.step.dtype == torch.int32
        _close(tm["lr"].numpy(), jm["lr"], f"{what} lr")
        _close(tm["grad_norm"].numpy(), jm["grad_norm"], f"{what} norm")


@pytest.mark.parametrize("schedule", ["cosine", "linear", "const"])
def test_lr_at_matches_reference(schedule):
    for warm, total in ((0, 10), (1, 10), (100, 10_000), (7, 5)):
        oc = dict(lr=3e-4, warmup_steps=warm, total_steps=total,
                  schedule=schedule)
        for step in (0, 1, 2, 5, 7, 99, 100, 101, 5000, 10_000, 12_000):
            got = topt.lr_at(topt.OptConfig(**oc), step)
            want = jopt.lr_at(jopt.OptConfig(**oc), jnp.int32(step))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL, atol=0,
                                       err_msg=f"{oc} step {step}")


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizers_reduce_loss_on_quadratic(name):
    oc = topt.OptConfig(name=name, lr=0.1, warmup_steps=0, total_steps=100,
                        weight_decay=0.0, schedule="const")
    params = {"w": torch.from_numpy(np.random.default_rng(0)
                                    .standard_normal((8, 8))
                                    .astype(np.float32))}
    state = topt.init(oc, params)
    l0 = float(torch.sum(params["w"] ** 2))
    for _ in range(20):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(torch.sum(w ** 2), [w])
        params, state, _ = topt.update(oc, state, params, {"w": g})
    assert float(torch.sum(params["w"] ** 2)) < 0.2 * l0


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_state_axes_match_reference(name):
    cfg = "qwen3-moe-30b-a3b"
    jaxes = jschema.logical_axes(
        jregistry.build(jconfigs.smoke_config(cfg)).schema())
    taxes = tree_map(lambda s: s.axes,
                     tregistry.build(tconfigs.smoke_config(cfg)).schema())
    want = jopt.state_axes(jopt.OptConfig(name=name), jaxes)
    got = topt.state_axes(topt.OptConfig(name=name), taxes)
    assert type(got).__name__ == type(want).__name__
    for g, w in zip(got, want):
        assert g == w


def test_state_leaves_follow_parameter_shapes():
    params = _to_torch(_draw(np.random.default_rng(0), 1.0))
    ada = topt.init(topt.OptConfig(name="adafactor"), params)
    assert ada.vr["stacks"][0]["w"].shape == (3, 8)
    assert ada.vc["stacks"][0]["w"].shape == (3, 6)
    assert ada.vr["norm"].shape == (8,) and ada.vc["norm"].shape == ()
    adam = topt.init(topt.OptConfig(), params)
    assert all(m.shape == p.shape and m.dtype == torch.float32
               for m, p in zip(leaves(adam.m), leaves(params)))
    with pytest.raises(ValueError):
        topt.init(topt.OptConfig(name="sgd"), params)
