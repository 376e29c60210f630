"""PyTorch port vs JAX reference: the ITA integer softmax arithmetic.

The same numpy inputs go through ``repro.core.ita`` and
``repro_torch.core.ita``. Everything here is integer arithmetic (the float
view divides an integer by 255), so every comparison is bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ita as jita
from repro_torch.core import ita

torch.set_num_threads(1)

SCALES = [1e-4, 3e-3, 0.01, 0.02, 0.05, 10.0 / 127, 0.25, 1.0, 1000.0 / 127,
          44.0, 60.0, 500.0]


def logits(seed, shape, scale, spread=3.0):
    """int8 logits as an attention layer's scores quantize to."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * spread
    return np.clip(np.round(x / scale), -127, 127).astype(np.int8)


def same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    bad = got != want
    assert not bad.any(), f"{bad.sum()} of {bad.size} values differ"


@pytest.mark.parametrize("scale", SCALES)
def test_softmax_spec_constants(scale):
    """mult and rshift over logit scales from 1e-4 to 500 (a negative
    rshift from 44 up)."""
    got, want = ita.SoftmaxSpec(scale), jita.SoftmaxSpec(scale)
    assert (got.alpha_mult, got.alpha_rshift) == (want.alpha_mult,
                                                  want.alpha_rshift)
    with pytest.raises(ValueError):
        ita.SoftmaxSpec(-scale).alpha_mult


def test_exp2_fixed_over_the_whole_domain():
    t = np.arange(ita.NEG_T, 1, dtype=np.int32)
    same(ita.exp2_fixed(torch.from_numpy(t)), jita.exp2_fixed(jnp.asarray(t)))
    assert ita.NEG_T == -(31 << jita.FB)
    assert int(ita.exp2_fixed(torch.tensor([ita.NEG_T], dtype=torch.int32))) == 0


@pytest.mark.parametrize("scale", [0.01, 0.05, 10.0 / 127, 1.0, 60.0])
def test_to_exponent_domain(scale):
    d = -np.arange(0, 255, dtype=np.int32)
    spec_t, spec_j = ita.SoftmaxSpec(scale), jita.SoftmaxSpec(scale)
    same(ita.to_exponent_domain(torch.from_numpy(d), spec_t),
         jita.to_exponent_domain(jnp.asarray(d), spec_j))


@pytest.mark.parametrize("shape,axis", [((4, 64), -1), ((3, 1025), -1),
                                        ((2, 5, 77), -1), ((40, 6), 0),
                                        ((7, 1), -1)])
@pytest.mark.parametrize("scale", [0.02, 0.05, 0.08, 60.0])
def test_int_softmax_probs_and_denominator(shape, axis, scale):
    lq = logits(sum(shape) + int(scale * 100), shape, scale)
    spec_t, spec_j = ita.SoftmaxSpec(scale), jita.SoftmaxSpec(scale)
    p, den = ita.int_softmax(torch.from_numpy(lq), spec_t, axis=axis)
    pj, denj = jita.int_softmax(jnp.asarray(lq), spec_j, axis=axis)
    same(p, pj)
    same(den, denj)
    same(ita.int_softmax_float_view(torch.from_numpy(lq), spec_t, axis=axis),
         jita.int_softmax_float_view(jnp.asarray(lq), spec_j, axis=axis))


@pytest.mark.parametrize("cols,tile", [(256, 256), (256, 64), (512, 32),
                                       (300, 100), (96, 7)])
@pytest.mark.parametrize("scale", [0.03, 0.08])
def test_streaming_tile_update_over_tilings(cols, tile, scale):
    """Fold the tiles of int8 logits (mapped to the exponent domain, not
    max-subtracted) one at a time: state, exponentials and carry shifts
    equal at every step; the last tile may be short."""
    rows = 6
    lq = logits(cols + tile, (rows, cols), scale).astype(np.int32)
    spec = jita.SoftmaxSpec(scale)
    t_all = (lq * spec.alpha_mult) >> spec.alpha_rshift
    state_t = ita.streaming_init(rows, device="cpu")
    state_j = jita.streaming_init(rows)
    same(state_t[0], state_j[0])
    same(state_t[1], state_j[1])
    for c0 in range(0, cols, tile):
        tt = np.ascontiguousarray(t_all[:, c0:c0 + tile])
        state_t, e_t, sh_t = ita.streaming_tile_update(state_t,
                                                        torch.from_numpy(tt))
        state_j, e_j, sh_j = jita.streaming_tile_update(state_j,
                                                         jnp.asarray(tt))
        same(e_t, e_j)
        same(sh_t, sh_j)
        same(state_t[0], state_j[0])
        same(state_t[1], state_j[1])


def test_streaming_init_follows_the_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ita.streaming_init(3)
    be, den = ita.streaming_init(3, device="cpu")
    assert be.tolist() == [-31] * 3 and den.tolist() == [0] * 3
