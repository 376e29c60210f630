"""PyTorch port vs JAX reference: the integer arithmetic of the int8 path.

Every function here is integer (or exactly-rounded float) arithmetic, so the
contract is bit-exactness on the same numpy inputs.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ita as jita
from repro.core import quant as jquant
from repro_torch.core import ita as tita
from repro_torch.core import quant as tquant

torch.set_num_threads(1)

INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def _wide_int32(rng, n):
    """int32 values over every magnitude band plus the edges."""
    mags = 2.0 ** rng.uniform(0, 31, n)
    v = (np.sign(rng.standard_normal(n)) * mags).astype(np.int64)
    edges = [0, 1, -1, 65535, -65535, 65536, -65536, INT32_MAX,
             INT32_MIN + 1, 1 << 30, -(1 << 30)]
    return np.clip(np.concatenate([v, edges]), INT32_MIN, INT32_MAX
                   ).astype(np.int32)


def test_round_shift_bit_exact():
    rng = np.random.default_rng(0)
    v = _wide_int32(rng, 4000)
    s = rng.integers(-12, 40, v.shape).astype(np.int32)
    _eq(jquant.round_shift(jnp.asarray(v), jnp.asarray(s)),
        tquant.round_shift(_t(v), _t(s)))
    for scalar in (0, 1, 7, 31, 32, -3):
        _eq(jquant.round_shift(jnp.asarray(v), scalar),
            tquant.round_shift(_t(v), scalar))


@pytest.mark.parametrize("band", ["small", "large", "saturating"])
def test_requantize_bit_exact(band):
    """|acc| < 2¹⁶ (exact product), |acc| ≥ 2¹⁶ (pre-normalized) and the
    saturation branch (shift smaller than the pre-shift)."""
    rng = np.random.default_rng({"small": 1, "large": 2, "saturating": 3}[band])
    n = 5000
    if band == "small":
        acc = rng.integers(-(1 << 16) + 1, 1 << 16, n).astype(np.int32)
        shift = rng.integers(0, 40, n).astype(np.int32)
    elif band == "large":
        acc = _wide_int32(rng, n)
        acc = acc[np.abs(acc.astype(np.int64)) >= (1 << 16)]
        shift = rng.integers(14, 40, acc.shape).astype(np.int32)
    else:
        acc = np.where(rng.random(n) < 0.5, 1, -1) * rng.integers(
            1 << 24, 1 << 31, n)
        acc = acc.astype(np.int32)
        shift = rng.integers(0, 12, n).astype(np.int32)
    m = rng.integers(1 << 14, 1 << 15, acc.shape).astype(np.int32)
    j = jquant.requantize(jnp.asarray(acc), jnp.asarray(m), jnp.asarray(shift))
    t = tquant.requantize(_t(acc), _t(m), _t(shift))
    assert t.dtype == torch.int8
    _eq(j, t)
    if band == "saturating":
        assert np.abs(t.numpy().astype(np.int32)).max() == 127


def test_quantize_to_fixed_point_bit_exact():
    rng = np.random.default_rng(4)
    mult = (2.0 ** rng.uniform(-30, 10, 3000)).astype(np.float32)
    mult = np.concatenate([mult, np.float32([1.0, 0.5, 0.9999999, 1e-8])])
    jm, js = jquant.quantize_to_fixed_point(jnp.asarray(mult))
    tm, ts = tquant.quantize_to_fixed_point(_t(mult))
    _eq(jm, tm)
    _eq(js, ts)
    for x in (0.0123, 1.0, 0.99999, 3.7e-5):
        assert tquant.quantize_to_fixed_point_py(x) == \
            jquant.quantize_to_fixed_point_py(x)


@pytest.mark.parametrize("per_channel", [True, False])
def test_quantize_weights_bit_exact(per_channel):
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((96, 40)) * 0.125).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero channel takes the eps floor
    jq, js = jquant.quantize_weights(jnp.asarray(w), per_channel=per_channel)
    tq, ts = tquant.quantize_weights(_t(w), per_channel=per_channel)
    _eq(jq, tq)
    _eq(js, ts)


@pytest.mark.parametrize("scale,out_scale", [
    (4.0 / 127, 4.0 / 127), (0.008, 0.05), (0.1, 0.02)])
def test_int_gelu_i8_bit_exact(scale, out_scale):
    q = np.arange(-127, 128, dtype=np.int32)
    _eq(jita.int_gelu_i8(jnp.asarray(q), scale, out_scale),
        tita.int_gelu_i8(_t(q), scale, out_scale))
    # the host-folded constants the CUDA epilogue receives agree with the
    # reference's traced ones
    qb, qc, one, m, shift = tita.gelu_constants(scale, out_scale)
    _, s_erf = jita.int_erf(jnp.asarray(q), scale / math.sqrt(2.0))
    jm, js = jquant.quantize_to_fixed_point(
        jnp.float32(abs(scale * s_erf / 2.0) / out_scale))
    assert (m, shift) == (int(jm), int(js))
    assert one == int(math.floor(1.0 / s_erf))


def test_int_relu_and_gelu_scale_guard():
    q = np.arange(-5, 6, dtype=np.int32)
    _eq(jita.int_relu(jnp.asarray(q)), tita.int_relu(_t(q)))
    with pytest.raises(ValueError):
        tita.int_gelu(_t(q), 0.001)
    with pytest.raises(ValueError):
        tita.gelu_constants(0.001, 0.1)


@pytest.mark.parametrize("k", [5, 4096])
def test_int8_matmul_ref_bit_exact(k):
    """int8 × int8 → int32 through the port's one exact route (float64
    products on every device) equals the reference's int32 dot."""
    rng = np.random.default_rng(k)
    a = rng.integers(-127, 128, (7, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, 9)).astype(np.int8)
    got = tquant.int8_matmul_ref(_t(a), _t(b))
    assert got.dtype == torch.int32
    _eq(jquant.int8_matmul_ref(jnp.asarray(a), jnp.asarray(b)), got)
    extreme = np.full((1, k), -127, np.int8)  # the largest |sum|: k·127²
    _eq(jquant.int8_matmul_ref(jnp.asarray(extreme), jnp.asarray(b * 0 - 127)),
        tquant.int8_matmul_ref(_t(extreme), _t(b * 0 - 127)))


def test_dequantize_and_quant_params_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    for axis in (None, 0):
        jscale = jquant.compute_scale(jnp.asarray(x), axis=axis)
        tscale = tquant.compute_scale(_t(x), axis=axis)
        _eq(jscale, tscale)
        q = tquant.quantize(_t(x), tscale)
        _eq(jquant.quantize(jnp.asarray(x), jscale), q)
        _eq(jquant.dequantize(jnp.asarray(q.numpy()), jscale),
            tquant.dequantize(q, tscale))
    assert tquant.QuantParams() == tquant.QuantParams(8, None)
    assert ([(f.name, f.default) for f in dataclasses.fields(tquant.QuantParams)]
            == [(f.name, f.default)
                for f in dataclasses.fields(jquant.QuantParams)])
