"""PyTorch port vs JAX reference: the Mamba-2 SSD scan's plain versions.

The same numpy inputs go through the JAX package's Pallas kernel
(``ssd_scan_pallas``, interpret mode, on the zero-padded sequence where S
is ragged, as the reference's ``xla`` path pads it), its ``xla`` chunked form
(``_ssd_chunked_xla``, with the carried state) and its sequential oracle,
and through the port's ``ssd_scan`` on the CPU (``ssd_scan_chunked_ref``
over the zero-padded sequence — the version the Hopper kernel is held to on
the card). Float32 throughout; the chunked and sequential forms add in
different orders, so the tolerance is ``rtol = 1e-4`` and
``atol = 1e-4 · max|y|`` (the reference's own tests use 2e-4 / 2e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan_pallas
from repro.kernels.ssd_scan.ops import _ssd_chunked_xla
from repro.kernels.ssd_scan.ops import ssd_scan as jssd_scan
from repro.kernels.ssd_scan.ref import ssd_decode_step as jdecode_step
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jscan_ref
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import (
    pad_to_chunks, ssd_decode_step, ssd_scan_chunked_ref, ssd_scan_ref,
)

torch.set_num_threads(1)


def inputs(s, g, seed, b=2, h=4, p=16, n=16):
    rng = np.random.default_rng(seed)
    dta = -rng.random((b, h, s), np.float32) * 0.1
    x = rng.standard_normal((b, h, s, p), np.float32)
    bm = rng.standard_normal((b, g, s, n), np.float32) * 0.3
    cm = rng.standard_normal((b, g, s, n), np.float32) * 0.3
    return dta, x, bm, cm


def close(got, want):
    want = np.asarray(want)
    atol = 1e-4 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=atol)


def torch_args(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("s", [1, 5, 64, 127, 192])
def test_scan_matches_xla_form_with_state(s, chunk, g):
    """y and the final state against ``_ssd_chunked_xla(return_state=True)``
    (through the reference op, which zero-pads a ragged tail), y against
    the Pallas kernel on the same zero-padded sequence (interpret mode),
    and y against the sequential oracle."""
    arrays = inputs(s, g, seed=s * 10 + chunk + g)
    jy, jstate = jssd_scan(*map(jnp.asarray, arrays), chunk=chunk,
                           backend="xla", return_state=True)
    y, state = ssd_scan(*torch_args(arrays), chunk=chunk, return_state=True)
    assert y.dtype == torch.float32 and state.shape == (2, 4, 16, 16)
    close(y.numpy(), jy)
    close(state.numpy(), jstate)
    close(y.numpy(), jscan_ref(*map(jnp.asarray, arrays)))
    c = min(chunk, s)
    padded = [jnp.asarray(a) for a in pad_to_chunks(*torch_args(arrays), c)]
    jpal = ssd_scan_pallas(*padded, chunk=c, interpret=True)
    close(y.numpy(), np.asarray(jpal)[:, :, :s])
    # without the state, the same y
    np.testing.assert_array_equal(
        ssd_scan(*torch_args(arrays), chunk=chunk).numpy(), y.numpy())


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("s,chunk", [(64, 32), (192, 64), (128, 64)])
def test_chunked_ref_matches_pallas_kernel(s, chunk, g):
    """The plain chunked form against the Pallas kernel body itself
    (interpret mode), on whole chunks as the kernel requires."""
    arrays = inputs(s, g, seed=s + chunk + g)
    want = ssd_scan_pallas(*map(jnp.asarray, arrays), chunk=chunk,
                           interpret=True)
    got = ssd_scan_chunked_ref(*torch_args(arrays), chunk=chunk)
    close(got.numpy(), want)
    _, jstate = _ssd_chunked_xla(*map(jnp.asarray, arrays), chunk=chunk,
                                 return_state=True)
    _, state = ssd_scan_chunked_ref(*torch_args(arrays), chunk=chunk,
                                    return_state=True)
    close(state.numpy(), jstate)


@pytest.mark.parametrize("s,g", [(5, 1), (40, 2)])
def test_sequential_ref_matches_reference_oracle(s, g):
    arrays = inputs(s, g, seed=7 + s)
    close(ssd_scan_ref(*torch_args(arrays)).numpy(),
          jscan_ref(*map(jnp.asarray, arrays)))


def test_decode_step_matches_reference_and_scan():
    """Six chained one-token updates against the reference's, and the last
    output against the scan over the same tokens."""
    dta, x, bm, cm = inputs(6, 2, seed=11)
    h = x.shape[1]
    rng = np.random.default_rng(12)
    state0 = rng.standard_normal((2, h, 16, 16), np.float32) * 0.1
    jstate, tstate = jnp.asarray(state0), torch.from_numpy(state0)
    zero = torch.zeros_like(tstate)
    for t in range(6):
        bh = np.repeat(bm[:, :, t], h // 2, axis=1)
        ch = np.repeat(cm[:, :, t], h // 2, axis=1)
        jstate, jy = jdecode_step(jstate, dta[:, :, t], x[:, :, t], bh, ch)
        tstate, ty = ssd_decode_step(tstate, *torch_args(
            (dta[:, :, t], x[:, :, t], bh, ch)))
        zero, zy = ssd_decode_step(zero, *torch_args(
            (dta[:, :, t], x[:, :, t], bh, ch)))
        close(ty.numpy(), jy)
        close(tstate.numpy(), jstate)
    close(zy.numpy(), ssd_scan(*torch_args((dta, x, bm, cm)))[:, :, -1])


def test_scan_keeps_input_dtype_and_refuses_bad_shapes():
    dta, x, bm, cm = torch_args(inputs(9, 1, seed=3))
    y = ssd_scan(dta, x.bfloat16(), bm, cm)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    with pytest.raises(ValueError, match="groups"):
        ssd_scan(dta, x, bm.repeat(1, 3, 1, 1), cm.repeat(1, 3, 1, 1))
    with pytest.raises(ValueError, match="dta"):
        ssd_scan(dta[:, :, :4], x, bm, cm)
