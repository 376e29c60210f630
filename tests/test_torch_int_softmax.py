"""PyTorch port vs JAX reference: the standalone integer softmax (B7).

The same numpy int8 logits go through the JAX package's ``xla`` form
(``int_softmax_ref``) and its Pallas kernel in interpret mode
(``int_softmax_pallas(interpret=True)``), and through the port's
``int_softmax`` on the CPU (``ref.int_softmax_ref``, the version the Hopper
kernel is held to on the card). Tolerance: bit for bit (uint8). The float
softmax yardstick agrees to f32 rounding (rtol 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.int_softmax.kernel import int_softmax_pallas
from repro.kernels.int_softmax.ops import int_softmax as jint_softmax
from repro.kernels.int_softmax.ref import int_softmax_ref as jint_softmax_ref
from repro.kernels.int_softmax.ref import softmax_float_ref as jsoftmax_float
from repro_torch.kernels.int_softmax import ops
from repro_torch.kernels.int_softmax.ref import (
    int_softmax_ref, softmax_float_ref,
)

torch.set_num_threads(1)


def logits(seed, shape, scale=10.0 / 127, spread=3.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * spread
    return np.clip(np.round(x / scale), -127, 127).astype(np.int8)


def uniform(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(-127, 128, shape).astype(np.int8)


def same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.uint8 and want.dtype == np.uint8
    assert tuple(got.shape) == want.shape
    bad = got.numpy() != want
    assert not bad.any(), f"{bad.sum()} of {bad.size} probabilities differ"


@pytest.mark.parametrize("rows,cols", [(64, 128), (256, 512), (512, 300),
                                       (8, 1370)])
@pytest.mark.parametrize("scale", [0.06, 10.0 / 127, 60.0])
@pytest.mark.parametrize("draw", [logits, uniform])
def test_plain_version_matches_the_pallas_kernel(rows, cols, scale, draw):
    """Rows the TPU kernel takes (a multiple of its 256-row block, or fewer
    than one block)."""
    lq = draw(rows * cols, (rows, cols))
    want = int_softmax_pallas(jnp.asarray(lq), logit_scale=scale,
                              interpret=True)
    same(ops.int_softmax(torch.from_numpy(lq), logit_scale=scale), want)
    same(int_softmax_ref(torch.from_numpy(lq), logit_scale=scale), want)


@pytest.mark.parametrize("shape", [(1000, 77), (257, 1), (3, 5, 4099),
                                   (2, 6, 13, 150), (1, 2)])
def test_any_rows_and_leading_shape_match_the_xla_ref(shape):
    """R not a multiple of 256 (the TPU kernel refuses it; the xla path
    takes it) and leading shapes reshaped as the JAX op does."""
    scale = 10.0 / 127
    lq = logits(sum(shape), shape)
    want = jint_softmax(jnp.asarray(lq), logit_scale=scale)
    same(ops.int_softmax(torch.from_numpy(lq), logit_scale=scale), want)
    flat = lq.reshape(-1, shape[-1])
    same(int_softmax_ref(torch.from_numpy(flat), logit_scale=scale),
         jint_softmax_ref(jnp.asarray(flat), logit_scale=scale))


def test_float_yardstick_matches():
    lq = logits(5, (16, 200))
    np.testing.assert_allclose(
        softmax_float_ref(torch.from_numpy(lq), logit_scale=0.05).numpy(),
        np.asarray(jsoftmax_float(jnp.asarray(lq), logit_scale=0.05)),
        rtol=1e-5, atol=1e-7)


def test_wrapper_checks_inputs():
    with pytest.raises(ValueError, match="int8"):
        ops.int_softmax(torch.zeros((2, 3), dtype=torch.int32),
                        logit_scale=0.05)
    with pytest.raises(ValueError, match="1 to"):
        ops.int_softmax(torch.zeros((2, 0), dtype=torch.int8),
                        logit_scale=0.05)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        ops.int_softmax_cuda(torch.zeros((2, 3), dtype=torch.int8),
                             logit_scale=0.05)
    assert ops.KERNEL.launches == 0  # the CPU path never counts a launch
