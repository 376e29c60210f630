"""PyTorch port vs JAX reference: the standalone integer softmax (B7).

The same numpy int8 logits go through the JAX package's ``xla`` form
(``int_softmax_ref``) and its Pallas kernel in interpret mode
(``int_softmax_pallas(interpret=True)``), and through the port's
``int_softmax`` on the CPU (``ref.int_softmax_ref``, the version the Hopper
kernel is held to on the card). Tolerance: bit for bit (uint8). The float
softmax yardstick agrees to f32 rounding (rtol 1e-5). The kernel's own
order (``int_softmax_table_ref``: an exponent table over k = max − x and a
division by a per-row reciprocal) is held to both bit for bit, and its
launch plan (``ops.plan``) to the card's limits.
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
    divide, int_softmax_ref, int_softmax_table_ref, reciprocal,
    softmax_float_ref,
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


def every_k(cols, scale, seed=0):
    """Four rows of ``cols`` logits: one holding -128 and 127 (and, where it
    is long enough, every value between: k = max − x takes every value
    0..255), one value repeated (den = cols · 256), two drawn."""
    rng = np.random.default_rng(seed + cols)
    ramp = np.arange(-128, 128)
    row0 = np.resize(rng.permutation(ramp), cols)
    row0[0], row0[-1] = -128, 127
    rows = [row0, np.full(cols, rng.integers(-128, 128)),
            logits(seed + 1, (cols,), scale), uniform(seed + 2, (cols,))]
    return np.stack(rows).astype(np.int8)


@pytest.mark.parametrize("cols", [1, 2, 127, 128, 1370, 4099])
@pytest.mark.parametrize("scale", [0.001, 0.06, 10.0 / 127, 60.0])
def test_table_order_matches_the_ref_and_the_pallas_kernel(cols, scale):
    """The kernel's order (exponent table, per-row reciprocal) equals the
    two-pass softmax and the TPU kernel bit for bit."""
    lq = every_k(cols, scale)
    if cols >= 256:
        k = lq[0].astype(np.int32).max() - lq[0].astype(np.int32)
        assert set(k.tolist()) == set(range(256))
    got = int_softmax_table_ref(torch.from_numpy(lq), logit_scale=scale)
    same(got, int_softmax_ref(torch.from_numpy(lq),
                              logit_scale=scale).numpy())
    same(got, int_softmax_pallas(jnp.asarray(lq), logit_scale=scale,
                                 interpret=True))


def test_table_order_on_the_paper_widths_and_leading_shapes():
    """Drawn logits at a DINOv2-S-wide row block and a leading shape."""
    for shape, scale in (((12, 1370), 10.0 / 127), ((2, 3, 150), 0.06)):
        x = torch.from_numpy(logits(sum(shape), shape, scale))
        same(int_softmax_table_ref(x, logit_scale=scale),
             int_softmax_ref(x, logit_scale=scale).numpy())


def test_reciprocal_division_is_exact():
    """(n · c) >> F is n // den for every den the kernel meets
    (256 ≤ den ≤ 2^30: powers of two, their neighbours, drawn) and every
    numerator e · 255 + den // 2 it forms, and up to 2^31 − 1 where F − 32
    is not a multiple of 8; c fits 32 bits."""
    rng = np.random.default_rng(7)
    dens = np.concatenate([
        [256, 257, 511, 512, 513, 65535, 65536, 65537, 1370 * 256,
         (1 << 21) - 1, 1 << 21, (1 << 21) + 1, (1 << 28) + 1,
         (1 << 30) - 1, 1 << 30],
        rng.integers(256, (1 << 30) + 1, 4000)])
    d = dens[:, None]
    n = np.concatenate([
        np.broadcast_to([0, 1, 255, 65280], (len(dens), 4)),
        d // 2, d // 2 + 65280,
        rng.integers(0, 257, (len(dens), 8)) * 255 + d // 2], axis=1)
    den, n = torch.from_numpy(d), torch.from_numpy(n)
    c, f = reciprocal(den)
    assert bool((c < 1 << 32).all()) and bool((f >= 32).all())
    assert torch.equal(divide(n, c, f), n // den)
    odd = (f - 32) % 8 != 0         # F = 31 + L: exact for any 31-bit n
    assert bool((den[odd] > 1 << 28).all())
    top = torch.tensor([(1 << 31) - 1, (1 << 31) - 2, 1 << 30])
    c_odd, f_odd, d_odd = (t[odd].unsqueeze(-1) for t in (c, f, den))
    assert torch.equal(divide(top, c_odd, f_odd), top // d_odd)
    # the staged body's rows (den ≤ 8192 · 256) give whole bytes
    staged = den <= 8192 * 256
    assert bool(((f[staged] - 32) % 8 == 0).all())


@pytest.mark.parametrize("rows,cols,blocks,warps", [
    (6 * 1370, 1370, 514, 8),     # DINOv2-S, one layer: 2 rows a warp
    (6 * 1500, 1500, 375, 8),     # Whisper-Tiny encoder: 3 rows a warp
    (4 * 128, 128, 128, 4),       # MobileBERT: 1 row a warp, 4 a block
])
def test_plan_fills_the_card_at_the_paper_widths(rows, cols, blocks, warps):
    p = ops.plan(rows, cols)
    assert p.path == "staged" and p.stages == ops.STAGES
    assert (p.blocks, p.threads) == (blocks, 32 * warps)
    # every SM a block where the rows allow blocks of MIN_WARPS warps
    assert p.blocks >= min(ops.SMS, rows // ops.MIN_WARPS)
    assert p.smem <= ops.SMEM_LIMIT
    # the grid fits on the card at once, and no warp takes more rows than
    # the card's resident warps need
    per_sm = min(ops.THREADS_SM // p.threads,
                 ops.SMEM_SM // (p.smem + 1024))
    assert p.blocks <= ops.SMS * per_sm
    resident = ops.SMS * per_sm * warps
    assert -(-rows // (p.blocks * warps)) == -(-rows // resident)
    assert (p.blocks - 1) * warps < -(-rows // -(-rows // resident))


@pytest.mark.parametrize("rows,cols,path", [
    (1, 1, "staged"), (131, 64, "staged"), (5, 4099, "staged"),
    (9, ops.STAGE_COLS - 1, "staged"), (2000, ops.STAGE_COLS, "staged"),
    (9, ops.STAGE_COLS + 1, "long"), (1, 100003, "long"),
    (1, 1 << 22, "long"), (700, 20000, "long"),
])
def test_plan_takes_the_long_body_past_the_staging_limit(rows, cols, path):
    p = ops.plan(rows, cols)
    assert p.path == path and p.smem <= ops.SMEM_LIMIT
    if path == "long":
        assert p.threads == 32 * ops.LONG_WARPS and p.stages == 0
        assert p.blocks == min(rows, ops.SMS * (ops.THREADS_SM // p.threads))
        assert p.smem == ops.TABLE_BYTES + 2 * ops.LONG_WARPS * 4
    else:
        per_sm = min(ops.THREADS_SM // p.threads,
                     ops.SMEM_SM // (p.smem + 1024))
        assert p.threads_per_row == 32 and p.blocks <= ops.SMS * per_sm
        assert ops.MIN_WARPS <= p.rows_per_block <= ops.STAGED_WARPS
        slot = cols // 16 * 16 + ops.EDGE
        assert p.smem == ops.TABLE_BYTES + p.rows_per_block * ops.STAGES * slot
    with pytest.raises(ValueError, match="1 to"):
        ops.plan(rows, ops.MAX_COLS + 1)
