"""PyTorch port vs JAX reference: the ITA fused int8 attention (B6) and
``int8_attention``.

The same numpy inputs go through the JAX package's ``xla`` form
(``ita_attention_ref``) and its Pallas kernel in interpret mode
(``ita_attention_pallas(interpret=True)``), and through the port's
``ita_attention`` on the CPU (``ref.ita_attention_ref`` over repeated kv
heads, the version the Hopper kernel is held to on the card). Tolerance: bit
for bit, for the int8 output and for ``int8_attention``'s float output in
f32 and bf16.

Two reference-side faults (ROADMAP Queue C) are pinned here: the JAX oracle
drops the keys past the last whole kv tile where the port (like the TPU
kernel) refuses the shape, and in the causal corner where a row's logits
saturate at the exponent floor the port follows the TPU kernel, not the
oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ita_attention.kernel import ita_attention_pallas
from repro.kernels.ita_attention.ops import ita_attention as jita_attention
from repro.kernels.ita_attention.ref import (
    attention_float_ref as jattention_float_ref,
)
from repro.kernels.ita_attention.ref import ita_attention_ref as jita_ref
from repro.models.attention import int8_attention as jint8_attention
from repro_torch.kernels.ita_attention import ops
from repro_torch.kernels.ita_attention.ref import (
    attention_float_ref, ita_attention_ref,
)
from repro_torch.models import attention

torch.set_num_threads(1)

SC = 4.0 / 127  # int8_attention's static scales


def int8_inputs(seed, b, hq, hkv, sq, skv, d, *, uniform=False):
    """int8 q, k, v [B, H, S, D]: quantized unit normals as
    ``int8_attention`` makes them (q pre-scaled by 1/√d), or uniform int8
    (scores that saturate the logits)."""
    rng = np.random.default_rng(seed)
    if uniform:
        return tuple(rng.integers(-127, 128, (b, h, s, d)).astype(np.int8)
                     for h, s in ((hq, sq), (hkv, skv), (hkv, skv)))
    q = rng.standard_normal((b, hq, sq, d)) * d ** -0.5
    k = rng.standard_normal((b, hkv, skv, d))
    v = rng.standard_normal((b, hkv, skv, d))
    return tuple(np.clip(np.round(x / SC), -127, 127).astype(np.int8)
                 for x in (q, k, v))


def same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    bad = got != want
    assert not bad.any(), f"{bad.sum()} of {bad.size} outputs differ"


def port(q, k, v, **kw):
    return ops.ita_attention(*(torch.from_numpy(x) for x in (q, k, v)), **kw)


def pallas(q, k, v, *, block_q=128, block_kv=128, **kw):
    """The TPU kernel in interpret mode over kv heads repeated to the query
    heads (as the JAX op feeds it)."""
    b, hq, sq, d = q.shape
    g = hq // k.shape[1]
    kf, vf = (np.repeat(x, g, axis=1).reshape(b * hq, -1, d) for x in (k, v))
    y = ita_attention_pallas(jnp.asarray(q.reshape(b * hq, sq, d)),
                             jnp.asarray(kf), jnp.asarray(vf),
                             block_q=block_q, block_kv=block_kv,
                             interpret=True, **kw)
    return np.asarray(y).reshape(q.shape)


@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
@pytest.mark.parametrize("hkv", [1, 2, 4])
@pytest.mark.parametrize("s,d,block_kv", [(256, 64, 32), (128, 32, 64),
                                          (256, 16, 128)])
def test_plain_version_matches_pallas_and_xla(causal, hkv, s, d, block_kv):
    """Hq = 4 over Hkv ∈ {1, 2, Hq}; block_q = 128 (the TPU kernel's), so
    the causal tile skip sees q tiles of 128 rows over kv tiles of 32–128."""
    q, k, v = int8_inputs(s + d + hkv, 2, 4, hkv, s, s, d)
    kw = dict(qk_scale=SC * SC, v_scale=SC, out_scale=0.9 * SC,
              causal=causal, block_kv=block_kv)
    got = port(q, k, v, **kw)
    same(got, pallas(q, k, v, **kw))
    same(got, jita_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             backend="xla", **kw))


@pytest.mark.parametrize("sq,skv,block_q,block_kv,causal", [
    (128, 128, 64, 32, True),    # several q tiles, kv tiles smaller
    (128, 128, 32, 64, True),    # q tiles smaller than kv tiles
    (64, 256, 64, 64, False),    # cross attention (Sq ≠ Skv)
    (100, 100, 25, 20, True),    # lengths that are no power of two
])
def test_tilings_and_saturated_scores(sq, skv, block_q, block_kv, causal):
    """Uniform int8 inputs (the logits saturate at ±127), another scale set
    (the epilogue multiplies by 1.5), and tilings off the defaults."""
    q, k, v = int8_inputs(sq + skv, 1, 4, 2, sq, skv, 32, uniform=True)
    kw = dict(qk_scale=1e-3, v_scale=0.03, out_scale=0.02, causal=causal,
              block_q=block_q, block_kv=block_kv)
    got = port(q, k, v, **kw)
    same(got, pallas(q, k, v, **kw))
    if block_q >= sq or not causal:  # no tile skip: the JAX oracle agrees
        kw.pop("block_q")
        same(got, jita_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), backend="xla", **kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["xla", "interpret"])
@pytest.mark.parametrize("causal", [True, False])
def test_int8_attention_matches_jax(dtype, backend, causal):
    """Float in and out: quantize with a true f32 divide, the ITA kernel,
    dequantize; equal bit for bit in f32 and in bf16."""
    rng = np.random.default_rng(7)
    b, hq, hkv, s, d = 2, 4, 2, 128, 32
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32)
               for h in (hq, hkv, hkv))
    jd = getattr(jnp, dtype)
    want = jint8_attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                           jnp.asarray(v, jd), causal=causal,
                           backend=backend)
    got = attention.int8_attention(
        *(torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)),
        causal=causal)
    assert got.dtype == getattr(torch, dtype)
    same(got.float(), np.asarray(want.astype(jnp.float32)))


def test_int8_attention_constants_match():
    from repro.models import attention as jattention

    assert attention.LOGIT_AMAX == jattention.LOGIT_AMAX
    assert attention.ATTN_OUT_SCALE == jattention.ATTN_OUT_SCALE


def test_port_refuses_the_tail_keys_the_jax_ref_drops():
    """Reference-side fault 1: with S = 200 and 128-wide tiles the JAX
    oracle (the op's default ``xla`` backend) attends only the first 128
    keys; the TPU kernel raises, and so does the port."""
    q, k, v = int8_inputs(11, 1, 2, 2, 200, 200, 64)
    kw = dict(qk_scale=SC * SC, v_scale=SC, out_scale=SC)
    jq, jk, jv = (jnp.asarray(x.reshape(2, 200, 64)) for x in (q, k, v))
    dropped = jita_ref(jq, jk, jv, **kw)
    assert (np.asarray(dropped)
            == np.asarray(jita_ref(jq, jk[:, :128], jv[:, :128], **kw))).all()
    with pytest.raises(ValueError, match="not divisible"):
        ita_attention_pallas(jq, jk, jv, interpret=True, **kw)
    with pytest.raises(ValueError, match="not divisible"):
        port(q, k, v, **kw)
    with pytest.raises(ValueError, match="not divisible"):
        ita_attention_ref(*(torch.from_numpy(x.reshape(2, 200, 64))
                            for x in (q, k, v)), **kw)


def test_causal_floor_corner_follows_the_tpu_kernel():
    """Reference-side fault 2: q ≡ 127, k ≡ −127 saturate every logit at
    the exponent floor when logit_amax = 1000 (alpha mult 2908, rshift 0),
    so the block exponent stays −31 and a masked entry still weighs
    p8 = 127. The TPU kernel skips the tiles above the diagonal, the JAX
    oracle folds them in: 64 of 128 rows differ. The port equals the
    kernel; at the default logit_amax the three agree."""
    s, d = 128, 64
    q = np.full((1, 1, s, d), 127, np.int8)
    k = np.full((1, 1, s, d), -127, np.int8)
    v = np.random.default_rng(3).integers(-127, 128, (1, 1, s, d)
                                          ).astype(np.int8)
    for amax, rows_differ in ((1000.0, 64), (10.0, 0)):
        kw = dict(qk_scale=1.0, v_scale=1.0, out_scale=1.0, causal=True,
                  logit_amax=amax, block_q=64, block_kv=64)
        want = pallas(q, k, v, **kw)
        got = port(q, k, v, **kw)
        same(got, want)
        kw.pop("block_q")
        oracle = np.asarray(jita_ref(*(jnp.asarray(x.reshape(1, s, d))
                                       for x in (q, k, v)), **kw))
        diff = (oracle.reshape(q.shape) != want).any(-1).sum()
        assert diff == rows_differ


def test_float_yardstick_matches():
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 64, 16)).astype(np.float32)
               for _ in range(3))
    for causal in (False, True):
        np.testing.assert_allclose(
            attention_float_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                                scale=0.25, causal=causal).numpy(),
            np.asarray(jattention_float_ref(
                *(jnp.asarray(x) for x in (q, k, v)), scale=0.25,
                causal=causal)),
            rtol=1e-5, atol=1e-6)


def test_wrapper_checks_inputs():
    q, k, v = (torch.zeros((1, h, 64, 16), dtype=torch.int8)
               for h in (4, 3, 3))
    kw = dict(qk_scale=1e-3, v_scale=SC, out_scale=SC)
    with pytest.raises(ValueError, match="not a multiple of kv heads"):
        ops.ita_attention(q, k, v, **kw)
    with pytest.raises(ValueError, match="int8"):
        ops.ita_attention(q.float(), k[:, :2], v[:, :2], **kw)
    with pytest.raises(ValueError, match="not divisible"):
        ops.ita_attention(q, k[:, :2], v[:, :2], block_kv=48, **kw)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        ops.ita_attention_cuda(q, k[:, :2], v[:, :2], **kw)
    assert ops.KERNEL.launches == 0  # the CPU path never counts a launch


@pytest.mark.parametrize("b,hq,hkv,s,d,bkv,want", [
    # want: warps, heads, kt, dt, stages
    (1, 32, 2, 2048, 128, 128, (8, 8, 4, 4, 2)),  # glm4-9b prompt (timed)
    (1, 4, 4, 128, 128, 128, (4, 1, 4, 4, 2)),    # MobileBERT
    (1, 6, 6, 1500, 64, 125, (4, 1, 4, 4, 2)),    # Whisper-Tiny encoder
    (1, 6, 6, 1370, 64, 137, (4, 1, 8, 4, 2)),    # DINOv2-S
    (1, 32, 2, 1000, 128, 125, (8, 8, 4, 4, 2)),  # 1000 rows: 16 ∤ S
    (1, 6, 2, 96, 32, 32, (4, 1, 4, 4, 2)),       # group 3
    (2, 8, 4, 64, 64, 64, (4, 2, 4, 4, 2)),       # group 2
    (1, 4, 1, 100, 20, 20, (4, 4, 4, 4, 2)),      # D = 20, 20-key tiles
    (1, 4, 2, 256, 48, 32, (4, 2, 4, 4, 2)),      # D = 48
    (1, 2, 2, 256, 256, 256, (4, 1, 8, 8, 1)),    # D = 256, 256-key tiles
])
def test_plan_routes_every_width(b, hq, hkv, s, d, bkv, want):
    """B6's launch plan: 16 query rows a warp, 8 warps a block where eight
    query heads share a kv head, else 4; a block's rows share one kv head
    (as many heads of the GQA group as the group allows, at the same
    positions); the blocks cover every row; the kernel instance holds the
    padded tile (scores packed for 256-key tiles and D = 256); the shared
    memory stays within a block's limit (two stages where they fit, so
    D = 256 with 256-key tiles takes one)."""
    p = ops.plan(b, hq, hkv, s, d, bkv)
    assert (p.warps, p.heads, p.kt, p.dt, p.stages) == want
    assert p.heads * p.positions == 16 * p.warps
    assert (hq // hkv) % p.heads == 0 and p.warps % p.heads == 0
    assert p.blocks * p.heads * p.positions >= b * hq * s
    assert p.blocks == b * hq // p.heads * -(-s // p.positions)
    assert p.key_slices * 32 >= bkv > (p.key_slices - 1) * 32
    assert p.d_slices * 32 >= d > (p.d_slices - 1) * 32
    assert p.packed == (p.kt == 8 or p.dt == 8)
    assert p.smem <= ops.SMEM_LIMIT
    if (b, hq, s, d) == (1, 32, 2048, 128):
        # glm4-9b: 512 blocks of 8 heads x 16 positions for 132 SMs
        assert p.blocks == 512 and p.positions == 16
