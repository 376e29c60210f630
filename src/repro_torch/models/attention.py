"""Attention constants and the prefill attention (port of
``repro.models.attention``).

``chunked_attention`` is plain PyTorch, as the reference's is plain jnp:
query blocks stream over the keys so the score matrix is one chunk at a
time, with causal, bidirectional and sliding-window masks and GQA head
grouping. ``decode_attention`` is the one-token attention over a dense
per-slot cache (the float arena's, and the hybrid family's ring layers),
and ``decode_attention_int8`` its ITA integer counterpart on ``serve_quant``
arenas, both plain PyTorch as the reference's are plain jnp (bit-exact
with the jitted reference in the integer case). Decode attention over the
block pool lives in
``repro_torch.kernels.paged_attention``. ``int8_attention`` is the
paper-faithful INT8 attention (float in and out, quantized inside) over the
ITA fused kernel, ``repro_torch.kernels.ita_attention``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.quant import int8_matmul_ref, recip32
from repro_torch.kernels.ita_attention.ops import ita_attention

NEG_INF = -1e30

# Static calibration scales for the INT8 serving path (cover ±4σ for unit-
# variance activations; the paper's flow likewise uses offline static
# quantization).
ACT_SCALE = 4.0 / 127
KV_SCALE = 4.0 / 127
Q_SCALE = 4.0 / 127
ATTN_OUT_SCALE = 4.0 / 127
LOGIT_AMAX = 10.0


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``exp(x - max) / sum`` — the reference's softmax formula (f32)."""
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


def _expand_kv(k: torch.Tensor, group: int) -> torch.Tensor:
    if group == 1:
        return k
    return k.repeat_interleave(group, dim=1)


def chunked_attention(
    q: torch.Tensor,  # [B, Hq, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Skv, D]
    v: torch.Tensor,  # [B, Hkv, Skv, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,  # sliding window (tokens), None = global
    chunk_q: int = 128,
    q_offset: int = 0,  # global position of q[0] (prefill continuation)
) -> torch.Tensor:
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    kf = _expand_kv(k, group).float()
    vf = _expand_kv(v, group).float()
    scale = d ** -0.5
    bq = min(chunk_q, sq)
    cols = torch.arange(skv, device=q.device)
    outs = []
    for row0 in range(0, sq, bq):
        # the last chunk may be short: the reference pads it and discards
        # the pad rows, which leaves the real rows' arithmetic unchanged
        q_blk = q[:, :, row0:row0 + bq].float()
        rows = row0 + torch.arange(q_blk.shape[2], device=q.device) + q_offset
        # f32 accumulation of the (possibly bf16) operands (flash convention)
        logits = (q_blk @ kf.transpose(-1, -2)) * scale
        mask = torch.ones((q_blk.shape[2], skv), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= cols[None, :] <= rows[:, None]
        if window is not None:
            mask &= cols[None, :] > rows[:, None] - window
        logits = torch.where(mask, logits, NEG_INF)
        p = softmax(logits).to(v.dtype)
        outs.append(p.float() @ vf)
    return torch.cat(outs, dim=2).to(q.dtype)


def decode_attention(
    q: torch.Tensor,        # [B, Hq, 1, D]
    k_cache: torch.Tensor,  # [B, Hkv, S_cache, D]
    v_cache: torch.Tensor,
    cache_len,              # [] or [B] int — valid entries (per row)
    *,
    ring: bool = False,     # ring buffer (sliding-window cache)
) -> torch.Tensor:
    """One query row per sequence against its first ``cache_len`` cache
    rows (all of them once a ring has wrapped). KV heads stay unexpanded:
    the query-group dimension rides in the products instead."""
    b, hq, _, d = q.shape
    hkv, s_cache = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    idx = torch.arange(s_cache, device=q.device)
    cl = torch.as_tensor(cache_len, dtype=torch.int32,
                         device=q.device).reshape(-1, 1)
    if ring:
        cl = torch.clamp(cl, max=s_cache)
    valid = idx[None, :] < cl                          # [B or 1, S]
    qg = q.reshape(b, hkv, group, d)                   # Sq = 1 folded in
    logits = torch.einsum("bhgd,bhkd->bhgk", qg.float(),
                          k_cache.float()) * (d ** -0.5)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p = softmax(logits)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return out.reshape(b, hq, 1, d).to(q.dtype)


def _q_to_int8_scale(d: int) -> float:
    """The one f32 constant the reference's jitted ``q · d^-½ / Q_SCALE``
    becomes: XLA turns the division into a multiply by the f32 reciprocal
    and folds the two constant multiplies into one (their f32 product), so
    q is rounded once, from ``q · c``."""
    return float(np.float32(np.float32(d ** -0.5) * np.float32(
        recip32(Q_SCALE))))


def decode_attention_int8(
    q: torch.Tensor,         # [B, Hq, 1, D] float (post-RoPE)
    k_cache8: torch.Tensor,  # [B, Hkv, S_cache, D] int8-valued (KV_SCALE)
    v_cache8: torch.Tensor,
    cache_len,               # [] or [B] int — valid entries (per row)
    *,
    window: Optional[int] = None,
    start=None,              # [B] absolute position of cache row 0
) -> torch.Tensor:
    """One-token ITA integer attention against an int8-valued KV cache.

    Port of the reference's ``decode_attention_int8`` (grouped GQA): int8
    q, exact int32 scores, requantized to int8 logits, the ITA base-2
    integer softmax (``core.ita``), int8 probabilities and an exact int32
    AV product, divided by the probabilities' sum. The cache may be int8
    or hold the integers in a float dtype (the arena's compute-dtype
    cache). ``window`` masks entries before ``cache_len − window``;
    ``start`` shifts the masks to absolute positions (row ``j`` holds
    position ``start + j``). A row with no valid entry attends every row
    alike, as in the reference.
    """
    from repro_torch.core import ita
    from repro_torch.core.quant import quantize_to_fixed_point_py, requantize

    b, hq, _, d = q.shape
    hkv, s_cache = k_cache8.shape[1], k_cache8.shape[2]
    group = hq // hkv
    q8 = torch.clamp(torch.round(q.float() * _q_to_int8_scale(d)), -127, 127)
    q8g = q8.reshape(b, hkv, group, d)             # Sq = 1 folded in
    # exact integer products (float64 on every device: an f32 product
    # is exact only while each partial sum stays below 2^24, which the AV
    # sum passes at S ≈ 1040 on a row of equal logits)
    s32 = int8_matmul_ref(q8g, k_cache8.transpose(-1, -2))  # [B, Hkv, g, S]

    s_logit = LOGIT_AMAX / 127.0
    mlt, sh = quantize_to_fixed_point_py(Q_SCALE * KV_SCALE / s_logit)
    s8 = requantize(s32, mlt, sh)
    spec = ita.SoftmaxSpec(s_logit)
    t = (s8.to(torch.int32) * spec.alpha_mult) >> ita.sra_count(
        spec.alpha_rshift)
    neg = ita.NEG_T
    t = torch.clamp(t, min=neg)
    idx = torch.arange(s_cache, dtype=torch.int32, device=q.device)
    idx = idx.reshape(1, 1, 1, -1)
    if start is not None:
        idx = idx + torch.as_tensor(start, dtype=torch.int32,
                                    device=q.device).reshape(-1, 1, 1, 1)
    cl = torch.as_tensor(cache_len, dtype=torch.int32,
                         device=q.device).reshape(-1, 1, 1, 1)
    valid = idx < cl
    if window is not None:
        valid = valid & (idx >= cl - window)
    t = torch.where(valid, t, neg)
    m = t.amax(dim=-1, keepdim=True)
    be = -((-m) >> ita.FB)
    e = ita.exp2_fixed(torch.clamp(t - (be << ita.FB), min=neg))
    p8 = torch.clamp(e >> 1, max=127)
    av = int8_matmul_ref(p8, v_cache8)             # [B, Hkv, group, D]
    den = torch.clamp(p8.sum(dim=-1, keepdim=True, dtype=torch.int32), min=1)
    y = av.float() / den.float() * KV_SCALE
    return y.reshape(b, hq, 1, d).to(q.dtype)


def _quantize_static(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``clip(round(x / scale))`` to int8, rounding half to even, with a
    true f32 divide: the reference runs ``int8_attention`` eagerly, so XLA
    does not turn the divide into a multiply by the reciprocal. The divisor
    is a tensor on ``x``'s device because PyTorch's CUDA divide by a Python
    number multiplies by its reciprocal; ``full`` fills it on the device,
    with no copy from the host."""
    div = torch.full((), scale, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x / div), -127, 127).to(torch.int8)


def int8_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *,
    causal: bool = True,
    q_scale: float = 4.0 / 127,   # static calibration: post-RoPE/rsqrt(d) q
    k_scale: float = 4.0 / 127,
    v_scale: float = 4.0 / 127,
    out_scale: float = 4.0 / 127,
    block_q: int = 128,
    block_kv: int = 128,
) -> torch.Tensor:
    """Paper-faithful INT8 attention (float in/out; quantized inside).

    Inputs are float [B, H, S, D] after RoPE (k and v may have fewer heads:
    GQA); q is pre-scaled by 1/√d. Static scales come from calibration
    (defaults cover ±4σ activations). ``block_q`` / ``block_kv`` are the ITA
    kernel's tiles (the reference's 128 by default); a sequence length they
    do not divide needs its own (1500 = 12 × 125, 1370 = 10 × 137).
    """
    d = q.shape[-1]
    qs = q.to(torch.float32) * (d ** -0.5)
    y8 = ita_attention(
        _quantize_static(qs, q_scale),
        _quantize_static(k.to(torch.float32), k_scale),
        _quantize_static(v.to(torch.float32), v_scale),
        qk_scale=q_scale * k_scale, v_scale=v_scale, out_scale=out_scale,
        causal=causal, block_q=block_q, block_kv=block_kv,
    )
    return (y8.to(torch.float32) * out_scale).to(q.dtype)
