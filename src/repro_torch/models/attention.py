"""Attention constants and the prefill attention (port of
``repro.models.attention``).

``chunked_attention`` is plain PyTorch, as the reference's is plain jnp:
query blocks stream over the keys so the score matrix is one chunk at a
time, with causal, bidirectional and sliding-window masks and GQA head
grouping. Decode attention over the block pool lives in
``repro_torch.kernels.paged_attention``.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30

# Static calibration scales for the INT8 serving path (cover ±4σ for unit-
# variance activations; the paper's flow likewise uses offline static
# quantization).
ACT_SCALE = 4.0 / 127
KV_SCALE = 4.0 / 127
Q_SCALE = 4.0 / 127


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
