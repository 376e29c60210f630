"""Plain PyTorch versions of paged decode attention (float and int8 pools).

Port of ``repro.kernels.paged_attention.ref``: gather each row's KV blocks
from the shared pool into a contiguous ``[B, Hkv, M·blk, D]`` view (table
entry ``i`` holds absolute positions ``start + i·blk ...``) and run masked
decode attention over it.

  * ``paged_attention_ref`` — float pools; the float kernel's contract.
  * ``paged_attention_int8_dequant_ref`` — int8 pools: q requantized with
    the static ``Q_SCALE``, exact int8·int8 score dots dequantized with the
    per-block K scale, f32 softmax, per-block V scale. This is the int8
    kernel's contract (the reference's Pallas kernel has the same one); the
    ITA integer-softmax oracle is a different function and is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant import recip32
from repro_torch.models.attention import NEG_INF, Q_SCALE, softmax


def _valid_mask(s: int, lens, window, start, device) -> torch.Tensor:
    """[B, S] absolute-position validity mask shared by every version:
    gathered entry ``j`` holds absolute position ``start + j`` (``start``
    None ⇒ 0), valid iff inside ``[lens - window, lens)``."""
    idx = torch.arange(s, device=device)[None, :]
    if start is not None:
        idx = idx + torch.as_tensor(start, dtype=torch.int32,
                                    device=device).reshape(-1, 1)
    cl = torch.as_tensor(lens, dtype=torch.int32, device=device).reshape(-1, 1)
    valid = idx < cl
    if window is not None:
        valid &= idx >= cl - window
    return valid


def gather_kv(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """[N, Hkv, blk, D] pool + [B, M] table → [B, Hkv, M·blk, D] dense KV."""
    _, hkv, blk, d = pool.shape
    b, m = block_table.shape
    g = pool[block_table.long()]            # [B, M, Hkv, blk, D]
    return g.transpose(1, 2).reshape(b, hkv, m * blk, d)


def paged_attention_ref(
    q: torch.Tensor,            # [B, Hq, 1, D] float
    k_pool: torch.Tensor,       # [N, Hkv, blk, D]
    v_pool: torch.Tensor,       # [N, Hkv, blk, D]
    block_table: torch.Tensor,  # [B, M] int32 pool indices
    lens: torch.Tensor,         # [B] int32 valid positions per row
    *,
    window: Optional[int] = None,
    start: Optional[torch.Tensor] = None,  # [B] int32 abs position of entry 0
) -> torch.Tensor:
    b, hq, _, d = q.shape
    hkv = k_pool.shape[1]
    group = hq // hkv
    k = gather_kv(k_pool, block_table)      # [B, Hkv, S, D]
    v = gather_kv(v_pool, block_table)
    valid = _valid_mask(k.shape[2], lens, window, start, q.device)
    # grouped GQA (no KV head expansion), f32 softmax
    qg = q.reshape(b, hkv, group, d).float()
    logits = (qg @ k.float().transpose(-1, -2)) * (d ** -0.5)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p = softmax(logits)
    # rows with no valid entries (empty serve slots) produce zeros
    p = torch.where(valid[:, None, None, :], p, 0.0)
    out = p @ v.float()
    return out.reshape(b, hq, 1, d).to(q.dtype)


def quantize_q(q: torch.Tensor) -> torch.Tensor:
    """q → int8-valued f32 with the static ``Q_SCALE`` (round half even),
    after the ``1/√D`` pre-scale — exactly the int8 kernel's q."""
    d = q.shape[-1]
    qs = q.float() * (d ** -0.5)
    return torch.clamp(torch.round(qs * recip32(Q_SCALE)), -127, 127)


def paged_attention_int8_dequant_ref(
    q: torch.Tensor,            # [B, Hq, 1, D] float (post-RoPE)
    k_pool: torch.Tensor,       # [N, Hkv, blk, D] int8
    v_pool: torch.Tensor,       # [N, Hkv, blk, D] int8
    block_table: torch.Tensor,  # [B, M] int32
    lens: torch.Tensor,         # [B] int32
    *,
    k_scale,                    # python float or per-block [N] f32
    v_scale,
    window: Optional[int] = None,
    start: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    b, hq, _, d = q.shape
    hkv, blk = k_pool.shape[1], k_pool.shape[2]
    group = hq // hkv
    k8 = gather_kv(k_pool, block_table)     # [B, Hkv, S, D] int8
    v8 = gather_kv(v_pool, block_table)
    s = k8.shape[2]

    def entry_scale(scale):
        """Per gathered entry [B, 1, 1, S] f32 (block scale repeated)."""
        scale = torch.as_tensor(scale, dtype=torch.float32, device=q.device)
        if scale.dim() == 0:
            return scale
        per_block = scale[block_table.long()]                 # [B, M]
        return per_block.repeat_interleave(blk, dim=1)[:, None, None, :]

    qg = quantize_q(q).reshape(b, hkv, group, d)
    # int8·int8 dots summed in f32 are exact (|sum| ≤ D·127² < 2²⁴)
    s32 = qg @ k8.float().transpose(-1, -2)
    logits = s32 * Q_SCALE * entry_scale(k_scale)
    valid = _valid_mask(s, lens, window, start, q.device)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p = softmax(logits)
    p = torch.where(valid[:, None, None, :], p, 0.0)
    out = (p * entry_scale(v_scale)) @ v8.float()
    return out.reshape(b, hq, 1, d).to(q.dtype)
