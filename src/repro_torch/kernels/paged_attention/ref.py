"""Plain PyTorch versions of paged decode and verify attention (float and
int8 pools).

Port of ``repro.kernels.paged_attention.ref``: gather each row's KV blocks
from the shared pool into a contiguous ``[B, Hkv, M·blk, D]`` view (table
entry ``i`` holds absolute positions ``start + i·blk ...``) and run masked
attention over it.

  * ``paged_attention_ref`` — one-token decode over float pools; the float
    kernel's contract.
  * ``paged_attention_int8_dequant_ref`` — int8 pools: q requantized with
    the static ``Q_SCALE``, exact int8·int8 score dots dequantized with the
    per-block K scale, f32 softmax, per-block V scale. This is the int8
    kernel's contract (the reference's Pallas kernel has the same one); the
    ITA integer-softmax oracle is a different function and is not ported.
  * ``paged_attention_verify_ref`` / ``paged_attention_verify_int8_dequant_ref``
    — the small-q speculative verify step: ``Q`` query rows per batch row,
    row ``j`` attending ``lens + j`` keys. The ``Q`` rows are folded into
    the GQA group axis (row ``g·Q + j``), so at ``Q == 1`` each is exactly
    the decode version — the same operations on the same shapes.

Each takes ``split_entries``: ``None`` (the contract, a dense softmax) or a
number of table entries per split, for the plain model of the kernels'
split-KV flash decoding (``split_attention``): every split's running max,
sum and unnormalised ``p·v``, then the splits rescaled and added in split
order. Nothing on the serving path passes it; the CPU tests hold it to the
dense version and pin its row independence (row 0 of a verify equals the
decode bit for bit).
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


def _verify_mask(s: int, qlen: int, lens, window, start, device
                 ) -> torch.Tensor:
    """[B, Q, S] per-query validity mask for the small-q verify step:
    query row ``j`` sits ``j`` positions past the committed frontier, so
    its effective length is ``lens + j`` (row 0 sees exactly what a decode
    step sees)."""
    idx = torch.arange(s, device=device)[None, None, :]
    if start is not None:
        idx = idx + torch.as_tensor(start, dtype=torch.int32,
                                    device=device).reshape(-1, 1, 1)
    cl = (torch.as_tensor(lens, dtype=torch.int32, device=device
                          ).reshape(-1, 1, 1)
          + torch.arange(qlen, dtype=torch.int32, device=device
                         )[None, :, None])
    valid = idx < cl
    if window is not None:
        valid &= idx >= cl - window
    return valid


def _fold_rows(valid: torch.Tensor, group: int) -> torch.Tensor:
    """[B, Q, S] → [B, 1, G·Q, S]: the mask of folded row ``g·Q + j`` is
    query ``j``'s."""
    return valid.repeat(1, group, 1)[:, None]


def gather_kv(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """[N, Hkv, blk, D] pool + [B, M] table → [B, Hkv, M·blk, D] dense KV."""
    _, hkv, blk, d = pool.shape
    b, m = block_table.shape
    g = pool[block_table.long()]            # [B, M, Hkv, blk, D]
    return g.transpose(1, 2).reshape(b, hkv, m * blk, d)


def _dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., R, D] · [..., S, D] → [..., R, S], each dot reduced on its own
    (elementwise products summed over the last axis), so a row's bits do
    not depend on how many rows are computed beside it."""
    return (a[..., :, None, :] * b[..., None, :, :]).sum(-1)


def split_attention(logits: torch.Tensor, valid: torch.Tensor,
                    v: torch.Tensor, blk: int, split_entries: int,
                    p_scale=None) -> torch.Tensor:
    """Flash-decoding model of the kernels: the gathered positions in
    splits of ``split_entries`` table entries; per split and row the max
    ``m`` of the valid logits (−inf if none), ``l = Σ exp(logit − m)`` and
    ``acc = Σ p·v`` (``p`` times ``p_scale``, the int8 pools' per-entry V
    scale, after ``l``); then ``M = max m``, and in split order, skipping
    splits with ``m = −inf``, ``L += exp(m − M)·l`` and ``O += exp(m −
    M)·acc``; out ``O / L``, zero where ``L = 0``. logits ``[..., R, S]``,
    valid broadcastable to it, v ``[..., S, D]``."""
    if split_entries < 1:
        raise ValueError(f"split_entries must be ≥ 1, got {split_entries}")
    neg = float("-inf")
    width = split_entries * blk
    parts = []
    for s0 in range(0, logits.shape[-1], width):
        sl = slice(s0, s0 + width)
        lg = torch.where(valid[..., sl], logits[..., sl], neg)
        m = lg.amax(-1, keepdim=True)
        p = torch.exp(lg - torch.where(m == neg, 0.0, m))
        l_ = p.sum(-1, keepdim=True)
        if p_scale is not None:
            p = p * (p_scale[..., sl] if p_scale.dim() else p_scale)
        parts.append((m, l_, _dots(p, v[..., sl, :].transpose(-1, -2))))
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    big = torch.where(big == neg, 0.0, big)
    lsum = torch.zeros_like(parts[0][1])
    out = torch.zeros_like(parts[0][2])
    for m, l_, acc in parts:
        live = m != neg
        w = torch.where(live, torch.exp(m - big), 0.0)
        lsum = torch.where(live, lsum + w * l_, lsum)
        out = torch.where(live, out + w * acc, out)
    return torch.where(lsum > 0, out / torch.where(lsum > 0, lsum, 1.0), 0.0)


def paged_attention_ref(
    q: torch.Tensor,            # [B, Hq, 1, D] float
    k_pool: torch.Tensor,       # [N, Hkv, blk, D]
    v_pool: torch.Tensor,       # [N, Hkv, blk, D]
    block_table: torch.Tensor,  # [B, M] int32 pool indices
    lens: torch.Tensor,         # [B] int32 valid positions per row
    *,
    window: Optional[int] = None,
    start: Optional[torch.Tensor] = None,  # [B] int32 abs position of entry 0
    split_entries: Optional[int] = None,
) -> torch.Tensor:
    b, hq, _, d = q.shape
    hkv = k_pool.shape[1]
    group = hq // hkv
    k = gather_kv(k_pool, block_table)      # [B, Hkv, S, D]
    v = gather_kv(v_pool, block_table)
    valid = _valid_mask(k.shape[2], lens, window, start, q.device)
    if split_entries is not None:
        qg = q.reshape(b, hkv, group, d).float()
        out = split_attention(_dots(qg, k.float()) * (d ** -0.5),
                              valid[:, None, None, :], v.float(),
                              k_pool.shape[2], split_entries)
        return out.reshape(b, hq, 1, d).to(q.dtype)
    # grouped GQA (no KV head expansion), f32 softmax
    qg = q.reshape(b, hkv, group, d).float()
    logits = (qg @ k.float().transpose(-1, -2)) * (d ** -0.5)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p = softmax(logits)
    # rows with no valid entries (empty serve slots) produce zeros
    p = torch.where(valid[:, None, None, :], p, 0.0)
    out = p @ v.float()
    return out.reshape(b, hq, 1, d).to(q.dtype)


def paged_attention_verify_ref(
    q: torch.Tensor,            # [B, Hq, Q, D] float — Q = spec_tokens + 1
    k_pool: torch.Tensor,       # [N, Hkv, blk, D]
    v_pool: torch.Tensor,       # [N, Hkv, blk, D]
    block_table: torch.Tensor,  # [B, M] int32 pool indices
    lens: torch.Tensor,         # [B] int32: committed_len + 1 (row 0's length)
    *,
    window: Optional[int] = None,
    start: Optional[torch.Tensor] = None,
    split_entries: Optional[int] = None,
) -> torch.Tensor:
    """Small-q verify over float pools: query row ``j`` attends ``lens + j``
    keys (the committed history plus the ``j`` drafts written before it)."""
    b, hq, qlen, d = q.shape
    hkv = k_pool.shape[1]
    group = hq // hkv
    k = gather_kv(k_pool, block_table)      # [B, Hkv, S, D]
    v = gather_kv(v_pool, block_table)
    valid = _fold_rows(
        _verify_mask(k.shape[2], qlen, lens, window, start, q.device), group)
    qg = q.reshape(b, hkv, group * qlen, d).float()
    if split_entries is not None:
        out = split_attention(_dots(qg, k.float()) * (d ** -0.5), valid,
                              v.float(), k_pool.shape[2], split_entries)
        return out.reshape(b, hq, qlen, d).to(q.dtype)
    logits = (qg @ k.float().transpose(-1, -2)) * (d ** -0.5)
    logits = torch.where(valid, logits, NEG_INF)
    p = softmax(logits)
    p = torch.where(valid, p, 0.0)
    out = p @ v.float()
    return out.reshape(b, hq, qlen, d).to(q.dtype)


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
    split_entries: Optional[int] = None,
) -> torch.Tensor:
    b, hq, _, d = q.shape
    hkv, blk = k_pool.shape[1], k_pool.shape[2]
    group = hq // hkv
    k8 = gather_kv(k_pool, block_table)     # [B, Hkv, S, D] int8
    v8 = gather_kv(v_pool, block_table)
    s = k8.shape[2]

    qg = quantize_q(q).reshape(b, hkv, group, d)
    # int8·int8 dots summed in f32 are exact (|sum| ≤ D·127² < 2²⁴)
    s32 = qg @ k8.float().transpose(-1, -2)
    logits = s32 * Q_SCALE * _entry_scale(k_scale, block_table, blk, q.device)
    valid = _valid_mask(s, lens, window, start, q.device)
    if split_entries is not None:
        out = split_attention(
            logits, valid[:, None, None, :], v8.float(), blk, split_entries,
            _entry_scale(v_scale, block_table, blk, q.device))
        return out.reshape(b, hq, 1, d).to(q.dtype)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p = softmax(logits)
    p = torch.where(valid[:, None, None, :], p, 0.0)
    out = (p * _entry_scale(v_scale, block_table, blk, q.device)) @ v8.float()
    return out.reshape(b, hq, 1, d).to(q.dtype)


def _entry_scale(scale, block_table, blk: int, device) -> torch.Tensor:
    """Per gathered entry [B, 1, 1, S] f32 (block scale repeated), or the
    scalar scale as given."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=device)
    if scale.dim() == 0:
        return scale
    per_block = scale[block_table.long()]                 # [B, M]
    return per_block.repeat_interleave(blk, dim=1)[:, None, None, :]


def paged_attention_verify_int8_dequant_ref(
    q: torch.Tensor,            # [B, Hq, Q, D] float (post-RoPE)
    k_pool: torch.Tensor,       # [N, Hkv, blk, D] int8
    v_pool: torch.Tensor,       # [N, Hkv, blk, D] int8
    block_table: torch.Tensor,  # [B, M] int32
    lens: torch.Tensor,         # [B] int32: committed_len + 1
    *,
    k_scale,                    # python float or per-block [N] f32
    v_scale,
    window: Optional[int] = None,
    start: Optional[torch.Tensor] = None,
    split_entries: Optional[int] = None,
) -> torch.Tensor:
    """Small-q verify over int8 pools with the decode version's numerics
    (the int8 verify kernel's contract), per-query masks."""
    b, hq, qlen, d = q.shape
    hkv, blk = k_pool.shape[1], k_pool.shape[2]
    group = hq // hkv
    k8 = gather_kv(k_pool, block_table)     # [B, Hkv, S, D] int8
    v8 = gather_kv(v_pool, block_table)
    qg = quantize_q(q).reshape(b, hkv, group * qlen, d)
    s32 = qg @ k8.float().transpose(-1, -2)
    logits = s32 * Q_SCALE * _entry_scale(k_scale, block_table, blk, q.device)
    valid = _fold_rows(
        _verify_mask(k8.shape[2], qlen, lens, window, start, q.device), group)
    if split_entries is not None:
        out = split_attention(
            logits, valid, v8.float(), blk, split_entries,
            _entry_scale(v_scale, block_table, blk, q.device))
        return out.reshape(b, hq, qlen, d).to(q.dtype)
    logits = torch.where(valid, logits, NEG_INF)
    p = softmax(logits)
    p = torch.where(valid, p, 0.0)
    out = (p * _entry_scale(v_scale, block_table, blk, q.device)) @ v8.float()
    return out.reshape(b, hq, qlen, d).to(q.dtype)
