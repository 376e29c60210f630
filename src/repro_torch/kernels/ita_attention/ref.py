"""Plain PyTorch versions of the ITA fused int8 attention.

Port of ``repro.kernels.ita_attention.ref``. ``ita_attention_ref`` runs the
integer schedule of the TPU kernel
(``repro/kernels/ita_attention/kernel.py:ita_attention_pallas``) one kv tile
at a time, in order: int32 score dots, requantization to int8 logits, the
base-2 Q(FB) exponent, an integer block exponent per row, 7-bit
probabilities, and the partial A·V sum and denominator rescaled by exact
right shifts. Because of those shifts the result depends on the tiling, so
the tile size and order are part of the contract. The only float step is the
final ``acc / den · (s_v / s_out)`` in f32. The Hopper kernel
(``csrc/ita_attention.cu``) is held to this version bit for bit.

It differs from the JAX oracle in two ways, both where the TPU kernel does:

* sequence lengths that ``block_q`` / ``block_kv`` do not divide raise
  ``ValueError`` (the JAX oracle silently drops the keys past the last whole
  kv tile);
* when causal, row ``r`` folds in kv tile ``ki`` only if
  ``ki·bkv ≤ (r // bq)·bq + bq − 1``: the TPU kernel skips a tile lying
  wholly above the diagonal of the row's q tile. The JAX oracle folds every
  tile in, which differs only where a row's logits saturate at the
  exponent floor (ROADMAP Queue C).

``attention_float_ref`` is ordinary float attention, the yardstick for the
quantization error.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import ita, quant


def tiling(sq: int, skv: int, block_q: int, block_kv: int) -> Tuple[int, int]:
    """``(bq, bkv)`` as the TPU kernel clips them; raises where they do not
    divide the sequence lengths."""
    bq, bkv = min(block_q, sq), min(block_kv, skv)
    if bq < 1 or bkv < 1 or sq % bq or skv % bkv:
        raise ValueError(f"seq lengths {(sq, skv)} not divisible by "
                         f"{(bq, bkv)}")
    return bq, bkv


@functools.lru_cache(maxsize=None)
def constants(qk_scale: float, v_scale: float, out_scale: float,
              logit_amax: float):
    """Host-side fixed-point constants, as the TPU kernel folds them:
    ``(qk_mult, qk_shift, alpha_mult, alpha_rshift, out_mult)``.
    ``out_mult`` is the f32 that ``v_scale / out_scale`` rounds to."""
    s_logit = logit_amax / 127.0
    qk_mult, qk_shift = quant.quantize_to_fixed_point_py(qk_scale / s_logit)
    spec = ita.SoftmaxSpec(s_logit)
    return (qk_mult, qk_shift, spec.alpha_mult,
            ita.sra_count(spec.alpha_rshift),
            float(np.float32(v_scale / out_scale)))


def _exact_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched int8 product with exact int32 sums. Float64 holds every
    integer below 2⁵³, far above the largest sum here (bkv or D times 127²),
    so the product is exact in any order of addition, on the CPU and on the
    card alike, whatever the TF32 settings."""
    return torch.bmm(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def ita_attention_ref(
    q: torch.Tensor,  # [BH, Sq, D] int8
    k: torch.Tensor,  # [BH, Skv, D] int8
    v: torch.Tensor,  # [BH, Skv, D] int8
    *,
    qk_scale: float,
    v_scale: float,
    out_scale: float,
    causal: bool = False,
    logit_amax: float = 10.0,
    block_q: int = 128,
    block_kv: int = 128,
) -> torch.Tensor:
    bh, sq, d = q.shape
    skv = k.shape[1]
    bq, bkv = tiling(sq, skv, block_q, block_kv)
    qk_mult, qk_shift, am, ar, out_mult = constants(
        qk_scale, v_scale, out_scale, logit_amax)
    dev = q.device
    acc = torch.zeros((bh, sq, d), dtype=torch.int32, device=dev)
    den = torch.zeros((bh, sq, 1), dtype=torch.int32, device=dev)
    be = torch.full((bh, sq, 1), -31, dtype=torch.int32, device=dev)
    rows = torch.arange(sq, device=dev)[:, None]
    for ki in range(skv // bkv):
        c0 = ki * bkv
        # causal: the rows that fold this tile in are those of the q tiles
        # it does not lie wholly above — a suffix of the rows
        r0 = (c0 // bq) * bq if causal else 0
        if r0 >= sq:
            break
        k_t = k[:, c0:c0 + bkv].transpose(1, 2)
        s32 = _exact_dot(q[:, r0:], k_t)  # [BH, Sq − r0, bkv]
        s8 = quant.requantize(s32, qk_mult, qk_shift)
        t = torch.clamp((s8.to(torch.int32) * am) >> ar, min=ita.NEG_T)
        if causal:
            cols = c0 + torch.arange(bkv, device=dev)[None, :]
            t = torch.where(cols > rows[r0:], ita.NEG_T, t)
        be_r = be[:, r0:]
        be_new = torch.maximum(be_r, ita._block_exp(t.amax(-1, keepdim=True)))
        sh = torch.clamp(be_new - be_r, 0, 31)
        e = ita.exp2_fixed(torch.clamp(t - be_new * ita.ONE, min=ita.NEG_T))
        p8 = torch.clamp(e >> 1, max=127)
        acc[:, r0:] = (acc[:, r0:] >> sh) + _exact_dot(p8, v[:, c0:c0 + bkv])
        den[:, r0:] = (den[:, r0:] >> sh) + p8.sum(-1, keepdim=True,
                                                   dtype=torch.int32)
        be[:, r0:] = be_new
    y = acc.to(torch.float32) / torch.clamp(den, min=1).to(torch.float32)
    y = y * out_mult
    y = torch.trunc(y + torch.where(y >= 0, 0.5, -0.5))  # round half away
    return torch.clamp(y, -127, 127).to(torch.int8)


def ita_attention_gqa_ref(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, **kw) -> torch.Tensor:
    """``ita_attention_ref`` over [B, H, S, D], the kv heads repeated to the
    query heads as the reference's op repeats them (the Hopper kernel reads
    kv head ``h // group`` in place instead; the result is the same)."""
    b, hq, sq, d = q.shape
    g = hq // k.shape[1]
    kf, vf = (x.repeat_interleave(g, dim=1).reshape(b * hq, -1, d)
              for x in (k, v))
    return ita_attention_ref(q.reshape(b * hq, sq, d), kf, vf,
                             **kw).reshape(q.shape)


def attention_float_ref(q_f: torch.Tensor, k_f: torch.Tensor,
                        v_f: torch.Tensor, *, scale: float,
                        causal: bool = False) -> torch.Tensor:
    """Float attention oracle: softmax(q·kᵀ·scale)·v over [BH, S, D]."""
    logits = torch.einsum("bqd,bkd->bqk", q_f, k_f) * scale
    if causal:
        sq, skv = logits.shape[-2:]
        mask = (torch.arange(skv, device=q_f.device)[None, :]
                > torch.arange(sq, device=q_f.device)[:, None])
        logits = logits.masked_fill(mask, -math.inf)
    return torch.einsum("bqk,bkd->bqd", torch.softmax(logits, -1), v_f)
