"""Mamba-2 (SSD) family — attention-free, the ``mamba2-2.7b`` assignment.

Port of ``repro.models.ssm``. Block: RMSNorm → in_proj → [z | xBC | dt] →
causal conv1d(4) on xBC → SiLU → SSD scan (``kernels/ssd_scan``, kernel B8 on
the card) → gated RMSNorm(y)·SiLU(z) → out_proj. The casts sit where the
reference has them: SiLU in float32 and back to the compute dtype, the scan
inputs in float32, ``y + D·x`` in float32, the gated ``rms_norm`` in the
compute dtype.

The reference's ``lax.scan`` over layers is a Python loop over the stacked
parameters' leading axis. Decode carries O(1) state per row: the conv tail
[K-1, C] and the SSD state [H, N, P] float32, stacked over layers.
``decode_step`` updates the cache it is given in place and returns it.
No config of the family takes embeddings as input, so the entry points
take tokens only.

**Conv tail.** ``prefill`` keeps the last ``d_conv - 1`` rows of the conv
input, left-padded with the zeros ``_conv1d`` itself pads with. For prompts
of at least ``d_conv - 1`` tokens that is the reference's tail; for shorter
ones the reference keeps fewer rows, which its serving arena writes at the
wrong place (see ROADMAP Queue C), and the port does not copy that.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_decode_step
from repro_torch.models import layers as nn
from repro_torch.models.config import ModelConfig
from repro_torch.models.schema import TensorSpec


def _dims(cfg: ModelConfig):
    d_inner = cfg.expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_headdim
    conv_ch = d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return d_inner, n_heads, conv_ch


def _layer_schema(cfg: ModelConfig, n_stack: int) -> Dict[str, TensorSpec]:
    d = cfg.d_model
    d_inner, h, conv_ch = _dims(cfg)
    L = ("layers",)

    def t(shape, axes, **kw):
        return TensorSpec((n_stack, *shape), L + axes, **kw)

    return {
        "ln": t((d,), ("embed",), init="zeros"),
        "w_in": t((d, 2 * d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state + h),
                  ("embed", "mlp")),
        "conv_w": t((cfg.d_conv, conv_ch), (None, "mlp"), scale=0.5),
        "conv_b": t((conv_ch,), ("mlp",), init="zeros"),
        "a_log": t((h,), ("heads",), init="ones"),
        "dt_bias": t((h,), ("heads",), init="zeros"),
        "d_skip": t((h,), ("heads",), init="ones"),
        "norm_g": t((d_inner,), ("mlp",), init="zeros"),
        "w_out": t((d_inner, d), ("mlp", "embed")),
    }


def schema(cfg: ModelConfig):
    return {
        "embed": TensorSpec((cfg.vocab, cfg.d_model), ("vocab", "embed_io"),
                            init="embed"),
        "final_norm": TensorSpec((cfg.d_model,), ("embed",), init="zeros"),
        "stacks": [_layer_schema(cfg, cfg.n_layers)],
        "unembed": TensorSpec((cfg.vocab, cfg.d_model), ("vocab", "embed_io")),
    }


def _layer(stack, i: int):
    """Layer ``i``'s parameters from the stacked tree."""
    return {k: v[i] for k, v in stack.items()}


def _split_proj(zxbcdt, cfg: ModelConfig):
    d_inner, h, _ = _dims(cfg)
    gn = cfg.ssm_ngroups * cfg.ssm_state
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * gn, h], dim=-1)
    return z, xbc, dt  # [..., d_inner], [..., d_inner+2GN], [..., H]


def _conv1d(xbc, w, b):
    """Causal depthwise conv over time. xbc [B, S, C]; w [K, C]. The sum
    starts from 0 and adds the taps in order, as the reference does."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = 0
    for i in range(k):
        out = out + pad[:, i:i + s] * w[i][None, None, :]
    return out + b[None, None, :]


def _silu_f32(x, dtype):
    return F.silu(x.float()).to(dtype)


def _softplus(x):
    """``jax.nn.softplus`` (logaddexp(x, 0)), without torch's threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssd_block(x, p, cfg: ModelConfig, return_state: bool = False):
    """[B, S, D] → [B, S, D] through one SSD mixing block."""
    b, s, _ = x.shape
    d_inner, h, _ = _dims(cfg)
    n, g, pdim = cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_headdim

    zxbcdt = nn.dense(x, p["w_in"])
    z, xbc_raw, dt = _split_proj(zxbcdt, cfg)
    xbc = _silu_f32(_conv1d(xbc_raw, p["conv_w"].to(x.dtype),
                            p["conv_b"].to(x.dtype)), x.dtype)
    xs, bmat, cmat = torch.split(xbc, [d_inner, g * n, g * n], dim=-1)

    dt = _softplus(dt.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())                     # [H], negative
    dta = (dt * a).transpose(1, 2)                         # [B, H, S]
    xh = xs.reshape(b, s, h, pdim).transpose(1, 2)         # [B, H, S, P]
    xh = xh * dt.transpose(1, 2)[..., None].to(xh.dtype)
    bm = bmat.reshape(b, s, g, n).transpose(1, 2)          # [B, G, S, N]
    cm = cmat.reshape(b, s, g, n).transpose(1, 2)

    scan_out = ssd_scan(dta.contiguous(), xh.float().contiguous(),
                        bm.float().contiguous(), cm.float().contiguous(),
                        return_state=return_state)         # [B, H, S, P]
    y, ssd_state = scan_out if return_state else (scan_out, None)
    y = y + p["d_skip"].float()[None, :, None, None] * xh.float()
    y = y.transpose(1, 2).reshape(b, s, d_inner).to(x.dtype)
    y = nn.rms_norm(y * _silu_f32(z, x.dtype), p["norm_g"])
    out = nn.dense(y, p["w_out"])
    if return_state:
        k = cfg.d_conv - 1
        tail = F.pad(xbc_raw, (0, 0, k, 0))[:, -k:]        # [B, K-1, C]
        return out, (tail.to(cfg.compute_dtype), ssd_state)
    return out


def forward(params, tokens, cfg: ModelConfig, *, embeds=None):
    """Teacher-forcing logits [B, S, V]; each layer's body is recomputed in
    the backward pass under ``cfg.remat``."""
    x = embeds if embeds is not None else nn.embed(
        tokens, params["embed"], cfg.compute_dtype)

    def apply_layer(xc, p):
        return xc + _ssd_block(nn.rms_norm(xc, p["ln"]), p, cfg)

    run = nn.remat(apply_layer, cfg.remat)
    stack = nn.unstack(params["stacks"][0])
    for i in range(cfg.n_layers):
        x = run(x, _layer(stack, i))
    x = nn.rms_norm(x, params["final_norm"])
    return nn.unembed(x, params["unembed"])


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               quantized=None, device: DeviceLike = None):
    """O(1) decode state: conv tail + SSD state, stacked over layers, and
    the per-row position vector, on ``device`` (default ``cuda``).
    ``quantized`` is accepted and ignored, as in the reference (the state
    has no int8 form)."""
    d_inner, h, conv_ch = _dims(cfg)
    device = resolve_device(device)
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.d_conv - 1, conv_ch),
                            dtype=cfg.compute_dtype, device=device),
        "ssd": torch.zeros((cfg.n_layers, batch, h, cfg.ssm_state,
                            cfg.ssm_headdim), dtype=torch.float32,
                           device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def decode_step(params, cache, tokens, cfg: ModelConfig, *, embeds=None):
    """One token per row: [B] tokens → ([B, V] logits, cache updated in
    place). The per-token SSD update is plain PyTorch (``ssd_decode_step``):
    the reference has no Pallas kernel there."""
    x = embeds if embeds is not None else nn.embed(
        tokens[:, None], params["embed"], cfg.compute_dtype)
    b = x.shape[0]
    d_inner, h, conv_ch = _dims(cfg)
    n, g, pdim = cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_headdim
    stack = params["stacks"][0]
    for i in range(cfg.n_layers):
        p = _layer(stack, i)
        hx = nn.rms_norm(x, p["ln"])
        zxbcdt = nn.dense(hx, p["w_in"])
        z, xbc, dt = _split_proj(zxbcdt, cfg)                  # [B, 1, ·]
        hist = torch.cat([cache["conv"][i], xbc], dim=1)       # [B, K, C]
        w = p["conv_w"].to(x.dtype)
        conv_out = torch.einsum("bkc,kc->bc", hist, w) + p["conv_b"].to(x.dtype)
        cache["conv"][i] = hist[:, 1:]
        xbc1 = _silu_f32(conv_out, x.dtype)
        xs, bm, cm = torch.split(xbc1, [d_inner, g * n, g * n], dim=-1)
        dtf = _softplus(dt[:, 0].float() + p["dt_bias"].float())
        a = -torch.exp(p["a_log"].float())
        dta_t = dtf * a                                        # [B, H]
        xh = xs.reshape(b, h, pdim) * dtf[..., None].to(xs.dtype)
        bm_h = bm.reshape(b, g, n).repeat_interleave(h // g, dim=1)
        cm_h = cm.reshape(b, g, n).repeat_interleave(h // g, dim=1)
        ssd_new, y = ssd_decode_step(cache["ssd"][i], dta_t, xh.float(),
                                     bm_h.float(), cm_h.float())
        cache["ssd"][i] = ssd_new
        y = y + p["d_skip"].float()[None, :, None] * xh.float()
        y = y.reshape(b, 1, d_inner).to(x.dtype)
        y = nn.rms_norm(y * _silu_f32(z, x.dtype), p["norm_g"])
        x = x + nn.dense(y, p["w_out"])
    x = nn.rms_norm(x, params["final_norm"])
    logits = nn.unembed(x, params["unembed"])
    cache["len"] += 1
    return logits[:, 0], cache


def prefill(params, tokens, cfg: ModelConfig, max_len: int, *,
            embeds=None):
    """Forward pass capturing the exact per-layer (conv tail, SSD state):
    [B, S] tokens → ([B, V] last-position logits, a batch-B cache)."""
    x = embeds if embeds is not None else nn.embed(
        tokens, params["embed"], cfg.compute_dtype)
    b, s = x.shape[:2]
    cache = init_cache(cfg, b, max_len, device=x.device)
    stack = params["stacks"][0]
    for i in range(cfg.n_layers):
        p = _layer(stack, i)
        out, (tail, ssd_state) = _ssd_block(nn.rms_norm(x, p["ln"]), p, cfg,
                                            return_state=True)
        cache["conv"][i] = tail
        cache["ssd"][i] = ssd_state
        x = x + out
    x = nn.rms_norm(x, params["final_norm"])
    logits = nn.unembed(x[:, -1:], params["unembed"])
    cache["len"].fill_(s)
    return logits[:, 0], cache
