"""Griffin / RecurrentGemma family — RG-LRU + local-attention hybrid.

Port of ``repro.models.griffin``. Pattern ``"RRL"``: two recurrent blocks to
one local-attention block. Each block is a temporal-mixing residual
followed by a GeGLU MLP residual.

Recurrent block: x → [linear → conv1d(4) → gates → RG-LRU scan] ⊙
gelu(gate branch) → out-projection. The scan runs through
``kernels/rglru`` (kernel B9 on the card), with a float32 state. Local
attention is MQA with a ``local_window`` ring cache.

The reference's ``lax.scan`` over layer groups is a Python loop over the
stacked parameters' leading axis (``transformer._layers``). The cache is
``{"stacks": [per-kind dict], "tail": [...], "len"}``: a recurrent entry
holds the conv tail [n, B, K-1, W] (compute dtype) and ``h`` [n, B, W]
float32, a local-attention entry ring K/V [n, B, Hkv, win, hd] with
``win = min(local_window, max_len)``; position ``p`` lives in ring row
``p % win``. ``decode_step`` updates the cache it is given in place and
returns it. No config of the family takes embeddings as input, so the
entry points take tokens only.

Numerics follow the reference's casts: the gates' projections in the
compute dtype, then float32; prefill rounds ``u = i·x`` to the compute
dtype before the scan and takes the recurrent state from the scan's
rounded last row, while decode keeps ``u`` and the state in float32.

**Conv tail.** ``prefill`` keeps the last ``d_conv - 1`` rows of the conv
input, left-padded with the zeros ``_conv1d`` itself pads with. For prompts
of at least ``d_conv - 1`` tokens that is the reference's tail; for shorter
ones the reference keeps fewer rows and its decode fails (ROADMAP Queue C),
which the port does not copy.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.kernels.rglru.ops import rglru
from repro_torch.kernels.rglru.ref import rglru_decode_step
from repro_torch.models import attention as attn
from repro_torch.models import layers as nn
from repro_torch.models import transformer as dense
from repro_torch.models.config import ModelConfig
from repro_torch.models.schema import TensorSpec
from repro_torch.models.ssm import _conv1d, _softplus

RG_C = 8.0  # Griffin's recurrence-gate sharpness constant


def _lru_w(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


def _rec_schema(cfg: ModelConfig, n_stack: int) -> Dict[str, TensorSpec]:
    d, w, f = cfg.d_model, _lru_w(cfg), cfg.d_ff
    L = ("layers",)

    def t(shape, axes, **kw):
        return TensorSpec((n_stack, *shape), L + axes, **kw)

    return {
        "ln1": t((d,), ("embed",), init="zeros"),
        "w_x": t((d, w), ("embed", "mlp")),
        "w_gate": t((d, w), ("embed", "mlp")),
        "conv_w": t((cfg.d_conv, w), (None, "mlp"), scale=0.5),
        "conv_b": t((w,), ("mlp",), init="zeros"),
        "w_r": t((w, w), ("mlp", "mlp")),
        "w_i": t((w, w), ("mlp", "mlp")),
        "lam": t((w,), ("mlp",), init="ones"),
        "w_out": t((w, d), ("mlp", "embed")),
        "ln2": t((d,), ("embed",), init="zeros"),
        "wg": t((d, f), ("embed", "mlp")),
        "wu": t((d, f), ("embed", "mlp")),
        "wd": t((f, d), ("mlp", "embed")),
    }


def _kind_schema(cfg: ModelConfig, kind: str, n_stack: int):
    if kind == "R":
        return _rec_schema(cfg, n_stack)
    return dense._layer_schema(cfg, n_stack)


def schema(cfg: ModelConfig):
    pattern, n_groups, tail = cfg.layer_layout()
    s: Dict[str, Any] = {
        "embed": TensorSpec((cfg.vocab, cfg.d_model), ("vocab", "embed_io"),
                            init="embed"),
        "final_norm": TensorSpec((cfg.d_model,), ("embed",), init="zeros"),
        "stacks": [_kind_schema(cfg, kind, n_groups) for kind in pattern],
    }
    if tail:
        s["tail"] = [_kind_schema(cfg, kind, 1) for kind in tail]
    s["unembed"] = TensorSpec((cfg.vocab, cfg.d_model), ("vocab", "embed_io"))
    return s


def _gates(x_c, p):
    """Recurrence/input gates + log decay. x_c [..., W] (post-conv)."""
    r = torch.sigmoid(nn.dense(x_c, p["w_r"]).float())
    i = torch.sigmoid(nn.dense(x_c, p["w_i"]).float())
    log_a = -RG_C * _softplus(p["lam"].float()) * r
    return log_a, i


def _gelu_f32(x, dtype):
    """``jax.nn.gelu`` (the tanh form) in float32, back to ``dtype``."""
    return F.gelu(x.float(), approximate="tanh").to(dtype)


def _rec_block(x, p, cfg: ModelConfig, return_state: bool = False):
    """Griffin recurrent temporal-mixing block, [B, S, D] → [B, S, D]
    (and ``(conv tail, h)`` with ``return_state``)."""
    h = nn.rms_norm(x, p["ln1"])
    xb = nn.dense(h, p["w_x"])
    gate = nn.dense(h, p["w_gate"])
    x_c = _conv1d(xb, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))
    log_a, i = _gates(x_c, p)
    u = (i * x_c.float()).to(x.dtype)
    hseq = rglru(log_a, u)
    y = hseq * _gelu_f32(gate, x.dtype)
    out = nn.dense(y, p["w_out"])
    if return_state:
        k = cfg.d_conv - 1
        tail = F.pad(xb, (0, 0, k, 0))[:, -k:]          # [B, K-1, W]
        return out, (tail.to(cfg.compute_dtype), hseq[:, -1].float())
    return out


def _rec_block_decode(x, p, c, cfg: ModelConfig):
    """One token through a recurrent block; ``c`` (conv tail [B, K-1, W],
    ``h`` [B, W]) is updated in place."""
    hx = nn.rms_norm(x, p["ln1"])
    xb = nn.dense(hx, p["w_x"])                          # [B, 1, W]
    gate = nn.dense(hx, p["w_gate"])
    hist = torch.cat([c["conv"], xb], dim=1)             # [B, K, W]
    w = p["conv_w"].to(x.dtype)
    x_c = torch.einsum("bkc,kc->bc", hist, w) + p["conv_b"].to(x.dtype)
    log_a, i = _gates(x_c, p)
    u = i * x_c.float()
    h_new, h_out = rglru_decode_step(c["h"], log_a, u)
    y = h_out[:, None].to(x.dtype) * _gelu_f32(gate, x.dtype)
    c["conv"].copy_(hist[:, 1:])
    c["h"].copy_(h_new)
    return nn.dense(y, p["w_out"])


def _mlp_res(x, p, cfg: ModelConfig):
    h = nn.rms_norm(x, p["ln2"])
    return x + nn.dense(nn.geglu(nn.dense(h, p["wg"]), nn.dense(h, p["wu"])),
                        p["wd"])


def _local_attention(x, p, cfg: ModelConfig, positions):
    """Prefill local attention: the residual and this layer's k, v."""
    h = nn.rms_norm(x, p["ln1"])
    q, k, v = dense._project_qkv(h, dense._float_lin(p), cfg, positions)
    o = attn.chunked_attention(q, k, v, causal=True, window=cfg.local_window,
                               chunk_q=min(cfg.attn_chunk_q, x.shape[1]))
    return x + nn.dense(dense._merge_heads(o), p["wo"]), k, v


def forward(params, tokens, cfg: ModelConfig, *, embeds=None):
    x = embeds if embeds is not None else nn.embed(
        tokens, params["embed"], cfg.compute_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    for kind, where, g in dense._layers(cfg):
        p = dense._entry(params, where, g)
        if kind == "R":
            x = x + _rec_block(x, p, cfg)
        else:
            x, _, _ = _local_attention(x, p, cfg, positions)
        x = _mlp_res(x, p, cfg)
    x = nn.rms_norm(x, params["final_norm"])
    return nn.unembed(x, params["unembed"])


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               quantized=None, device: DeviceLike = None):
    """Recurrent state + ring KV, stacked like the parameters, and the
    per-row position vector, on ``device`` (default ``cuda``).
    ``quantized`` is accepted and ignored, as in the reference."""
    pattern, n_groups, tail = cfg.layer_layout()
    device = resolve_device(device)
    w = _lru_w(cfg)
    win = min(cfg.local_window, max_len)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def one(kind, n_stack):
        if kind == "R":
            return {"conv": zeros((n_stack, batch, cfg.d_conv - 1, w),
                                  cfg.compute_dtype),
                    "h": zeros((n_stack, batch, w), torch.float32)}
        kv = (n_stack, batch, cfg.n_kv_heads, win, cfg.hd)
        return {"k": zeros(kv, cfg.compute_dtype),
                "v": zeros(kv, cfg.compute_dtype)}

    cache: Dict[str, Any] = {
        "stacks": [one(kind, n_groups) for kind in pattern],
        "len": zeros((batch,), torch.int32),
    }
    if tail:
        cache["tail"] = [one(kind, 1) for kind in tail]
    return cache


def _attn_block_decode(x, p, c, cfg: ModelConfig, pos):
    """One token through a local-attention block: rope at each row's
    position, the ring write, then attention over the ring."""
    h = nn.rms_norm(x, p["ln1"])
    b, hd = x.shape[0], cfg.hd
    q = nn.dense(h, p["wq"]).reshape(b, 1, cfg.n_heads, hd).transpose(1, 2)
    k = nn.dense(h, p["wk"]).reshape(b, 1, cfg.n_kv_heads, hd).transpose(1, 2)
    v = nn.dense(h, p["wv"]).reshape(b, 1, cfg.n_kv_heads, hd).transpose(1, 2)
    q = nn.rope(q, pos[:, None, None], cfg.rope_theta)
    k = nn.rope(k, pos[:, None, None], cfg.rope_theta)
    dense._cache_write(c, k, v, pos, "L", cfg)
    o = attn.decode_attention(q, c["k"], c["v"], pos + 1, ring=True)
    return x + nn.dense(dense._merge_heads(o), p["wo"])


def decode_step(params, cache, tokens, cfg: ModelConfig, *, embeds=None):
    """One token per row: [B] tokens → ([B, V] logits, cache updated in
    place). The per-token RG-LRU update is plain PyTorch
    (``rglru_decode_step``): the reference has no Pallas kernel there."""
    x = embeds if embeds is not None else nn.embed(
        tokens[:, None], params["embed"], cfg.compute_dtype)
    pos = dense._as_positions(cache["len"], x.shape[0])
    for kind, where, g in dense._layers(cfg):
        p = dense._entry(params, where, g)
        c = dense._entry(cache, where, g)
        if kind == "R":
            x = x + _rec_block_decode(x, p, c, cfg)
        else:
            x = _attn_block_decode(x, p, c, cfg, pos)
        x = _mlp_res(x, p, cfg)
    x = nn.rms_norm(x, params["final_norm"])
    logits = nn.unembed(x, params["unembed"])
    cache["len"] += 1
    return logits[:, 0], cache


def prefill(params, tokens, cfg: ModelConfig, max_len: int, *,
            embeds=None):
    """Forward pass capturing the exact per-layer state (conv tails,
    recurrent ``h``, ring K/V): [B, S] tokens → ([B, V] last-position
    logits, a batch-B cache)."""
    x = embeds if embeds is not None else nn.embed(
        tokens, params["embed"], cfg.compute_dtype)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)
    cache = init_cache(cfg, b, max_len, device=x.device)
    win = min(cfg.local_window, max_len)
    for kind, where, g in dense._layers(cfg):
        p = dense._entry(params, where, g)
        c = dense._entry(cache, where, g)
        if kind == "R":
            out, (tail, h) = _rec_block(x, p, cfg, return_state=True)
            x = x + out
            c["conv"].copy_(tail)
            c["h"].copy_(h)
        else:
            x, k, v = _local_attention(x, p, cfg, positions)
            if s >= win:  # ring semantics: position p lives at row p % win
                k = torch.roll(k[:, :, -win:], s % win, dims=2)
                v = torch.roll(v[:, :, -win:], s % win, dims=2)
            c["k"][:, :, :min(s, win)] = k
            c["v"][:, :, :min(s, win)] = v
        x = _mlp_res(x, p, cfg)
    x = nn.rms_norm(x, params["final_norm"])
    logits = nn.unembed(x[:, -1:], params["unembed"])
    cache["len"].fill_(s)
    return logits[:, 0], cache
