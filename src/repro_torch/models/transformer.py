"""Dense decoder-only transformer family: the paged serving path.

Port of the paged half of ``repro.models.transformer``. Parameters are a
dict tree with the reference schema's keys and its leading ``n_stack``
axis: ``stacks[i][name][g]`` is layer ``g·len(pattern) + i``. The stack is
evaluated as a Python loop over groups (the reference's ``lax.scan``).

The paged cache is ``{"stacks": [{"k", "v"[, "kscale", "vscale"]}], "len"}``
with pools ``[n_stack, num_blocks, Hkv, block_len, hd]``. Writes go into the
pool tensors **in place** (the reference returns a new pytree and donates
the old one); ``paged_decode_step`` and ``paged_prefill`` still return the
cache so callers read like the reference.

INT8 serving (``serve_quant``): K/V are requantized at write time into int8
blocks; decode runs W8A8 projections through ``kernels.int8_gemm`` and
attention through ``paged_attention_int8``. As in the reference, prefill
uses the *float* projections even on int8 archs; only decode is W8A8.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch

from repro_torch.core.quant import recip32
from repro_torch.models import attention as attn
from repro_torch.models import layers as nn
from repro_torch.models.config import ModelConfig
from repro_torch.models.schema import TensorSpec

# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------

LINEARS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


def _layer_schema(cfg: ModelConfig, n_stack: int) -> Dict[str, TensorSpec]:
    d, hd = cfg.d_model, cfg.hd
    nq, nkv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    L = ("layers",)

    def t(shape, axes, **kw):
        return TensorSpec((n_stack, *shape), L + axes, **kw)

    return {
        "ln1": t((d,), ("embed",), init="zeros"),
        "wq": t((d, nq * hd), ("embed", "heads")),
        "wk": t((d, nkv * hd), ("embed", "kv")),
        "wv": t((d, nkv * hd), ("embed", "kv")),
        "wo": t((nq * hd, d), ("heads", "embed")),
        "ln2": t((d,), ("embed",), init="zeros"),
        "wg": t((d, f), ("embed", "mlp")),
        "wu": t((d, f), ("embed", "mlp")),
        "wd": t((f, d), ("mlp", "embed")),
    }


def schema(cfg: ModelConfig):
    pattern, n_groups, tail = cfg.layer_layout()
    s: Dict[str, Any] = {
        "embed": TensorSpec((cfg.vocab, cfg.d_model), ("vocab", "embed_io"),
                            init="embed"),
        "final_norm": TensorSpec((cfg.d_model,), ("embed",), init="zeros"),
        "stacks": [_layer_schema(cfg, n_groups) for _ in pattern],
    }
    if tail:
        s["tail"] = [_layer_schema(cfg, 1) for _ in tail]
    if not cfg.tie_embeddings:
        s["unembed"] = TensorSpec((cfg.vocab, cfg.d_model), ("vocab", "embed_io"))
    return s


def _layers(cfg: ModelConfig):
    """(kind, where, index) for every layer in order: the layer lives at
    ``tree[where[0]][where[1]]`` of any tree stacked like the params
    (params, cache, qparams), at ``index`` on the leading axis."""
    pattern, n_groups, tail = cfg.layer_layout()
    for g in range(n_groups):
        for i, kind in enumerate(pattern):
            yield kind, ("stacks", i), g
    for i, kind in enumerate(tail):
        yield kind, ("tail", i), 0


def _entry(tree, where, g):
    """Layer ``g`` of ``tree[where[0]][where[1]]`` (views, no copies)."""
    sub = tree[where[0]][where[1]]
    return {k: v[g] for k, v in sub.items()}


# ---------------------------------------------------------------------------
# Float (prefill) layer
# ---------------------------------------------------------------------------


def _project_qkv(x, p, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    hd = cfg.hd
    q = nn.dense(x, p["wq"]).reshape(b, s, cfg.n_heads, hd).transpose(1, 2)
    k = nn.dense(x, p["wk"]).reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    v = nn.dense(x, p["wv"]).reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    q = nn.rope(q, positions, cfg.rope_theta)
    k = nn.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _merge_heads(o):
    b, h, s, hd = o.shape
    return o.transpose(1, 2).reshape(b, s, h * hd)


def _mlp(x, p, cfg: ModelConfig):
    act = nn.ACTIVATIONS[cfg.act]
    h = act(nn.dense(x, p["wg"]), nn.dense(x, p["wu"]))
    return nn.dense(h, p["wd"])


def _prefill_layer(xc, p, kind: str, cfg: ModelConfig, positions):
    """One prefill layer application; returns (x, this layer's k, v)."""
    h = nn.rms_norm(xc, p["ln1"])
    q, k, v = _project_qkv(h, p, cfg, positions)
    o = attn.chunked_attention(
        q, k, v, causal=kind != "B",
        window=cfg.local_window if kind == "L" else None,
        chunk_q=min(cfg.attn_chunk_q, xc.shape[1]),
    )
    xc = xc + nn.dense(_merge_heads(o), p["wo"])
    xc = xc + _mlp(nn.rms_norm(xc, p["ln2"]), p, cfg)
    return xc, k, v


# ---------------------------------------------------------------------------
# Paged KV cache + decode (block-pool serving layout)
# ---------------------------------------------------------------------------


def init_paged_cache(cfg: ModelConfig, slots: int, layout, *,
                     quantized: Optional[bool] = None, device=None):
    """Block-pool KV cache: per pattern-position stacks of shape
    ``[n_stack, num_blocks, Hkv, block_len, hd]`` shared by all ``slots``
    decode rows, plus the per-row position vector. Int8 pools
    (``quantized``, default ``cfg.serve_quant``) carry per-block scale
    vectors ``kscale``/``vscale`` ([n_stack, num_blocks] f32, filled with
    the static ``attn.KV_SCALE`` calibration)."""
    if getattr(layout, "window", None) is not None:
        raise NotImplementedError(
            "ring-block (sliding-window) pools are not ported yet")
    if quantized is None:
        quantized = cfg.serve_quant
    pattern, n_groups, tail = cfg.layer_layout()
    hd, nkv = cfg.hd, cfg.n_kv_heads
    dt = torch.int8 if quantized else cfg.compute_dtype

    def kv(n_stack):
        shape = (n_stack, layout.num_blocks, nkv, layout.block_len, hd)
        c = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
        if quantized:
            c["kscale"] = torch.full((n_stack, layout.num_blocks),
                                     attn.KV_SCALE, dtype=torch.float32,
                                     device=device)
            c["vscale"] = torch.full((n_stack, layout.num_blocks),
                                     attn.KV_SCALE, dtype=torch.float32,
                                     device=device)
        return c

    cache: Dict[str, Any] = {
        "stacks": [kv(n_groups) for _ in pattern],
        "len": torch.zeros((slots,), dtype=torch.int32, device=device),
    }
    if tail:
        cache["tail"] = [kv(1) for _ in tail]
    return cache


def _resolve_paged_table(table, kind: str):
    """(block table, start vector or None) for a layer of ``kind``. The
    port takes the plain ``[slots, max_blocks]`` table only (ring tables
    are not ported)."""
    if isinstance(table, dict):
        raise NotImplementedError("ring block tables are not ported yet")
    return table, None


def _paged_cache_write(c, k_new, v_new, pos, table, block_len: int,
                       start=None):
    """Scatter one token's k/v at per-row position ``pos`` through the
    block table, in place. Empty rows point at the trash block (table row
    zeros), so their writes are harmless."""
    rows_b = pos.shape[0]
    max_blocks = table.shape[1]
    rel = pos if start is None else pos - start
    bi = torch.clamp(rel // block_len, 0, max_blocks - 1)
    rows = torch.arange(rows_b, device=pos.device)
    blk_ids = table[rows, bi].long()               # [B] pool rows
    off = (pos % block_len).long()
    c["k"][blk_ids, :, off] = k_new[:, :, 0].to(c["k"].dtype)
    c["v"][blk_ids, :, off] = v_new[:, :, 0].to(c["v"].dtype)
    return c


def _qlin(qp, name, y):
    """Quantized linear for the int8 serving path (static activation scale)."""
    from repro_torch.kernels.int8_gemm.ops import int8_gemm

    y8 = torch.clamp(torch.round(y.float() * recip32(attn.ACT_SCALE)),
                     -127, 127).to(torch.int8)
    out8 = int8_gemm(y8, qp[name])
    return (out8.float() * attn.ACT_SCALE).to(y.dtype)


def _paged_decode_layer(x, p, c, kind, cfg: ModelConfig, pos, table, *,
                        qparams=None):
    """One-token decode through one layer against the paged pool."""
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention, paged_attention_int8,
    )
    from repro_torch.models.cache import quantize_kv

    int8_w = qparams is not None
    int8_kv = c["k"].dtype == torch.int8
    if int8_w and not int8_kv:
        raise ValueError(
            "int8 serving over float block pools is not supported: build "
            "the paged cache with quantized=True so K/V live in int8 blocks")
    h = nn.rms_norm(x, p["ln1"])
    b = x.shape[0]
    hd = cfg.hd
    block_len = c["k"].shape[2]  # [num_blocks, Hkv, block_len, hd]
    lin = functools.partial(_qlin, qparams) if int8_w else (
        lambda name, y: nn.dense(y, p[name]))
    q = lin("wq", h).reshape(b, 1, cfg.n_heads, hd).transpose(1, 2)
    k = lin("wk", h).reshape(b, 1, cfg.n_kv_heads, hd).transpose(1, 2)
    v = lin("wv", h).reshape(b, 1, cfg.n_kv_heads, hd).transpose(1, 2)
    q = nn.rope(q, pos[:, None, None], cfg.rope_theta)
    k = nn.rope(k, pos[:, None, None], cfg.rope_theta)

    window = cfg.local_window if kind == "L" else None
    tbl, start = _resolve_paged_table(table, kind)
    lens = pos + 1
    if int8_kv:
        _paged_cache_write(c, quantize_kv(k, attn.KV_SCALE),
                           quantize_kv(v, attn.KV_SCALE), pos, tbl,
                           block_len, start=start)
        o = paged_attention_int8(q.contiguous(), c["k"], c["v"], tbl, lens,
                                 k_scale=c["kscale"], v_scale=c["vscale"],
                                 window=window, start=start)
    else:
        _paged_cache_write(c, k, v, pos, tbl, block_len, start=start)
        o = paged_attention(q.contiguous(), c["k"], c["v"], tbl, lens,
                            window=window, start=start)
    x = x + lin("wo", _merge_heads(o))
    h = nn.rms_norm(x, p["ln2"])
    act = nn.ACTIVATIONS[cfg.act]
    x = x + lin("wd", act(lin("wg", h), lin("wu", h)))
    return x


def paged_decode_step(params, cache, tokens, cfg: ModelConfig, table, *,
                      qparams=None):
    """One decode step against the paged block pool.

    ``table`` [slots, max_blocks] int32 maps each row's position ``p`` to
    pool block ``table[row, p // block_len]`` (offset ``p % block_len``);
    the engine owns it host-side and passes it each call. Returns
    ``(logits [slots, V], cache)`` with ``cache["len"]`` advanced by one.
    """
    x = nn.embed(tokens[:, None], params["embed"], cfg.compute_dtype)
    pos = cache["len"].to(torch.int32).expand(x.shape[0])
    table = table.to(torch.int32)
    for kind, where, g in _layers(cfg):
        qp = None if qparams is None else _entry(qparams, where, g)
        x = _paged_decode_layer(
            x, _entry(params, where, g), _entry(cache, where, g), kind, cfg,
            pos, table, qparams=qp)
    x = nn.rms_norm(x, params["final_norm"])
    table_w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = nn.unembed(x, table_w)
    cache["len"] = cache["len"] + 1
    return logits[:, 0], cache


def paged_prefill(params, tokens, cfg: ModelConfig, cache, slot, block_ids,
                  *, true_len=None):
    """Prefill straight into pool blocks: forward pass + per-layer K/V
    writes into the paged ``cache`` (in place). Returns ``(last-position
    logits, cache)``.

    ``tokens`` [1, S] may be right-padded to an admission bucket;
    ``true_len`` is then the real length (logits are taken at position
    ``true_len - 1`` and ``slot``'s position counter is set to it). Every
    layer writes ``len(block_ids)`` blocks, the partially-valid tail block
    whole. Prefix resume and ring writes are not ported yet."""
    return _paged_prefill_impl(params, tokens, cfg, cache, slot, block_ids,
                               layer_fn=_prefill_layer, true_len=true_len)


def _paged_prefill_impl(params, tokens, cfg: ModelConfig, cache, slot,
                        block_ids, *, layer_fn, true_len=None):
    """Shared paged-prefill scaffold (block writes, layer loop, last-real-
    token logits, slot position update). Int8 pools requantize K/V
    (``cache.quantize_kv``, static ``attn.KV_SCALE``) before the write."""
    from repro_torch.models.cache import prefill_write_kv, quantize_kv

    x = nn.embed(tokens, params["embed"], cfg.compute_dtype)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    block_ids = torch.as_tensor(block_ids, dtype=torch.long, device=x.device)
    n = s if true_len is None else int(true_len)

    for kind, where, g in _layers(cfg):
        x, k, v = layer_fn(x, _entry(params, where, g), kind, cfg, positions)
        c = _entry(cache, where, g)
        if c["k"].dtype == torch.int8:
            k = quantize_kv(k, attn.KV_SCALE)
            v = quantize_kv(v, attn.KV_SCALE)
        prefill_write_kv(c["k"], k, block_ids)
        prefill_write_kv(c["v"], v, block_ids)

    x = nn.rms_norm(x, params["final_norm"])
    table_w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    last = x[:, n - 1:n]                      # last *real* position
    logits = nn.unembed(last, table_w)
    cache["len"][slot] = n
    return logits[:, 0], cache


# Right-padded prompts are exact for this family (causal attention: real
# positions never attend to pad positions; pad entries beyond ``true_len``
# are masked out of decode by the per-row position vector).
SUPPORTS_PADDED_PREFILL = True

# The paged pool may store K/V as int8 blocks (+ per-block scales).
PAGED_INT8_KV = True


# ---------------------------------------------------------------------------
# INT8 serving parameter conversion (the paper's deployment flow)
# ---------------------------------------------------------------------------


def quantize_params(params, cfg: ModelConfig):
    """Float params → QuantizedLinearParams tree for the W8A8 serving path
    (one stack entry at a time, so a full-width model quantizes in place of
    the reference's vmap without a float32 copy of a whole stack)."""
    from repro_torch.kernels.int8_gemm.ops import QuantizedLinearParams

    s = attn.ACT_SCALE

    def qlayer(p):
        out = {}
        for name in LINEARS:
            w = p[name]
            parts = []
            for wi in w:
                zero_bias = torch.zeros((wi.shape[-1],), dtype=torch.float32,
                                        device=wi.device)
                parts.append(QuantizedLinearParams.from_float(
                    wi.float(), zero_bias, s, s))
            out[name] = QuantizedLinearParams(
                *(torch.stack([getattr(q, f) for q in parts])
                  for f in ("w_q", "bias", "mult", "shift")))
        return out

    q = {"stacks": [qlayer(st) for st in params["stacks"]]}
    if "tail" in params:
        q["tail"] = [qlayer(t) for t in params["tail"]]
    return q
