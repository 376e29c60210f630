"""Whisper-style encoder-decoder family (``whisper-small``).

Port of ``repro.models.encdec``. Encoder: bidirectional self-attention over
precomputed mel-frame embeddings (the conv frontend is a stub: requests
carry ``[enc_seq, d_model]`` frame embeddings as ``embeds``). Decoder:
causal self-attention, cross-attention to the encoder states, MLP. RoPE
stands in for Whisper's sinusoidal positions, as in the reference.

Parameters keep the reference's keys: ``enc_stack`` (the dense family's
layer schema), ``dec_stack`` (the same plus ``lnx`` / ``xwq`` / ``xwk`` /
``xwv`` / ``xwo``), ``enc_norm``, ``final_norm``, ``embed``, ``unembed``;
each stack leaf carries the layer on its leading axis. The layers reuse
the dense family's halves (``transformer._prefill_attention``,
``_decode_attention``, ``_paged_decode_attention``,
``_paged_verify_attention``, ``_lin_mlp``, ``_logits``), whose arithmetic
is the reference's for a global ("G") layer.

Caches are flat dicts, as in the reference. The arena's (``init_cache``):
self-attention ``k`` / ``v`` ``[L, B, Hkv, max_len, hd]``, cross K/V
``xk`` / ``xv`` ``[L, B, Hkv, enc_seq, hd]``, ``len`` [B]. The paged one
(``init_paged_cache``): ``k`` / ``v`` are block pools ``[L, N, Hkv, blk,
hd]`` (int8 with per-block ``kscale`` / ``vscale`` ``[L, N]`` under
``serve_quant``), while ``xk`` / ``xv`` / ``len`` stay per slot. Only the
self-attention K/V grows with the decode position, so only it is paged and
only it is requantized (``serve_quant``); weights and the cross K/V stay
float, so the family launches no W8A8 GEMM. Writes go into the cache in
place; the functions still return it, as the reference's do.

The paged decode step attends the pools through B1 / B2 and the verify
step through B4 / B5; the cross-attention is the plain ``decode_attention``
over all ``enc_seq`` rows in both (verify folds its Q rows into the head
axis, so each row is the decode path's cross-attention bit for bit).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as nn
from repro_torch.models import transformer as dense
from repro_torch.models.cache import POOL_LEAVES
from repro_torch.models.config import ModelConfig
from repro_torch.models.schema import TensorSpec

# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------


def _xattn_layer_schema(cfg: ModelConfig, n_stack: int) -> Dict[str, TensorSpec]:
    """Decoder layer: self-attn + cross-attn + MLP."""
    base = dense._layer_schema(cfg, n_stack)
    d, hd, nq, nkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    L = ("layers",)

    def t(shape, axes, **kw):
        return TensorSpec((n_stack, *shape), L + axes, **kw)

    base.update({
        "lnx": t((d,), ("embed",), init="zeros"),
        "xwq": t((d, nq * hd), ("embed", "heads")),
        "xwk": t((d, nkv * hd), ("embed", "kv")),
        "xwv": t((d, nkv * hd), ("embed", "kv")),
        "xwo": t((nq * hd, d), ("heads", "embed")),
    })
    return base


def schema(cfg: ModelConfig):
    return {
        "embed": TensorSpec((cfg.vocab, cfg.d_model), ("vocab", "embed_io"),
                            init="embed"),
        "enc_stack": dense._layer_schema(cfg, cfg.n_enc_layers),
        "enc_norm": TensorSpec((cfg.d_model,), ("embed",), init="zeros"),
        "dec_stack": _xattn_layer_schema(cfg, cfg.n_layers),
        "final_norm": TensorSpec((cfg.d_model,), ("embed",), init="zeros"),
        "unembed": TensorSpec((cfg.vocab, cfg.d_model), ("vocab", "embed_io")),
    }


def _at(tree: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Entry ``i`` of every leaf of a flat stacked dict (views)."""
    return {k: v[i] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Encoder, cross-attention, teacher forcing
# ---------------------------------------------------------------------------


def _need_embeds(embeds, what: str) -> None:
    if embeds is None:
        raise ValueError(f"encdec {what} needs frame embeddings (stub input)")


def encode(params, frame_embeds, cfg: ModelConfig):
    """[B, S_enc, D] frame embeddings → encoder states (bidirectional
    "B" layers, then ``enc_norm``)."""
    x = frame_embeds.to(cfg.compute_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.n_enc_layers):
        x, _, _ = dense._prefill_layer(x, _at(params["enc_stack"], i), "B",
                                       cfg, positions)
    return nn.rms_norm(x, params["enc_norm"])


def _enc_kv(p, enc, cfg: ModelConfig):
    """Cross-attention K/V [B, Hkv, S_enc, hd] of the encoder states."""
    b, se, _ = enc.shape
    hd = cfg.hd
    k = nn.dense(enc, p["xwk"]).reshape(b, se, cfg.n_kv_heads, hd).transpose(1, 2)
    v = nn.dense(enc, p["xwv"]).reshape(b, se, cfg.n_kv_heads, hd).transpose(1, 2)
    return k, v


def _cross_attn(x, p, enc_kv, cfg: ModelConfig):
    """x plus cross-attention over precomputed encoder K/V (prefill)."""
    b, s, _ = x.shape
    h = nn.rms_norm(x, p["lnx"])
    q = nn.dense(h, p["xwq"]).reshape(b, s, cfg.n_heads, cfg.hd).transpose(1, 2)
    k, v = enc_kv
    o = attn.chunked_attention(q, k, v, causal=False,
                               chunk_q=min(cfg.attn_chunk_q, s))
    return x + nn.dense(dense._merge_heads(o), p["xwo"])


def _cross_decode(x, p, xk, xv, cfg: ModelConfig):
    """x plus cross-attention of ``x`` [B, Q, D] (Q = 1 for decode, the
    verify rows otherwise) against a slot's cached cross K/V, through
    ``decode_attention`` over all ``enc_seq`` rows. The Q rows are folded
    into the head axis: rows flatten kv-major, so row (h, j) lands in kv
    group h // group, each the decode path's single-query attention."""
    b, qlen, _ = x.shape
    hd, nq = cfg.hd, cfg.n_heads
    hx = nn.rms_norm(x, p["lnx"])
    xq = nn.dense(hx, p["xwq"]).reshape(b, qlen, nq, hd).transpose(1, 2)
    xo = attn.decode_attention(xq.reshape(b, nq * qlen, 1, hd), xk, xv,
                               cfg.enc_seq).reshape(b, nq, qlen, hd)
    return x + nn.dense(dense._merge_heads(xo), p["xwo"])


def _dec_prefill_layer(xc, p, enc, cfg: ModelConfig, positions, *,
                       kv_prefix=None):
    """One decoder-layer prefill application; returns (x, k, v, xk, xv —
    the newly computed positions only). ``kv_prefix`` resumes a
    prefix-cache hit: self-attention runs [prefix ++ suffix] at
    ``q_offset``; cross-attention is position-free."""
    xc, k, v = dense._prefill_attention(xc, p, "G", cfg, positions,
                                        kv_prefix=kv_prefix)
    xk, xv = _enc_kv(p, enc, cfg)
    xc = _cross_attn(xc, p, (xk, xv), cfg)
    return dense._lin_mlp(xc, p, cfg, dense._float_lin(p)), k, v, xk, xv


def forward(params, tokens, cfg: ModelConfig, *, embeds=None):
    """Teacher forcing: ``embeds`` = encoder frame embeddings (stub
    input), ``tokens`` the decoder input; logits [B, S, V]."""
    _need_embeds(embeds, "forward")
    enc = encode(params, embeds, cfg)
    x = nn.embed(tokens, params["embed"], cfg.compute_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.n_layers):
        x, *_ = _dec_prefill_layer(x, _at(params["dec_stack"], i), enc, cfg,
                                   positions)
    return dense._logits(params, x, cfg)


# ---------------------------------------------------------------------------
# Dense arena: the per-slot cache, prefill and decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               quantized: Optional[bool] = None, device: DeviceLike = None):
    """Per-slot cache on ``device`` (default ``cuda``), all in the compute
    dtype (``quantized`` is accepted and ignored, as in the reference:
    under ``serve_quant`` the self K/V hold requantized integers)."""
    del quantized
    device = resolve_device(device)
    hd, nkv, L, dt = cfg.hd, cfg.n_kv_heads, cfg.n_layers, cfg.compute_dtype

    def zeros(s_len):
        return torch.zeros((L, batch, nkv, s_len, hd), dtype=dt,
                           device=device)

    return {"k": zeros(max_len), "v": zeros(max_len),
            "xk": zeros(cfg.enc_seq), "xv": zeros(cfg.enc_seq),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def prefill(params, tokens, cfg: ModelConfig, max_len: int, *, embeds=None):
    """Encode the frames and ingest the decoder prompt: ([B, V] logits of
    the last position, a batch-B cache of ``max_len``). Under
    ``serve_quant`` the self K/V are requantized at write time (cross K/V
    stay float)."""
    from repro_torch.models.cache import quantize_kv

    _need_embeds(embeds, "prefill")
    enc = encode(params, embeds, cfg)
    x = nn.embed(tokens, params["embed"], cfg.compute_dtype)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)
    cache = init_cache(cfg, b, max_len, device=x.device)
    for i in range(cfg.n_layers):
        x, k, v, xk, xv = _dec_prefill_layer(x, _at(params["dec_stack"], i),
                                             enc, cfg, positions)
        if cfg.serve_quant:
            k, v = quantize_kv(k, attn.KV_SCALE), quantize_kv(v, attn.KV_SCALE)
        dt = cache["k"].dtype
        cache["k"][i, :, :, :s] = k.to(dt)
        cache["v"][i, :, :, :s] = v.to(dt)
        cache["xk"][i] = xk.to(dt)
        cache["xv"][i] = xv.to(dt)
    cache["len"].fill_(s)
    return dense._logits(params, x[:, -1:], cfg)[:, 0], cache


def decode_step(params, cache, tokens, cfg: ModelConfig, *, qparams=None,
                embeds=None):
    """One arena decode step, the cache written in place and ``len``
    advanced. Under ``serve_quant`` the self K/V are requantized and
    attended by the ITA integer ``decode_attention_int8`` (the dense
    family's attention half); the cross-attention stays float."""
    del qparams, embeds   # encdec serving keeps float weights
    x = nn.embed(tokens[:, None], params["embed"], cfg.compute_dtype)
    pos = dense._as_positions(cache["len"], x.shape[0])
    for i in range(cfg.n_layers):
        p = _at(params["dec_stack"], i)
        lin = dense._float_lin(p)
        c = {"k": cache["k"][i], "v": cache["v"][i]}
        x = dense._decode_attention(x, p, c, "G", cfg, pos, lin)
        x = _cross_decode(x, p, cache["xk"][i], cache["xv"][i], cfg)
        x = dense._lin_mlp(x, p, cfg, lin)
    logits = dense._logits(params, x, cfg)
    cache["len"] = cache["len"] + 1
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# Paged self-attention pools + per-slot cross K/V
# ---------------------------------------------------------------------------

# the self-attention K/V may live in int8 blocks (cross K/V stays float)
PAGED_INT8_KV = True


def init_paged_cache(cfg: ModelConfig, slots: int, layout, *,
                     quantized: Optional[bool] = None,
                     device: DeviceLike = None):
    """Paged self-attention pools ``[L, num_blocks, Hkv, block_len, hd]``
    (int8 plus per-block ``kscale`` / ``vscale`` when ``quantized``,
    default ``cfg.serve_quant``) and the per-slot cross K/V and positions,
    on ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    if quantized is None:
        quantized = cfg.serve_quant
    hd, nkv, L, dt = cfg.hd, cfg.n_kv_heads, cfg.n_layers, cfg.compute_dtype
    pool = (L, layout.num_blocks, nkv, layout.block_len, hd)
    pool_dt = torch.int8 if quantized else dt
    cross = (L, slots, nkv, cfg.enc_seq, hd)
    cache = {
        "k": torch.zeros(pool, dtype=pool_dt, device=device),
        "v": torch.zeros(pool, dtype=pool_dt, device=device),
        "xk": torch.zeros(cross, dtype=dt, device=device),
        "xv": torch.zeros(cross, dtype=dt, device=device),
        "len": torch.zeros((slots,), dtype=torch.int32, device=device),
    }
    if quantized:
        for name in ("kscale", "vscale"):
            cache[name] = torch.full((L, layout.num_blocks), attn.KV_SCALE,
                                     dtype=torch.float32, device=device)
    return cache


def _pools_at(cache, i: int):
    """Layer ``i``'s pool leaves (K/V and, on int8 pools, the scales)."""
    return {k: cache[k][i] for k in POOL_LEAVES if k in cache}


def paged_insert(cache, single, slot: int, block_ids, cfg: ModelConfig):
    """Splice a batch-1 prefill (``prefill``'s cache, ``max_len`` =
    ``len(block_ids)·block_len``) into pool blocks (self-attention) and
    ``slot``'s row (cross K/V and position), in place; returns ``cache``."""
    from repro_torch.models.cache import cache_insert, paged_insert_kv

    paged_insert_kv(cache["k"], single["k"], block_ids)
    paged_insert_kv(cache["v"], single["v"], block_ids)
    names = ("xk", "xv", "len")
    cache_insert({k: cache[k] for k in names}, {k: single[k] for k in names},
                 slot)
    return cache


def paged_prefill(params, tokens, cfg: ModelConfig, cache, slot, block_ids,
                  *, ring_ids=None, true_len=None, embeds=None,
                  prefix_ids=None, start=0):
    """Encode the frames and ingest the decoder prompt straight into the
    paged cache, in place: self K/V into pool blocks ``block_ids``
    (requantized on int8 pools), cross K/V and the position into
    ``slot``'s rows. Returns (last-position logits, cache).

    ``prefix_ids`` / ``start`` resume a prefix-cache hit (or a chunk):
    ``tokens`` carries only the decoder suffix, each layer gathers the
    cached prefix K/V from its pool and the suffix attends [prefix ++
    suffix] at ``q_offset = start``. The encoder and the cross K/V always
    run in full: they depend on ``embeds``, not on shareable blocks."""
    from repro_torch.models.cache import (
        gather_prefix_kv, prefill_write_kv, quantize_kv,
    )

    if ring_ids is not None:
        raise ValueError(
            "encdec has no sliding-window layers: ring_ids must be None "
            "(a ring table/start layout would be read incorrectly)")
    _need_embeds(embeds, "prefill")
    enc = encode(params, embeds, cfg)
    x = nn.embed(tokens, params["embed"], cfg.compute_dtype)
    s = x.shape[1]
    start = int(start)
    positions = start + torch.arange(s, device=x.device)
    block_ids = torch.as_tensor(block_ids, dtype=torch.long, device=x.device)
    if prefix_ids is not None:
        prefix_ids = torch.as_tensor(prefix_ids, dtype=torch.long,
                                     device=x.device)
    n = start + s if true_len is None else int(true_len)
    for i in range(cfg.n_layers):
        c = _pools_at(cache, i)
        kv_prefix = None
        if prefix_ids is not None:
            kv_prefix = (gather_prefix_kv(c["k"], prefix_ids, c.get("kscale")),
                         gather_prefix_kv(c["v"], prefix_ids, c.get("vscale")))
        x, k, v, xk, xv = _dec_prefill_layer(
            x, _at(params["dec_stack"], i), enc, cfg, positions,
            kv_prefix=kv_prefix)
        if c["k"].dtype == torch.int8:
            k, v = quantize_kv(k, attn.KV_SCALE), quantize_kv(v, attn.KV_SCALE)
        prefill_write_kv(c["k"], k, block_ids)
        prefill_write_kv(c["v"], v, block_ids)
        cache["xk"][i, slot] = xk[0].to(cache["xk"].dtype)
        cache["xv"][i, slot] = xv[0].to(cache["xv"].dtype)
    last = x[:, n - 1 - start:n - start]      # last *real* position
    cache["len"][slot] = n
    return dense._logits(params, last, cfg)[:, 0], cache


def paged_decode_step(params, cache, tokens, cfg: ModelConfig, table, *,
                      qparams=None):
    """One decode step with paged self-attention (B1 on float pools, B2 on
    int8) and the per-slot cross K/V; returns ([slots, V] logits, cache)
    with ``len`` advanced. The self-attention is global: a ring dict
    ``table`` resolves to its full-history table."""
    del qparams   # encdec serving keeps float weights
    x = nn.embed(tokens[:, None], params["embed"], cfg.compute_dtype)
    pos = cache["len"].to(torch.int32).expand(x.shape[0])
    tbl, _ = dense._resolve_paged_table(table, "G")
    tbl = tbl.to(torch.int32)
    for i in range(cfg.n_layers):
        p = _at(params["dec_stack"], i)
        lin = dense._float_lin(p)
        x = dense._paged_decode_attention(x, p, _pools_at(cache, i), "G", cfg,
                                          pos, tbl, lin)
        x = _cross_decode(x, p, cache["xk"][i], cache["xv"][i], cfg)
        x = dense._lin_mlp(x, p, cfg, lin)
    logits = dense._logits(params, x, cfg)
    cache["len"] = cache["len"] + 1
    return logits[:, 0], cache


def paged_verify_step(params, cache, tokens, cfg: ModelConfig, table, *,
                      qparams=None):
    """Speculative verify step (``transformer.paged_verify_step``'s
    contract): ``tokens`` [slots, Q], self-attention through B4 / B5 over
    the pools, the cross-attention folded per row; returns ([slots, Q, V]
    logits, cache) with ``cache["len"]`` untouched."""
    del qparams
    x = nn.embed(tokens, params["embed"], cfg.compute_dtype)
    pos = cache["len"].to(torch.int32).expand(x.shape[0])
    tbl, _ = dense._resolve_paged_table(table, "G")
    tbl = tbl.to(torch.int32)
    for i in range(cfg.n_layers):
        p = _at(params["dec_stack"], i)
        lin = dense._float_lin(p)
        x = dense._paged_verify_attention(x, p, _pools_at(cache, i), "G",
                                          cfg, pos, tbl, lin)
        x = _cross_decode(x, p, cache["xk"][i], cache["xv"][i], cfg)
        x = dense._lin_mlp(x, p, cfg, lin)
    return dense._logits(params, x, cfg), cache
