"""Dense decoder-only transformer family: the paged and dense-arena serving
paths.

Port of ``repro.models.transformer``. Parameters are a dict tree with the
reference schema's keys and its leading ``n_stack`` axis:
``stacks[i][name][g]`` is layer ``g·len(pattern) + i``. The stack is
evaluated as a Python loop over groups (the reference's ``lax.scan``).

Dense arena (``forward``, ``init_cache``, ``prefill``, ``decode_step``):
a per-slot KV cache ``{"stacks": [{"k", "v"}], "tail": [...], "len"}``
with leaves ``[n_stack, B, Hkv, S_len, hd]``, where a sliding-window ("L")
layer keeps a ring of ``S_len = min(local_window, max_len)`` rows
(position ``p`` at row ``p % S_len``). ``decode_step`` writes into the
cache it is given, in place. Under ``serve_quant`` (the reference's
int8 arena step) every write requantizes K/V (``cache.quantize_kv``),
so the cache holds int8 integers (in the compute dtype on the serving
arena, as in the reference), and decode attends them through the ITA
integer ``attention.decode_attention_int8``; with ``qparams`` the seven
decode projections are W8A8 (``_qlin``, kernel B3 on the card), and
prefill keeps the float ones. Tail layers are written through the
same in-place views as the stacked ones, so their cache keeps the
``[1, B, Hkv, S_len, hd]`` shape that ``init_cache`` gives it (the
reference's ``prefill`` drops the leading axis there, ROADMAP Queue C).

The paged cache is ``{"stacks": [{"k", "v"[, "kscale", "vscale"]}], "len"}``
with pools ``[n_stack, num_blocks, Hkv, block_len, hd]``. Writes go into the
pool tensors **in place** (the reference returns a new pytree and donates
the old one); ``paged_decode_step`` and ``paged_prefill`` still return the
cache so callers read like the reference.

INT8 serving (``serve_quant``): K/V are requantized at write time into int8
blocks; decode runs W8A8 projections through ``kernels.int8_gemm`` and
attention through ``paged_attention_int8``. As in the reference, prefill
uses the *float* projections even on int8 archs; decode and the
speculative verify step are W8A8.

Speculative decoding: ``paged_verify_step`` scores ``Q = spec_tokens + 1``
positions per slot in one pass (``paged_attention_verify{,_int8}``); query
row 0 is exactly a decode step. Prefix caching: ``paged_prefill`` resumes
after ``start`` cached positions (``prefix_ids``), attending the gathered
prefix K/V and computing only the suffix.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch

from repro_torch.core.device import DeviceLike, resolve_device
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
# Projections and the layers' shared halves
# ---------------------------------------------------------------------------


def _qlin(qp, name, y):
    """Quantized linear for the int8 serving path (static activation scale)."""
    from repro_torch.kernels.int8_gemm.ops import int8_gemm

    y8 = torch.clamp(torch.round(y.float() * recip32(attn.ACT_SCALE)),
                     -127, 127).to(torch.int8)
    out8 = int8_gemm(y8, qp[name])
    return (out8.float() * attn.ACT_SCALE).to(y.dtype)


def _float_lin(p):
    """The float projections of a layer, as ``_qlin`` is called."""
    return lambda name, y: nn.dense(y, p[name])


def _lin_for(p, qparams):
    """The layer's projections: W8A8 with ``qparams``, else float."""
    return (functools.partial(_qlin, qparams) if qparams is not None
            else _float_lin(p))


def _lin_mlp(x, p, cfg: ModelConfig, lin):
    """x plus the gated MLP of ``rms_norm(x)`` through ``lin``."""
    h = nn.rms_norm(x, p["ln2"])
    act = nn.ACTIVATIONS[cfg.act]
    return x + lin("wd", act(lin("wg", h), lin("wu", h)))


def _project_qkv(x, lin, cfg: ModelConfig, positions):
    """q, k, v ([B, H, S, hd]) of ``x`` [B, S, D] through the projections
    ``lin`` (``_float_lin`` or the W8A8 ``_qlin``), RoPE at
    ``positions``."""
    b, s, _ = x.shape
    hd = cfg.hd
    q = lin("wq", x).reshape(b, s, cfg.n_heads, hd).transpose(1, 2)
    k = lin("wk", x).reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    v = lin("wv", x).reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    q = nn.rope(q, positions, cfg.rope_theta)
    k = nn.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _merge_heads(o):
    b, h, s, hd = o.shape
    return o.transpose(1, 2).reshape(b, s, h * hd)


def _prefill_layer(xc, p, kind: str, cfg: ModelConfig, positions, *,
                   kv_prefix=None):
    """One prefill layer application; returns (x, this layer's k, v — the
    newly computed positions only).

    ``kv_prefix`` (prefix-cache resume): ``(k, v)`` of the cached prefix,
    gathered from the pool. The suffix queries attend [prefix ++ suffix]
    with ``q_offset`` placing row 0 right after the prefix, so the causal
    and window masks bind by absolute position."""
    xc, k, v = _prefill_attention(xc, p, kind, cfg, positions,
                                  kv_prefix=kv_prefix)
    return _lin_mlp(xc, p, cfg, _float_lin(p)), k, v


def _prefill_attention(xc, p, kind: str, cfg: ModelConfig, positions, *,
                       kv_prefix=None):
    """The attention half of a prefill layer, shared with the moe family:
    returns (x plus the attention output, this layer's k, v)."""
    h = nn.rms_norm(xc, p["ln1"])
    q, k, v = _project_qkv(h, _float_lin(p), cfg, positions)
    ka, va, q_off = k, v, 0
    if kv_prefix is not None:
        kp, vp = kv_prefix
        ka = torch.cat([kp.to(k.dtype), k], dim=2)
        va = torch.cat([vp.to(v.dtype), v], dim=2)
        q_off = kp.shape[2]
    o = attn.chunked_attention(
        q, ka, va, causal=kind != "B",
        window=cfg.local_window if kind == "L" else None,
        chunk_q=min(cfg.attn_chunk_q, xc.shape[1]),
        q_offset=q_off,
    )
    return xc + nn.dense(_merge_heads(o), p["wo"]), k, v


# ---------------------------------------------------------------------------
# Dense (per-slot) KV cache writes: the arena's layers (this family's, the
# moe family's and the hybrid family's ring layers)
# ---------------------------------------------------------------------------


def _as_positions(pos, batch: int) -> torch.Tensor:
    """Normalize a scalar or [B] ``len`` entry to a per-row position vector."""
    return torch.as_tensor(pos, dtype=torch.int32).expand(batch)


def _cache_write(c, k_new, v_new, pos, kind: str, cfg: ModelConfig):
    """Write one token's k/v ([B, Hkv, 1, hd]) at per-row position ``pos``
    into ``c["k"]``/``c["v"]`` ([B, Hkv, S_len, hd]), in place: a local
    ("L") layer's cache is a ring (slot ``pos % S_len``), a global layer's
    is clamped at its last row. Rows may sit at different positions (the
    continuous-batching case), so the write is a per-row scatter."""
    b, _, s_len, _ = c["k"].shape
    pos = _as_positions(pos, b).long()
    idx = pos % s_len if kind == "L" else torch.clamp(pos, max=s_len - 1)
    rows = torch.arange(b, device=pos.device)
    c["k"][rows, :, idx] = k_new[:, :, 0].to(c["k"].dtype)
    c["v"][rows, :, idx] = v_new[:, :, 0].to(c["v"].dtype)
    return c


def _logits(params, x, cfg: ModelConfig):
    """Final norm and the LM head: f32 logits [B, S, V]."""
    x = nn.rms_norm(x, params["final_norm"])
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return nn.unembed(x, table)


# ---------------------------------------------------------------------------
# Dense arena: teacher forcing, the per-slot KV cache, prefill and decode
# ---------------------------------------------------------------------------


def _embed_in(params, tokens, cfg: ModelConfig, embeds):
    """``embeds`` when given (the vlm/audio frontend stubs), else the token
    embedding."""
    if embeds is not None:
        return embeds
    return nn.embed(tokens, params["embed"], cfg.compute_dtype)


def _prompt_in(params, tokens, cfg: ModelConfig, embeds, start: int = 0,
               stop: Optional[int] = None):
    """A prefill's input, positions ``start .. stop - 1`` of a sequence
    whose tokens from ``start`` on are ``tokens``: their token embedding
    (all of ``tokens``); or, with ``embeds`` (the vlm frontend stub: the
    prompt's embeddings from position 0), its rows, continued past its
    last row by the token embedding. A chunk or a prefix-cache resume
    takes its own rows of ``embeds``, and the re-prefill of a preempted
    request its generated tokens after the prompt, whose embeddings the
    request does not hold (the reference feeds ``embeds`` whole to every
    prefill, ROADMAP Queue C). ``stop`` defaults to the end of
    ``tokens``; without ``tokens`` the input is ``embeds`` whole."""
    if embeds is None or tokens is None:
        return _embed_in(params, tokens, cfg, embeds)
    if stop is None:
        stop = start + tokens.shape[1]
    rows = embeds[:, start:stop]
    if rows.shape[1] == stop - start:
        return rows
    rest = nn.embed(tokens[:, rows.shape[1]:stop - start], params["embed"],
                    cfg.compute_dtype)
    return torch.cat([rows, rest.to(rows.dtype)], dim=1)


def forward(params, tokens, cfg: ModelConfig, *, embeds=None):
    """Teacher-forcing logits [B, S, V]. ``embeds`` [B, S, D] overrides the
    token embedding."""
    return _forward_impl(params, tokens, cfg, layer_fn=_prefill_layer,
                         embeds=embeds)


def _forward_impl(params, tokens, cfg: ModelConfig, *, layer_fn,
                  embeds=None):
    """Shared forward scaffold over ``layer_fn`` (a prefill layer; its k/v
    are dropped)."""
    x = _embed_in(params, tokens, cfg, embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    for kind, where, g in _layers(cfg):
        x, _, _ = layer_fn(x, _entry(params, where, g), kind, cfg, positions)
    return _logits(params, x, cfg)


def _cache_len_for(kind: str, cfg: ModelConfig, max_len: int) -> int:
    return min(cfg.local_window, max_len) if kind == "L" else max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               quantized: Optional[bool] = None, device: DeviceLike = None):
    """Per-slot KV cache on ``device`` (default ``cuda``), stacked like the
    parameters: ``[n_stack, batch, Hkv, S_len, hd]`` leaves (int8 when
    ``quantized``, default ``cfg.serve_quant``; else the compute dtype)
    and the per-row position vector ``len``."""
    device = resolve_device(device)
    if quantized is None:
        quantized = cfg.serve_quant
    dt = torch.int8 if quantized else cfg.compute_dtype
    pattern, n_groups, tail = cfg.layer_layout()

    def kv(n_stack, kind):
        shape = (n_stack, batch, cfg.n_kv_heads,
                 _cache_len_for(kind, cfg, max_len), cfg.hd)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    cache: Dict[str, Any] = {
        "stacks": [kv(n_groups, kind) for kind in pattern],
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if tail:
        cache["tail"] = [kv(1, kind) for kind in tail]
    return cache


def _decode_attention(x, p, c, kind, cfg: ModelConfig, pos, lin):
    """The attention half of a one-token arena decode layer, shared with
    the moe family: q/k/v projected with ``lin``, k/v written at each
    row's position (a ring on "L" layers, ``_cache_write``, in place),
    then attention over the slot's cache; returns x plus the attention
    output. Under ``serve_quant`` K/V are requantized before the write
    and attended by the ITA integer ``decode_attention_int8`` (no window:
    a ring holds only the window, and once it wraps every row is
    valid)."""
    from repro_torch.models.cache import quantize_kv

    h = nn.rms_norm(x, p["ln1"])
    q, k, v = _project_qkv(h, lin, cfg, pos[:, None, None])
    if cfg.serve_quant:
        _cache_write(c, quantize_kv(k, attn.KV_SCALE),
                     quantize_kv(v, attn.KV_SCALE), pos, kind, cfg)
        o = attn.decode_attention_int8(q, c["k"], c["v"], pos + 1)
    else:
        _cache_write(c, k, v, pos, kind, cfg)
        o = attn.decode_attention(q, c["k"], c["v"], pos + 1,
                                  ring=kind == "L")
    return x + lin("wo", _merge_heads(o))


def _decode_layer(x, p, c, kind, cfg: ModelConfig, pos, *, qparams=None):
    """One-token decode through one layer (W8A8 projections with
    ``qparams``)."""
    lin = _lin_for(p, qparams)
    return _lin_mlp(_decode_attention(x, p, c, kind, cfg, pos, lin), p, cfg,
                    lin)


def decode_step(params, cache, tokens, cfg: ModelConfig, *, qparams=None,
                embeds=None):
    """One decode step: tokens [B] (or ``embeds`` [B, 1, D]) → ([B, V]
    logits, the cache written in place with ``len`` advanced by one).
    ``cache["len"]`` is a per-row position vector, so rows sit at their
    own positions (the continuous-batching layout). ``qparams``
    (``quantize_params``) makes the projections W8A8; ``serve_quant``
    makes the K/V writes and the attention integer."""
    return _decode_impl(params, cache, tokens, cfg, layer_fn=_decode_layer,
                        qparams=qparams, embeds=embeds)


def _decode_impl(params, cache, tokens, cfg: ModelConfig, *, layer_fn,
                 qparams=None, embeds=None):
    """Shared arena decode-step scaffold (layer loop over ``layer_fn``,
    each layer given its ``qparams`` entry, logits, position advance)."""
    x = _embed_in(params, None if tokens is None else tokens[:, None], cfg,
                  embeds)
    pos = _as_positions(cache["len"], x.shape[0])
    for kind, where, g in _layers(cfg):
        qp = None if qparams is None else _entry(qparams, where, g)
        x = layer_fn(x, _entry(params, where, g), _entry(cache, where, g),
                     kind, cfg, pos, qparams=qp)
    logits = _logits(params, x, cfg)
    cache["len"] = cache["len"] + 1
    return logits[:, 0], cache


def _fill(c, k, v, cfg: ModelConfig) -> None:
    """Write a prefill's k/v ([B, Hkv, S, hd]) into a fresh cache entry, in
    place: rows ``0..S-1``, or, where the prompt is longer than a ring,
    its last ``S_len`` positions with position ``p`` at row ``p % S_len``.
    Under ``serve_quant`` K/V are requantized first, as every serving
    write path of the reference does."""
    if cfg.serve_quant:
        from repro_torch.models.cache import quantize_kv

        k, v = quantize_kv(k, attn.KV_SCALE), quantize_kv(v, attn.KV_SCALE)
    s, s_len = k.shape[2], c["k"].shape[2]
    if s > s_len:
        k = torch.roll(k[:, :, -s_len:], s % s_len, dims=2)
        v = torch.roll(v[:, :, -s_len:], s % s_len, dims=2)
    c["k"][:, :, :min(s, s_len)] = k.to(c["k"].dtype)
    c["v"][:, :, :min(s, s_len)] = v.to(c["v"].dtype)


def prefill(params, tokens, cfg: ModelConfig, max_len: int, *, embeds=None,
            true_len=None):
    """Forward pass plus a populated float cache: [B, S] tokens (or
    ``embeds``) → ([B, V] logits, a batch-B cache of ``max_len``).

    ``true_len`` (a scalar or [B]) serves length-bucketed admission:
    ``tokens`` may be right-padded to a bucket, the logits are taken at
    position ``true_len - 1`` and ``len`` is set to ``true_len``, so the
    pad entries are never attended by decode (causal attention keeps them
    out of the real positions' prefill too)."""
    return _prefill_impl(params, tokens, cfg, max_len,
                         layer_fn=_prefill_layer, embeds=embeds,
                         true_len=true_len)


def _prefill_impl(params, tokens, cfg: ModelConfig, max_len: int, *,
                  layer_fn, embeds=None, true_len=None):
    """Shared arena prefill scaffold (layer loop over ``layer_fn``, cache
    fill, last-real-token logits)."""
    x = _prompt_in(params, tokens, cfg, embeds, stop=None if true_len is None
                   else int(torch.as_tensor(true_len).max()))
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)
    cache = init_cache(cfg, b, max_len, quantized=False, device=x.device)
    for kind, where, g in _layers(cfg):
        x, k, v = layer_fn(x, _entry(params, where, g), kind, cfg, positions)
        _fill(_entry(cache, where, g), k, v, cfg)
    if true_len is None:
        last = x[:, -1:]
        cache["len"].fill_(s)
    else:
        lens = torch.as_tensor(true_len, dtype=torch.int32,
                               device=x.device).expand(b)
        rows = torch.arange(b, device=x.device)
        last = x[rows, lens.long() - 1][:, None]      # last *real* position
        cache["len"].copy_(lens)
    return _logits(params, last, cfg)[:, 0], cache


# ---------------------------------------------------------------------------
# Paged KV cache + decode (block-pool serving layout)
# ---------------------------------------------------------------------------


def init_paged_cache(cfg: ModelConfig, slots: int, layout, *,
                     quantized: Optional[bool] = None,
                     device: DeviceLike = None):
    """Block-pool KV cache on ``device`` (default ``cuda``): per
    pattern-position stacks of shape ``[n_stack, num_blocks, Hkv,
    block_len, hd]`` shared by all ``slots`` decode rows, plus the per-row
    position vector. Int8 pools (``quantized``, default
    ``cfg.serve_quant``) carry per-block scale vectors ``kscale``/``vscale``
    ([n_stack, num_blocks] f32, filled with the static ``attn.KV_SCALE``
    calibration).

    When ``layout.window`` is set, sliding-window ("L") stacks are sized
    ``layout.ring_num_blocks`` rows, their scale vectors too: each slot
    reuses a fixed ring of ``layout.ring_blocks`` blocks, so an L layer's
    residency is bounded by the window, not ``max_len``."""
    device = resolve_device(device)
    if quantized is None:
        quantized = cfg.serve_quant
    pattern, n_groups, tail = cfg.layer_layout()
    hd, nkv = cfg.hd, cfg.n_kv_heads
    dt = torch.int8 if quantized else cfg.compute_dtype
    ring = getattr(layout, "window", None) is not None

    def kv(n_stack, kind):
        n_blocks = (layout.ring_num_blocks if ring and kind == "L"
                    else layout.num_blocks)
        shape = (n_stack, n_blocks, nkv, layout.block_len, hd)
        c = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
        if quantized:
            c["kscale"] = torch.full((n_stack, n_blocks),
                                     attn.KV_SCALE, dtype=torch.float32,
                                     device=device)
            c["vscale"] = torch.full((n_stack, n_blocks),
                                     attn.KV_SCALE, dtype=torch.float32,
                                     device=device)
        return c

    cache: Dict[str, Any] = {
        "stacks": [kv(n_groups, kind) for kind in pattern],
        "len": torch.zeros((slots,), dtype=torch.int32, device=device),
    }
    if tail:
        cache["tail"] = [kv(1, kind) for kind in tail]
    return cache


def _resolve_paged_table(table, kind: str):
    """(block table, start vector or None) for a layer of ``kind``.

    ``table`` is either a plain ``[slots, max_blocks]`` tensor (every layer
    walks the full-history table from position 0) or the ring dict
    ``{"full", "ring", "start"}`` the backend passes when sliding-window
    layers store ring blocks: L layers then walk the rotating ring table,
    whose entry 0 sits at absolute position ``start[slot]``."""
    if isinstance(table, dict):
        if kind == "L":
            return table["ring"], table["start"]
        return table["full"], None
    return table, None


def _paged_cache_write(c, k_new, v_new, pos, table, block_len: int,
                       start=None):
    """Scatter one token's k/v at per-row position ``pos`` through the
    block table, in place (ring tables pass ``start``, the absolute
    position of table entry 0). Empty rows point at the trash block (table
    row zeros), so their writes are harmless."""
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


def _check_int8_pools(qparams, c) -> None:
    """W8A8 weights need int8 pools."""
    if qparams is not None and c["k"].dtype != torch.int8:
        raise ValueError(
            "int8 serving over float block pools is not supported: build "
            "the paged cache with quantized=True so K/V live in int8 blocks")


def _paged_decode_attention(x, p, c, kind, cfg: ModelConfig, pos, table,
                            lin):
    """The attention half of a one-token paged decode layer, shared with the
    moe family: project q/k/v with ``lin``, write k/v through the block
    table (requantized on int8 pools), attend (B1/B2); returns x plus the
    attention output."""
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention, paged_attention_int8,
    )
    from repro_torch.models.cache import quantize_kv

    h = nn.rms_norm(x, p["ln1"])
    block_len = c["k"].shape[2]  # [num_blocks, Hkv, block_len, hd]
    q, k, v = _project_qkv(h, lin, cfg, pos[:, None, None])

    window = cfg.local_window if kind == "L" else None
    tbl, start = _resolve_paged_table(table, kind)
    lens = pos + 1
    if c["k"].dtype == torch.int8:
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
    return x + lin("wo", _merge_heads(o))


def _paged_decode_layer(x, p, c, kind, cfg: ModelConfig, pos, table, *,
                        qparams=None):
    """One-token decode through one layer against the paged pool."""
    _check_int8_pools(qparams, c)
    lin = _lin_for(p, qparams)
    x = _paged_decode_attention(x, p, c, kind, cfg, pos, table, lin)
    return _lin_mlp(x, p, cfg, lin)


def paged_decode_step(params, cache, tokens, cfg: ModelConfig, table, *,
                      qparams=None):
    """One decode step against the paged block pool.

    ``table`` [slots, max_blocks] int32 maps each row's position ``p`` to
    pool block ``table[row, p // block_len]`` (offset ``p % block_len``);
    the engine owns it host-side and passes it each call. On a ring layout
    it is the dict ``{"full": [slots, max_blocks], "ring": [slots,
    ring_blocks], "start": [slots]}``: sliding-window layers walk ``ring``
    from absolute position ``start`` (``_resolve_paged_table``). Returns
    ``(logits [slots, V], cache)`` with ``cache["len"]`` advanced by one.
    """
    return _paged_decode_impl(params, cache, tokens, cfg, table,
                              layer_fn=_paged_decode_layer, qparams=qparams)


def _paged_decode_impl(params, cache, tokens, cfg: ModelConfig, table, *,
                       layer_fn, qparams=None):
    """Shared paged decode-step scaffold (layer loop over ``layer_fn``,
    logits, position advance)."""
    x = nn.embed(tokens[:, None], params["embed"], cfg.compute_dtype)
    pos = cache["len"].to(torch.int32).expand(x.shape[0])
    if isinstance(table, dict):
        table = {k: v.to(torch.int32) for k, v in table.items()}
    else:
        table = table.to(torch.int32)
    for kind, where, g in _layers(cfg):
        qp = None if qparams is None else _entry(qparams, where, g)
        x = layer_fn(
            x, _entry(params, where, g), _entry(cache, where, g), kind, cfg,
            pos, table, qparams=qp)
    logits = _logits(params, x, cfg)
    cache["len"] = cache["len"] + 1
    return logits[:, 0], cache


def _paged_verify_write(c, k_new, v_new, pos, table, block_len: int):
    """Scatter Q consecutive tokens' k/v per row, in place: row ``b``'s
    query ``j`` lands at position ``pos[b] + j`` through the block table.
    Positions past the table (a full-length request's pad columns) divert
    to the trash block — clipping onto the last table entry could
    overwrite a real block's committed offsets. Pad columns past a row's
    drafts land past every committed length: never attended, and always
    rewritten before the frontier reaches them."""
    rows_b = pos.shape[0]
    qlen = k_new.shape[2]                          # [B, Hkv, Q, hd]
    max_blocks = table.shape[1]
    positions = pos[:, None] + torch.arange(qlen, dtype=torch.int32,
                                            device=pos.device)[None, :]
    bi_raw = positions // block_len
    bi = torch.clamp(bi_raw, 0, max_blocks - 1)
    rows = torch.arange(rows_b, device=pos.device)[:, None]
    blk_ids = table[rows, bi].long()               # [B, Q] pool rows
    blk_ids = torch.where(bi_raw >= max_blocks, 0, blk_ids)
    off = (positions % block_len).long()
    # advanced-index result axes lead: value shape [B, Q, Hkv, hd]
    c["k"][blk_ids, :, off] = k_new.transpose(1, 2).to(c["k"].dtype)
    c["v"][blk_ids, :, off] = v_new.transpose(1, 2).to(c["v"].dtype)
    return c


def _paged_verify_attention(x, p, c, kind, cfg: ModelConfig, pos, table,
                            lin):
    """The attention half of a small-q verify layer, shared with the moe
    family: Q consecutive positions a row projected with ``lin``, written
    through the block table and scored (B4/B5); returns x plus the
    attention output."""
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention_verify, paged_attention_verify_int8,
    )
    from repro_torch.models.cache import quantize_kv

    h = nn.rms_norm(x, p["ln1"])
    qlen = x.shape[1]
    block_len = c["k"].shape[2]
    positions = pos[:, None] + torch.arange(qlen, dtype=torch.int32,
                                            device=pos.device)[None, :]
    q, k, v = _project_qkv(h, lin, cfg, positions[:, None, :])

    window = cfg.local_window if kind == "L" else None
    tbl, start = _resolve_paged_table(table, kind)
    lens = pos + 1
    if c["k"].dtype == torch.int8:
        _paged_verify_write(c, quantize_kv(k, attn.KV_SCALE),
                            quantize_kv(v, attn.KV_SCALE), pos, tbl,
                            block_len)
        o = paged_attention_verify_int8(
            q.contiguous(), c["k"], c["v"], tbl, lens, k_scale=c["kscale"],
            v_scale=c["vscale"], window=window, start=start)
    else:
        _paged_verify_write(c, k, v, pos, tbl, block_len)
        o = paged_attention_verify(q.contiguous(), c["k"], c["v"], tbl, lens,
                                   window=window, start=start)
    return x + lin("wo", _merge_heads(o))


def _paged_verify_layer(x, p, c, kind, cfg: ModelConfig, pos, table, *,
                        qparams=None):
    """Small-q (speculative verify) pass through one layer: ``x`` carries
    Q = spec_tokens + 1 positions per row — the last committed token plus
    the drafts — all written and scored in one pool sweep. Query row 0
    repeats ``_paged_decode_layer``'s math (same write, and the verify
    attention's row 0 is exactly the decode mask)."""
    _check_int8_pools(qparams, c)
    lin = _lin_for(p, qparams)
    x = _paged_verify_attention(x, p, c, kind, cfg, pos, table, lin)
    return _lin_mlp(x, p, cfg, lin)


def paged_verify_step(params, cache, tokens, cfg: ModelConfig, table, *,
                      qparams=None):
    """Speculative-decode verify step: score Q = spec_tokens + 1 positions
    per slot in one pass against the paged pool.

    ``tokens`` [slots, Q] int32 — column 0 is each row's last committed
    token, columns 1.. the host-drafted candidates (pad columns repeat
    anything; their logits are ignored host-side). Logits row ``j`` is the
    model's prediction after consuming ``tokens[:, :j+1]``.

    Unlike ``paged_decode_step`` the position vector is host-owned:
    ``cache["len"]`` is read, never advanced — the engine commits the
    accepted count host-side and passes refreshed lengths next call (draft
    K/V past the accept point stays in the pool as garbage that is never
    attended and is overwritten before the frontier reaches it).

    Returns ``(logits [slots, Q, V], cache)``.
    """
    return _paged_verify_impl(params, cache, tokens, cfg, table,
                              layer_fn=_paged_verify_layer, qparams=qparams)


def _paged_verify_impl(params, cache, tokens, cfg: ModelConfig, table, *,
                       layer_fn, qparams=None):
    """Shared verify-step scaffold (layer loop over ``layer_fn``, logits;
    ``cache["len"]`` untouched)."""
    x = nn.embed(tokens, params["embed"], cfg.compute_dtype)  # [slots, Q, D]
    pos = cache["len"].to(torch.int32).expand(x.shape[0])
    table = table.to(torch.int32)
    for kind, where, g in _layers(cfg):
        qp = None if qparams is None else _entry(qparams, where, g)
        x = layer_fn(
            x, _entry(params, where, g), _entry(cache, where, g), kind, cfg,
            pos, table, qparams=qp)
    return _logits(params, x, cfg), cache


def paged_insert(cache, single, slot: int, block_ids, cfg: ModelConfig):
    """Splice a batch-1 prefilled arena cache (``prefill``'s, sized to
    ``len(block_ids)·block_len``) into pool blocks ``block_ids`` of every
    layer, in place, and set ``slot``'s position counter to the prefill's
    length. Int8 pools take the cache's requantized integers exactly.
    Returns ``cache``. (No engine calls it: the paged backend prefills
    straight into the pool.)"""
    from repro_torch.models.cache import paged_insert_kv

    for group in ("stacks", "tail"):
        for pc, sc in zip(cache.get(group, ()), single.get(group, ())):
            paged_insert_kv(pc["k"], sc["k"], block_ids)
            paged_insert_kv(pc["v"], sc["v"], block_ids)
    cache["len"][slot] = single["len"][0]
    return cache


def paged_prefill(params, tokens, cfg: ModelConfig, cache, slot, block_ids,
                  *, ring_ids=None, true_len=None, embeds=None,
                  prefix_ids=None, start=0):
    """Prefill straight into pool blocks: forward pass + per-layer K/V
    writes into the paged ``cache`` (in place). Returns ``(last-position
    logits, cache)``.

    ``tokens`` [1, S] may be right-padded to an admission bucket;
    ``true_len`` is then the real (total) length (logits are taken at
    position ``true_len - 1`` and ``slot``'s position counter is set to
    it). Full-history layers write ``len(block_ids)`` blocks, the
    partially-valid tail block whole; with ``ring_ids`` sliding-window
    ("L") layers write only the last ``len(ring_ids)`` blocks, circularly
    (``cache.ring_prefill_write_kv``). ``prefix_ids``/``start`` resume a
    prefix-cache hit: the first ``start = len(prefix_ids)·block_len``
    positions already live in pool blocks ``prefix_ids``, ``tokens``
    carries only the suffix, and the cached blocks are attended, not
    recomputed. ``embeds`` [1, S, D] replaces the token embedding, as in
    ``forward``."""
    return _paged_prefill_impl(params, tokens, cfg, cache, slot, block_ids,
                               layer_fn=_prefill_layer, ring_ids=ring_ids,
                               true_len=true_len, embeds=embeds,
                               prefix_ids=prefix_ids, start=start)


def _paged_prefill_impl(params, tokens, cfg: ModelConfig, cache, slot,
                        block_ids, *, layer_fn, ring_ids=None, true_len=None,
                        embeds=None, prefix_ids=None, start=0):
    """Shared paged-prefill scaffold (block writes, layer loop, last-real-
    token logits, slot position update). Int8 pools requantize K/V
    (``cache.quantize_kv``, static ``attn.KV_SCALE``) before the write.
    With ``prefix_ids`` each layer gathers the cached prefix K/V (int8
    pools dequantized by their per-block scales) before its suffix write —
    the prefix blocks are disjoint from ``block_ids``. Ring layers cannot
    resume (the skipped prefix would leave their ring unwritten), so
    ``prefix_ids`` with ``ring_ids`` is refused; the backend turns prefix
    caching off on ring layouts."""
    from repro_torch.models.cache import (
        check_fits, gather_prefix_kv, prefill_write_kv, quantize_kv,
        ring_prefill_write_kv, ring_write_index,
    )

    if prefix_ids is not None and ring_ids is not None:
        raise ValueError("prefix-cache resume is incompatible with ring "
                         "(sliding-window) prefill")
    start = int(start)
    n = start + tokens.shape[1] if true_len is None else int(true_len)
    if embeds is not None:
        # the reference writes every row of ``embeds`` into this call's
        # blocks, whatever ``start``: refuse where its write does
        check_fits(embeds.shape[1], block_ids.shape[0],
                   cache["stacks"][0]["k"].shape[3])
    x = _prompt_in(params, tokens, cfg, embeds, start, n)
    s = x.shape[1]
    positions = start + torch.arange(s, device=x.device)
    block_ids = torch.as_tensor(block_ids, dtype=torch.long, device=x.device)
    if prefix_ids is not None:
        prefix_ids = torch.as_tensor(prefix_ids, dtype=torch.long,
                                     device=x.device)
    ring_index = None
    if ring_ids is not None:
        ring_ids = torch.as_tensor(ring_ids, dtype=torch.long,
                                   device=x.device)
        # the (source block, ring row) pairs are the same for every layer
        block_len = cache["stacks"][0]["k"].shape[3]
        ring_index = ring_write_index(ring_ids, n, block_len)

    for kind, where, g in _layers(cfg):
        c = _entry(cache, where, g)
        kv_prefix = None
        if prefix_ids is not None:
            kv_prefix = (gather_prefix_kv(c["k"], prefix_ids, c.get("kscale")),
                         gather_prefix_kv(c["v"], prefix_ids, c.get("vscale")))
        x, k, v = layer_fn(x, _entry(params, where, g), kind, cfg, positions,
                           kv_prefix=kv_prefix)
        if c["k"].dtype == torch.int8:
            k = quantize_kv(k, attn.KV_SCALE)
            v = quantize_kv(v, attn.KV_SCALE)
        if kind == "L" and ring_ids is not None:
            ring_prefill_write_kv(c["k"], k, ring_ids, n, ring_index)
            ring_prefill_write_kv(c["v"], v, ring_ids, n, ring_index)
        else:
            prefill_write_kv(c["k"], k, block_ids)
            prefill_write_kv(c["v"], v, block_ids)

    last = x[:, n - 1 - start:n - start]      # last *real* position
    cache["len"][slot] = n
    return _logits(params, last, cfg)[:, 0], cache


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
    the reference's vmap without a float32 copy of a whole stack). Each
    stack's ``w_q`` [L, K, N] is the transposed view of one contiguous
    [L, N, K] tensor that the entries are written into, so ``params[i]`` is
    K-major as the int8 GEMM kernel takes it, and no second copy of a
    stack's weights is ever held."""
    from repro_torch.kernels.int8_gemm.ops import QuantizedLinearParams

    s = attn.ACT_SCALE

    def qlayer(p):
        out = {}
        for name in LINEARS:
            w = p[name]
            w_q = torch.empty(w.shape[:-2] + (w.shape[-1], w.shape[-2]),
                              dtype=torch.int8, device=w.device)
            consts = []
            for i, wi in enumerate(w):
                zero_bias = torch.zeros((wi.shape[-1],), dtype=torch.float32,
                                        device=wi.device)
                q = QuantizedLinearParams.from_float(wi.float(), zero_bias,
                                                     s, s)
                w_q[i] = q.w_q.mT
                consts.append((q.bias, q.mult, q.shift))
            out[name] = QuantizedLinearParams(
                w_q.mT, *(torch.stack(c) for c in zip(*consts)))
        return out

    q = {"stacks": [qlayer(st) for st in params["stacks"]]}
    if "tail" in params:
        q["tail"] = [qlayer(t) for t in params["tail"]]
    return q
