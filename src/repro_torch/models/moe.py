"""Mixture-of-Experts transformer family (qwen3-moe-30b-a3b, kimi-k2-1t):
the paged and dense-arena serving paths.

Port of ``repro.models.moe`` (its serving half): dense GQA attention (the
dense family's attention halves: kernels B1/B2 in paged decode and B4/B5
in verify, plain PyTorch on the arena) and a top-k routed expert FFN.
Routing is token-choice with a per-batch-row capacity: each batch row is
one routing group, and an expert takes at most ``_capacity(cfg, s)`` of a
group's ``s · topk`` slots, in slot order; the rest are dropped (they add
nothing to the token's output). The parameter tree has the reference
schema's keys and its leading ``n_stack`` axis.

The family keeps float weights (the W8A8 path is the dense family's) but
stores K/V in int8 blocks on ``serve_quant`` archs, as the dense family
does; its arena entry points (``forward``, ``init_cache``, ``prefill``,
``decode_step``) are the dense family's scaffolds with this family's
layers, with the dense family's int8 K/V arena step (requantized
writes, ``decode_attention_int8``) on ``serve_quant`` archs. It defines
no ``quantize_params`` and takes no right-padded prompts: pad tokens
would enlarge the routing capacity and could change which real tokens
overflow. The expert
products are plain batched matrix products over the full ``[B, E, C,
D]`` dispatch buffer, as in the reference (which computes them outside
any Pallas kernel).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import layers as nn
from repro_torch.models import transformer as dense
from repro_torch.models.config import ModelConfig
from repro_torch.models.schema import TensorSpec


def _capacity(cfg: ModelConfig, seq: int) -> int:
    """Slots an expert takes from one routing group of ``seq`` tokens
    (rounded up to a multiple of 8, at least 8)."""
    c = int(seq * cfg.topk * cfg.moe_capacity / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def _moe_layer_schema(cfg: ModelConfig, n_stack: int) -> Dict[str, TensorSpec]:
    d, hd = cfg.d_model, cfg.hd
    nq, nkv, f, e = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.n_experts
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
        "router": t((d, e), ("embed", "experts")),
        "we_gate": t((e, d, f), ("experts", "embed", "mlp")),
        "we_up": t((e, d, f), ("experts", "embed", "mlp")),
        "we_down": t((e, f, d), ("experts", "mlp", "embed")),
    }


def schema(cfg: ModelConfig):
    pattern, n_groups, tail = cfg.layer_layout()
    s: Dict[str, Any] = {
        "embed": TensorSpec((cfg.vocab, cfg.d_model), ("vocab", "embed_io"),
                            init="embed"),
        "final_norm": TensorSpec((cfg.d_model,), ("embed",), init="zeros"),
        "stacks": [_moe_layer_schema(cfg, n_groups) for _ in pattern],
    }
    if tail:
        s["tail"] = [_moe_layer_schema(cfg, 1) for _ in tail]
    if not cfg.tie_embeddings:
        s["unembed"] = TensorSpec((cfg.vocab, cfg.d_model), ("vocab", "embed_io"))
    return s


# ---------------------------------------------------------------------------
# Routed expert FFN
# ---------------------------------------------------------------------------


def route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """Token-choice top-k routing of ``x`` [B, S, D] with capacity
    ``_capacity(cfg, S)`` per expert and batch row.

    Returns ``(gate [B, S·k], flat_e [B, S·k], pos [B, S·k], keep [B,
    S·k])``: slot ``t = token·k + j`` goes to expert ``flat_e[:, t]`` (the
    token's j-th choice) at position ``pos`` in that expert's buffer, and
    is kept when ``pos`` is under the capacity. The top k come from a
    stable descending sort, so equal probabilities take the lower expert
    first, as ``jax.lax.top_k`` does (a zero router ties every expert)."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.topk
    cap = _capacity(cfg, s)
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[..., :k], idx[..., :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat_e = idx.reshape(b, s * k)
    onehot = flat_e[..., None] == torch.arange(e, device=x.device)
    seen = torch.cumsum(onehot, dim=1, dtype=torch.int32)       # [B, S·k, E]
    pos = seen.gather(-1, flat_e[..., None])[..., 0] - 1
    keep = (pos < cap) & (pos >= 0)
    return gate.reshape(b, s * k), flat_e, pos, keep


def moe_mlp(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """Token-choice top-k expert FFN with per-batch-row capacity: the
    reference's gather-only dispatch. The slot map is inverted once (an
    integer scatter; dropped slots land on a trash entry), tokens are
    gathered into the ``[B, E, C, D]`` expert buffer, every expert runs
    its three products over its whole buffer in ``x``'s dtype, and each
    kept slot's output is gathered back, scaled by its gate and summed
    over the token's k choices."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.topk
    cap = _capacity(cfg, s)
    act = nn.ACTIVATIONS[cfg.act]
    gate, flat_e, pos, keep = route(x, p["router"], cfg)
    pos_c = torch.clamp(pos, 0, cap - 1)
    dev = x.device
    bidx = torch.arange(b, device=dev)[:, None]

    # slot_id[b, e, c]: the slot held at expert e's position c, or the
    # sentinel s·k where the position is empty
    sk = s * k
    trash = b * e * cap
    lin = torch.where(keep, (bidx * e + flat_e) * cap + pos_c, trash)
    slot_id = torch.full((trash + 1,), sk, dtype=torch.long, device=dev)
    slot_id.scatter_(0, lin.reshape(-1),
                     torch.arange(sk, device=dev).repeat(b))
    slot_id = slot_id[:trash].view(b, e, cap)
    empty = slot_id >= sk
    token_of_slot = torch.clamp(slot_id, max=sk - 1) // k       # [B, E, C]

    # tokens -> expert slots (gather), held expert-major [E, B·C, D] so
    # each expert's products are one matrix product of a batched product
    buf = x[bidx, token_of_slot.reshape(b, e * cap)].view(b, e, cap, d)
    buf = buf.masked_fill(empty[..., None], 0)
    buf = buf.transpose(0, 1).reshape(e, b * cap, d)
    h = act(torch.bmm(buf, p["we_gate"].to(x.dtype)),
            torch.bmm(buf, p["we_up"].to(x.dtype)))
    out_buf = torch.bmm(h, p["we_down"].to(x.dtype)).view(e, b, cap, d)

    # expert slots -> token slots (gather)
    y = out_buf[flat_e, bidx, pos_c]                             # [B, S·k, D]
    y = y.masked_fill(~keep[..., None], 0)
    y = y * gate[..., None].to(y.dtype)
    return y.view(b, s, k, d).sum(2)


# ---------------------------------------------------------------------------
# Layers, and the dense-arena entry points
# ---------------------------------------------------------------------------


def _ffn(x, p, cfg: ModelConfig):
    return x + moe_mlp(nn.rms_norm(x, p["ln2"]), p, cfg)


def _prefill_layer(xc, p, kind: str, cfg: ModelConfig, positions, *,
                   kv_prefix=None):
    """One prefill layer; returns (x, this layer's k, v). With
    ``kv_prefix`` (a prefix-cache hit or a later chunk) the router sees
    only the suffix tokens, so the capacity is sized to the suffix."""
    xc, k, v = dense._prefill_attention(xc, p, kind, cfg, positions,
                                        kv_prefix=kv_prefix)
    return _ffn(xc, p, cfg), k, v


def forward(params, tokens, cfg: ModelConfig, *, embeds=None):
    """Teacher-forcing logits [B, S, V]; each batch row routes as a group."""
    return dense._forward_impl(params, tokens, cfg, layer_fn=_prefill_layer,
                               embeds=embeds)


# the dense family's per-slot KV cache
init_cache = dense.init_cache


def _decode_layer(x, p, c, kind, cfg: ModelConfig, pos, *, qparams=None):
    """One-token arena decode through one layer (float weights; int8 K/V
    and the ITA integer attention under ``serve_quant``); each row is its
    own routing group of one token."""
    x = dense._decode_attention(x, p, c, kind, cfg, pos, dense._float_lin(p))
    return _ffn(x, p, cfg)


def decode_step(params, cache, tokens, cfg: ModelConfig, *, qparams=None,
                embeds=None):
    """One arena decode step (the dense family's ``decode_step`` contract).
    ``qparams`` is ignored, as in the reference: the family serves float
    weights; under ``serve_quant`` its K/V writes requantize and its
    attention is ``decode_attention_int8``, as the dense family's."""
    del qparams
    return dense._decode_impl(params, cache, tokens, cfg,
                              layer_fn=_decode_layer, embeds=embeds)


def prefill(params, tokens, cfg: ModelConfig, max_len: int, *, embeds=None):
    """Forward pass plus a populated float cache (the dense family's
    ``prefill`` contract). ``tokens`` is the exact prompt, one routing
    group a row: there is no ``true_len``, since pad tokens would change
    the capacity ``_capacity(cfg, S)``."""
    return dense._prefill_impl(params, tokens, cfg, max_len,
                               layer_fn=_prefill_layer, embeds=embeds)


# ---------------------------------------------------------------------------
# Paged serving steps
# ---------------------------------------------------------------------------


def _paged_decode_layer(x, p, c, kind, cfg: ModelConfig, pos, table, *,
                        qparams=None):
    """One-token decode through one layer; each row is its own routing
    group of one token."""
    x = dense._paged_decode_attention(x, p, c, kind, cfg, pos, table,
                                      dense._float_lin(p))
    return _ffn(x, p, cfg)


def _paged_verify_layer(x, p, c, kind, cfg: ModelConfig, pos, table, *,
                        qparams=None):
    """Small-q verify through one layer: the Q = spec + 1 positions of a
    row form one routing group, with capacity ``_capacity(cfg, Q)``."""
    x = dense._paged_verify_attention(x, p, c, kind, cfg, pos, table,
                                      dense._float_lin(p))
    return _ffn(x, p, cfg)


def paged_decode_step(params, cache, tokens, cfg: ModelConfig, table, *,
                      qparams=None):
    """One decode step against the paged block pool (the dense family's
    ``paged_decode_step`` contract). ``qparams`` is ignored: the family
    serves float weights."""
    del qparams
    return dense._paged_decode_impl(params, cache, tokens, cfg, table,
                                    layer_fn=_paged_decode_layer)


def paged_verify_step(params, cache, tokens, cfg: ModelConfig, table, *,
                      qparams=None):
    """Speculative-decode verify step (the dense family's
    ``paged_verify_step`` contract): ``tokens`` [slots, Q], returns
    ``(logits [slots, Q, V], cache)`` with ``cache["len"]`` untouched."""
    del qparams
    return dense._paged_verify_impl(params, cache, tokens, cfg, table,
                                    layer_fn=_paged_verify_layer)


def paged_prefill(params, tokens, cfg: ModelConfig, cache, slot, block_ids,
                  *, ring_ids=None, true_len=None, embeds=None,
                  prefix_ids=None, start=0):
    """Prefill straight into pool blocks: the dense family's scaffold with
    this family's layer (see ``transformer.paged_prefill`` for the write
    and resume conventions). ``tokens`` is the exact prompt or chunk: the
    routing capacity is ``_capacity(cfg, tokens.shape[1])``, so a resumed
    suffix (prefix-cache hit or chunk) routes as a group of its own."""
    return dense._paged_prefill_impl(
        params, tokens, cfg, cache, slot, block_ids, layer_fn=_prefill_layer,
        ring_ids=ring_ids, true_len=true_len, embeds=embeds,
        prefix_ids=prefix_ids, start=start)


# the dense family's pool layout; K/V may live in int8 blocks
init_paged_cache = dense.init_paged_cache
paged_insert = dense.paged_insert
PAGED_INT8_KV = True
