"""Architecture configs: the 10 assigned archs + the paper's own workloads.

Exact figures from the assignment table (``[source; verified-tier]`` noted
per arch in the module for each). ``--arch <id>`` resolves through
``get_config``; ``smoke_config`` returns the reduced same-family variant
used by CPU smoke tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.models.config import ModelConfig

from repro_torch.configs.shapes import (  # noqa: F401
    SHAPES, ShapeCell, cell_applicable, cells_for_arch,
)

_CONFIGS: Dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    _CONFIGS[cfg.name] = cfg
    return cfg


# — LM-family transformers (assignment block) ————————————————————————————

# [ssm] SSD; arXiv:2405.21060; unverified
MAMBA2_2P7B = _register(ModelConfig(
    name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
    # vocab 50280 padded to 50304 (÷256) for TP sharding — standard practice
    n_heads=80, n_kv_heads=80, d_ff=0, vocab=50304, pattern="M",
    ssm_state=128, ssm_headdim=64, ssm_ngroups=1, expand=2,
    max_seq=1048576,
))

# [dense] RoPE SwiGLU GQA; arXiv:2404.14219; unverified
PHI3_MEDIUM_14B = _register(ModelConfig(
    name="phi3-medium-14b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=10, d_ff=17920, vocab=100352, act="swiglu",
    max_seq=131072,
))

# [dense] RoPE GQA; hf:THUDM/glm-4-9b; hf
GLM4_9B = _register(ModelConfig(
    name="glm4-9b", family="dense", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=2, d_ff=13696, vocab=151552, act="swiglu",
    max_seq=131072,
))

# [dense] 5:1 local:global, 128k; hf:google/gemma-3-*; unverified
GEMMA3_4B = _register(ModelConfig(
    name="gemma3-4b", family="dense", n_layers=34, d_model=2560,
    n_heads=8, n_kv_heads=4, d_ff=10240, vocab=262144, act="geglu",
    pattern="LLLLLG", local_window=1024, head_dim=256,
    tie_embeddings=True, max_seq=1048576,
))

# [dense] RoPE SwiGLU; arXiv:2404.14219; unverified
PHI3_MINI_3P8B = _register(ModelConfig(
    name="phi3-mini-3.8b", family="dense", n_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32064, act="swiglu",
    max_seq=131072,
))

# [moe] 128 experts top-8; hf:Qwen/Qwen3-30B-A3B; hf
QWEN3_MOE_30B = _register(ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=4, d_ff=768, vocab=151936, act="swiglu",
    head_dim=128, n_experts=128, topk=8, max_seq=131072,
))

# [moe] trillion-param MoE (paper-table); arXiv:2501.kimi2; unverified
KIMI_K2_1T = _register(ModelConfig(
    name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
    n_heads=64, n_kv_heads=8, d_ff=2048, vocab=163840, act="swiglu",
    head_dim=128, n_experts=384, topk=8, dtype="bfloat16",
    max_seq=131072,
))

# [vlm] anyres tiling (frontend stubbed); hf:llava-hf/…; unverified
LLAVA_NEXT_34B = _register(ModelConfig(
    name="llava-next-34b", family="vlm-dense", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=20480, vocab=64000, act="swiglu",
    embeds_input=True, max_seq=131072,
))

# [hybrid] RG-LRU + local attn, 1:2; arXiv:2402.19427; unverified
RECURRENTGEMMA_9B = _register(ModelConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, d_ff=12288, vocab=256000, act="geglu",
    pattern="RRL", local_window=2048, lru_width=4096, head_dim=256,
    max_seq=1048576,
))

# [audio] enc-dec, conv frontend (stub); arXiv:2212.04356; unverified
WHISPER_SMALL = _register(ModelConfig(
    name="whisper-small", family="encdec", n_layers=12, n_enc_layers=12,
    # vocab 51865 padded to 51904 (÷64) for TP sharding — standard practice
    d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072, vocab=51904,
    act="geglu", enc_seq=1500, embeds_input=True, max_seq=32768,
))

# — the paper's own Table II workloads ————————————————————————————————

MOBILEBERT = _register(ModelConfig(
    name="mobilebert", family="dense", n_layers=24, d_model=512,
    n_heads=4, n_kv_heads=4, d_ff=512, vocab=30522, pattern="G",
    act="geglu", max_seq=512,
))

WHISPER_TINY_ENC = _register(ModelConfig(
    name="whisper-tiny-enc", family="encdec", n_layers=4, n_enc_layers=4,
    d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536, vocab=51865,
    act="geglu", enc_seq=1500, embeds_input=True, max_seq=448,
))

DINOV2_S = _register(ModelConfig(
    name="dinov2-s", family="vlm-dense", n_layers=12, d_model=384,
    n_heads=6, n_kv_heads=6, d_ff=1536, vocab=1024, act="geglu",
    embeds_input=True, max_seq=1370,
))

ASSIGNED = [
    "mamba2-2.7b", "phi3-medium-14b", "glm4-9b", "gemma3-4b",
    "phi3-mini-3.8b", "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b",
    "llava-next-34b", "recurrentgemma-9b", "whisper-small",
]


def get_config(name: str) -> ModelConfig:
    if name not in _CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_CONFIGS)}")
    return _CONFIGS[name]


def all_configs() -> Dict[str, ModelConfig]:
    return dict(_CONFIGS)


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (one fwd/train step)."""
    cfg = get_config(name)
    period = len(cfg.pattern)
    overrides = dict(
        name=cfg.name + "-smoke",
        n_layers=max(2 * period, period + 1) if period > 1 else 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_ff=96 if cfg.family == "moe" else 128,
        vocab=512,
        head_dim=16,
        local_window=16,
        lru_width=64 if cfg.lru_width else None,
        n_experts=8 if cfg.n_experts else 0,
        topk=2 if cfg.topk else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_headdim=16 if cfg.ssm_state else 64,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        enc_seq=24 if cfg.n_enc_layers else 1500,
        max_seq=128,
        attn_chunk_q=16,
    )
    if cfg.family == "ssm":
        overrides["n_heads"] = 8  # d_inner/headdim = 128/16
        overrides["n_kv_heads"] = 8
    return dataclasses.replace(cfg, **overrides)
