"""Model configuration shared by all architecture families."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm-dense
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    act: str = "swiglu"            # swiglu | geglu
    rope_theta: float = 10000.0
    tie_embeddings: bool = False

    # layer pattern: sequence of per-layer kinds repeated down the stack.
    # kinds: 'G' global attn, 'L' local (sliding-window) attn, 'R' RG-LRU,
    # 'M' mamba2/SSD. E.g. gemma3 "LLLLLG", recurrentgemma "RRL", mamba2 "M".
    pattern: str = "G"
    local_window: int = 1024

    # MoE
    n_experts: int = 0
    topk: int = 0
    moe_capacity: float = 1.25

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    d_conv: int = 4
    expand: int = 2

    # hybrid (RG-LRU)
    lru_width: Optional[int] = None

    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 1500  # whisper mel-frame positions after conv stub

    # frontend stubs ([vlm]/[audio]: inputs arrive as embeddings)
    embeds_input: bool = False

    # numerics / execution
    dtype: str = "bfloat16"
    remat: bool = True             # checkpoint layer-group bodies in training
    attn_chunk_q: int = 128
    serve_quant: bool = True       # INT8 (paper) serving path where applicable
    max_seq: int = 131072

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    def layer_layout(self) -> Tuple[str, int, str]:
        """(group_pattern, n_groups, tail_pattern) covering n_layers."""
        p = len(self.pattern)
        n_groups, tail = divmod(self.n_layers, p)
        return self.pattern, n_groups, self.pattern[:tail]

    def param_count_estimate(self) -> int:
        from repro_torch.models import registry
        from repro_torch.models.schema import param_count

        return param_count(registry.get_family(self.family).schema(self))
