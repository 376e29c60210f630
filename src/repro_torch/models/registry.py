"""Architecture registry (port of ``repro.models.registry``).

This slice ports the dense transformer family, which also serves the
``vlm-dense`` configs (frontend stubbed, embeddings in). Other families
raise ``NotImplementedError`` naming the family.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Optional

from repro_torch.models.config import ModelConfig

_FAMILY_MODULES = {
    "dense": "repro_torch.models.transformer",
    "vlm-dense": "repro_torch.models.transformer",  # frontend stubbed
}


def get_family(family: str):
    if family not in _FAMILY_MODULES:
        raise NotImplementedError(
            f"family {family!r} is not ported to repro_torch yet "
            f"(ported: {', '.join(sorted(_FAMILY_MODULES))})")
    return importlib.import_module(_FAMILY_MODULES[family])


@dataclasses.dataclass(frozen=True)
class Arch:
    """Bound architecture: config + the family's paged serving entry points."""

    cfg: ModelConfig
    schema: Callable
    quantize_params: Optional[Callable] = None
    # prefill accepts right-padded prompts + ``true_len`` (bucketed serving
    # admission); exact only for causal-attention families
    supports_padded_prefill: bool = False
    init_paged_cache: Optional[Callable] = None
    paged_decode_step: Optional[Callable] = None
    paged_prefill: Optional[Callable] = None
    # the family can store paged K/V as int8 blocks (+ per-block scales)
    paged_int8_kv: bool = False

    @property
    def supports_paged(self) -> bool:
        return self.paged_decode_step is not None

    @property
    def supports_paged_prefill(self) -> bool:
        return self.paged_prefill is not None

    @property
    def supports_paged_int8(self) -> bool:
        return self.supports_paged and self.paged_int8_kv

    @property
    def name(self) -> str:
        return self.cfg.name


def build(cfg: ModelConfig) -> Arch:
    mod = get_family(cfg.family)
    return Arch(
        cfg=cfg,
        schema=lambda: mod.schema(cfg),
        quantize_params=lambda params: mod.quantize_params(params, cfg),
        supports_padded_prefill=mod.SUPPORTS_PADDED_PREFILL,
        paged_int8_kv=mod.PAGED_INT8_KV,
        init_paged_cache=lambda slots, layout, **kw: mod.init_paged_cache(
            cfg, slots, layout, **kw),
        paged_decode_step=lambda params, cache, tokens, table, **kw:
            mod.paged_decode_step(params, cache, tokens, cfg, table, **kw),
        paged_prefill=lambda params, tokens, cache, slot, block_ids, **kw:
            mod.paged_prefill(params, tokens, cfg, cache, slot, block_ids,
                              **kw),
    )


def build_by_name(name: str) -> Arch:
    from repro_torch.configs import get_config

    return build(get_config(name))
