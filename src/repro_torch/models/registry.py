"""Architecture registry (port of ``repro.models.registry``).

Every family of the reference is ported: the dense transformer (which also
serves the ``vlm-dense`` configs, frontend stubbed, embeddings in), the
``moe`` family, the Mamba-2 ``ssm`` and Griffin ``hybrid`` families and
the whisper-style ``encdec`` family (frame embeddings in). Each binds its
dense-arena entry points (``forward``, ``prefill``, ``decode_step``,
``init_cache``); the attention-cache families (dense, vlm-dense, moe,
encdec) also their paged serving paths. ``registry.build`` succeeds on
every config; what the port still refuses is a mesh (``serve.api``).
Entry points a family module does not define stay ``None``, as in the
reference.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Optional

from repro_torch.models.config import ModelConfig

_FAMILY_MODULES = {
    "dense": "repro_torch.models.transformer",
    "vlm-dense": "repro_torch.models.transformer",  # frontend stubbed
    "moe": "repro_torch.models.moe",
    "ssm": "repro_torch.models.ssm",
    "hybrid": "repro_torch.models.griffin",
    "encdec": "repro_torch.models.encdec",
}


def get_family(family: str):
    if family not in _FAMILY_MODULES:
        raise NotImplementedError(
            f"family {family!r} is not ported to repro_torch yet "
            f"(ported: {', '.join(sorted(_FAMILY_MODULES))})")
    return importlib.import_module(_FAMILY_MODULES[family])


@dataclasses.dataclass(frozen=True)
class Arch:
    """Bound architecture: config + the family's entry points."""

    cfg: ModelConfig
    schema: Callable
    # dense-arena entry points (None where a family module does not
    # define them)
    forward: Optional[Callable] = None
    prefill: Optional[Callable] = None
    decode_step: Optional[Callable] = None
    init_cache: Optional[Callable] = None
    quantize_params: Optional[Callable] = None
    # prefill accepts right-padded prompts + ``true_len`` (bucketed serving
    # admission); exact only for causal-attention families
    supports_padded_prefill: bool = False
    # paged block-pool KV cache entry points (attention-cache families only;
    # recurrent state has no growing KV to page)
    init_paged_cache: Optional[Callable] = None
    paged_decode_step: Optional[Callable] = None
    # splice a batch-1 arena prefill into pool blocks (no engine calls it)
    paged_insert: Optional[Callable] = None
    paged_prefill: Optional[Callable] = None
    # small-q speculative verify step (score spec_tokens + 1 positions per
    # slot against the paged pool in one pass)
    paged_verify_step: Optional[Callable] = None
    # the family can store paged K/V as int8 blocks (+ per-block scales)
    paged_int8_kv: bool = False

    @property
    def supports_paged(self) -> bool:
        return self.paged_decode_step is not None

    @property
    def supports_paged_prefill(self) -> bool:
        return self.paged_prefill is not None

    @property
    def supports_spec_decode(self) -> bool:
        return (self.supports_paged and self.supports_paged_prefill
                and self.paged_verify_step is not None)

    @property
    def supports_paged_int8(self) -> bool:
        return self.supports_paged and self.paged_int8_kv

    @property
    def serve_backends(self) -> tuple:
        """Execution backends (``repro_torch.serve.backends``) this arch
        serves on. ``slot`` and ``arena`` need the dense-arena entry points
        (every ported family has them, as every family does in the
        reference), ``paged`` the paged decode and prefill entry points
        (recurrent state has no KV cache to page): ``("slot", "arena",
        "paged")`` for the dense, vlm-dense, moe and encdec families,
        ``("slot", "arena")`` for ssm and hybrid. A ``serve_quant`` arch of
        the attention-cache families serves on all three (the int8 arena
        step on ``slot`` and ``arena``)."""
        out = []
        if self.decode_step is not None and self.prefill is not None:
            out += ["slot", "arena"]
        if self.supports_paged and self.supports_paged_prefill:
            out.append("paged")
        return tuple(out)

    @property
    def name(self) -> str:
        return self.cfg.name


def _bind(mod, name: str, fn):
    """``fn`` when the family module defines ``name``, else None."""
    return fn if hasattr(mod, name) else None


def build(cfg: ModelConfig) -> Arch:
    mod = get_family(cfg.family)
    return Arch(
        cfg=cfg,
        schema=lambda: mod.schema(cfg),
        forward=_bind(mod, "forward", lambda params, tokens, **kw:
                      mod.forward(params, tokens, cfg, **kw)),
        prefill=_bind(mod, "prefill", lambda params, tokens, max_len, **kw:
                      mod.prefill(params, tokens, cfg, max_len, **kw)),
        decode_step=_bind(mod, "decode_step",
                          lambda params, cache, tokens, **kw:
                          mod.decode_step(params, cache, tokens, cfg, **kw)),
        init_cache=_bind(mod, "init_cache", lambda batch, max_len, **kw:
                         mod.init_cache(cfg, batch, max_len, **kw)),
        quantize_params=_bind(mod, "quantize_params", lambda params:
                              mod.quantize_params(params, cfg)),
        supports_padded_prefill=getattr(mod, "SUPPORTS_PADDED_PREFILL", False),
        paged_int8_kv=getattr(mod, "PAGED_INT8_KV", False),
        init_paged_cache=_bind(mod, "init_paged_cache",
                               lambda slots, layout, **kw:
                               mod.init_paged_cache(cfg, slots, layout, **kw)),
        paged_decode_step=_bind(mod, "paged_decode_step",
                                lambda params, cache, tokens, table, **kw:
                                mod.paged_decode_step(params, cache, tokens,
                                                      cfg, table, **kw)),
        paged_insert=_bind(mod, "paged_insert",
                           lambda cache, single, slot, block_ids:
                           mod.paged_insert(cache, single, slot, block_ids,
                                            cfg)),
        paged_prefill=_bind(mod, "paged_prefill",
                            lambda params, tokens, cache, slot, block_ids, **kw:
                            mod.paged_prefill(params, tokens, cfg, cache,
                                              slot, block_ids, **kw)),
        paged_verify_step=_bind(mod, "paged_verify_step",
                                lambda params, cache, tokens, table, **kw:
                                mod.paged_verify_step(params, cache, tokens,
                                                      cfg, table, **kw)),
    )


def build_by_name(name: str) -> Arch:
    from repro_torch.configs import get_config

    return build(get_config(name))
