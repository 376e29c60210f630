"""The assigned input-shape cells and per-arch applicability rules.

40 cells total = 10 archs × 4 shapes. ``long_500k`` requires sub-quadratic
attention: it runs for SSM/hybrid/mostly-local archs and is SKIPPED (with
the reason recorded) for pure full-attention archs and the 448-position
whisper decoder — see DESIGN.md §6.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

# archs allowed to run long_500k (sub-quadratic / O(1)-state decode)
_LONG_OK = {"mamba2-2.7b", "recurrentgemma-9b", "gemma3-4b"}

_SKIP_REASONS = {
    "long_500k": (
        "pure full-attention arch: O(S) full KV decode at 524k context is "
        "outside the design envelope (quadratic prefill, ≤128k trained "
        "context) — skipped per assignment rules"
    ),
    "whisper_long": "enc-dec with 448-position decoder: 524k decode undefined",
    "whisper_decode32k": (
        "exercised structurally: whisper's real decoder envelope is 448 "
        "positions; the 32k cell validates sharding/compile only"
    ),
}


def cell_applicable(arch: str, shape: str) -> tuple[bool, Optional[str]]:
    """(runs?, note). Note is set for skips AND for structural-only runs."""
    if shape == "long_500k":
        if arch == "whisper-small":
            return False, _SKIP_REASONS["whisper_long"]
        if arch not in _LONG_OK:
            return False, _SKIP_REASONS["long_500k"]
        return True, None
    if arch == "whisper-small" and shape == "decode_32k":
        return True, _SKIP_REASONS["whisper_decode32k"]
    return True, None


def cells_for_arch(arch: str):
    """All (cell, note) pairs that actually run for this arch."""
    out = []
    for s, cell in SHAPES.items():
        ok, note = cell_applicable(arch, s)
        if ok:
            out.append((cell, note))
    return out
