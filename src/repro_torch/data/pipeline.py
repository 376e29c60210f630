"""Deterministic, step-indexed data pipeline (port of ``repro.data.pipeline``).

``batch_for_step(step)`` is a pure function of (seed, step): restarting
from a checkpoint at step N reproduces the exact batch stream with no
cursor state to persist. Two sources, built in numpy exactly as the
reference builds them, so a batch is bit-identical to the reference's for
every (seed, step, row):

  * the synthetic LM stream (a Zipf-like token draw from a counter hash),
  * byte-tokenized text files (``ByteCorpus``).

``device_batch`` puts the step's batch on a device as the int64 tensor the
port's ``embed`` and ``cross_entropy`` index with (the reference's
``sharded_batch`` places it on a mesh instead).
"""

from __future__ import annotations

import dataclasses
import hashlib
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    corpus_path: Optional[str] = None  # None → synthetic


class ByteCorpus:
    """Byte-level tokenizer over a text file (vocab 256 + pad)."""

    def __init__(self, path: str):
        self.data = np.frombuffer(Path(path).read_bytes(), np.uint8)

    def window(self, start: int, n: int) -> np.ndarray:
        idx = (start + np.arange(n)) % len(self.data)
        return self.data[idx].astype(np.int32)


def _synthetic_tokens(cfg: DataConfig, step: int, row: int) -> np.ndarray:
    """Deterministic pseudo-text: Zipf-ish tokens from a counter hash."""
    seed_bytes = f"{cfg.seed}:{step}:{row}".encode()
    h = int.from_bytes(hashlib.sha256(seed_bytes).digest()[:8], "little")
    rng = np.random.default_rng(h)
    # Zipf-like marginal (bounded)
    z = rng.zipf(1.3, size=cfg.seq_len).astype(np.int64)
    return np.asarray((z - 1) % cfg.vocab, np.int32)


def batch_for_step(cfg: DataConfig, step: int,
                   corpus: Optional[ByteCorpus] = None) -> np.ndarray:
    """[global_batch, seq_len] int32 tokens for this step (pure function)."""
    rows = []
    for r in range(cfg.global_batch):
        if corpus is not None:
            stride = cfg.seq_len * cfg.global_batch
            rows.append(corpus.window(step * stride + r * cfg.seq_len,
                                      cfg.seq_len))
        else:
            rows.append(_synthetic_tokens(cfg, step, r))
    return np.stack(rows)


def device_batch(cfg: DataConfig, step: int, device: DeviceLike = None,
                 corpus: Optional[ByteCorpus] = None) -> torch.Tensor:
    """The step's batch as an int64 tensor on ``device`` (default
    ``cuda``)."""
    dev = resolve_device(device)
    return torch.from_numpy(batch_for_step(cfg, step, corpus)).to(
        device=dev, dtype=torch.int64)
