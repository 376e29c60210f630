"""Checkpointing with atomic commit and async writes (port of
``repro.train.checkpointing``).

Layout (one directory per step), the reference's::

    <dir>/step_00000123.tmp/   → written, fsynced, then renamed to
    <dir>/step_00000123/       → the atomic commit point
        meta.json              → step, arch name
        arrays.npz             → flattened tree leaves (key = tree path)

Keys are the ``/``-joined tree paths, as the reference's
``tree_flatten_with_path`` names them: dict keys, list indices and
NamedTuple field names (``params/stacks/0/wq``, ``opt/step``,
``opt/m/embed``). A checkpoint the JAX ``Trainer`` writes restores into
the port's, and the reverse. Leaves are copied to host memory before
``save`` returns (the port updates parameters in place, so the async
writer thread must hold a snapshot); bfloat16 leaves are stored as
float32, which ``restore`` casts back to the like-tree's dtype.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device


def _children(tree):
    """(key, child) pairs of a dict, list/tuple or NamedTuple node, or None
    for a leaf."""
    if isinstance(tree, dict):
        return list(tree.items())
    if hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def flatten_with_paths(tree, prefix: str = "") -> dict:
    """{path: leaf} with the reference's ``/``-joined path keys."""
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out = {}
    for k, v in kids:
        out.update(flatten_with_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten_like(like, flat: dict, prefix: str = ""):
    kids = _children(like)
    if kids is None:
        return flat[prefix]
    built = [(k, _unflatten_like(v, flat, f"{prefix}/{k}" if prefix
                                 else str(k))) for k, v in kids]
    if isinstance(like, dict):
        return dict(built)
    if hasattr(like, "_fields"):
        return type(like)(*(v for _, v in built))
    return type(like)(v for _, v in built)


def _host_copy(x) -> np.ndarray:
    """A numpy copy of a tensor or array leaf (bfloat16 widened to f32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


def _fsync(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(ckpt_dir: str, step: int, tree, *, meta: Optional[dict] = None,
         async_write: bool = False):
    """Checkpoint ``tree`` at ``step``. Returns the commit path, or the
    writer thread when ``async_write``."""
    arrays = {k: _host_copy(v) for k, v in flatten_with_paths(tree).items()}

    def _write():
        d = Path(ckpt_dir)
        d.mkdir(parents=True, exist_ok=True)
        tmp = d / f"step_{step:08d}.tmp"
        final = d / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        np.savez(tmp / "arrays.npz", **arrays)
        (tmp / "meta.json").write_text(json.dumps({"step": step,
                                                   **(meta or {})}))
        for f in (tmp / "arrays.npz", tmp / "meta.json", tmp):
            _fsync(f)
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic commit
        _fsync(d)
        return str(final)

    if async_write:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    return _write()


def latest_step(ckpt_dir: str) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = [
        int(p.name.split("_")[1]) for p in d.iterdir()
        if p.is_dir() and p.name.startswith("step_")
        and not p.name.endswith(".tmp")
    ]
    return max(steps) if steps else None


def _torch_dtype(like) -> torch.dtype:
    if isinstance(like, torch.Tensor):
        return like.dtype
    return torch.from_numpy(np.zeros((), np.asarray(like).dtype)).dtype


def restore(ckpt_dir: str, step: int, like_tree, device: DeviceLike = None):
    """Load a checkpoint into the structure of ``like_tree`` (tensor or
    numpy leaves): every leaf's shape is checked against the like leaf's,
    and it is cast to the like leaf's dtype and placed on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    d = Path(ckpt_dir) / f"step_{step:08d}"
    loaded = {}
    with np.load(d / "arrays.npz") as data:
        for key, like in flatten_with_paths(like_tree).items():
            arr = data[key]
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(
                    f"checkpoint/model shape mismatch at {key}: "
                    f"{arr.shape} vs {tuple(like.shape)}")
            loaded[key] = torch.from_numpy(arr).to(device=dev,
                                                   dtype=_torch_dtype(like))
    return _unflatten_like(like_tree, loaded)


def meta(ckpt_dir: str, step: int) -> dict:
    return json.loads(
        (Path(ckpt_dir) / f"step_{step:08d}" / "meta.json").read_text())
