"""Public op: the Mamba-2 SSD chunked scan (port of ``repro.kernels.ssd_scan.ops``).

The device decides which version runs, as for every kernel of the port: a
CPU tensor takes the plain version (``ref.ssd_scan_chunked_ref`` over the
zero-padded sequence), a CUDA tensor launches the Hopper kernel
(``csrc/ssd_scan.cu``, which replaces the TPU kernel
``repro/kernels/ssd_scan/kernel.py:ssd_scan_pallas``). There is no fallback
from one to the other.

Unlike the reference's Pallas op, both versions can return the carried
state (``return_state=True``): the serving prefill needs it, and the
reference computes it through the ``xla`` form of the same op.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import (
    pad_to_chunks, ssd_scan_chunked_ref,
)

_C = ctypes
KERNEL = build.register(build.CudaKernel(
    "ssd_scan",
    build.CudaLibrary(build.KERNELS_DIR / "ssd_scan" / "csrc" / "ssd_scan.cu"),
    "ssd_scan_launch",
    [_C.c_void_p] * 6 + [_C.c_int] * 7 + [_C.c_void_p],
    replaces="src/repro/kernels/ssd_scan/kernel.py:66 ssd_scan_pallas",
))

MAX_CHUNK = 128   # rows of a chunk the kernel stages in shared memory
MAX_STATE = 128   # state size N the kernel stages in shared memory


def _check_shapes(dta, x, b_mat, c_mat):
    if x.dim() != 4 or dta.shape != x.shape[:3]:
        raise ValueError(f"dta {tuple(dta.shape)} / x {tuple(x.shape)} must "
                         f"be [B, H, S] / [B, H, S, P]")
    bsz, h, s, _ = x.shape
    if b_mat.dim() != 4 or b_mat.shape != c_mat.shape \
            or b_mat.shape[0] != bsz or b_mat.shape[2] != s:
        raise ValueError(f"b/c {tuple(b_mat.shape)}/{tuple(c_mat.shape)} "
                         f"must be [B, G, S, N] beside x {tuple(x.shape)}")
    if h % b_mat.shape[1]:
        raise ValueError(f"heads {h} not a multiple of groups "
                         f"{b_mat.shape[1]}")
    if s == 0:
        raise ValueError("empty sequence")


def ssd_scan_cuda(dta, x, b_mat, c_mat, *, chunk: int,
                  return_state: bool = False):
    """Launch the Hopper kernel on float32 CUDA tensors; ``chunk`` ≤ 128
    and a ragged last chunk is masked in the kernel."""
    bsz, h, s, p = x.shape
    g, n = b_mat.shape[1], b_mat.shape[3]
    if not 1 <= chunk <= MAX_CHUNK or n > MAX_STATE:
        raise ValueError(f"ssd_scan kernel: chunk {chunk} (max {MAX_CHUNK}) "
                         f"or state size {n} (max {MAX_STATE}) out of range")
    build.check_cuda("dta", dta, torch.float32, (bsz, h, s))
    build.check_cuda("x", x, torch.float32)
    build.check_cuda("b_mat", b_mat, torch.float32, (bsz, g, s, n))
    build.check_cuda("c_mat", c_mat, torch.float32, (bsz, g, s, n))
    y = torch.empty_like(x)
    state = (torch.empty((bsz, h, n, p), dtype=torch.float32,
                         device=x.device) if return_state else None)
    if bsz and h and p:
        KERNEL.launch(build.ptr(dta), build.ptr(x), build.ptr(b_mat),
                      build.ptr(c_mat), build.ptr(y), build.ptr(state),
                      bsz, h, g, s, n, p, chunk, build.stream_ptr(x))
    return (y, state) if return_state else y


def ssd_scan(dta: torch.Tensor, x: torch.Tensor, b_mat: torch.Tensor,
             c_mat: torch.Tensor, *, chunk: int = 128,
             return_state: bool = False):
    """SSD chunked scan: dta [B, H, S], x [B, H, S, P] (Δ folded in),
    b_mat/c_mat [B, G, S, N] → y [B, H, S, P] in ``x``'s dtype (and the
    final state [B, H, N, P] float32 when ``return_state``).

    ``chunk = min(chunk, S)``; a ragged tail behaves as the reference's
    zero padding (Δ·A = 0, B = 0, padded outputs dropped). Inputs are
    computed in float32, as the reference casts them.
    """
    _check_shapes(dta, x, b_mat, c_mat)
    s = x.shape[2]
    chunk = min(chunk, s)
    args = [t.float() for t in (dta, x, b_mat, c_mat)]
    if x.device.type == "cpu":
        out = ssd_scan_chunked_ref(*pad_to_chunks(*args, chunk), chunk=chunk,
                                   return_state=return_state)
        y, state = out if return_state else (out, None)
        y = y[:, :, :s]
    elif x.device.type == "cuda":
        out = ssd_scan_cuda(*(t.contiguous() for t in args), chunk=chunk,
                            return_state=return_state)
        y, state = out if return_state else (out, None)
    else:
        raise ValueError(f"ssd_scan: no version for device {x.device}")
    y = y.to(x.dtype)
    return (y, state) if return_state else y
