"""Public op: quantized linear layer (port of ``repro.kernels.int8_gemm.ops``).

The device decides which version runs: a CPU tensor takes the plain
version (``ref.int8_gemm_ref``), a CUDA tensor launches the Hopper kernel
(``csrc/int8_gemm.cu``, which replaces the TPU kernel
``repro/kernels/int8_gemm/kernel.py:int8_gemm_pallas``). The two agree bit
for bit; there is no fallback from one to the other.

Weights are K-major: ``w_q`` keeps its logical ``[K, N]`` shape but is the
transposed view of a contiguous ``[N, K]`` tensor (``stride == (1, K)``;
a stacked tree's ``[L, K, N]`` is the view of ``[L, N, K]``), which the
kernel's s8 tensor-core products read as they are. ``from_float`` and
``models.transformer.quantize_params`` lay them out so; the kernel refuses
any other layout and nothing on the call path copies the weights.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from repro_torch.core import ita, quant
from repro_torch.kernels import build
from repro_torch.kernels.int8_gemm.ref import int8_gemm_ref

_C = ctypes
KERNEL = build.register(build.CudaKernel(
    "int8_gemm",
    build.CudaLibrary(build.KERNELS_DIR / "int8_gemm" / "csrc" / "int8_gemm.cu"),
    "int8_gemm_launch",
    [_C.c_void_p] * 7 + [_C.c_int] * 9 + [_C.c_longlong, _C.c_void_p],
    replaces="src/repro/kernels/int8_gemm/kernel.py:72 int8_gemm_pallas",
))

ACTIVATIONS = {"none": 0, "relu": 1, "gelu": 2}
# (device index, stream) → the split-K workspace (tickets and shared tiles'
# sums, int32): every launch leaves it 0, so it is allocated once and never
# cleared per call
_WORKSPACE: dict = {}
_WORKSPACE_INTS: dict = {}     # (M, N) → int32 words a launch needs


@dataclasses.dataclass(frozen=True)
class QuantizedLinearParams:
    """Static-quantized weights + requant constants for one linear layer.

    Fields may carry a leading stack axis (one entry per layer), like the
    reference's vmapped tree.
    """

    w_q: torch.Tensor      # [K, N] int8, K-major (stride (1, K))
    bias: torch.Tensor     # [N] int32 (bias folded to accumulator scale)
    mult: torch.Tensor     # [N] int32
    shift: torch.Tensor    # [N] int32

    @classmethod
    def from_float(cls, w, bias_f, in_scale: float, out_scale: float):
        w_q, w_scale = quant.quantize_weights(w)          # per-out-channel
        w_q = k_major(w_q)
        acc_scale = w_scale * in_scale                    # int32 acc scale
        bias_q = torch.round(bias_f / acc_scale).to(torch.int32)
        mult, shift = quant.quantize_to_fixed_point(acc_scale / out_scale)
        return cls(w_q=w_q, bias=bias_q, mult=mult, shift=shift)

    def __getitem__(self, i) -> "QuantizedLinearParams":
        """One stack entry (layer ``i``) of a stacked tree."""
        return QuantizedLinearParams(self.w_q[i], self.bias[i], self.mult[i],
                                     self.shift[i])


def k_major(w: torch.Tensor) -> torch.Tensor:
    """``w`` ([..., K, N]) as the transposed view of a contiguous
    [..., N, K] tensor: the layout the kernel takes."""
    return w.mT.contiguous().mT


def _library_fn(name: str, argtypes, restype):
    fn = getattr(KERNEL.library.load(), name)
    fn.argtypes, fn.restype = argtypes, restype
    return fn


def grid(m: int, k: int, n: int) -> int:
    """Blocks the kernel launches for an [m, k] × [k, n] product."""
    return _library_fn("int8_gemm_grid", [_C.c_int] * 3, _C.c_int)(m, k, n)


def _workspace(device: torch.device, stream, m: int, n: int) -> torch.Tensor:
    """The split-K workspace of (device, stream), grown to what an [m, ·]
    × [·, n] launch needs. One stream runs its launches one after another,
    so they share it without clearing it: each launch leaves it all 0."""
    need = _WORKSPACE_INTS.get((m, n))
    if need is None:
        need = _WORKSPACE_INTS[(m, n)] = _library_fn(
            "int8_gemm_workspace_ints", [_C.c_int] * 3, _C.c_longlong)(m, 0, n)
    key = (device.index, stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws.numel() < need:
        ws = _WORKSPACE[key] = torch.zeros(max(need, 1 << 20),
                                           dtype=torch.int32, device=device)
    return ws


def _check_args(x_q, w_q, bias, mult, shift, k, n) -> None:
    """Raise on what the kernel does not take (each case by name)."""
    build.check_cuda("x_q", x_q, torch.int8)
    if w_q.device.type != "cuda" or w_q.dtype != torch.int8:
        raise ValueError(f"w_q: expected a CUDA int8 tensor, got {w_q.dtype} "
                         f"on {w_q.device}")
    if not w_q.mT.is_contiguous():
        raise ValueError(
            f"w_q: expected the K-major layout (the transposed view of a "
            f"contiguous [N, K] tensor, stride (1, {k})), got stride "
            f"{tuple(w_q.stride())}; lay the weights out with k_major once")
    for name, t in (("bias", bias), ("mult", mult), ("shift", shift)):
        build.check_cuda(name, t, torch.int32, (n,))


def int8_gemm_cuda(x_q, w_q, bias, mult, shift, *, activation="none",
                   act_scales=None) -> torch.Tensor:
    """Launch the Hopper kernel: [M, K] int8 × [K, N] int8 (K-major) →
    [M, N] int8."""
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"shapes {tuple(x_q.shape)} × {tuple(w_q.shape)} "
                         f"do not chain")
    m, k = x_q.shape
    n = w_q.shape[1]
    # the call path runs this 280 times a step: one expression for the
    # common case, the named checks only when it fails
    i8, i32, vec = torch.int8, torch.int32, (n,)
    if not (x_q.is_cuda and w_q.is_cuda and bias.is_cuda and mult.is_cuda
            and shift.is_cuda and x_q.dtype == i8 and w_q.dtype == i8
            and bias.dtype == i32 and mult.dtype == i32 and shift.dtype == i32
            and bias.shape == vec and mult.shape == vec and shift.shape == vec
            and x_q.is_contiguous() and w_q.mT.is_contiguous()
            and bias.is_contiguous() and mult.is_contiguous()
            and shift.is_contiguous()):
        _check_args(x_q, w_q, bias, mult, shift, k, n)
    act = ACTIVATIONS.get(activation)
    if act is None:
        raise ValueError(f"unknown activation {activation!r}")
    gelu = ita.gelu_constants(*act_scales) if act == 2 else (0, 0, 0, 0, 0)
    out = x_q.new_empty((m, n))
    if m == 0 or n == 0:
        return out
    stream = build.stream_ptr(x_q)
    ws = _workspace(x_q.device, stream, m, n)
    KERNEL.launch(x_q.data_ptr(), w_q.data_ptr(), bias.data_ptr(),
                  mult.data_ptr(), shift.data_ptr(), out.data_ptr(),
                  ws.data_ptr(), m, k, n, act, *gelu, ws.numel(), stream)
    return out


def int8_gemm(
    x_q: torch.Tensor,
    params: QuantizedLinearParams,
    *,
    activation: str = "none",
    act_scales: Optional[tuple] = None,
) -> torch.Tensor:
    """[..., K] int8 → [..., N] int8 quantized linear."""
    lead = x_q.shape[:-1]
    x2 = x_q.reshape(-1, x_q.shape[-1])
    if x2.device.type == "cpu":
        y = int8_gemm_ref(x2, params.w_q, params.bias, params.mult,
                          params.shift, activation=activation,
                          act_scales=act_scales)
    elif x2.device.type == "cuda":
        # w_q goes as it is: the kernel reads the K-major view in place
        y = int8_gemm_cuda(x2.contiguous(), params.w_q,
                           params.bias.contiguous(), params.mult.contiguous(),
                           params.shift.contiguous(), activation=activation,
                           act_scales=act_scales)
    else:
        raise ValueError(f"int8_gemm: no version for device {x2.device}")
    return y.reshape(*lead, -1)
