"""Where a B3 launch spends its time, block by block (card only).

Builds a copy of ``csrc/int8_gemm.cu`` with ``%globaltimer`` stamps at the
phase boundaries of each block (start, first W box landed, last unit
computed, the shared tile's adds and fence, the ticket, the last block's
reads of the sums, the epilogue, the end), runs glm4-9b's projections at
M = 8 and 40 with L2 flushed by a read before each call, and prints one
JSON line per (projection, M) with the 0/50/90/100th percentiles over the
blocks, in ns. The stamps are spliced into the source text; a kernel edit
that moves a splice point fails loudly here. Run on the card::

    PYTHONPATH=src python -m repro_torch.kernels.int8_gemm.phases
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.kernels import build
from repro_torch.kernels.int8_gemm import ops

SHAPES = {"wq": (4096, 4096), "wk": (4096, 256), "wg": (4096, 13696),
          "wd": (13696, 4096)}
STAMPS = 9   # per block: phases 0..7, then the tiles it ended
# (anchor in int8_gemm.cu, text before it, text after it); each anchor
# must occur once
SPLICES = [
    ("namespace {\n", "",
     "__device__ unsigned long long phase_t[8192][9];\n"
     "__device__ __forceinline__ unsigned long long now() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"),
    ("  const int nu = (int)(first_unit(b + 1, p.units, G) - u0);\n", "",
     "  unsigned long long T[9] = {now(), 0, 0, 0, 0, 0, 0, 0, 0};\n"),
    ("    if (VEC) bar_wait(&full[i % STAGES], (i / STAGES) & 1);\n", "",
     "    if (i == 0) T[1] = now();\n"),
    ("    if (kt != p.k_tiles - 1 && i != nu - 1) continue;\n",
     "    if (i == nu - 1) T[2] = now();\n", "    ++T[8];\n"),
    ("      __threadfence();\n      __syncthreads();\n", "",
     "      if (i == nu - 1) T[3] = now();\n"),
    ("      if (last_s) {\n", "      if (i == nu - 1) T[4] = now();\n", ""),
    ("            if (j < t.jt) __stcg(sums + (j * 4 + e) * 32, 0);\n", "",
     "        if (i == nu - 1) T[5] = now();\n"),
    ("        epilogue(p, t, acc, sacc, warp, g, q, tid);\n", "",
     "        if (i == nu - 1) T[6] = now();\n"),
    ("  cp_async_wait<0>();\n", "",
     "  T[7] = now();\n"
     "  if (tid == 0) for (int e = 0; e < 9; ++e) phase_t[b][e] = T[e];\n"),
]


def instrumented_source() -> str:
    src = (build.KERNELS_DIR / "int8_gemm" / "csrc" / "int8_gemm.cu").read_text()
    src = src.replace('#include "../../common/int32.cuh"',
                      f'#include "{build.COMMON_DIR / "int32.cuh"}"')
    for anchor, before, after in SPLICES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"splice point moved: {anchor!r}")
        src = src.replace(anchor, before + anchor + after)
    return src + ('\nextern "C" int phases_read(void* dst) {\n'
                  "  return (int)cudaMemcpyFromSymbol(dst, phase_t, "
                  "sizeof(phase_t));\n}\n")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("phases: needs an NVIDIA GPU")
    out_dir = build.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "int8_gemm.cu"
    src.write_text(instrumented_source())
    lib = build.CudaLibrary(src)
    lib.load()
    ops.KERNEL = build.CudaKernel("int8_gemm", lib, "int8_gemm_launch",
                                  ops.KERNEL.argtypes, "instrumented copy")
    read = lib.load().phases_read
    read.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    scratch = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    pct = (0, 50, 90, 100)
    for name, (k, n) in SHAPES.items():
        w = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                          dtype=torch.int8).mT
        mult, shift = quant.quantize_to_fixed_point(
            torch.exp2(-8 - 6 * torch.rand(n, generator=g, device=dev)))
        bias = torch.zeros(n, dtype=torch.int32, device=dev)
        for m in (8, 40):
            x = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                              dtype=torch.int8)
            args = (x, w, bias, mult.to(torch.int32), shift.to(torch.int32))
            for _ in range(3):
                scratch.sum()
                torch.cuda.synchronize()
                ops.int8_gemm_cuda(*args)
                torch.cuda.synchronize()
            blocks = ops.grid(m, k, n)
            buf = np.zeros((8192, STAMPS), dtype=np.uint64)
            if read(buf.ctypes.data) != 0:
                raise RuntimeError("phases: reading the stamps failed")
            t = buf[:blocks].astype(np.int64)

            def q(a):
                return [int(np.percentile(a, p)) for p in pct] if a.size else None

            shared = t[:, 3] > 0
            last = t[:, 5] > 0
            print(json.dumps({
                "proj": name, "M": m, "blocks": blocks,
                "first_box_ns": q(t[:, 1] - t[:, 0]),
                "stream_ns": q(t[:, 2] - t[:, 1]),
                "tail_ns": q(t[:, 7] - t[:, 2]),
                "end_ns": q(t[:, 7] - t[:, 0].min()),
                "adds_fence_ns": q((t[:, 3] - t[:, 2])[shared]),
                "ticket_ns": q((t[:, 4] - t[:, 3])[shared]),
                "last_reads_ns": q((t[:, 5] - t[:, 4])[last]),
                "epilogue_ns": q((t[:, 6] - t[:, 5])[last]),
                "tiles_per_block": q(t[:, 8])}), flush=True)


if __name__ == "__main__":
    main()
