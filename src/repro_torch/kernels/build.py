"""Build-at-first-use and ctypes binding for the hand-written CUDA kernels.

Each kernel source (``kernels/<name>/csrc/*.cu``) exports a plain C launch
function that takes device pointers, sizes and a ``cudaStream_t`` and
returns ``cudaGetLastError()``. ``CudaLibrary`` compiles one source with
``nvcc`` for ``sm_90a`` into a shared library under ``kernels/_build/``
(keyed by the hash of the source and of the shared headers in
``kernels/common/``, so an edited source or header rebuilds) and loads it
with ``ctypes``. ``CudaKernel`` is one launch function of a library plus
its launch count — the number that shows a run went through the kernel.

Nothing here runs at import: the CPU tests import every module, and a
machine without ``nvcc`` only fails when a kernel is actually launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "_build"
COMMON_DIR = KERNELS_DIR / "common"     # headers the sources include
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


class CudaLibrary:
    """One ``.cu`` source compiled into a ctypes-loaded shared library."""

    def __init__(self, source: Path):
        self.source = Path(source)
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.build_log = ""

    @property
    def lib_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(COMMON_DIR.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        digest = h.hexdigest()
        return BUILD_DIR / f"{self.source.stem}-{digest[:16]}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` in the background (None if already built)."""
        out = self.lib_path
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        self.build_log, _ = proc.communicate()
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {self.source} (exit {proc.returncode}):\n"
                f"{self.build_log}")
        os.replace(tmp, self.lib_path)  # atomic: concurrent builds agree

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self.finish_build(self.start_build())
                self._lib = ctypes.CDLL(str(self.lib_path))
            return self._lib


class CudaKernel:
    """A C launch function of a ``CudaLibrary`` and its launch count.

    ``launches`` counts successful launches from the wrapper: it is the
    only place a kernel is launched, so a zero count after a run proves the
    run never reached the kernel.
    """

    def __init__(self, name: str, library: CudaLibrary, symbol: str,
                 argtypes: Sequence, replaces: str):
        self.name = name
        self.library = library
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    def _resolve(self):
        if self._fn is None:
            lib = self.library.load()
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, "repro_cuda_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._err = err
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        code = self._resolve()(*args)
        if code != 0:
            raise RuntimeError(
                f"{self.name}: CUDA launch failed ({code}): "
                f"{self._err(code).decode()}")
        self.launches += 1


_REGISTRY: Dict[str, CudaKernel] = {}


def register(kernel: CudaKernel) -> CudaKernel:
    _REGISTRY[kernel.name] = kernel
    return kernel


def all_kernels() -> List[CudaKernel]:
    """Every kernel of the port (importing the ops modules registers them)."""
    from repro_torch.kernels.int8_gemm import ops as _gemm  # noqa: F401
    from repro_torch.kernels.int_softmax import ops as _smax  # noqa: F401
    from repro_torch.kernels.ita_attention import ops as _ita  # noqa: F401
    from repro_torch.kernels.paged_attention import ops as _attn  # noqa: F401
    from repro_torch.kernels.rglru import ops as _rglru  # noqa: F401
    from repro_torch.kernels.ssd_scan import ops as _ssd  # noqa: F401

    return list(_REGISTRY.values())


def start_builds() -> Dict[Path, tuple]:
    """Start one ``nvcc`` per kernel source, all at once (nothing for a
    library already built); returns {source: (library, process or None)}
    for ``finish_builds``."""
    libs = {k.library.source: k.library for k in all_kernels()}
    return {src: (lib, lib.start_build()) for src, lib in libs.items()}


def finish_builds(pending: Dict[Path, tuple],
                  kernels: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Wait for the builds of the libraries that ``kernels`` (names; all
    when None) live in, load them and resolve those kernels; the finished
    builds leave ``pending``. Returns each finished source's ``-Xptxas -v``
    log."""
    logs = {}
    for k in all_kernels():
        if kernels is not None and k.name not in kernels:
            continue
        entry = pending.pop(k.library.source, None)
        if entry is not None:
            lib, proc = entry
            lib.finish_build(proc)
            logs[str(lib.source)] = lib.build_log
        k._resolve()
    return logs


def build_all() -> Dict[str, str]:
    """Compile every library at once (one ``nvcc`` per source, in
    parallel) and load it; returns each source's ``-Xptxas -v`` log."""
    return finish_builds(start_builds())


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device (a ``cudaStream_t``; the
    launch functions take it as ``c_void_p``)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def ptr(t: Optional[torch.Tensor]) -> int:
    """A tensor's device address for a ``c_void_p`` argument (0: none)."""
    return 0 if t is None else t.data_ptr()


def check_cuda(name: str, t: torch.Tensor, dtype, shape=None) -> None:
    """Wrapper-side argument checks before a pointer crosses into C."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
