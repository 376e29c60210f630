"""Import and device hygiene of the PyTorch port.

``repro_torch`` imports torch and numpy only — never ``jax`` and nothing of
the JAX package ``repro`` — and its entry points run on CUDA unless the
caller asks for the CPU: with no GPU and no ``device="cpu"`` they raise
instead of falling back.
"""

import pkgutil

import pytest
import torch

import repro_torch
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import registry
from repro_torch.serve import EngineConfig, LLMEngine

from subproc import run_script

torch.set_num_threads(1)


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_port_imports_neither_jax_nor_the_reference_package():
    mods = _all_modules()
    assert {"repro_torch.serve.api", "repro_torch.kernels.build",
            "repro_torch.kernels.int8_gemm.ops",
            "repro_torch.kernels.paged_attention.ops",
            "repro_torch.bridge"} <= set(mods)
    script = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('OK')\n")
    run_script(script, timeout=300)


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch = registry.build(tconfigs.smoke_config("glm4-9b"))
    npp = bridge.numpy_params(arch.schema(), seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.params_from_numpy(npp)
    params = bridge.params_from_numpy(npp, "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(arch, params, EngineConfig())
    eng = LLMEngine(arch, params, EngineConfig(), device="cpu")
    assert eng.cache["len"].device.type == "cpu"


def test_kernels_are_registered_with_their_tpu_counterparts():
    from repro_torch.kernels.build import all_kernels

    by_name = {k.name: k for k in all_kernels()}
    assert set(by_name) == {"int8_gemm", "paged_attention",
                            "paged_attention_int8"}
    for k in by_name.values():
        assert k.library.source.exists()
        assert k.replaces.startswith("src/repro/kernels/")
