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
from repro_torch.models.cache import PagedLayout
from repro_torch.models.schema import leaves
from repro_torch.serve import EngineConfig, LLMEngine

from subproc import run_script

torch.set_num_threads(1)


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_port_imports_neither_jax_nor_the_reference_package():
    mods = _all_modules()
    assert {"repro_torch.serve.api", "repro_torch.serve.spec",
            "repro_torch.serve.backends", "repro_torch.kernels.build",
            "repro_torch.kernels.int8_gemm.ops",
            "repro_torch.kernels.paged_attention.ops",
            "repro_torch.kernels.paged_attention.ref",
            "repro_torch.models.cache", "repro_torch.models.transformer",
            "repro_torch.models.ssm", "repro_torch.models.moe",
            "repro_torch.kernels.ssd_scan.ops",
            "repro_torch.kernels.ssd_scan.ref", "repro_torch.bridge",
            "repro_torch.models.griffin", "repro_torch.models.attention",
            "repro_torch.kernels.rglru.ops", "repro_torch.kernels.rglru.ref",
            "repro_torch.core.ita", "repro_torch.kernels.int_softmax.ops",
            "repro_torch.kernels.int_softmax.ref",
            "repro_torch.kernels.ita_attention.ops",
            "repro_torch.kernels.ita_attention.ref",
            "repro_torch.models.encdec", "repro_torch.serve.engine",
            } <= set(mods)
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
        LLMEngine(arch, params, EngineConfig(backend="paged"))
    eng = LLMEngine(arch, params, EngineConfig(backend="paged"),
                    device="cpu")
    assert eng.cache["len"].device.type == "cpu"


def test_kernels_are_registered_with_their_tpu_counterparts():
    from repro_torch.kernels.build import all_kernels

    by_name = {k.name: k for k in all_kernels()}
    assert set(by_name) == {"int8_gemm", "paged_attention",
                            "paged_attention_int8", "paged_attention_verify",
                            "paged_attention_verify_int8", "ssd_scan",
                            "rglru", "ita_attention", "int_softmax"}
    for k in by_name.values():
        assert k.library.source.exists()
        assert k.replaces.startswith("src/repro/kernels/")


def test_kernel_library_name_follows_its_shared_headers(tmp_path,
                                                        monkeypatch):
    """An edit to a header in ``kernels/common`` renames (so rebuilds)
    every library that could include it."""
    from repro_torch.kernels import build

    assert (build.COMMON_DIR / "int32.cuh").exists()
    monkeypatch.setattr(build, "COMMON_DIR", tmp_path)
    (tmp_path / "int32.cuh").write_text("// one\n")
    lib = build.CudaLibrary(build.KERNELS_DIR / "int_softmax" / "csrc"
                            / "int_softmax.cu")
    before = lib.lib_path
    assert lib.lib_path == before
    (tmp_path / "int32.cuh").write_text("// two\n")
    assert lib.lib_path != before


def test_arena_entry_point_raises_without_cuda_unless_cpu_is_asked(
        monkeypatch):
    """The Mamba-2 family on the arena backend: the same device rule."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch = registry.build(tconfigs.smoke_config("mamba2-2.7b"))
    params = bridge.params_from_numpy(bridge.numpy_params(arch.schema(), 0),
                                      "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(arch, params, EngineConfig(backend="arena"))
    eng = LLMEngine(arch, params, EngineConfig(backend="arena"), device="cpu")
    assert eng.cache["ssd"].device.type == "cpu"
    assert eng.cache["ssd"].dtype == torch.float32


@pytest.mark.parametrize("name,make", [
    ("mamba2-2.7b", lambda arch: arch.init_cache(2, 32)),
    ("recurrentgemma-9b", lambda arch: arch.init_cache(2, 32)),
    ("glm4-9b", lambda arch: arch.init_paged_cache(
        2, PagedLayout(block_len=8, num_blocks=5, max_len=32))),
])
def test_cache_constructors_default_to_cuda(name, make):
    """A cache built without ``device`` lies on the card; with no GPU
    visible, the constructor raises instead of allocating on the CPU."""
    arch = registry.build(tconfigs.smoke_config(name))
    if torch.cuda.is_available():
        assert all(t.device.type == "cuda" for t in leaves(make(arch)))
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(arch)
