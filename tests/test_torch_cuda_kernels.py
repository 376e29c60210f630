"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc`` (a CUDA kernel has no CPU
mode): it carries the ``cuda`` marker and skips with a reason where no card
is visible. The file imports neither JAX nor the JAX package, so it runs on
a machine that has only PyTorch::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Contracts: the int8 GEMM is bit-exact with ``int8_gemm_ref``; paged
attention is allclose with ``paged_attention_ref`` /
``paged_attention_int8_dequant_ref`` (f32 outputs: online-softmax
reordering only, 1e-4; bf16 outputs: both sides round an f32 result to
bf16, 1.6e-2 ≈ two bf16 ulps).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import quant
from repro_torch.kernels import build
from repro_torch.kernels.int8_gemm import ops as gemm_ops
from repro_torch.kernels.int8_gemm.ref import int8_gemm_ref
from repro_torch.kernels.paged_attention import ops as attn_ops
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_int8_dequant_ref, paged_attention_ref,
)

ACT_SCALES = (4.0 / 127, 4.0 / 127)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (a CUDA kernel has no CPU "
                    "mode); run on the card")
    for src, log in build.build_all().items():
        print(f"\n--- nvcc -Xptxas -v: {src}\n{log}")
    return torch.device("cuda")


def _gemm_operands(m, k, n, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                      dtype=torch.int8)
    bias = torch.randint(-20000, 20000, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    mult, shift = quant.quantize_to_fixed_point(
        torch.exp2(-8 - 6 * torch.rand(n, generator=g, device=dev)))
    return x, w, bias, mult.to(torch.int32), shift.to(torch.int32)


@pytest.mark.parametrize("activation", ["none", "relu", "gelu"])
@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (8, 4096, 256),
                                   (8, 13696, 4096), (9, 256, 96),
                                   (5, 96, 40), (3, 30, 7)])
def test_int8_gemm_bit_exact(cuda_device, activation, m, k, n):
    """glm4-9b decode shapes (M = 1 and 8 slots), a second row tile, and
    K/N not multiples of 4 (the byte-wise path)."""
    args = _gemm_operands(m, k, n, m + k + n, cuda_device)
    scales = ACT_SCALES if activation == "gelu" else None
    before = gemm_ops.KERNEL.launches
    y = gemm_ops.int8_gemm_cuda(*args, activation=activation,
                                act_scales=scales)
    torch.cuda.synchronize()
    assert gemm_ops.KERNEL.launches == before + 1
    ref = int8_gemm_ref(*args, activation=activation, act_scales=scales)
    assert torch.equal(y, ref), int((y != ref).sum())


def test_int8_gemm_wrapper_checks_inputs(cuda_device):
    x, w, bias, mult, shift = _gemm_operands(4, 64, 32, 0, cuda_device)
    with pytest.raises(ValueError, match="int32"):
        gemm_ops.int8_gemm_cuda(x, w, bias.float(), mult, shift)
    with pytest.raises(ValueError, match="contiguous"):
        gemm_ops.int8_gemm_cuda(x, w.t().contiguous().t(), bias, mult, shift)
    with pytest.raises(ValueError, match="CUDA"):
        gemm_ops.int8_gemm_cuda(x.cpu(), w, bias, mult, shift)


def _attn_case(dev, *, pool, hq=32, hkv=2, d=128, blk=16, seed=0,
               window=None, start=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    lens = [0, 1, 17, 64, 130, 255, 400, 544]
    b = len(lens)
    m = (max(lens) + 2 * blk + blk - 1) // blk
    n = b * m + 1
    int8 = pool == torch.int8
    q = torch.randn((b, hq, 1, d), generator=g, device=dev) * 2.0
    if int8:
        kp = torch.randint(-127, 128, (n, hkv, blk, d), generator=g,
                           device=dev, dtype=torch.int8)
        vp = torch.randint(-127, 128, (n, hkv, blk, d), generator=g,
                           device=dev, dtype=torch.int8)
    else:
        kp = torch.randn((n, hkv, blk, d), generator=g, device=dev).to(pool)
        vp = torch.randn((n, hkv, blk, d), generator=g, device=dev).to(pool)
    if pool == torch.bfloat16:
        q = q.bfloat16()
    perm = torch.randperm(n - 1, generator=g, device=dev)[:b * m] + 1
    table = perm.reshape(b, m).to(torch.int32)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    kw = dict(window=window, start=None)
    if start:
        st = ((torch.arange(b, device=dev) % 3) * blk).to(torch.int32)
        lens_t = torch.where(lens_t > 0, lens_t + st, 0).to(torch.int32)
        kw["start"] = st
    if int8:
        kw["k_scale"] = torch.rand(n, generator=g, device=dev) * 0.04 + 0.01
        kw["v_scale"] = torch.rand(n, generator=g, device=dev) * 0.04 + 0.01
    return (q, kp, vp, table, lens_t), kw


@pytest.mark.parametrize("pool", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("window,start", [(None, False), (100, True)],
                         ids=["full", "window-start"])
@pytest.mark.parametrize("hq,d", [(32, 128), (4, 16)], ids=["glm4", "smoke"])
def test_paged_attention_matches_plain_version(cuda_device, pool, window,
                                               start, hq, d):
    args, kw = _attn_case(cuda_device, pool=pool, hq=hq, d=d, window=window,
                          start=start)
    int8 = pool == torch.int8
    kern = attn_ops.KERNEL_INT8 if int8 else attn_ops.KERNEL
    op = attn_ops.paged_attention_int8 if int8 else attn_ops.paged_attention
    ref = paged_attention_int8_dequant_ref if int8 else paged_attention_ref
    before = kern.launches
    out = op(*args, **kw)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = ref(*args, **kw)
    tol = 1.6e-2 if out.dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    assert torch.all(out[0] == 0)  # the lens == 0 row


def test_paged_attention_int8_with_bf16_queries(cuda_device):
    """The int8 serving path: bf16 queries over int8 pools."""
    args, kw = _attn_case(cuda_device, pool=torch.int8, seed=3)
    args = (args[0].bfloat16(),) + args[1:]
    out = attn_ops.paged_attention_int8(*args, **kw)
    want = paged_attention_int8_dequant_ref(*args, **kw)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), want.float(), atol=1.6e-2,
                               rtol=1.6e-2)


def test_serving_path_on_card_agrees_with_cpu_plain_versions(cuda_device):
    """Smoke-size glm4-9b (float32), float and int8 pools: the engine on
    the card (kernels) and on the CPU (plain versions) give the same greedy
    tokens up to near-ties."""
    import dataclasses

    from repro_torch import bridge, configs
    from repro_torch.models import registry
    from repro_torch.serve import EngineConfig, LLMEngine

    for quant_on in (False, True):
        cfg = dataclasses.replace(configs.smoke_config("glm4-9b"),
                                  dtype="float32", serve_quant=quant_on)
        arch = registry.build(cfg)
        npp = bridge.numpy_params(arch.schema(), seed=0)
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, cfg.vocab, int(rng.integers(3, 40)))
                   for _ in range(6)]
        outs = []
        for device in ("cuda", "cpu"):
            eng = LLMEngine(arch, bridge.params_from_numpy(npp, device),
                            EngineConfig(slots=4, max_len=64,
                                         admit_window=2), device=device)
            hs = [eng.add_request(p, max_new_tokens=12) for p in prompts]
            eng.run_until_drained()
            outs.append([eng.request(h).output for h in hs])
        same = sum(a == b for x, y in zip(*outs) for a, b in zip(x, y))
        assert same >= 0.9 * 72, (quant_on, outs)
