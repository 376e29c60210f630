"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc`` (a CUDA kernel has no CPU
mode): it carries the ``cuda`` marker and skips with a reason where no card
is visible. The file imports neither JAX nor the JAX package, so it runs on
a machine that has only PyTorch::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Contracts: the int8 GEMM is bit-exact with ``int8_gemm_ref`` on K-major
weights (``w_q`` the transposed view of a contiguous [N, K]); paged
attention (decode and verify) is allclose with ``paged_attention_ref`` /
``paged_attention_int8_dequant_ref`` and their verify versions (f32
outputs: online-softmax reordering only, 1e-4; bf16 outputs: both sides
round an f32 result to bf16, 1.6e-2 ≈ two bf16 ulps). The verify kernels
at ``Q = 1``, and row 0 of any ``Q``, are bit-equal to the decode kernels
at the same lengths, also with lens on and beside the kernels' split
boundaries, a window starting inside a split and a 4096-key row. The SSD
chunked scan is allclose with ``ssd_scan_chunked_ref`` over the
zero-padded sequence (float32; only the
order of additions differs: ``rtol = 1e-4``, ``atol = 1e-4 · max|y|``), its
final state likewise. The RG-LRU scan is allclose with ``rglru_ref``
(float32 output: ``rtol = 1e-5``, ``atol = 1e-5 · max|h|``; bf16 output: at
most one bf16 ulp apart). The ITA fused int8 attention is bit-exact with
``ita_attention_ref`` (over kv heads repeated to the query heads) and the
ITA integer softmax with ``int_softmax_ref``; ``int8_attention`` on the card
equals it on the CPU bit for bit. Paged decode attention is also held at
gemma3-4b's geometry on ring tables (``start`` in the thousands, window
1024) and its full-history rows, and the ring-pool engine on
``gemma3-4b-smoke`` agrees with the CPU's. Paged decode and verify
attention are held at qwen3-moe-30b-a3b's geometry (a GQA group of 8, rows
up to 4096 keys) and at whisper-small's (a GQA group of 1, head_dim 64,
rows up to 448 keys), and the moe and encdec families' paged steps and
engines on ``qwen3-moe-30b-a3b-smoke`` / ``whisper-small-smoke`` agree
with the CPU's. The dense and moe
families' float arena and slot backends (plain PyTorch, no kernel) on the
card agree with the CPU's arena. The int8 arena step: the GEMM bit-exact at
M = 1 on glm4-9b's projection shapes (the slot backend's batch-1 decode),
``decode_attention_int8`` on the card equal to it on the CPU bit for bit
(its products run in float64 on both), and the int8 arena and slot engines
on the card agreeing with the CPU's arena, launching the GEMM seven times a
layer and step (dense) or no kernel (moe).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import bridge, configs
from repro_torch.core import quant
from repro_torch.kernels import build
from repro_torch.kernels.int8_gemm import ops as gemm_ops
from repro_torch.kernels.int8_gemm.ref import int8_gemm_ref
from repro_torch.kernels.int_softmax import ops as smax_ops
from repro_torch.kernels.int_softmax.ref import int_softmax_ref
from repro_torch.kernels.ita_attention import ops as ita_ops
from repro_torch.kernels.ita_attention.ref import (
    ita_attention_gqa_ref as ita_plain,
)
from repro_torch.kernels.paged_attention import ops as attn_ops
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_int8_dequant_ref, paged_attention_ref,
    paged_attention_verify_int8_dequant_ref, paged_attention_verify_ref,
)
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.kernels.rglru.ref import rglru_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import (
    pad_to_chunks, ssd_scan_chunked_ref,
)
from repro_torch.models import transformer

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


def _gemm_operands(m, k, n, seed, dev, bias_range=20000):
    """int8 operands with the weights K-major, as the kernel takes them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                      dtype=torch.int8).mT
    bias = torch.randint(-bias_range, bias_range, (n,), generator=g,
                         device=dev, dtype=torch.int32)
    mult, shift = quant.quantize_to_fixed_point(
        torch.exp2(-8 - 6 * torch.rand(n, generator=g, device=dev)))
    return x, w, bias, mult.to(torch.int32), shift.to(torch.int32)


def _gemm_case(args, activation):
    scales = ACT_SCALES if activation == "gelu" else None
    before = gemm_ops.KERNEL.launches
    y = gemm_ops.int8_gemm_cuda(*args, activation=activation,
                                act_scales=scales)
    torch.cuda.synchronize()
    assert gemm_ops.KERNEL.launches == before + 1
    ref = int8_gemm_ref(*args, activation=activation, act_scales=scales)
    assert torch.equal(y, ref), int((y != ref).sum())


@pytest.mark.parametrize("activation", ["none", "relu", "gelu"])
@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (8, 4096, 256),
                                   (8, 13696, 4096), (40, 4096, 4096),
                                   (40, 4096, 256), (40, 13696, 4096),
                                   (64, 4096, 256), (65, 4096, 256),
                                   (65, 640, 200), (9, 256, 96),
                                   (5, 96, 40), (3, 30, 7)])
def test_int8_gemm_bit_exact(cuda_device, activation, m, k, n):
    """glm4-9b decode and verify shapes (M = 1, 8 slots, 40 verify rows;
    wk/wv's N = 256 is the largest split, wd's K = 13696 the k-tile tail),
    the 64-row tile edge (M = 64, 65: a second row tile in the same
    launch), ragged N and K, and K/N not multiples of 16 (the byte-wise
    loads)."""
    _gemm_case(_gemm_operands(m, k, n, m + k + n, cuda_device), activation)


@pytest.mark.parametrize("activation", ["none", "relu", "gelu"])
@pytest.mark.parametrize("m,k,n", [(8, 96, 40), (40, 4096, 256),
                                   (3, 30, 7)])
def test_int8_gemm_large_bias_bit_exact(cuda_device, activation, m, k, n):
    """Biases over the whole int32 range: every accumulator takes
    requantize's large-accumulator branch, and acc + bias wraps."""
    args = _gemm_operands(m, k, n, 7 * m + n, cuda_device,
                          bias_range=2 ** 31 - 1)
    _gemm_case(args, activation)


def test_int8_gemm_wrapper_checks_inputs(cuda_device):
    x, w, bias, mult, shift = _gemm_operands(4, 64, 32, 0, cuda_device)
    with pytest.raises(ValueError, match="int32"):
        gemm_ops.int8_gemm_cuda(x, w, bias.float(), mult, shift)
    with pytest.raises(ValueError, match="K-major"):
        gemm_ops.int8_gemm_cuda(x, w.contiguous(), bias, mult, shift)
    with pytest.raises(ValueError, match="CUDA"):
        gemm_ops.int8_gemm_cuda(x.cpu(), w, bias, mult, shift)
    # the K-major view is taken as it is
    y = gemm_ops.int8_gemm_cuda(x, w, bias, mult, shift)
    assert torch.equal(y, int8_gemm_ref(x, w, bias, mult, shift))


def test_quantize_params_on_card_k_major_and_never_copied(cuda_device,
                                                         monkeypatch):
    """``quantize_params`` on the card yields K-major stacks, and
    ``int8_gemm`` on a stack entry launches B3 once with the weights'
    own pointer: nothing copies ``w_q`` on the call path."""
    cfg = dataclasses.replace(configs.smoke_config("glm4-9b"),
                              dtype="float32")
    npp = bridge.numpy_params(transformer.schema(cfg), seed=5)
    tq = bridge.qparams_from_numpy(npp, cfg, device="cuda")
    seen = []
    launch = gemm_ops.KERNEL.launch

    def spy(*args):
        seen.append(args[1])
        launch(*args)

    monkeypatch.setattr(gemm_ops.KERNEL, "launch", spy)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    for name in transformer.LINEARS:
        stack = tq["stacks"][0][name]
        n_layers, k, n = stack.w_q.shape
        assert stack.w_q.stride() == (n * k, 1, k), name
        p = stack[n_layers - 1]
        x = torch.randint(-127, 128, (2, 3, k), generator=g,
                          device=cuda_device, dtype=torch.int8)
        before = gemm_ops.KERNEL.launches
        y = gemm_ops.int8_gemm(x, p)
        torch.cuda.synchronize()
        assert gemm_ops.KERNEL.launches == before + 1, name
        assert seen[-1] == p.w_q.data_ptr(), name
        ref = int8_gemm_ref(x.reshape(6, k), p.w_q, p.bias, p.mult, p.shift)
        assert torch.equal(y.reshape(6, n), ref), name


LENS = [0, 1, 17, 64, 130, 255, 400, 544]


def _attn_case(dev, *, pool, hq=32, hkv=2, d=128, blk=16, seed=0,
               window=None, start=False, qlen=1, lens=LENS, width=None,
               firsts=None):
    """A table sized for the longest row plus two blocks (or ``width``
    entries); ``start`` puts row i's entry 0 at (i % 3)·blk, ``firsts``
    (cycled over the rows) at first·blk, with lens measured from there."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b = len(lens)
    m = width or (max(lens) + 2 * blk + blk - 1) // blk
    n = b * m + 1
    int8 = pool == torch.int8
    q = torch.randn((b, hq, qlen, d), generator=g, device=dev) * 2.0
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
    if firsts is not None:
        kw["start"] = torch.tensor([firsts[i % len(firsts)] * blk
                                    for i in range(b)], dtype=torch.int32,
                                   device=dev)
        lens_t = lens_t + kw["start"]
    if int8:
        kw["k_scale"] = torch.rand(n, generator=g, device=dev) * 0.04 + 0.01
        kw["v_scale"] = torch.rand(n, generator=g, device=dev) * 0.04 + 0.01
    return (q, kp, vp, table, lens_t), kw


@pytest.mark.parametrize("pool", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("window,start", [(None, False), (100, True)],
                         ids=["full", "window-start"])
@pytest.mark.parametrize("hq,d", [(32, 128), (4, 16), (8, 256)],
                         ids=["glm4", "smoke", "d256"])
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


def test_paged_attention_wrapper_checks_inputs(cuda_device):
    """The kernel copies 16 bytes at a time and takes head_dim in
    multiples of 16 up to 256: the wrapper refuses the rest."""
    args, kw = _attn_case(cuda_device, pool=torch.bfloat16)
    q = args[0]
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype,
                          device=q.device)[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte"):
        attn_ops.paged_attention(shifted, *args[1:], **kw)
    args, kw = _attn_case(cuda_device, pool=torch.bfloat16, d=8)
    with pytest.raises(ValueError, match="head_dim 8"):
        attn_ops.paged_attention(*args, **kw)


VERIFY_LENS = [max(x, 1) for x in LENS]   # verify rows attend lens ≥ 1


@pytest.mark.parametrize("pool", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("window,start", [(None, False), (100, True)],
                         ids=["full", "window-start"])
@pytest.mark.parametrize("hq,d,qlen", [(32, 128, 5), (4, 16, 3), (8, 256, 5)],
                         ids=["glm4-k4", "smoke-k2", "d256-k4"])
def test_paged_attention_verify_matches_plain_version(cuda_device, pool,
                                                      window, start, hq, d,
                                                      qlen):
    args, kw = _attn_case(cuda_device, pool=pool, hq=hq, d=d, window=window,
                          start=start, qlen=qlen, lens=VERIFY_LENS)
    int8 = pool == torch.int8
    kern = attn_ops.KERNEL_VERIFY_INT8 if int8 else attn_ops.KERNEL_VERIFY
    op = (attn_ops.paged_attention_verify_int8 if int8
          else attn_ops.paged_attention_verify)
    ref = (paged_attention_verify_int8_dequant_ref if int8
           else paged_attention_verify_ref)
    before = kern.launches
    out = op(*args, **kw)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = ref(*args, **kw)
    tol = 1.6e-2 if out.dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("pool", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["f32", "bf16", "int8"])
def test_verify_kernels_reduce_to_decode_bit_for_bit(cuda_device, pool):
    """B4/B5 at Q = 1 equal B1/B2 exactly, and row 0 of a Q = 5 verify
    equals the decode at the same lens exactly."""
    int8 = pool == torch.int8
    dec = attn_ops.paged_attention_int8 if int8 else attn_ops.paged_attention
    ver = (attn_ops.paged_attention_verify_int8 if int8
           else attn_ops.paged_attention_verify)
    for var in (dict(), dict(window=100, start=True)):
        args, kw = _attn_case(cuda_device, pool=pool, qlen=5,
                              lens=VERIFY_LENS, **var)
        q = args[0]
        if int8:
            q = q.bfloat16()
        q1 = q[:, :, :1].contiguous()
        rest = args[1:]
        assert torch.equal(ver(q1, *rest, **kw), dec(q1, *rest, **kw))
        out5 = ver(q.contiguous(), *rest, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out5[:, :, :1], dec(q1, *rest, **kw))


def split_lens(pool, long):
    """Lens on, one below and one past the kernel's split boundaries at
    glm4-9b's widths (block_len 16): phase 2's table (up to 544 keys), or
    one with a 4096-key row (M = 258 entries), where a split is longer."""
    top = 4096 if long else 544
    m = (top + 2 * 16 + 15) // 16                      # as _attn_case sizes it
    esz = torch.empty((), dtype=pool).element_size()
    w = attn_ops.split_plan(m, 16, 128, esz)[1] * 16   # keys per split
    if long:
        return [0, 1, w - 1, w, w + 1, 1000, 2047, top]
    return [0, w - 1, w, w + 1, 2 * w - 1, 2 * w, 2 * w + 1, top]


@pytest.mark.parametrize("pool", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("window,start", [(None, False), (100, True)],
                         ids=["full", "window-start"])
@pytest.mark.parametrize("long", [False, True], ids=["544", "4096"])
def test_paged_attention_split_boundaries_match_plain_version(
        cuda_device, pool, window, start, long):
    """B1/B2 with lens on, below and past split boundaries, a window that
    starts inside a split (100 keys before 544; 1000 before 4096), and a
    4096-key row; the lens == 0 row is zero."""
    window = window and (1000 if long else 100)
    lens = split_lens(pool, long)
    args, kw = _attn_case(cuda_device, pool=pool, window=window, start=start,
                          lens=lens, seed=5)
    int8 = pool == torch.int8
    if int8:
        args = (args[0].bfloat16(),) + args[1:]
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
    assert torch.all(out[0] == 0)


@pytest.mark.parametrize("pool", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("long", [False, True], ids=["544", "4096"])
def test_verify_kernels_on_split_boundaries(cuda_device, pool, long):
    """B4/B5 at Q = 5 on the split-boundary lens: allclose with the plain
    version, and at Q = 1 and in row 0 bit-equal to B1/B2 (the verify walk
    reaches one entry, and maybe one split, past the decode's)."""
    int8 = pool == torch.int8
    dec = attn_ops.paged_attention_int8 if int8 else attn_ops.paged_attention
    ver = (attn_ops.paged_attention_verify_int8 if int8
           else attn_ops.paged_attention_verify)
    ref = (paged_attention_verify_int8_dequant_ref if int8
           else paged_attention_verify_ref)
    lens = [max(x, 1) for x in split_lens(pool, long)]
    for var in (dict(), dict(window=1000 if long else 100, start=True)):
        args, kw = _attn_case(cuda_device, pool=pool, qlen=5, lens=lens,
                              seed=6, **var)
        q = args[0].bfloat16() if int8 else args[0]
        rest = args[1:]
        out5 = ver(q, *rest, **kw)
        torch.cuda.synchronize()
        want = ref(q, *rest, **kw)
        tol = 1.6e-2 if out5.dtype == torch.bfloat16 else 1e-4
        torch.testing.assert_close(out5.float(), want.float(), atol=tol,
                                   rtol=tol)
        q1 = q[:, :, :1].contiguous()
        d1 = dec(q1, *rest, **kw)
        assert torch.equal(ver(q1, *rest, **kw), d1)
        assert torch.equal(out5[:, :, :1], d1)


@pytest.mark.parametrize("pool", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("rows", ["ring", "full"])
def test_paged_attention_gemma3_ring_and_full_rows(cuda_device, pool, rows):
    """B1/B2 at gemma3-4b's geometry, as the ring path gives them: ring
    tables 65 entries wide with start = first·16 (first 0, 1, 62, 185) and
    lens − start from 1 to 1040 at window 1024; and a G layer's
    full-history table (max_len 4128: 258 entries) with rows up to 4096
    keys, whose first splits lie wholly below the window. Allclose with
    the plain version, finite."""
    gemma = dict(pool=pool, hq=8, hkv=4, d=256, window=1024, seed=7)
    if rows == "ring":
        args, kw = _attn_case(
            cuda_device, width=65, firsts=(0, 1, 62, 185),
            lens=[1, 15, 16, 17, 500, 1008, 1023, 1024, 1025, 1039, 1040],
            **gemma)
    else:
        args, kw = _attn_case(
            cuda_device, width=258,
            lens=[1, 1000, 1024, 1025, 2047, 3000, 4095, 4096], **gemma)
    int8 = pool == torch.int8
    if int8:   # the serving path's bf16 queries
        args = (args[0].bfloat16(),) + args[1:]
    kern = attn_ops.KERNEL_INT8 if int8 else attn_ops.KERNEL
    op = attn_ops.paged_attention_int8 if int8 else attn_ops.paged_attention
    ref = paged_attention_int8_dequant_ref if int8 else paged_attention_ref
    before = kern.launches
    out = op(*args, **kw)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert bool(torch.isfinite(out).all())
    want = ref(*args, **kw)
    tol = 1.6e-2 if out.dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


MOE_LENS = [0, 17, 130, 544, 1000, 2047, 3000, 4096]
# whisper-small's decoder rows (max_len 448): empty, one key, both sides of
# a 16-key block, a long row and the envelope's end
WHISPER_LENS = [0, 1, 15, 16, 17, 200, 447, 448]


def _check_paged_geometry(dev, pool, kind, *, hq, hkv, d, lens, seed):
    """B1/B2 (decode) or B4/B5 (verify, Q = 5, lens ≥ 1) at a model's head
    geometry: one launch, allclose with the plain version; the verify row
    0 bit-equal to the decode, a decode row of lens 0 zero."""
    int8 = pool == torch.int8
    verify = kind == "verify"
    lens = [max(x, 1) for x in lens] if verify else lens
    args, kw = _attn_case(dev, pool=pool, hq=hq, hkv=hkv, d=d, lens=lens,
                          qlen=5 if verify else 1, seed=seed)
    if int8:   # the serving path's bf16 queries
        args = (args[0].bfloat16(),) + args[1:]
    if verify:
        kern = attn_ops.KERNEL_VERIFY_INT8 if int8 else attn_ops.KERNEL_VERIFY
        op = (attn_ops.paged_attention_verify_int8 if int8
              else attn_ops.paged_attention_verify)
        ref = (paged_attention_verify_int8_dequant_ref if int8
               else paged_attention_verify_ref)
    else:
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
    if verify:
        dec = (attn_ops.paged_attention_int8 if int8
               else attn_ops.paged_attention)
        q1 = args[0][:, :, :1].contiguous()
        assert torch.equal(out[:, :, :1], dec(q1, *args[1:], **kw))
    else:
        assert torch.all(out[0] == 0)


@pytest.mark.parametrize("pool", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("kind", ["decode", "verify"])
def test_paged_kernels_at_qwen3_moe_geometry(cuda_device, pool, kind):
    """B1/B2 (decode) and B4/B5 (verify, Q = 5) at qwen3-moe-30b-a3b's
    geometry: 32 query heads on 4 kv heads of 128 (a GQA group of 8), 8
    rows up to 4096 keys. Allclose with the plain version; the verify row
    0 bit-equal to the decode."""
    _check_paged_geometry(cuda_device, pool, kind, hq=32, hkv=4, d=128,
                          lens=MOE_LENS, seed=9)


@pytest.mark.parametrize("pool", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("kind", ["decode", "verify"])
def test_paged_kernels_at_whisper_small_geometry(cuda_device, pool, kind):
    """B1/B2 (decode) and B4/B5 (verify, Q = 5) at whisper-small's decoder
    geometry: 12 query heads on 12 kv heads of 64 (a GQA group of 1, one
    query row a K/V tile; 5 rows in verify), 8 rows up to 448 keys.
    Allclose with the plain version; the verify row 0 bit-equal to the
    decode."""
    _check_paged_geometry(cuda_device, pool, kind, hq=12, hkv=12, d=64,
                          lens=WHISPER_LENS, seed=18)


@pytest.mark.parametrize("quant_on", [False, True], ids=["float", "int8"])
def test_moe_paged_steps_on_card_agree_with_cpu(cuda_device, quant_on):
    """Smoke-size qwen3-moe-30b-a3b (float32, capacity 1.25): a 52-token
    prefill (which drops routing slots) and three decode steps on the card
    (kernels B1/B2, one launch a layer a step) and on the CPU (plain
    versions), logits allclose; then the engine's greedy tokens on the
    card equal the CPU's, and spec on equals spec off on the card."""
    from repro_torch.models import registry
    from repro_torch.models.cache import PagedLayout
    from repro_torch.serve import EngineConfig, LLMEngine

    cfg = dataclasses.replace(configs.smoke_config("qwen3-moe-30b-a3b"),
                              dtype="float32", serve_quant=quant_on)
    arch = registry.build(cfg)
    npp = bridge.numpy_params(arch.schema(), seed=0)
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 52)))
    ids = torch.arange(3, 10, dtype=torch.int32)
    table = torch.zeros((1, 8), dtype=torch.int32)
    table[0, :7] = ids
    kern = attn_ops.KERNEL_INT8 if quant_on else attn_ops.KERNEL
    logits = {}
    for device in ("cuda", "cpu"):
        params = bridge.params_from_numpy(npp, device)
        cache = arch.init_paged_cache(1, PagedLayout(8, 12, 64),
                                      device=device)
        out, cache = arch.paged_prefill(params, prompt.to(device), cache, 0,
                                        ids.to(device))
        steps = [out]
        tok = out.argmax(-1).to(torch.int32)
        for _ in range(3):
            before = kern.launches
            out, cache = arch.paged_decode_step(params, cache, tok,
                                                table.to(device))
            if device == "cuda":
                torch.cuda.synchronize()
                assert kern.launches == before + cfg.n_layers
            steps.append(out)
            tok = out.argmax(-1).to(torch.int32)
        logits[device] = torch.stack([x.cpu() for x in steps])
    torch.testing.assert_close(logits["cuda"], logits["cpu"], atol=1e-4,
                               rtol=1e-4)

    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(17, 41)))
               for _ in range(6)]
    outs = {}
    for device, k in (("cuda", 0), ("cpu", 0), ("cuda", 3)):
        eng = LLMEngine(arch, bridge.params_from_numpy(npp, device),
                        EngineConfig(backend="paged", slots=4, max_len=64,
                                     admit_window=2,
                                     block_len=8, spec_tokens=k),
                        device=device)
        hs = [eng.add_request(p, max_new_tokens=12) for p in prompts]
        eng.run_until_drained()
        outs[device, k] = [eng.request(h).output for h in hs]
    assert outs["cuda", 0] == outs["cpu", 0]
    assert outs["cuda", 3] == outs["cuda", 0]


@pytest.mark.parametrize("quant_on", [False, True], ids=["float", "int8"])
def test_encdec_on_card_agrees_with_cpu(cuda_device, quant_on):
    """Smoke-size whisper-small (float32): a 13-token decoder prefill over
    24 frames and three paged decode steps on the card (B1/B2, one launch
    a layer a step) and on the CPU, logits allclose; then the engine's
    greedy tokens on the card equal the CPU's on the paged backend (spec
    3 on vs off too) and on the arena and slot backends, which launch no
    kernel."""
    from repro_torch.kernels.build import all_kernels
    from repro_torch.models import registry
    from repro_torch.models.cache import PagedLayout
    from repro_torch.serve import EngineConfig, LLMEngine

    cfg = dataclasses.replace(configs.smoke_config("whisper-small"),
                              dtype="float32", serve_quant=quant_on)
    arch = registry.build(cfg)
    npp = bridge.numpy_params(arch.schema(), seed=0)
    rng = np.random.default_rng(5)
    emb = torch.from_numpy((0.1 * rng.standard_normal(
        (2, cfg.enc_seq, cfg.d_model))).astype(np.float32))
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 13)))
    ids = torch.arange(3, 7, dtype=torch.int32)
    table = torch.zeros((1, 8), dtype=torch.int32)
    table[0, :4] = ids
    kern = attn_ops.KERNEL_INT8 if quant_on else attn_ops.KERNEL
    logits = {}
    for device in ("cuda", "cpu"):
        params = bridge.params_from_numpy(npp, device)
        cache = arch.init_paged_cache(1, PagedLayout(4, 12, 32),
                                      device=device)
        out, cache = arch.paged_prefill(params, prompt.to(device), cache, 0,
                                        ids.to(device),
                                        embeds=emb[:1].to(device))
        steps = [out]
        tok = out.argmax(-1).to(torch.int32)
        for _ in range(3):
            before = kern.launches
            out, cache = arch.paged_decode_step(params, cache, tok,
                                                table.to(device))
            if device == "cuda":
                torch.cuda.synchronize()
                assert kern.launches == before + cfg.n_layers
            steps.append(out)
            tok = out.argmax(-1).to(torch.int32)
        logits[device] = torch.stack([x.cpu() for x in steps])
    torch.testing.assert_close(logits["cuda"], logits["cpu"], atol=1e-4,
                               rtol=1e-4)

    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(3, 20)))
               for _ in range(6)]
    outs = {}
    for device, backend, k in (("cuda", "paged", 0), ("cpu", "paged", 0),
                               ("cuda", "paged", 3), ("cuda", "arena", 0),
                               ("cpu", "arena", 0), ("cuda", "slot", 0)):
        eng = LLMEngine(arch, bridge.params_from_numpy(npp, device),
                        EngineConfig(backend=backend, slots=4, max_len=48,
                                     admit_window=2, block_len=4,
                                     spec_tokens=k), device=device)
        before = {kk.name: kk.launches for kk in all_kernels()}
        hs = [eng.add_request(p, max_new_tokens=10, embeds=emb[i % 2].numpy())
              for i, p in enumerate(prompts)]
        eng.run_until_drained()
        outs[device, backend, k] = [eng.request(h).output for h in hs]
        if backend != "paged":
            assert all(kk.launches == before[kk.name]
                       for kk in all_kernels()), backend
    assert outs["cuda", "paged", 0] == outs["cpu", "paged", 0]
    assert outs["cuda", "paged", 3] == outs["cuda", "paged", 0]
    assert outs["cuda", "arena", 0] == outs["cpu", "arena", 0]
    assert outs["cuda", "slot", 0] == outs["cuda", "arena", 0]


def test_ring_serving_on_card_agrees_with_cpu(cuda_device):
    """Smoke-size gemma3-4b (window 16, float32) on ring pools (block_len
    4, max_len 64, prompts longer than the window), float and int8 pools:
    the engine on the card (kernels) and on the CPU (plain versions) give
    the same greedy tokens up to near-ties."""
    from repro_torch.models import registry
    from repro_torch.serve import EngineConfig, LLMEngine

    for quant_on in (False, True):
        cfg = dataclasses.replace(configs.smoke_config("gemma3-4b"),
                                  dtype="float32", serve_quant=quant_on)
        arch = registry.build(cfg)
        npp = bridge.numpy_params(arch.schema(), seed=0)
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, cfg.vocab, int(rng.integers(17, 41)))
                   for _ in range(6)]
        outs = []
        for device in ("cuda", "cpu"):
            eng = LLMEngine(arch, bridge.params_from_numpy(npp, device),
                            EngineConfig(backend="paged", slots=4, max_len=64,
                                         admit_window=2,
                                         block_len=4), device=device)
            assert eng.backend.ring
            hs = [eng.add_request(p, max_new_tokens=12) for p in prompts]
            eng.run_until_drained()
            outs.append([eng.request(h).output for h in hs])
        same = sum(a == b for x, y in zip(*outs) for a, b in zip(x, y))
        assert same >= 0.9 * 72, (quant_on, outs)


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
                            EngineConfig(backend="paged", slots=4, max_len=64,
                                         admit_window=2), device=device)
            hs = [eng.add_request(p, max_new_tokens=12) for p in prompts]
            eng.run_until_drained()
            outs.append([eng.request(h).output for h in hs])
        same = sum(a == b for x, y in zip(*outs) for a, b in zip(x, y))
        assert same >= 0.9 * 72, (quant_on, outs)


def test_spec_serving_on_card_agrees_with_cpu_and_spec_off(cuda_device):
    """Smoke-size glm4-9b (float32) with spec_tokens=3 and the prefix cache,
    float and int8 pools: on the card, spec on and spec off give the same
    greedy tokens up to near-ties, and the card agrees with the CPU."""
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
        shared = rng.integers(0, cfg.vocab, 19)
        prompts = [np.concatenate([shared, np.tile(
            rng.integers(0, cfg.vocab, 3), 8)[:int(rng.integers(4, 20))]])
            for _ in range(6)]
        outs = {}
        for device, k in (("cuda", 3), ("cuda", 0), ("cpu", 3)):
            eng = LLMEngine(arch, bridge.params_from_numpy(npp, device),
                            EngineConfig(backend="paged", slots=4, max_len=64,
                                         admit_window=2,
                                         block_len=8, spec_tokens=k,
                                         prefix_cache=True), device=device)
            hs = [eng.add_request(p, max_new_tokens=12) for p in prompts]
            eng.run_until_drained()
            outs[device, k] = [eng.request(h).output for h in hs]
        for other in (("cuda", 0), ("cpu", 3)):
            same = sum(a == b for x, y in zip(outs["cuda", 3], outs[other])
                       for a, b in zip(x, y))
            assert same >= 0.9 * 72, (quant_on, other, outs)


@pytest.mark.parametrize("prefix", [False, True], ids=["cache-off",
                                                      "cache-on"])
@pytest.mark.parametrize("chunk", [8, 16])
def test_chunked_serving_on_card_agrees_with_monolithic_and_cpu(
        cuda_device, chunk, prefix):
    """Smoke-size glm4-9b (float32) with chunked prefill of one or two
    blocks: on the card, float pools give the monolithic run's greedy tokens
    up to near-ties, and both pool types agree with the CPU's chunked run.
    (On int8 pools a chunk boundary resumes over dequantized int8 K/V, a
    different function from the monolithic prefill in both packages.)"""
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
        shared = rng.integers(0, cfg.vocab, 16)
        prompts = [np.concatenate([shared, rng.integers(
            0, cfg.vocab, int(rng.integers(1, 30)))]) for _ in range(6)]
        outs = {}
        for device, c in (("cuda", chunk), ("cuda", None), ("cpu", chunk)):
            eng = LLMEngine(arch, bridge.params_from_numpy(npp, device),
                            EngineConfig(backend="paged", slots=4, max_len=64,
                                         admit_window=2,
                                         block_len=8, prefill_chunk_tokens=c,
                                         prefix_cache=prefix), device=device)
            hs = [eng.add_request(p, max_new_tokens=12) for p in prompts]
            eng.run_until_drained()
            outs[device, c] = [eng.request(h).output for h in hs]
            if c is not None:
                assert eng.backend.prefill_chunk_dispatches > len(prompts)
        others = [("cpu", chunk)] + ([] if quant_on else [("cuda", None)])
        for other in others:
            same = sum(a == b for x, y in zip(outs["cuda", chunk],
                                              outs[other])
                       for a, b in zip(x, y))
            assert same >= 0.9 * 72, (quant_on, other, outs)


def _ssd_case(dev, s, *, h=80, g=1, p=64, n=128, decay=2.0, seed=0):
    """mamba2-2.7b's widths by default (80 heads × P 64, N 128, one group);
    Δ·A drawn in (-decay, 0]."""
    gen = torch.Generator(device=dev).manual_seed(seed + s)
    dta = -torch.rand((1, h, s), generator=gen, device=dev) * decay
    x = torch.randn((1, h, s, p), generator=gen, device=dev)
    bm = torch.randn((1, g, s, n), generator=gen, device=dev) * 0.3
    cm = torch.randn((1, g, s, n), generator=gen, device=dev) * 0.3
    return dta, x, bm, cm


def _ssd_plain(args, s, chunk):
    chunk = min(chunk, s)
    y, state = ssd_scan_chunked_ref(*pad_to_chunks(*args, chunk), chunk=chunk,
                                    return_state=True)
    return y[:, :, :s], state


def _ssd_close(got, want):
    atol = 1e-4 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("decay", [0.1, 2.0])
@pytest.mark.parametrize("s", [1, 2, 5, 127, 128, 129, 300, 512, 2048])
def test_ssd_scan_matches_plain_version(cuda_device, s, decay):
    """Ragged tails, S < 128 (one short chunk) and whole chunks, at
    mamba2-2.7b's widths; with and without the state."""
    args = _ssd_case(cuda_device, s, decay=decay)
    before = ssd_ops.KERNEL.launches
    y, state = ssd_ops.ssd_scan_cuda(*args, chunk=min(128, s),
                                     return_state=True)
    y_only = ssd_ops.ssd_scan_cuda(*args, chunk=min(128, s))
    torch.cuda.synchronize()
    assert ssd_ops.KERNEL.launches == before + 2
    want_y, want_state = _ssd_plain(args, s, 128)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    _ssd_close(y, want_y)
    _ssd_close(state, want_state)
    assert torch.equal(y_only, y)


@pytest.mark.parametrize("s,chunk", [(64, 32), (100, 32), (37, 64)])
@pytest.mark.parametrize("h,g,p,n", [(8, 2, 64, 128), (8, 2, 16, 16),
                                     (6, 3, 100, 20), (6, 3, 33, 18)],
                         ids=["groups2", "smoke", "ragged-widths",
                              "odd-widths"])
def test_ssd_scan_groups_and_widths(cuda_device, s, chunk, h, g, p, n):
    """G = 2 with H/G = 4, the smoke widths (P = N = 16), P, N that are not
    multiples of the kernel's tiles, and P, N that are not multiples of 4
    (4-byte staging, scalar stores and chain); chunks shorter than 128."""
    args = _ssd_case(cuda_device, s, h=h, g=g, p=p, n=n, decay=0.5)
    y, state = ssd_ops.ssd_scan_cuda(*args, chunk=min(chunk, s),
                                     return_state=True)
    want_y, want_state = _ssd_plain(args, s, chunk)
    _ssd_close(y, want_y)
    _ssd_close(state, want_state)


@pytest.mark.parametrize("decay", [0.01, 2.0])
def test_ssd_scan_long_carry_chain(cuda_device, decay):
    """S = 4096 at mamba2-2.7b's widths: 32 chunks, so the state is carried
    through a long chain (Δ·A in (-0.01, 0] keeps it alive to the end)."""
    args = _ssd_case(cuda_device, 4096, decay=decay)
    y, state = ssd_ops.ssd_scan_cuda(*args, chunk=128, return_state=True)
    want_y, want_state = _ssd_plain(args, 4096, 128)
    _ssd_close(y, want_y)
    _ssd_close(state, want_state)


@pytest.mark.parametrize("s", [129, 512])
def test_ssd_scan_two_groups_of_40_heads(cuda_device, s):
    """G = 2 with H/G = 40 at full P and N: each group's C·Bᵀ is formed
    once and read by 40 heads."""
    args = _ssd_case(cuda_device, s, g=2)
    y, state = ssd_ops.ssd_scan_cuda(*args, chunk=128, return_state=True)
    want_y, want_state = _ssd_plain(args, s, 128)
    _ssd_close(y, want_y)
    _ssd_close(state, want_state)


@pytest.mark.parametrize("s", [5, 2048])
def test_ssd_scan_is_deterministic(cuda_device, s):
    """Two identical calls give the same bits (the carry is combined in
    chunk order, with no float atomics), and so does a call without the
    state; one chunk takes two CUDA launches, more take three."""
    args = _ssd_case(cuda_device, s)
    y1, st1 = ssd_ops.ssd_scan_cuda(*args, chunk=128, return_state=True)
    y2, st2 = ssd_ops.ssd_scan_cuda(*args, chunk=128, return_state=True)
    y3 = ssd_ops.ssd_scan_cuda(*args, chunk=128)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(st1, st2)
    assert torch.equal(y1, y3)
    _, launches, grids = ssd_ops.plan(1, 80, 1, s, 128, 64, min(128, s),
                                      True)
    assert launches == (2 if s <= 128 else 3)
    assert grids[2] == 80 * -(-s // 128)


def test_ssd_scan_op_dispatches_by_device(cuda_device):
    """The public op launches the kernel for CUDA tensors (bf16 in, bf16
    out) and agrees with itself on the CPU."""
    args = _ssd_case(cuda_device, 200, h=8, g=2, p=16, n=16)
    before = ssd_ops.KERNEL.launches
    y = ssd_ops.ssd_scan(args[0], args[1].bfloat16(), *args[2:])
    assert ssd_ops.KERNEL.launches == before + 1 and y.dtype == torch.bfloat16
    cpu = ssd_ops.ssd_scan(*(a.cpu() for a in (args[0], args[1].bfloat16(),
                                                args[2], args[3])))
    torch.testing.assert_close(y.float().cpu(), cpu.float(), rtol=1.6e-2,
                               atol=1.6e-2 * float(cpu.float().abs().max()))


def test_ssd_scan_wrapper_checks_inputs(cuda_device):
    dta, x, bm, cm = _ssd_case(cuda_device, 16, h=4, g=1, p=16, n=16)
    with pytest.raises(ValueError, match="chunk"):
        ssd_ops.ssd_scan_cuda(dta, x, bm, cm, chunk=256)
    with pytest.raises(ValueError, match="float32"):
        ssd_ops.ssd_scan_cuda(dta, x.bfloat16(), bm, cm, chunk=16)
    big = torch.zeros((1, 1, 16, 160), device=cuda_device)
    with pytest.raises(ValueError, match="state size"):
        ssd_ops.ssd_scan_cuda(dta, x, big, big, chunk=16)


def test_mamba_serving_on_card_agrees_with_cpu_and_slot(cuda_device):
    """mamba2-2.7b-smoke (float32) through the arena on the card and on the
    CPU: the same greedy tokens up to near-ties; on the card, the slot
    backend gives the arena's tokens."""
    import dataclasses

    from repro_torch import bridge, configs
    from repro_torch.models import registry
    from repro_torch.serve import EngineConfig, LLMEngine

    cfg = dataclasses.replace(configs.smoke_config("mamba2-2.7b"),
                              dtype="float32")
    arch = registry.build(cfg)
    npp = bridge.numpy_params(arch.schema(), seed=0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(3, 40)))
               .astype(np.int32) for _ in range(6)]
    outs = {}
    before = ssd_ops.KERNEL.launches
    for device, backend in (("cuda", "arena"), ("cuda", "slot"),
                            ("cpu", "arena")):
        eng = LLMEngine(arch, bridge.params_from_numpy(npp, device),
                        EngineConfig(backend=backend, slots=4, max_len=64,
                                     admit_window=2), device=device)
        hs = [eng.add_request(p, max_new_tokens=12) for p in prompts]
        eng.run_until_drained()
        outs[device, backend] = [eng.request(h).output for h in hs]
    # each admission prefill runs the kernel once per layer
    assert ssd_ops.KERNEL.launches - before >= 2 * len(prompts) * cfg.n_layers
    assert outs["cuda", "slot"] == outs["cuda", "arena"]
    same = sum(a == b for x, y in zip(outs["cuda", "arena"],
                                      outs["cpu", "arena"])
               for a, b in zip(x, y))
    assert same >= 0.9 * 72, outs


@pytest.mark.parametrize("name", ["glm4-9b", "qwen3-moe-30b-a3b"])
def test_float_arena_serving_on_card_agrees_with_cpu_and_slot(cuda_device,
                                                              name):
    """The dense and moe families' smoke configs (float32,
    ``serve_quant=False``) through the arena and the slot backend on the
    card and the arena on the CPU: on the card slot == arena, card vs CPU
    the same greedy tokens up to near-ties, and no hand-written kernel
    launched (the arena path computes with plain PyTorch)."""
    from repro_torch.models import registry
    from repro_torch.serve import EngineConfig, LLMEngine

    cfg = dataclasses.replace(configs.smoke_config(name), dtype="float32",
                              serve_quant=False)
    arch = registry.build(cfg)
    npp = bridge.numpy_params(arch.schema(), seed=0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(3, 40)))
               .astype(np.int32) for _ in range(6)]
    before = {k.name: k.launches for k in build.all_kernels()}
    outs = {}
    for device, backend in (("cuda", "arena"), ("cuda", "slot"),
                            ("cpu", "arena")):
        eng = LLMEngine(arch, bridge.params_from_numpy(npp, device),
                        EngineConfig(backend=backend, slots=4, max_len=64,
                                     admit_window=2), device=device)
        hs = [eng.add_request(p, max_new_tokens=12) for p in prompts]
        eng.run_until_drained()
        outs[device, backend] = [eng.request(h).output for h in hs]
    assert {k.name: k.launches for k in build.all_kernels()} == before
    assert outs["cuda", "slot"] == outs["cuda", "arena"]
    same = sum(a == b for x, y in zip(outs["cuda", "arena"],
                                      outs["cpu", "arena"])
               for a, b in zip(x, y))
    assert same >= 0.9 * 72, outs


@pytest.mark.parametrize("activation", ["none", "relu", "gelu"])
@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 256), (4096, 13696),
                                 (13696, 4096)],
                         ids=["wq-wo", "wk-wv", "wg-wu", "wd"])
def test_int8_gemm_m1_at_glm4_projections(cuda_device, activation, k, n):
    """M = 1, the slot backend's batch-1 int8 decode, at each of glm4-9b's
    projection shapes."""
    _gemm_case(_gemm_operands(1, k, n, 3 * k + n, cuda_device), activation)


@pytest.mark.parametrize("geometry,dtype", [
    ("glm4-9b", torch.bfloat16), ("glm4-9b", torch.float32),
    ("gemma3-4b", torch.bfloat16)], ids=["glm4-bf16", "glm4-f32",
                                         "gemma3-ring-bf16"])
def test_decode_attention_int8_card_equals_cpu(cuda_device, geometry, dtype):
    """glm4-9b's arena decode (8 rows, 32 / 2 heads of 128, a 1024-row cache,
    lens 1–1024, the last row's logits all equal so Σp8 is at its largest)
    and gemma3-4b's ring layers (8 / 4 heads of 256 over a 1024-row ring,
    rows wrapped past it), caches holding the integers in ``dtype``."""
    from repro_torch.models.attention import decode_attention_int8

    cfg = configs.get_config(geometry)
    g = torch.Generator().manual_seed(7)
    b, s = 8, 1024
    q = torch.randn((b, cfg.n_heads, 1, cfg.hd), generator=g) * 2
    k = torch.randint(-127, 128, (b, cfg.n_kv_heads, s, cfg.hd),
                      generator=g).float()
    v = torch.randint(-127, 128, (b, cfg.n_kv_heads, s, cfg.hd),
                      generator=g).float()
    k[-1] = 0
    lens = torch.tensor([1, 17, 130, 255, 512, 777, 1000, 1024] if
                        geometry == "glm4-9b" else
                        [1, 300, 1023, 1024, 1025, 1500, 2900, 3000],
                        dtype=torch.int32)
    args = [t.to(dtype) for t in (q, k, v)] + [lens]
    want = decode_attention_int8(*args)
    got = decode_attention_int8(*(t.to(cuda_device) for t in args))
    assert got.dtype == dtype and bool(torch.isfinite(want).all())
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("name", ["glm4-9b", "qwen3-moe-30b-a3b"])
def test_int8_arena_serving_on_card_agrees_with_cpu_and_slot(cuda_device,
                                                             name):
    """The dense and moe families' smoke configs under ``serve_quant``
    (float32: the int8 arena step) through the arena and the slot backend
    on the card and the arena on the CPU: on the card slot == arena, card
    vs CPU the same greedy tokens up to near-ties; on the card the dense
    family launches the GEMM seven times a layer and decode step, the moe
    family no kernel."""
    from repro_torch.models import registry
    from repro_torch.serve import EngineConfig, LLMEngine

    cfg = dataclasses.replace(configs.smoke_config(name), dtype="float32")
    assert cfg.serve_quant
    arch = registry.build(cfg)
    npp = bridge.numpy_params(arch.schema(), seed=0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(3, 40)))
               .astype(np.int32) for _ in range(6)]
    outs = {}
    for device, backend in (("cuda", "arena"), ("cuda", "slot"),
                            ("cpu", "arena")):
        before = {k.name: k.launches for k in build.all_kernels()}
        eng = LLMEngine(arch, bridge.params_from_numpy(npp, device),
                        EngineConfig(backend=backend, slots=4, max_len=64,
                                     admit_window=2), device=device)
        hs = [eng.add_request(p, max_new_tokens=12) for p in prompts]
        eng.run_until_drained()
        outs[device, backend] = [eng.request(h).output for h in hs]
        launched = {k.name: k.launches - before[k.name]
                    for k in build.all_kernels()}
        want = {k: 0 for k in launched}
        if device == "cuda" and arch.quantize_params is not None:
            want["int8_gemm"] = (len(transformer.LINEARS) * cfg.n_layers
                                 * eng.backend.decode_dispatches)
        assert launched == want, (device, backend, launched)
    assert outs["cuda", "slot"] == outs["cuda", "arena"]
    same = sum(a == b for x, y in zip(outs["cuda", "arena"],
                                      outs["cpu", "arena"])
               for a, b in zip(x, y))
    assert same >= 0.9 * 72, outs


def _rglru_case(dev, b, s, d=4096, *, u_dtype=torch.bfloat16, seed=0):
    """recurrentgemma-9b's width (D = lru_width = 4096) by default; log_a as
    the model makes it, −8·softplus(Λ)·r with r a sigmoid."""
    gen = torch.Generator(device=dev).manual_seed(seed + s + b)
    lam = torch.randn((d,), generator=gen, device=dev)
    r = torch.sigmoid(torch.randn((b, s, d), generator=gen, device=dev))
    log_a = -8.0 * torch.logaddexp(lam, torch.zeros_like(lam)) * r
    u = torch.randn((b, s, d), generator=gen, device=dev).to(u_dtype)
    return log_a, u


def rglru_close(got, want):
    """float32: rtol 1e-5, atol 1e-5·max|want|; bf16: one ulp at most."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
        return
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    bad = int(((g - w).abs() > ulp).sum())
    assert bad == 0, f"{bad} outputs more than one bf16 ulp apart"


@pytest.mark.parametrize("u_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("b,s", [(1, 1), (1, 5), (1, 255), (1, 256),
                                 (1, 257), (1, 512), (1, 2048), (1, 2300),
                                 (3, 300), (1, 63), (1, 64), (1, 65),
                                 (1, 191), (1, 192), (1, 193), (3, 2300)])
def test_rglru_matches_plain_version(cuda_device, b, s, u_dtype):
    """Kernel B9 at recurrentgemma-9b's width: lengths around the TPU
    kernel's 256-row chunk, around the kernel's 64-row tile (63 / 64 / 65)
    and its ring of four (191 / 192 / 193: the first tile past the three in
    flight; 255 / 256 / 257: the ring wraps), the model's long prompts, and
    B = 3 at 300 and 2300."""
    log_a, u = _rglru_case(cuda_device, b, s, u_dtype=u_dtype)
    before = rglru_ops.KERNEL.launches
    h = rglru_ops.rglru_cuda(log_a, u)
    torch.cuda.synchronize()
    assert rglru_ops.KERNEL.launches == before + 1
    assert h.dtype == u_dtype and torch.isfinite(h.float()).all()
    rglru_close(h, rglru_ref(log_a, u))


@pytest.mark.parametrize("u_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("b,s,d", [(2, 70, 40), (1, 130, 102), (3, 9, 6)])
def test_rglru_ragged_widths(cuda_device, b, s, d, u_dtype):
    """Widths the 16-channel blocks do not divide: 40 (a block with two
    four-channel groups in and two out), 102 and 6 (not a multiple of four:
    the kernel's unstaged path)."""
    log_a, u = _rglru_case(cuda_device, b, s, d, u_dtype=u_dtype, seed=d)
    h = rglru_ops.rglru_cuda(log_a, u)
    torch.cuda.synchronize()
    rglru_close(h, rglru_ref(log_a, u))


def test_rglru_op_dispatches_by_device(cuda_device):
    """The public op launches the kernel for CUDA tensors and agrees with
    the plain version on the CPU; the wrapper refuses what the kernel does
    not take."""
    log_a, u = _rglru_case(cuda_device, 2, 40, d=96)
    before = rglru_ops.KERNEL.launches
    h = rglru_ops.rglru(log_a, u)
    assert rglru_ops.KERNEL.launches == before + 1
    rglru_close(h.cpu(), rglru_ops.rglru(log_a.cpu(), u.cpu()))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rglru_ops.rglru_cuda(log_a, u.half())
    with pytest.raises(ValueError, match="float32"):
        rglru_ops.rglru_cuda(log_a.bfloat16(), u)
    with pytest.raises(ValueError, match="contiguous"):
        rglru_ops.rglru_cuda(log_a, u.transpose(1, 2).contiguous()
                             .transpose(1, 2))


def test_hybrid_serving_on_card_agrees_with_cpu_and_slot(cuda_device):
    """recurrentgemma-9b-smoke (float32, window 16: the rings wrap) through
    the arena on the card and on the CPU: the same greedy tokens up to
    near-ties; on the card, the slot backend gives the arena's tokens."""
    import dataclasses

    from repro_torch import bridge, configs
    from repro_torch.models import registry
    from repro_torch.serve import EngineConfig, LLMEngine

    cfg = dataclasses.replace(configs.smoke_config("recurrentgemma-9b"),
                              dtype="float32")
    arch = registry.build(cfg)
    npp = bridge.numpy_params(arch.schema(), seed=0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(3, 41)))
               .astype(np.int32) for _ in range(6)]
    outs = {}
    before = rglru_ops.KERNEL.launches
    for device, backend in (("cuda", "arena"), ("cuda", "slot"),
                            ("cpu", "arena")):
        eng = LLMEngine(arch, bridge.params_from_numpy(npp, device),
                        EngineConfig(backend=backend, slots=4, max_len=64,
                                     admit_window=2), device=device)
        hs = [eng.add_request(p, max_new_tokens=12) for p in prompts]
        eng.run_until_drained()
        outs[device, backend] = [eng.request(h).output for h in hs]
    # each admission prefill runs the kernel once per recurrent layer
    n_rec = cfg.layer_layout()[1] * cfg.pattern.count("R")
    assert rglru_ops.KERNEL.launches - before >= 2 * len(prompts) * n_rec
    assert outs["cuda", "slot"] == outs["cuda", "arena"]
    same = sum(a == b for x, y in zip(outs["cuda", "arena"],
                                      outs["cpu", "arena"])
               for a, b in zip(x, y))
    assert same >= 0.9 * 72, outs


ITA_SC = 4.0 / 127  # int8_attention's static scales


def _ita_case(dev, b, hq, hkv, sq, skv, d, *, seed=0, saturated=False):
    """int8 q, k, v [B, H, S, D]: quantized unit normals as int8_attention
    makes them, or uniform int8 (the logits saturate)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shapes = [(b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)]
    if saturated:
        return [torch.randint(-127, 128, sh, generator=g, device=dev,
                              dtype=torch.int8) for sh in shapes]
    xs = [torch.randn(sh, generator=g, device=dev) for sh in shapes]
    xs[0] = xs[0] * d ** -0.5
    return [torch.clamp(torch.round(x / ITA_SC), -127, 127).to(torch.int8)
            for x in xs]


@pytest.mark.parametrize("b,hq,hkv,s,d,bq,bkv,causal,sat", [
    (1, 32, 2, 2048, 128, 128, 128, True, False),   # glm4-9b prefill
    (1, 32, 2, 512, 128, 128, 128, False, False),
    (2, 8, 8, 512, 64, 128, 64, True, False),       # no GQA
    (1, 6, 6, 1000, 64, 125, 125, True, False),     # block_kv 125
    (1, 6, 6, 1370, 64, 137, 137, False, False),    # DINOv2-S
    (1, 6, 6, 1500, 64, 125, 125, False, False),    # Whisper-Tiny
    (1, 4, 4, 128, 128, 128, 128, False, False),    # MobileBERT
    (1, 4, 2, 256, 48, 64, 32, True, True),         # saturated, q ≠ kv tile
    (1, 4, 1, 100, 20, 25, 20, True, True),         # D % 4 ≠ 0
    (1, 2, 2, 256, 256, 64, 256, True, False),      # the largest tile
    (1, 6, 6, 1370, 64, 137, 137, True, False),     # 137-key tiles, causal
    (1, 32, 2, 1000, 128, 125, 125, True, False),   # group 16, 16 ∤ S
    (1, 16, 1, 600, 128, 200, 200, True, False),    # scores packed (bkv > 128)
    (1, 6, 2, 96, 32, 32, 32, True, False),         # group 3: one head a block
])
def test_ita_attention_bit_exact(cuda_device, b, hq, hkv, s, d, bq, bkv,
                                 causal, sat):
    q, k, v = _ita_case(cuda_device, b, hq, hkv, s, s, d, seed=s + d,
                        saturated=sat)
    kw = dict(qk_scale=ITA_SC * ITA_SC if not sat else 1e-3,
              v_scale=ITA_SC if not sat else 0.03,
              out_scale=0.9 * ITA_SC if not sat else 0.02, causal=causal,
              block_q=bq, block_kv=bkv)
    before = ita_ops.KERNEL.launches
    y = ita_ops.ita_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ita_ops.KERNEL.launches == before + 1
    want = ita_plain(q, k, v, **kw)
    assert torch.equal(y, want), int((y != want).sum())


@pytest.mark.parametrize("s,tile", [(128, 64), (120, 60)])
def test_ita_attention_causal_floor_corner(cuda_device, s, tile):
    """q ≡ 127, k ≡ −127 at logit_amax = 1000 saturate every logit at the
    exponent floor; tiles above the diagonal are skipped per logical q tile
    (64 or 60 rows), as the TPU kernel skips them, and the kernel's padding
    of a 60-key tile to 64 keeps the padded keys at p8 = 0."""
    d = 64
    q = torch.full((1, 1, s, d), 127, dtype=torch.int8, device=cuda_device)
    k = torch.full((1, 1, s, d), -127, dtype=torch.int8, device=cuda_device)
    v = _ita_case(cuda_device, 1, 1, 1, s, s, d, saturated=True)[2]
    for amax in (1000.0, 10.0):
        kw = dict(qk_scale=1.0, v_scale=1.0, out_scale=1.0, causal=True,
                  logit_amax=amax, block_q=tile, block_kv=tile)
        y = ita_ops.ita_attention_cuda(q, k, v, **kw)
        assert torch.equal(y, ita_plain(q, k, v, **kw))


def test_ita_attention_op_dispatches_by_device(cuda_device):
    """The public op launches the kernel for CUDA tensors and agrees with
    the CPU's plain version bit for bit; the wrapper refuses what the
    kernel does not take."""
    q, k, v = _ita_case(cuda_device, 1, 4, 2, 256, 256, 32)
    kw = dict(qk_scale=ITA_SC * ITA_SC, v_scale=ITA_SC, out_scale=ITA_SC,
              causal=True, block_kv=64)
    before = ita_ops.KERNEL.launches
    y = ita_ops.ita_attention(q, k, v, **kw)
    assert ita_ops.KERNEL.launches == before + 1
    assert torch.equal(y.cpu(), ita_ops.ita_attention(q.cpu(), k.cpu(),
                                                      v.cpu(), **kw))
    with pytest.raises(ValueError, match="up to 256"):
        ita_ops.ita_attention_cuda(*_ita_case(cuda_device, 1, 2, 2, 512, 512,
                                              32), **dict(kw, block_kv=512))
    with pytest.raises(ValueError, match="not divisible"):
        ita_ops.ita_attention(q, k, v, **dict(kw, block_kv=96))
    with pytest.raises(ValueError, match="contiguous"):
        ita_ops.ita_attention_cuda(q.transpose(2, 3).contiguous()
                                   .transpose(2, 3), k, v, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_int8_attention_on_card_equals_cpu(cuda_device, dtype):
    from repro_torch.models.attention import int8_attention

    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = (torch.randn((2, h, 256, 64), generator=g, device=cuda_device
                           ).to(dtype) for h in (4, 2, 2))
    before = ita_ops.KERNEL.launches
    y = int8_attention(q, k, v, causal=True)
    assert ita_ops.KERNEL.launches == before + 1
    want = int8_attention(q.cpu(), k.cpu(), v.cpu(), causal=True)
    assert y.dtype == dtype and torch.equal(y.cpu(), want)


def _smax_logits(r, c, scale, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.clamp(torch.round(torch.randn((r, c), generator=g,
                                               device=dev) * 3.0
                                   / scale), -127, 127).to(torch.int8)


def _smax_same(x, scale):
    before = smax_ops.KERNEL.launches
    y = smax_ops.int_softmax_cuda(x, logit_scale=scale)
    torch.cuda.synchronize()
    assert smax_ops.KERNEL.launches == before + 1
    want = int_softmax_ref(x, logit_scale=scale)
    assert torch.equal(y, want), int((y != want).sum())


LIM = smax_ops.STAGE_COLS


@pytest.mark.parametrize("r,c", [(6 * 1370, 1370), (6 * 1500, 1500),
                                 (4 * 128, 128), (1001, 999), (3, 1),
                                 (5, 4099), (1, 100003), (256, 128),
                                 (4001, 333), (9, LIM - 1), (9, LIM),
                                 (9, LIM + 1), (1, 1 << 22)])
@pytest.mark.parametrize("scale", [0.06, 10.0 / 127, 60.0, 0.001])
def test_int_softmax_bit_exact(cuda_device, r, c, scale):
    """The paper networks' per-layer logits (DINOv2-S, Whisper-Tiny,
    MobileBERT), ragged R and C (333: row starts on every residue mod 16
    over many blocks), rows at the staged body's limit and either side of
    it, a long row and one of 2^22 (the long body), and logit scales from
    0.001 to one whose alpha shift is negative (60)."""
    _smax_same(_smax_logits(r, c, scale, r + c, cuda_device), scale)


@pytest.mark.parametrize("r,c", [(64, 1370), (5, 4099), (3, 20001), (40, 7)])
@pytest.mark.parametrize("scale", [10.0 / 127, 60.0])
def test_int_softmax_extremes_and_views_off_the_grid(cuda_device, r, c,
                                                     scale):
    """Rows holding -128 and 127 (k = m - x reaches 255), and the same
    logits read from a view 3 bytes off the 16-byte grid (the wrapper
    copies it; the kernel takes 16-byte aligned rows)."""
    x = _smax_logits(1, r * c + 16, scale, r * c, cuda_device)[0]
    x[3::c], x[3 + c - 1::c] = -128, 127
    view = x[3:3 + r * c].view(r, c)
    assert view.data_ptr() % 16 == 3
    assert int(view.min()) == -128 and int(view.max()) == 127
    _smax_same(view, scale)
    _smax_same(view.clone(), scale)


def test_int_softmax_op_dispatches_by_device(cuda_device):
    x = torch.randint(-127, 128, (2, 3, 50), dtype=torch.int8,
                      device=cuda_device)
    before = smax_ops.KERNEL.launches
    y = smax_ops.int_softmax(x, logit_scale=0.05)
    assert smax_ops.KERNEL.launches == before + 1
    assert y.shape == x.shape and y.dtype == torch.uint8
    assert torch.equal(y.cpu(), smax_ops.int_softmax(x.cpu(),
                                                     logit_scale=0.05))
    with pytest.raises(ValueError, match="int8"):
        smax_ops.int_softmax_cuda(x.reshape(6, 50).int(), logit_scale=0.05)
    with pytest.raises(ValueError, match=r"\[R, C\]"):
        smax_ops.int_softmax_cuda(x, logit_scale=0.05)
    with pytest.raises(ValueError, match="contiguous"):
        smax_ops.int_softmax_cuda(x.reshape(6, 50).t(), logit_scale=0.05)


# -- training on the card ---------------------------------------------------


def test_scan_kernels_refuse_autograd_by_name(cuda_device):
    """B8 and B9 have no backward kernel: a CUDA input that requires grad
    under grad mode raises instead of giving outputs without ``grad_fn``
    (zero gradients for everything before the scan); without grad they
    launch as before."""
    from repro_torch.models import registry
    from repro_torch.optim import optimizer as opt
    from repro_torch.train import trainer

    dta, x, bm, cm = _ssd_case(cuda_device, 40, h=4, p=8, n=16)
    with pytest.raises(NotImplementedError,
                       match="no backward for the SSD scan kernel on the "
                             "card yet"):
        ssd_ops.ssd_scan(dta, x.requires_grad_(), bm, cm)
    with torch.no_grad():
        ssd_ops.ssd_scan(dta, x, bm, cm)
    log_a, u = _rglru_case(cuda_device, 1, 40, d=32, u_dtype=torch.float32)
    with pytest.raises(NotImplementedError,
                       match="no backward for the RG-LRU scan kernel"):
        rglru_ops.rglru(log_a, u.requires_grad_())
    for name in ("mamba2-2.7b", "recurrentgemma-9b"):
        cfg = dataclasses.replace(configs.smoke_config(name),
                                  dtype="float32")
        arch = registry.build(cfg)
        params = bridge.params_from_numpy(
            bridge.numpy_params(arch.schema(), seed=0), cuda_device)
        toks = torch.randint(0, cfg.vocab, (2, 9), device=cuda_device)
        tc = trainer.TrainConfig(model=cfg, opt=opt.OptConfig())
        step = trainer.make_train_step(arch, tc)
        with pytest.raises(NotImplementedError, match="no backward"):
            step(params, opt.init(tc.opt, params), toks)


def _train_inputs(cfg, seed=0, batch=4, seq=33):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int64)
    emb = None
    if cfg.family == "encdec":
        emb = rng.standard_normal((batch, cfg.enc_seq, cfg.d_model))
    elif cfg.family == "vlm-dense":
        emb = rng.standard_normal((batch, seq, cfg.d_model))
    return toks, None if emb is None else emb.astype(np.float32)


@pytest.mark.parametrize("name", ["phi3-mini-3.8b", "qwen3-moe-30b-a3b",
                                  "whisper-small", "llava-next-34b"])
def test_train_step_on_card_equals_cpu(cuda_device, name):
    """One train step (float32, two microbatches) on the card and on the
    CPU from the same numpy parameters and batch: ``make_train_step``'s
    loss at ``rtol = 1e-5``, every gradient leaf at ``rtol = 1e-4`` with
    ``atol = 1e-5 · max|g|``, and the AdamW update of the CPU's gradients
    on both devices, every parameter at ``rtol = 1e-4`` with
    ``atol = 1e-5 · max|p|`` (a whole step's parameters are not compared
    element-wise: Adam's first step moves an element whose gradient is
    near eps by up to 2·lr, whichever way each device rounds it); no
    kernel of the port launched."""
    from repro_torch.models import registry
    from repro_torch.optim import optimizer as opt
    from repro_torch.train import trainer
    from repro_torch.train.checkpointing import flatten_with_paths

    def host(tree):
        return {k: v.cpu() for k, v in flatten_with_paths(tree).items()}

    cfg = dataclasses.replace(configs.smoke_config(name), dtype="float32")
    arch = registry.build(cfg)
    npp = bridge.numpy_params(arch.schema(), seed=0)
    toks, emb = _train_inputs(cfg)
    tc = trainer.TrainConfig(model=cfg, opt=opt.OptConfig(
        lr=3e-4, warmup_steps=1, total_steps=10), microbatches=2)
    out = {}
    launches = [k.launches for k in build.all_kernels()]
    for dev in ("cpu", "cuda"):
        t = torch.from_numpy(toks).to(dev)
        e = None if emb is None else torch.from_numpy(emb).to(dev)
        params = bridge.params_from_numpy(npp, dev)
        _, _, m = trainer.make_train_step(arch, tc)(
            params, opt.init(tc.opt, params), t, e)
        loss, grads = trainer.loss_and_grads(
            trainer.make_loss_fn(arch), bridge.params_from_numpy(npp, dev),
            arch.schema(), t, e, 2)
        out[dev] = (float(loss), float(m["loss"]), grads)
    cpu_grads = bridge.numpy_from_params(out["cpu"][2])
    upd = {}
    for dev in ("cpu", "cuda"):
        params = bridge.params_from_numpy(npp, dev)
        opt.update(tc.opt, opt.init(tc.opt, params), params,
                   bridge.params_from_numpy(cpu_grads, dev))
        upd[dev] = host(params)
    assert [k.launches for k in build.all_kernels()] == launches
    (cl, cm, cg), (gl, gm, gg) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(gl, cl, rtol=1e-5)
    np.testing.assert_allclose(gm, cm, rtol=1e-5)
    for got, want in ((host(gg), host(cg)), (upd["cuda"], upd["cpu"])):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(
                got[k].numpy(), want[k].numpy(), rtol=1e-4,
                atol=1e-5 * float(want[k].abs().max()), err_msg=k)
