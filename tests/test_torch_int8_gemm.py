"""PyTorch port vs JAX reference: the W8A8 int8 GEMM (kernel B3).

The plain version (``repro_torch.kernels.int8_gemm.ref``) is held bit-exact
to the reference's Pallas kernel (interpret mode) and its ``int8_gemm_ref``
oracle; the port's weight quantization is held bit-exact to the
reference's. The CUDA kernel is held to the plain version on the card in
``test_torch_cuda_kernels.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import quant as jquant
from repro.kernels.int8_gemm.kernel import int8_gemm_pallas
from repro.kernels.int8_gemm.ops import QuantizedLinearParams as JQLP
from repro.kernels.int8_gemm.ref import int8_gemm_ref as j_gemm_ref
from repro.models import transformer as jtransformer
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.kernels.int8_gemm import ops as tops
from repro_torch.kernels.int8_gemm.ref import int8_gemm_ref as t_gemm_ref
from repro_torch.models import transformer as ttransformer

torch.set_num_threads(1)

ACT_SCALES = (4.0 / 127, 4.0 / 127)


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    bias = rng.integers(-20000, 20000, n).astype(np.int32)
    scale = (2.0 ** rng.uniform(-14, -8, n)).astype(np.float32)
    mult, shift = (np.asarray(a) for a in
                   jquant.quantize_to_fixed_point(jnp.asarray(scale)))
    return x, w, bias, mult.astype(np.int32), shift.astype(np.int32)


def _torch_args(ops):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in ops]


@pytest.mark.parametrize("activation", ["none", "relu", "gelu"])
def test_plain_gemm_matches_pallas_kernel_bit_exact(activation):
    ops = _operands(16, 256, 128, seed=0)
    scales = ACT_SCALES if activation == "gelu" else None
    j = int8_gemm_pallas(*(jnp.asarray(a) for a in ops),
                         activation=activation, act_scales=scales,
                         interpret=True)
    t = t_gemm_ref(*_torch_args(ops), activation=activation,
                   act_scales=scales)
    assert t.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(j), t.numpy())
    # both sides exercise the requantization, not a constant
    assert len(np.unique(t.numpy())) > 50


@pytest.mark.parametrize("activation", ["none", "relu", "gelu"])
@pytest.mark.parametrize("m,k,n", [(1, 64, 48), (5, 96, 40), (3, 30, 7)])
def test_plain_gemm_ragged_matches_reference_oracle(activation, m, k, n):
    """Ragged M (decode: M = live slots), and K/N off every block size."""
    ops = _operands(m, k, n, seed=m * 100 + n)
    scales = ACT_SCALES if activation == "gelu" else None
    j = j_gemm_ref(*(jnp.asarray(a) for a in ops), activation=activation,
                   act_scales=scales)
    t = t_gemm_ref(*_torch_args(ops), activation=activation,
                   act_scales=scales)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_int8_gemm_op_on_cpu_uses_plain_version_with_lead_dims():
    x, w, bias, mult, shift = _operands(6, 64, 32, seed=7)
    p = tops.QuantizedLinearParams(*_torch_args([w, bias, mult, shift]))
    before = tops.KERNEL.launches
    y = tops.int8_gemm(torch.from_numpy(x).reshape(2, 3, 64), p)
    assert y.shape == (2, 3, 32)
    np.testing.assert_array_equal(
        y.reshape(6, 32).numpy(), t_gemm_ref(*_torch_args([x, w, bias, mult,
                                                           shift])).numpy())
    assert tops.KERNEL.launches == before  # the CPU never reaches the kernel


@pytest.mark.parametrize("activation", ["none", "relu", "gelu"])
def test_k_major_params_through_op_match_pallas_kernel(activation):
    """The weights as the kernel takes them (the transposed view of a
    contiguous [N, K] tensor) through the port's ``int8_gemm`` on the CPU
    equal the reference's Pallas kernel bit for bit."""
    x, w, bias, mult, shift = _operands(16, 256, 128, seed=5)
    scales = ACT_SCALES if activation == "gelu" else None
    j = int8_gemm_pallas(*(jnp.asarray(a) for a in (x, w, bias, mult, shift)),
                         activation=activation, act_scales=scales,
                         interpret=True)
    w_t = tops.k_major(torch.from_numpy(w))
    assert w_t.stride() == (1, 256) and w_t.mT.is_contiguous()
    p = tops.QuantizedLinearParams(w_t, *_torch_args([bias, mult, shift]))
    before = tops.KERNEL.launches
    y = tops.int8_gemm(torch.from_numpy(x).reshape(4, 4, 256), p,
                       activation=activation, act_scales=scales)
    assert tops.KERNEL.launches == before
    np.testing.assert_array_equal(np.asarray(j), y.reshape(16, 128).numpy())
    assert len(np.unique(np.asarray(j))) > 50


def test_quantized_weights_are_k_major():
    """``from_float``, ``quantize_params`` (through
    ``bridge.qparams_from_numpy``) and a stack entry ``params[i]`` all give
    the layout the kernel takes, so no call copies the weights."""
    rng = np.random.default_rng(4)
    w = torch.from_numpy((rng.standard_normal((64, 48)) * 0.1
                          ).astype(np.float32))
    q = tops.QuantizedLinearParams.from_float(w, torch.zeros(48), 0.05, 0.02)
    assert q.w_q.shape == (64, 48) and q.w_q.stride() == (1, 64)

    cfg = dataclasses.replace(tconfigs.smoke_config("glm4-9b"),
                              dtype="float32")
    npp = bridge.numpy_params(ttransformer.schema(cfg), seed=12)
    tq = bridge.qparams_from_numpy(npp, cfg, device="cpu")
    for st in tq["stacks"]:
        for name in ttransformer.LINEARS:
            wq = st[name].w_q
            n_layers, k, n = wq.shape
            assert wq.stride() == (n * k, 1, k), (name, wq.stride())
            layer = st[name][n_layers - 1]
            assert layer.w_q.shape == (k, n) and layer.w_q.stride() == (1, k)
            assert layer.bias.is_contiguous() and layer.bias.shape == (n,)


def test_from_float_and_quantize_params_bit_exact():
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((64, 48)) * 0.1).astype(np.float32)
    bias_f = (rng.standard_normal(48) * 0.01).astype(np.float32)
    j = JQLP.from_float(jnp.asarray(w), jnp.asarray(bias_f), 0.05, 0.02)
    t = tops.QuantizedLinearParams.from_float(
        torch.from_numpy(w), torch.from_numpy(bias_f), 0.05, 0.02)
    for f in ("w_q", "bias", "mult", "shift"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f).numpy(), err_msg=f)

    cfg_j = dataclasses.replace(jconfigs.smoke_config("glm4-9b"),
                                dtype="float32")
    cfg_t = dataclasses.replace(tconfigs.smoke_config("glm4-9b"),
                                dtype="float32")
    npp = bridge.numpy_params(ttransformer.schema(cfg_t), seed=11)
    jq = jtransformer.quantize_params(jax.tree.map(jnp.asarray, npp), cfg_j)
    tq = bridge.qparams_from_numpy(npp, cfg_t, device="cpu")
    for name in ttransformer.LINEARS:
        for f in ("w_q", "bias", "mult", "shift"):
            np.testing.assert_array_equal(
                np.asarray(getattr(jq["stacks"][0][name], f)),
                getattr(tq["stacks"][0][name], f).numpy(),
                err_msg=f"{name}.{f}")
