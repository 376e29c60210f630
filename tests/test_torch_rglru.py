"""PyTorch port vs JAX reference: the RG-LRU scan's plain versions.

The same numpy inputs go through the JAX package's ``xla`` form
(``_rglru_xla``, an associative scan: what ``repro.models.griffin`` runs)
and its sequential oracle (``rglru_ref``), and through the port's ``rglru``
on the CPU (``ref.rglru_ref``, the version the Hopper kernel is held to on
the card). The Pallas kernel itself is not run here: its interpret mode
needs ``pl.store``, which this JAX lacks (ROADMAP Queue C).

Tolerances. Float32 output: the associative scan adds in another order than
the sequential forms, so ``rtol = 1e-5`` and ``atol = 1e-5 · max|h|``.
Bfloat16 output: both sides round float32 values that agree to about 1e-6
relative, so they are at most one bf16 ulp apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru.ops import _rglru_xla
from repro.kernels.rglru.ref import rglru_decode_step as jdecode_step
from repro.kernels.rglru.ref import rglru_ref as jrglru_ref
from repro_torch.kernels.rglru import ops
from repro_torch.kernels.rglru.ref import rglru_decode_step, rglru_ref

torch.set_num_threads(1)

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def inputs(b, s, d, seed):
    """log_a as the model makes it (−8·softplus(Λ)·r, r a sigmoid) and a
    unit-scale gated input."""
    rng = np.random.default_rng(seed)
    lam = rng.standard_normal(d).astype(np.float32)
    r = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, d))))
    log_a = (-8.0 * np.logaddexp(lam, 0.0) * r).astype(np.float32)
    u = rng.standard_normal((b, s, d)).astype(np.float32)
    return log_a, u


def bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits; normal range)."""
    mag = np.maximum(np.abs(x), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def close(got: torch.Tensor, want, dtype: str):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))
    else:
        ulp = bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        bad = np.abs(got - want) > ulp
        assert not bad.any(), (f"{bad.sum()} outputs more than one bf16 ulp "
                               f"apart; max |diff| {np.abs(got - want).max()}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("d", [64, 96])
@pytest.mark.parametrize("s", [1, 5, 256, 300])
def test_scan_matches_xla_form_and_oracle(s, d, b, dtype):
    log_a, u = inputs(b, s, d, seed=s + d + b)
    _, jdt, tdt = DTYPES[dtype]
    ju = jnp.asarray(u).astype(jdt)
    tu = torch.from_numpy(u).to(tdt)
    h = ops.rglru(torch.from_numpy(log_a), tu)
    assert h.dtype == tdt and h.shape == (b, s, d)
    close(h, _rglru_xla(jnp.asarray(log_a), ju), dtype)
    close(h, jrglru_ref(jnp.asarray(log_a), ju), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_reference_and_the_scan(dtype):
    """Eight one-token updates against the reference's, with float32 state
    carried on both sides; each step's output equals the scan's row."""
    log_a, u = inputs(2, 8, 64, seed=11)
    _, jdt, tdt = DTYPES[dtype]
    tu = torch.from_numpy(u).to(tdt)
    ju = jnp.asarray(u).astype(jdt)
    scan = rglru_ref(torch.from_numpy(log_a), tu)
    h = torch.zeros((2, 64))
    jh = jnp.zeros((2, 64), jnp.float32)
    for t in range(8):
        h, out = rglru_decode_step(h, torch.from_numpy(log_a[:, t]),
                                   tu[:, t])
        jh, jout = jdecode_step(jh, jnp.asarray(log_a[:, t]), ju[:, t])
        assert h.dtype == torch.float32 and out.dtype == tdt
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-6,
                                   atol=1e-6)
        close(out, jout, dtype)
        torch.testing.assert_close(out, scan[:, t], rtol=1e-6, atol=1e-6)


def test_op_dispatches_by_device():
    """CPU tensors take the plain version (no launch); a device with no
    version raises; malformed shapes raise before any dispatch."""
    log_a, u = inputs(1, 7, 64, seed=3)
    la, tu = torch.from_numpy(log_a), torch.from_numpy(u)
    before = ops.KERNEL.launches
    torch.testing.assert_close(ops.rglru(la, tu), rglru_ref(la, tu),
                               rtol=0, atol=0)
    assert ops.KERNEL.launches == before
    with pytest.raises(ValueError, match="no version for device meta"):
        ops.rglru(la.to("meta"), tu.to("meta"))
    with pytest.raises(ValueError, match=r"\[B, S, D\]"):
        ops.rglru(la[0], tu[0])
    with pytest.raises(ValueError, match="empty sequence"):
        ops.rglru(la[:, :0], tu[:, :0])
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        ops.rglru_cuda(la, tu)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.rglru_cuda(la, tu.half())


@pytest.mark.parametrize("b", [1, 3])
def test_plan_fills_the_card_and_covers_every_length(b):
    """B9's launch plan at recurrentgemma-9b's width (D = lru_width = 4096):
    blocks of 16 channels (one prompt: 256 blocks, two an SM), a ring that
    fits an SM twice, and tiles that cover every prefill length from 1 to
    2300 without an empty tile."""
    for u_bytes in (2, 4):
        p = ops.plan(b, 512, 4096, u_bytes)
        assert p.blocks == (256, b) and p.blocks[0] * ops.CHANS == 4096
        assert p.threads == p.steps * ops.CHANS // ops.GROUP + 32 <= 1024
        assert 2 * p.smem <= 227 * 1024
    for s in range(1, 2301):
        p = ops.plan(b, s, 4096)
        assert (p.tiles - 1) * p.steps < s <= p.tiles * p.steps
    narrow = ops.plan(b, 7, 96)   # a width the blocks do not divide evenly
    assert narrow.blocks == (6, b)
    assert ops.plan(b, 7, 100).blocks == (7, b)
