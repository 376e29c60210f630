"""PyTorch port vs JAX reference: paged decode attention (kernels B1, B2).

The plain versions (``repro_torch.kernels.paged_attention.ref``) are held to
the reference's Pallas kernels run in interpret mode, on the same numpy
inputs, at atol 1e-5 in float32: the only difference is the order of the
f32 additions (the Pallas kernels run an online softmax block by block, the
plain versions a dense softmax). The cases cover GQA groups > 1, a sliding
window, a per-row start offset, a ``lens == 0`` row and non-uniform
per-block scales. The CUDA kernel is held to the plain version on the card
in ``test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.kernel import (
    paged_attention_int8_pallas, paged_attention_pallas,
)
from repro.kernels.paged_attention.ref import (
    paged_attention_ref as j_paged_attention_ref,
)
from repro.models.attention import Q_SCALE as J_Q_SCALE
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import (
    gather_kv, paged_attention_int8_dequant_ref, paged_attention_ref,
)

torch.set_num_threads(1)

ATOL = 1e-5  # f32 flash reordering only


def _case(seed, *, int8, b=4, hq=8, hkv=2, blk=8, d=16, n=14, m=5,
          start=False):
    """Pools, table, lens (one zero-length row) and optional start."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, hq, 1, d)) * 2.0).astype(np.float32)
    shape = (n, hkv, blk, d)
    if int8:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
    table = np.stack([rng.permutation(np.arange(1, n))[:m]
                      for _ in range(b)]).astype(np.int32)
    st = np.zeros(b, np.int32)
    if start:
        st = (rng.integers(0, 3, b) * blk).astype(np.int32)
        st[0] = 0
    lens = np.asarray([0, 7, 23, m * blk], np.int32)[:b]
    lens = np.where(lens > 0, lens + st, 0).astype(np.int32)
    ks = rng.uniform(0.01, 0.05, n).astype(np.float32)
    vs = rng.uniform(0.01, 0.05, n).astype(np.float32)
    return q, k, v, table, lens, (st if start else None), ks, vs


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("window", [None, 10])
@pytest.mark.parametrize("start", [False, True])
@pytest.mark.parametrize("group", [1, 4])
def test_plain_float_matches_pallas_kernel(window, start, group):
    q, k, v, table, lens, st, _, _ = _case(
        1, int8=False, hq=2 * group, start=start)
    j = paged_attention_pallas(_j(q), _j(k), _j(v), _j(table), _j(lens),
                               window=window, start=_j(st), interpret=True)
    t = paged_attention_ref(_t(q), _t(k), _t(v), _t(table), _t(lens),
                            window=window, start=_t(st))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)
    assert np.all(t.numpy()[0] == 0.0)          # lens == 0 → zeros
    # and the public op on a CPU tensor is exactly the plain version
    o = ops.paged_attention(_t(q), _t(k), _t(v), _t(table), _t(lens),
                            window=window, start=_t(st))
    assert torch.equal(o, t)
    # the dense JAX oracle agrees too
    jr = j_paged_attention_ref(_j(q), _j(k), _j(v), _j(table), _j(lens),
                               window=window, start=_j(st))
    np.testing.assert_allclose(t.numpy(), np.asarray(jr), atol=ATOL, rtol=0)


@pytest.mark.parametrize("window", [None, 10])
@pytest.mark.parametrize("start", [False, True])
@pytest.mark.parametrize("group", [1, 4])
def test_plain_int8_matches_pallas_kernel(window, start, group):
    q, k, v, table, lens, st, ks, vs = _case(
        2, int8=True, hq=2 * group, start=start)
    j = paged_attention_int8_pallas(
        _j(q), _j(k), _j(v), _j(table), _j(lens), _j(ks), _j(vs),
        q_scale=J_Q_SCALE, window=window, start=_j(st), interpret=True)
    t = paged_attention_int8_dequant_ref(
        _t(q), _t(k), _t(v), _t(table), _t(lens), k_scale=_t(ks),
        v_scale=_t(vs), window=window, start=_t(st))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)
    assert np.all(t.numpy()[0] == 0.0)
    o = ops.paged_attention_int8(_t(q), _t(k), _t(v), _t(table), _t(lens),
                                 k_scale=_t(ks), v_scale=_t(vs),
                                 window=window, start=_t(st))
    assert torch.equal(o, t)


def test_gather_kv_block_order_is_position_order():
    _, k, _, table, _, _, _, _ = _case(3, int8=False)
    g = gather_kv(_t(k), _t(table)).numpy()
    blk = k.shape[2]
    for row in range(table.shape[0]):
        for p in (0, blk - 1, blk, 3 * blk + 2):
            np.testing.assert_array_equal(
                g[row, :, p], k[table[row, p // blk], :, p % blk])


def test_ops_reject_bad_inputs():
    q, k, v, table, lens, _, ks, vs = _case(4, int8=True)
    with pytest.raises(ValueError, match="float pools"):
        ops.paged_attention(_t(q), _t(k), _t(v), _t(table), _t(lens))
    qf, kf, vf, *_ = _case(4, int8=False)
    with pytest.raises(ValueError, match="int8 pools"):
        ops.paged_attention_int8(_t(qf), _t(kf), _t(vf), _t(table), _t(lens))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        ops.paged_attention(_t(qf[:, :3]), _t(kf), _t(vf), _t(table),
                            _t(lens))
