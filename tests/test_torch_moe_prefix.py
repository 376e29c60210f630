"""PyTorch port vs JAX reference: the moe family on the paged backend with
the prefix cache, and on ring pools.

Greedy streams, preemptions and every metric not read off the host clock
of the port's engine equal the synchronised JAX engine's on
``qwen3-moe-30b-a3b-smoke`` in float32 (``test_torch_moe_serve.
identity_cell``; int8 pools anchored on ``attn_backend="interpret"``):

* the prefix cache at ``moe_capacity`` 1.25, where prefill drops slots,
  and at ``n_experts``, where none drop: a resumed suffix routes as a
  group of its own in both packages, so they agree whether or not the
  capacity binds;
* the ``GL`` layout (a global layer, a sliding-window layer and a global
  tail layer) with window 16 under ``max_len`` 64, on ring pools.
"""

import pytest
import torch

from test_torch_moe_serve import N_EXPERTS, identity_cell
from test_torch_serve import prompts_for
from test_torch_spec import ENGINE_KW, spec_prompts

torch.set_num_threads(1)


@pytest.mark.parametrize("capacity", [1.25, N_EXPERTS],
                         ids=["cap1.25", "cap-n_experts"])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_prefix_cache_identity_with_reference(quant, capacity):
    _, m, dropped = identity_cell(quant, spec_prompts(512, seed=2),
                                  dict(ENGINE_KW, prefix_cache=True),
                                  moe_capacity=capacity)
    assert m["prefix_cache_hit_blocks"] > 0 and m["prefill_skip_rate"] > 0
    assert (dropped > 0) == (capacity == 1.25)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_ring_layout_identity_with_reference(quant):
    """``GL`` with three layers (a global tail) and window 16 under
    ``max_len`` 64: the sliding-window layer keeps ring blocks; prompts
    longer than the window."""
    te, _, dropped = identity_cell(quant, prompts_for(512, n=6, seed=3),
                                   dict(slots=4, max_len=64, admit_window=2,
                                        block_len=4),
                                   pattern="GL", n_layers=3)
    assert te.backend.ring and dropped > 0


