"""PyTorch port vs JAX reference: paged serving end to end, int8 pools.

Quantized archs (``serve_quant``, the default) serve from int8 block pools
with W8A8 decode projections. The port implements the contract of the
reference's int8 *kernel* (f32 flash softmax over exact int8 score dots,
``paged_attention_int8_dequant_ref``), which is what the reference's TPU
path runs; the reference's default CPU backend (``xla``) runs the ITA
integer softmax instead, a different function whose streams part from the
kernel's within a few tokens. So the JAX anchor here is the engine with
``attn_backend="interpret"`` — the Pallas int8 kernel run on the CPU.
"""

import pytest
import torch

from test_torch_serve import CONFIGS, serve_both

torch.set_num_threads(1)


@pytest.mark.parametrize("scheduler", ["bounded", "fcfs"])
@pytest.mark.parametrize("name", CONFIGS)
def test_greedy_identity_int8_pools(name, scheduler):
    jreqs, treqs, te = serve_both(name, quant=True, scheduler=scheduler)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [r.preemptions for r in treqs] == [r.preemptions for r in jreqs]
    assert all(len(r.output) == 10 for r in treqs)
    if scheduler == "bounded":
        assert sum(r.preemptions for r in treqs) >= 1
    assert te.qparams is not None and te.quantized
    assert te.cache["stacks"][0]["k"].dtype == torch.int8
    assert te.alloc.live_blocks == 0
