"""PyTorch port vs JAX reference: the moe family with chunked prefill.

Greedy streams, preemptions and every metric not read off the host clock
of the port's engine equal the synchronised JAX engine's on
``qwen3-moe-30b-a3b-smoke`` in float32 (``test_torch_moe_serve.
identity_cell``; int8 pools anchored on ``attn_backend="interpret"``) with
chunks of one and two blocks, prefix cache off and on. Each chunk is sent
as its exact tokens and routes as a group of its own in both packages, so
they agree at ``moe_capacity`` 1.25, where two-block chunks drop slots, as
at ``n_experts``.
"""

import pytest
import torch

from test_torch_moe_serve import N_EXPERTS, identity_cell
from test_torch_spec import BLK, ENGINE_KW, spec_prompts

torch.set_num_threads(1)


@pytest.mark.parametrize("chunk,quant,prefix,capacity", [
    (1, False, False, 1.25), (2, False, False, 1.25), (1, True, False, 1.25),
    (2, True, False, 1.25), (2, True, True, 1.25),
    (1, False, True, N_EXPERTS)], ids=lambda v: str(v))
def test_chunked_identity_with_reference(chunk, quant, prefix, capacity):
    prompts = spec_prompts(512, seed=2)
    _, m, dropped = identity_cell(
        quant, prompts, dict(ENGINE_KW, prefill_chunk_tokens=chunk * BLK,
                             prefix_cache=prefix), moe_capacity=capacity)
    assert m["prefill_chunks_dispatched"] > len(prompts)
    # an expert takes at most one slot a token, so a one-block chunk (8
    # tokens, capacity 8) never drops; two-block chunks (capacity 8 for 16
    # tokens) do at 1.25
    assert (dropped > 0) == (capacity == 1.25 and chunk == 2)
    if prefix:
        assert m["prefix_cache_hit_blocks"] > 0
