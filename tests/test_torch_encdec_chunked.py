"""PyTorch port vs JAX reference: chunked prefill on the encdec family.

Greedy streams of the port's paged ``LLMEngine`` against the synchronised
JAX engine on ``whisper-small-smoke`` (float32, float and int8 pools, the
workload of ``test_torch_encdec_serve``), prefills in chunks of 1, 2 and
4 blocks (prefix cache on at 2): every chunk reruns the encoder over the
whole clip and resumes the decoder prompt after the blocks already
written, as the reference does; the chunk counts agree.
"""

import pytest
import torch

from test_torch_encdec_serve import BLK, assert_drained, identity_cell

torch.set_num_threads(1)


@pytest.mark.parametrize("blocks,prefix", [(1, False), (2, True), (4, False)],
                         ids=["chunk1", "chunk2-cache-on", "chunk4"])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_chunked_identity_with_reference(quant, blocks, prefix):
    je, te, reqs = identity_cell(quant, prefill_chunk_tokens=blocks * BLK,
                                 prefix_cache=prefix)
    m, jm = te.metrics(), je.metrics()
    assert m["prefill_chunks_dispatched"] == jm["prefill_chunks_dispatched"]
    assert m["prefill_chunks_dispatched"] > len(reqs)
    assert_drained(te)
