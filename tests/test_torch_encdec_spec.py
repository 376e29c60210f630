"""PyTorch port vs JAX reference: speculative decoding on the encdec
family.

Greedy streams of the port's paged ``LLMEngine`` against the synchronised
JAX engine on ``whisper-small-smoke`` (float32, float and int8 pools, the
workload of ``test_torch_encdec_serve``: two clips, a shared two-block
decoder prefix), ``spec_tokens`` 1 (prefix cache off) and 3 (on): the
verify step (B4 / B5's plain versions, the cross-attention folded per
row) commits the reference's tokens, and the acceptance counters agree.
Chunked prefill is in ``test_torch_encdec_chunked.py``.
"""

import pytest
import torch

from test_torch_encdec_serve import assert_drained, identity_cell

torch.set_num_threads(1)


@pytest.mark.parametrize("k,prefix", [(1, False), (3, True)],
                         ids=["spec1", "spec3-cache-on"])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_spec_identity_with_reference(quant, k, prefix):
    je, te, _ = identity_cell(quant, spec_tokens=k, prefix_cache=prefix)
    assert te._spec == k
    m, jm = te.metrics(), je.metrics()
    for key in ("spec_drafted", "spec_accepted", "iterations"):
        assert m[key] == jm[key], key
    assert_drained(te)
