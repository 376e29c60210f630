"""PyTorch port vs JAX reference: the step-indexed data pipeline
(``data/pipeline.py``).

Batches are numpy on both sides, so the contract is bit equality with
``repro.data.pipeline.batch_for_step`` for every (seed, step, row): the
synthetic Zipf stream over several seeds, vocabularies and shapes, and a
``ByteCorpus`` over a file shorter and one longer than a step's window
(the window wraps). ``device_batch`` gives the same tokens as an int64
tensor, on ``cuda`` unless the caller asks for the CPU.
"""

import numpy as np
import pytest
import torch

from repro.data import pipeline as jdata
from repro_torch.data import pipeline as tdata

STEPS = (0, 1, 2, 17, 1000)


@pytest.mark.parametrize("seed,vocab,seq,batch", [
    (0, 512, 32, 4), (1, 512, 32, 4), (3, 100, 16, 4),
    (0, 32064, 128, 8), (7, 151936, 64, 2), (12345, 256, 1, 3),
])
def test_synthetic_batches_bit_equal_reference(seed, vocab, seq, batch):
    kw = dict(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed)
    for step in STEPS:
        want = jdata.batch_for_step(jdata.DataConfig(**kw), step)
        got = tdata.batch_for_step(tdata.DataConfig(**kw), step)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert got.min() >= 0 and got.max() < vocab


@pytest.mark.parametrize("nbytes", [37, 5000])
def test_byte_corpus_batches_bit_equal_reference(tmp_path, nbytes):
    path = tmp_path / "corpus.txt"
    rng = np.random.default_rng(nbytes)
    path.write_bytes(rng.integers(0, 256, nbytes).astype(np.uint8).tobytes())
    kw = dict(vocab=256, seq_len=24, global_batch=3, seed=0)
    jc, tc = jdata.ByteCorpus(str(path)), tdata.ByteCorpus(str(path))
    for step in STEPS:
        np.testing.assert_array_equal(
            tdata.batch_for_step(tdata.DataConfig(**kw), step, tc),
            jdata.batch_for_step(jdata.DataConfig(**kw), step, jc))


def test_batches_are_a_function_of_seed_and_step():
    cfg = tdata.DataConfig(vocab=100, seq_len=16, global_batch=4, seed=3)
    a, b = tdata.batch_for_step(cfg, 5), tdata.batch_for_step(cfg, 5)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, tdata.batch_for_step(cfg, 6))
    other = tdata.DataConfig(vocab=100, seq_len=16, global_batch=4, seed=4)
    assert not np.array_equal(a, tdata.batch_for_step(other, 5))


def test_device_batch_is_an_int64_tensor_on_the_device(monkeypatch):
    cfg = tdata.DataConfig(vocab=512, seq_len=9, global_batch=2, seed=1)
    t = tdata.device_batch(cfg, 4, "cpu")
    assert t.dtype == torch.int64 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), jdata.batch_for_step(
        jdata.DataConfig(vocab=512, seq_len=9, global_batch=2, seed=1), 4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdata.device_batch(cfg, 4)
