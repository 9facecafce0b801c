"""The port's data pipeline against ``repro.data``: ``SyntheticLM`` batches
(at steps 0 and 7, and after ``seek``) and ``pack_documents`` on ragged
documents are equal bit for bit; the device feed keeps them so."""

import numpy as np
import pytest
import torch

from repro.data import SyntheticLM as JSyntheticLM
from repro.data import pack_documents as jpack
from repro_torch.data import (SyntheticLM, make_batch_iterator,
                              pack_documents, to_device)


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype == np.int32
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("vocab,seq,batch,seed", [(97, 32, 4, 5),
                                                  (151_936, 256, 2, 0),
                                                  (65_536, 64, 3, 11)])
def test_synthetic_batches_equal_jax(vocab, seq, batch, seed):
    ours, ref = (cls(vocab, seq, batch, seed=seed)
                 for cls in (SyntheticLM, JSyntheticLM))
    got = [next(ours) for _ in range(8)]
    want = [next(ref) for _ in range(8)]
    for i in (0, 7):
        _same(got[i], want[i])
    ours.seek(123)
    ref.seek(123)
    _same(next(ours), next(ref))
    ours.seek(7)
    _same(next(ours), want[7])


@pytest.mark.parametrize("lengths,seq_len", [([5, 3, 10], 8),
                                             ([1, 1, 1], 4),
                                             ([17, 2, 9, 30, 4], 16),
                                             ([8, 8], 8)])
def test_pack_documents_equals_jax(lengths, seq_len):
    rng = np.random.RandomState(sum(lengths))
    docs = [rng.randint(1, 500, n) for n in lengths]
    _same(pack_documents(docs, seq_len), jpack(docs, seq_len))
    _same(pack_documents(docs, seq_len, pad_id=7),
          jpack(docs, seq_len, pad_id=7))


def test_to_device_and_iterator_keep_the_batches():
    src = SyntheticLM(97, 16, 2, seed=1)
    want = [next(SyntheticLM(97, 16, 2, seed=1)) for _ in range(1)]
    placed = to_device(want[0], "cpu")
    assert all(t.dtype == torch.int32 and t.device.type == "cpu"
               for t in placed.values())
    np.testing.assert_array_equal(placed["tokens"].numpy(),
                                  want[0]["tokens"])
    ref = SyntheticLM(97, 16, 2, seed=1)
    for prefetch in (0, 2):
        src.seek(0)
        it = make_batch_iterator(
            (next(src) for _ in range(5)), device="cpu", prefetch=prefetch)
        got = list(it)
        ref.seek(0)
        assert len(got) == 5
        for g in got:
            w = next(ref)
            assert isinstance(g["tokens"], torch.Tensor)
            np.testing.assert_array_equal(g["tokens"].numpy(), w["tokens"])
    host = list(make_batch_iterator(iter([want[0]])))
    assert host[0] is want[0]           # no device: left on the host


def test_iterator_reraises_the_sources_error():
    def source():
        yield {"tokens": np.zeros((1, 2), np.int32)}
        raise RuntimeError("source failed")

    it = make_batch_iterator(source(), device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="source failed"):
        next(it)


def test_to_device_defaults_to_the_card():
    batch = {"tokens": np.zeros((1, 2), np.int32)}
    if torch.cuda.is_available():
        assert to_device(batch)["tokens"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            to_device(batch)
