"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: each test decides inside itself whether a card is present
and skips, with its reason, when there is none. On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX: the machine with the card has none.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.race_lookup import ops, race_lookup as kern
from repro_torch.kernels.race_lookup.ref import (
    make_table, race_lookup_ref, race_lookup_sharded_ref)
from repro_torch.kvs import DeviceRaceTable, ShardedDeviceRaceTable

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _inputs(cuda, nb, nslot, vdim, nq, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.choice(np.arange(1, 20_000), size=nb * nslot // 3,
                      replace=False)
    vals = rng.standard_normal((len(keys), vdim)).astype(np.float32)
    fp, vt, prep = make_table(nb, nslot, vdim, keys, vals)
    qk = rng.choice(np.concatenate([keys, np.arange(30_000, 30_100)]), nq)
    fps, bidx = prep(qk)
    bidx[::5] = rng.integers(-4, nb + 4, bidx[::5].shape)   # clamped ids
    return (torch.from_numpy(fp).to(cuda),
            torch.from_numpy(vt).to(cuda, dtype),
            torch.from_numpy(fps).to(cuda), torch.from_numpy(bidx).to(cuda))


def _assert_same(got, want):
    torch.cuda.synchronize()
    assert got[0].dtype == want[0].dtype and got[1].dtype == torch.int32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("nslot,vdim,dtype", [
    (4, 64, torch.float32), (8, 256, torch.float32), (16, 128, torch.float32),
    (32, 32, torch.float32), (8, 256, torch.bfloat16),
    (8, 33, torch.bfloat16), (4, 3, torch.float32)])
@pytest.mark.parametrize("nq,qblock", [(0, 8), (1, 8), (7, 8), (65, 64),
                                       (1000, 32)])
def test_tiled_and_scalar_kernels_equal_plain(cuda, nslot, vdim, dtype, nq,
                                              qblock):
    fp, vt, q, b = _inputs(cuda, 64, nslot, vdim, nq, dtype)
    want = race_lookup_ref(fp, vt, q, b)
    _assert_same(kern.race_lookup_tiled(fp, vt, q, b, qblock=qblock), want)
    _assert_same(kern.race_lookup_scalar(fp, vt, q, b), want)


@pytest.mark.parametrize("counts", [[0, 0, 0], [0, 9, 40], [300, 0, 1]])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_kernel_equals_plain(cuda, counts, dtype):
    rng = np.random.default_rng(sum(counts))
    ns, nb = len(counts), 32
    parts = [_inputs(cuda, nb, 8, 48, 400, dtype, seed=s) for s in range(ns)]
    fp = torch.stack([p[0] for p in parts])
    vt = torch.stack([p[1] for p in parts])
    sidx = np.repeat(np.arange(ns), counts).astype(np.int32)
    rng.shuffle(sidx)
    pick = rng.integers(0, 400, len(sidx))
    q = torch.stack([parts[s][2][i] for s, i in zip(sidx, pick)]) \
        if len(sidx) else torch.zeros(0, dtype=torch.int32, device=cuda)
    b = torch.stack([parts[s][3][i] for s, i in zip(sidx, pick)]) \
        if len(sidx) else torch.zeros((0, 2), dtype=torch.int32, device=cuda)
    s_t = torch.from_numpy(sidx).to(cuda)
    want = race_lookup_sharded_ref(fp, vt, q, b, s_t)
    _assert_same(kern.race_lookup_sharded(fp, vt, q, b, s_t, qblock=16),
                 want)
    _assert_same(ops.race_lookup_sharded(fp, vt, q, b, s_t, impl="scalar"),
                 want)


def test_launch_counters_count_kernel_launches_only(cuda):
    fp, vt, q, b = _inputs(cuda, 64, 8, 64, 100)
    _build.launches.clear()
    ops.race_lookup(fp, vt, q, b)
    ops.race_lookup(fp, vt, q, b, impl="scalar")
    ops.race_lookup(fp, vt, q, b, impl="ref")
    kern.race_lookup_tiled(fp, vt, q[:0], b[:0])          # NQ = 0: no launch
    ops.race_lookup_sharded(fp[None], vt[None], q, b, torch.zeros_like(q))
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"race_lookup_tiled": 1,
                                     "race_lookup_scalar": 1,
                                     "race_lookup_sharded": 1}
    with pytest.raises(IndexError):
        ops.race_lookup_sharded(fp[None], vt[None], q, b, torch.ones_like(q))
    assert _build.launches["race_lookup_sharded"] == 1


def test_tables_on_the_card_match_plain_and_ground_truth(cuda):
    rng = np.random.default_rng(7)
    keys = rng.permutation(np.unique(rng.integers(10_000, 2 ** 32 - 1,
                                                   3500)))[:3000]
    vals = rng.standard_normal((len(keys), 64), dtype=np.float32)
    for table in (DeviceRaceTable(2039, 8, 64),
                  ShardedDeviceRaceTable(4, 509, 8, 64)):
        assert table.device.type == "cuda"
        for k, v in zip(keys.tolist(), vals):
            table.insert(k, v)
        qk = np.concatenate([keys[:700], np.arange(5, 105)])
        plain = table.lookup_batch(qk, impl="ref")
        for impl in ("kernel", "scalar"):
            got = table.lookup_batch(qk, impl=impl)
            _assert_same(got, plain)
            assert bool(got[1][:700].all()) and not got[1][700:].any()
            assert torch.equal(got[0][:700],
                               torch.from_numpy(vals[:700]).to(cuda))
