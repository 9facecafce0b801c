"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: each test decides inside itself whether a card is present
and skips, with its reason, when there is none. On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX: the machine with the card has none.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import make_cluster
from repro_torch.kernels import _build
from repro_torch.kernels.race_lookup import ops, race_lookup as kern
from repro_torch.kernels.race_lookup.ref import (
    make_table, race_lookup_ref, race_lookup_sharded_ref)
from repro_torch.kernels.serverless_stage import ops as stage_ops
from repro_torch.kernels.serverless_stage.ref import chunk_gather_ref
from repro_torch.kernels.serverless_stage.stage import chunk_gather_cuda
from repro_torch.kvs import DeviceRaceTable, ShardedDeviceRaceTable
from repro_torch.serverless import (ChainRunner, ContainerPool,
                                    default_registry, expected_outputs)

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


def _gather_same(cuda, src, rows, valid, chunk=128):
    src = src if isinstance(src, torch.Tensor) \
        else torch.from_numpy(src).to(cuda)
    rows, valid = (torch.tensor(a, dtype=torch.int32, device=cuda)
                   for a in (rows, valid))
    got = chunk_gather_cuda(src, rows, valid, chunk=chunk)
    want = chunk_gather_ref(src, rows, valid, chunk=chunk)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (len(rows), chunk)
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("nsrc,nout,chunk", [
    (1, 0, 128), (1, 1, 128), (1, 9, 128), (7, 1, 128), (33, 77, 128),
    (300, 1001, 128), (5, 13, 6), (4, 9, 36), (3, 5, 1), (9, 40, 4)])
def test_chunk_gather_kernel_equals_plain(cuda, nsrc, nout, chunk):
    """Ragged NOUT, valid 0 / 1 / half / chunk-1 / chunk / above / negative,
    repeated rows and ids outside [0, NSRC)."""
    rng = np.random.default_rng(nsrc * 1000 + nout)
    src = rng.integers(-2 ** 31, 2 ** 31, (nsrc, chunk),
                       dtype=np.int64).astype(np.int32)
    rows = rng.integers(-nsrc - 3, nsrc + 3, nout)
    valid = rng.choice([0, 1, chunk // 2, chunk - 1, chunk, chunk + 1,
                        4 * chunk, -1, -chunk], nout)
    _gather_same(cuda, src, rows, valid, chunk)


@pytest.mark.parametrize("v", [0, 1, 64, 127, 128, 129, -1, -2 ** 31])
def test_chunk_gather_valid_edges_and_repeated_rows(cuda, v):
    src = np.arange(4 * 128, dtype=np.int32).reshape(4, 128) + 1
    got = _gather_same(cuda, src, [2, 2, 0, 3, 2], [v] * 5)
    assert int((got != 0).sum(1).max()) == min(max(v, 0), 128)


def test_chunk_gather_out_of_range_ids_and_unaligned_source(cuda):
    src = np.arange(4 * 128, dtype=np.int32).reshape(4, 128) + 1
    ids = [-1, -4, -5, -2 ** 31, 4, 5, 2 ** 31 - 1, 0, 3]
    got = _gather_same(cuda, src, ids, [128] * len(ids))
    want = torch.from_numpy(src[[3, 0, 0, 0, 3, 3, 3, 0, 3]]).to(cuda)
    assert torch.equal(got, want)
    flat = torch.arange(1, 6 * 128 + 2, dtype=torch.int32, device=cuda)
    _gather_same(cuda, flat[1:].view(6, 128), [5, 0, -1, 9],
                 [128, 3, 130, 0])             # the scalar path


def test_chunk_gather_refuses_an_empty_source_and_counts_launches(cuda):
    src = torch.ones((3, 128), dtype=torch.int32, device=cuda)
    rows = torch.zeros(2, dtype=torch.int32, device=cuda)
    _build.launches.clear()
    stage_ops.chunk_gather(src, rows, rows)
    stage_ops.chunk_gather(src, rows, rows, impl="ref")
    chunk_gather_cuda(src, rows[:0], rows[:0])            # NOUT 0: no launch
    with pytest.raises(ValueError, match="no rows"):
        chunk_gather_cuda(src[:0], rows, rows)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"chunk_gather": 1}


@pytest.mark.parametrize("lengths", [[0], [1], [127, 128, 129],
                                     [0, 1, 127, 128, 129, 513],
                                     [513] * 16 + [1, 0]])
def test_stage_pack_unpack_on_the_card_equal_the_cpu(cuda, lengths):
    rng = np.random.default_rng(len(lengths))
    lmax = max(lengths)
    payloads = rng.integers(-2 ** 31, 2 ** 31, (len(lengths), lmax),
                            dtype=np.int64).astype(np.int32)
    slab, starts = stage_ops.stage_pack(payloads, lengths, device=cuda)
    cslab, cstarts = stage_ops.stage_pack(payloads, lengths, device="cpu")
    assert np.array_equal(slab, cslab) and np.array_equal(starts, cstarts)
    out = stage_ops.stage_unpack(slab, lengths, lmax, device=cuda)
    assert np.array_equal(out, stage_ops.stage_unpack(cslab, lengths, lmax,
                                                      device="cpu"))
    for i, n in enumerate(lengths):
        assert np.array_equal(out[i, :n], payloads[i, :n])
        assert not out[i, n:].any()


def test_krcore_chain_epoch_on_the_card_equals_the_cpu(cuda):
    chain = ("extract", "transform", "load")
    rng = np.random.default_rng(4)
    payloads = [rng.integers(0, 256, n, dtype=np.uint8)
                for n in rng.integers(1, 5000, 24)]
    reports = {}
    for device in (cuda, "cpu"):
        cluster = make_cluster(n_nodes=3, n_meta=1)
        reg = default_registry(payload_bytes=5000)
        runner = ChainRunner(cluster, reg, ContainerPool(cluster, "krcore"),
                             "krcore", slab_payloads=16, device=device)
        _build.launches.clear()
        rep = cluster.env.run_process(runner.run_batch(
            chain, ["n0", "n1", "n2"], len(payloads), payloads), "chain")
        # two hops, each one pack and one unpack per slab (two slabs)
        assert _build.launches["chunk_gather"] == (8 if device == cuda
                                                   else 0)
        exp = expected_outputs(reg, chain, payloads)
        assert all(np.array_equal(a, b) for a, b in zip(rep.outputs, exp))
        reports[str(device)] = (rep.total_us, rep.transfer_us,
                                [vars(h) for h in rep.hops])
    assert reports[str(cuda)] == reports["cpu"]
