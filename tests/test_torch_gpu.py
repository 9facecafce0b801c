"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: each test decides inside itself whether a card is present
and skips, with its reason, when there is none. On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX: the machine with the card has none.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import make_cluster
from repro_torch.dkv import DkvClient, DkvService
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.flash_attention import (
    MMA_TILE, flash_attention_cuda, flash_route, launches_by_shape)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6.ref import wkv_chunked_ref, wkv_sequential
from repro_torch.kernels.rwkv6.rwkv6 import wkv_cuda
from repro_torch.kernels.race_lookup import ops, race_lookup as kern
from repro_torch.kernels.race_lookup.ref import (
    make_table, race_lookup_ref, race_lookup_sharded_ref)
from repro_torch.kernels.serverless_stage import ops as stage_ops
from repro_torch.kernels.serverless_stage.ref import chunk_gather_ref
from repro_torch.kernels.serverless_stage import stage
from repro_torch.kernels.serverless_stage.stage import chunk_gather_cuda
from repro_torch.kvs import DeviceRaceTable, ShardedDeviceRaceTable
from repro_torch import obs
from repro_torch.launch import steps
from repro_torch.models import decode_step, forward_full, init_params, prefill
from repro_torch.serverless import (ChainRunner, ContainerPool,
                                    default_registry, expected_outputs)
from repro_torch.tree import tree_leaves

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
    hq, hb = q.cpu().numpy(), b.cpu().numpy()
    _build.launches.clear()
    for routing in ((q, b), (hq, hb)):            # on the card, on the host
        ops.race_lookup(fp, vt, *routing)
        ops.race_lookup(fp, vt, *routing, impl="scalar")
        ops.race_lookup(fp, vt, *routing, impl="ref")
    kern.race_lookup_tiled(fp, vt, q[:0], b[:0])          # NQ = 0: no launch
    kern.race_lookup_scalar(fp, vt, hq[:0], hb[:0])
    ops.race_lookup_sharded(fp[None], vt[None], q, b, torch.zeros_like(q))
    ops.race_lookup_sharded(fp[None], vt[None], hq, hb, np.zeros_like(hq),
                            impl="scalar")
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"race_lookup_tiled": 1,
                                     "race_lookup_scalar": 1,
                                     "race_lookup_tiled_byval": 1,
                                     "race_lookup_scalar_byval": 2,
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
        # two hops, each one pack and one unpack per slab (two slabs), all
        # on the by-value route: the planners' routing stays on the host
        assert dict(_build.launches) == ({"chunk_gather_byval": 8}
                                         if device == cuda else {})
        exp = expected_outputs(reg, chain, payloads)
        assert all(np.array_equal(a, b) for a, b in zip(rep.outputs, exp))
        reports[str(device)] = (rep.total_us, rep.transfer_us,
                                [vars(h) for h in rep.hops])
    assert reports[str(cuda)] == reports["cpu"]


# ------------------------------------- the by-value and device routes
def _launched(fn):
    """Run ``fn``; return its result and the launches it made."""
    _build.launches.clear()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(_build.launches)


def _sharded_case(cuda, nslot, nq, dtype, ns=3, nb=16, vdim=256, seed=0):
    """Random fingerprints from a small range (slots repeat, many are
    empty), bucket ids partly out of range, ragged shards."""
    rng = np.random.default_rng(seed)
    fp = torch.from_numpy(rng.integers(0, 40, (ns, nb, nslot))
                          .astype(np.int32)).to(cuda)
    vt = torch.from_numpy(rng.standard_normal((ns, nb, nslot, vdim))
                          .astype(np.float32)).to(cuda, dtype)
    q = rng.integers(0, 40, nq).astype(np.int32)
    b = rng.integers(-3, nb + 3, (nq, 2)).astype(np.int32)
    s = rng.choice(ns, nq, p=[0.7, 0.3] + [0.0] * (ns - 2)).astype(np.int32)
    return fp, vt, (q, b, s)


def _both_sharded_routes(cuda, fp, vt, host, qblock=kern.QBLOCK):
    card = tuple(torch.from_numpy(a).to(cuda) for a in host)
    want = race_lookup_sharded_ref(fp, vt, *card)
    nq = len(host[0])
    for on_host, args in ((True, host), (False, card)):
        got, ran = _launched(lambda: kern.race_lookup_sharded(
            fp, vt, *args, qblock=qblock))
        _assert_same(got, want)
        assert ran == {kern.route("sharded", on_host, nq): 1}
    return want


CAP = kern.BYVAL_CAP


@pytest.mark.parametrize("nslot", [4, 8, 16, 32])
@pytest.mark.parametrize("nq", [1, 7, CAP - 1, CAP, CAP + 1])
def test_sharded_routes_equal_plain(cuda, nslot, nq):
    """Both routes at every NSLOT (4 and 8 pair two queries a warp, so an
    odd NQ leaves a half warp idle) and around the by-value cap; bfloat16
    values at NSLOT 8."""
    dtype = torch.bfloat16 if nslot == 8 else torch.float32
    fp, vt, host = _sharded_case(cuda, nslot, nq, dtype, seed=nslot + nq)
    want = _both_sharded_routes(cuda, fp, vt, host)
    assert 0 < int(want[1].sum()) or nq < 8


@pytest.mark.parametrize("qblock", [1, 3, 7, 64])
@pytest.mark.parametrize("nslot", [8, 16])
def test_sharded_routes_take_any_qblock(cuda, qblock, nslot):
    fp, vt, host = _sharded_case(cuda, nslot, 301, torch.float32, seed=qblock)
    _both_sharded_routes(cuda, fp, vt, host, qblock=qblock)


@pytest.mark.parametrize("vdim,dtype", [(33, torch.bfloat16),
                                        (3, torch.float32),
                                        (48, torch.float32)])
def test_sharded_routes_copy_any_row_size(cuda, vdim, dtype):
    """Rows that are not a multiple of 16 bytes take narrower copy units."""
    fp, vt, host = _sharded_case(cuda, 8, 257, dtype, vdim=vdim)
    _both_sharded_routes(cuda, fp, vt, host)


def test_sharded_routes_refuse_each_others_routing(cuda):
    fp, vt, (q, b, s) = _sharded_case(cuda, 8, CAP + 1, torch.float32)
    routing = kern.pack_routing(q, b, s)
    card = torch.from_numpy(routing).to(cuda)
    out = torch.empty((CAP + 1, 256), device=cuda)
    found = torch.empty(CAP + 1, dtype=torch.int32, device=cuda)
    lib = kern._lib()
    stream = torch.cuda.current_stream().cuda_stream

    def call(symbol, ptr, nq):
        _build.launch(lib, symbol, fp.data_ptr(), vt.data_ptr(), ptr,
                      out.data_ptr(), found.data_ptr(), nq, 3, 16, 8,
                      256 * 4, kern.QBLOCK, stream)

    _build.launches.clear()
    for symbol, ptr, nq in (
            ("race_lookup_sharded_byval", card.data_ptr(), 64),  # on card
            ("race_lookup_sharded_byval", routing.ctypes.data, CAP + 1),
            ("race_lookup_sharded", routing.ctypes.data, 64)):   # on host
        with pytest.raises(RuntimeError, match="invalid argument"):
            call(symbol, ptr, nq)
    assert not _build.launches
    call("race_lookup_sharded_byval", routing.ctypes.data, CAP)
    call("race_lookup_sharded", card.data_ptr(), CAP + 1)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"race_lookup_sharded_byval": 1,
                                     "race_lookup_sharded": 1}


def test_sharded_ops_route_by_where_the_routing_lies(cuda):
    fp, vt, host = _sharded_case(cuda, 8, CAP + 1, torch.float32)
    small = tuple(a[:512] for a in host)
    counts = {}
    for args in (small, host, tuple(torch.from_numpy(a).to(cuda)
                                    for a in small)):
        _, ran = _launched(lambda: ops.race_lookup_sharded(fp, vt, *args))
        counts.update({k: counts.get(k, 0) + n for k, n in ran.items()})
    _, ran = _launched(lambda: ops.race_lookup_sharded(
        fp, vt, *(a[:0] for a in host)))                 # NQ = 0
    assert not ran
    assert counts == {"race_lookup_sharded_byval": 1,
                      "race_lookup_sharded": 2}
    with pytest.raises(IndexError):                      # shard id 3 of 3
        ops.race_lookup_sharded(fp, vt, *small[:2], small[2] + 3)


def test_sharded_table_lookups_take_the_by_value_route(cuda):
    rng = np.random.default_rng(3)
    keys = rng.permutation(np.unique(rng.integers(10_000, 2 ** 32 - 1,
                                                   3000)))[:2500]
    vals = rng.standard_normal((len(keys), 64), dtype=np.float32)
    table = ShardedDeviceRaceTable(4, 509, 8, 64)
    for k, v in zip(keys.tolist(), vals):
        table.insert(k, v)
    for n, route in ((512, "race_lookup_sharded_byval"),
                     (CAP + 1, "race_lookup_sharded")):
        (v, f), ran = _launched(lambda: table.lookup_batch(keys[:n]))
        assert ran == {route: 1}
        assert bool(f.all())
        assert torch.equal(v, torch.from_numpy(vals[:n]).to(cuda))


# ----------------------- the tiled and scalar kernels' two routes
def _unsharded_case(cuda, nslot, nq, dtype, nb=16, vdim=256, seed=0):
    """As :func:`_sharded_case`, one table."""
    fp, vt, (q, b, _) = _sharded_case(cuda, nslot, nq, dtype, ns=2, nb=nb,
                                      vdim=vdim, seed=seed)
    return fp[1].contiguous(), vt[1].contiguous(), (q, b)


def _both_unsharded_routes(cuda, fp, vt, host, qblock=kern.QBLOCK):
    card = tuple(torch.from_numpy(a).to(cuda) for a in host)
    want = race_lookup_ref(fp, vt, *card)
    nq = len(host[0])
    for on_host, args in ((True, host), (False, card)):
        for kernel, fn in (("tiled", lambda: kern.race_lookup_tiled(
                fp, vt, *args, qblock=qblock)),
                ("scalar", lambda: kern.race_lookup_scalar(fp, vt, *args))):
            got, ran = _launched(fn)
            _assert_same(got, want)
            assert ran == {kern.route(kernel, on_host, nq): 1}
    return want


@pytest.mark.parametrize("nslot", [4, 8, 16, 32])
@pytest.mark.parametrize("nq", [1, 7, CAP - 1, CAP, CAP + 1])
def test_unsharded_routes_equal_plain(cuda, nslot, nq):
    """The tiled and scalar kernels on both routes at every NSLOT and
    around the by-value cap; bfloat16 values at NSLOT 8."""
    dtype = torch.bfloat16 if nslot == 8 else torch.float32
    fp, vt, host = _unsharded_case(cuda, nslot, nq, dtype, seed=nslot + nq)
    want = _both_unsharded_routes(cuda, fp, vt, host)
    assert 0 < int(want[1].sum()) or nq < 8


@pytest.mark.parametrize("qblock", [1, 3, 7, 64])
@pytest.mark.parametrize("nslot", [8, 16])
def test_unsharded_routes_take_any_qblock(cuda, qblock, nslot):
    fp, vt, host = _unsharded_case(cuda, nslot, 301, torch.float32,
                                   seed=qblock)
    _both_unsharded_routes(cuda, fp, vt, host, qblock=qblock)


@pytest.mark.parametrize("vdim,dtype", [(33, torch.bfloat16),
                                        (3, torch.float32),
                                        (48, torch.float32)])
def test_unsharded_routes_copy_any_row_size(cuda, vdim, dtype):
    fp, vt, host = _unsharded_case(cuda, 8, 257, dtype, vdim=vdim)
    _both_unsharded_routes(cuda, fp, vt, host)


def test_unsharded_routes_refuse_each_others_routing(cuda):
    fp, vt, (q, b) = _unsharded_case(cuda, 8, CAP + 1, torch.float32)
    routing = kern.pack_routing(q, b, np.arange(CAP + 1, dtype=np.int32))
    card = torch.from_numpy(routing).to(cuda)
    out = torch.empty((CAP + 1, 256), device=cuda)
    found = torch.empty(CAP + 1, dtype=torch.int32, device=cuda)
    lib = kern._lib()
    stream = torch.cuda.current_stream().cuda_stream

    def call(symbol, ptr, nq):
        dims = (nq, CAP + 1, 16, 8, 256 * 4) if "scalar" in symbol \
            else (nq, 16, 8, 256 * 4, kern.QBLOCK)
        _build.launch(lib, symbol, fp.data_ptr(), vt.data_ptr(), ptr,
                      out.data_ptr(), found.data_ptr(), *dims, stream)

    _build.launches.clear()
    for kernel in ("tiled", "scalar"):
        byval, device = kern.ROUTES[kernel]
        for symbol, ptr, nq in ((byval, card.data_ptr(), 64),   # on card
                                (byval, routing.ctypes.data, CAP + 1),
                                (device, routing.ctypes.data, 64),  # host
                                (byval, routing.ctypes.data, 0),
                                (device, card.data_ptr(), 0)):
            with pytest.raises(RuntimeError, match="invalid argument"):
                call(symbol, ptr, nq)
    assert not _build.launches
    for kernel in ("tiled", "scalar"):
        byval, device = kern.ROUTES[kernel]
        call(byval, routing.ctypes.data, CAP)
        call(device, card.data_ptr(), CAP + 1)
    torch.cuda.synchronize()
    assert dict(_build.launches) == dict.fromkeys(
        [*kern.ROUTES["tiled"], *kern.ROUTES["scalar"]], 1)


def test_scalar_kernel_writes_only_the_rows_its_routing_names(cuda):
    """Each query writes the output row of its routing's fourth word; the
    kernel skips rows outside [0, NOUT), and the wrapper refuses such rows
    in host routing."""
    fp, vt, (q, b) = _unsharded_case(cuda, 8, 40, torch.float32)
    want = race_lookup_ref(fp, vt, *(torch.from_numpy(a).to(cuda)
                                     for a in (q, b)))
    rows = np.random.default_rng(5).permutation(60)[:40].astype(np.int32)
    host = kern.pack_routing(q, b, rows)
    for routing in (host, torch.from_numpy(host).to(cuda)):
        out = (torch.full((60, 256), 7.0, device=cuda),
               torch.full((60,), 9, dtype=torch.int32, device=cuda))
        kern.race_lookup_packed("scalar", fp, vt, routing, out=out)
        _assert_same((out[0][rows], out[1][rows]), want)
        rest = np.setdiff1d(np.arange(60), rows)
        assert bool((out[0][rest] == 7.0).all() and (out[1][rest] == 9).all())
    bad = host.copy()
    bad[[0, 1], 3] = -1, 60
    out = (torch.full((60, 256), 7.0, device=cuda),
           torch.full((60,), 9, dtype=torch.int32, device=cuda))
    with pytest.raises(IndexError):
        kern.race_lookup_packed("scalar", fp, vt, bad, out=out)
    kern.race_lookup_packed("scalar", fp, vt, torch.from_numpy(bad).to(cuda),
                            out=out)
    _assert_same((out[0][rows[2:]], out[1][rows[2:]]),
                 (want[0][2:], want[1][2:]))
    assert bool((out[1][rest] == 9).all())


def test_device_table_lookups_take_the_by_value_route(cuda):
    rng = np.random.default_rng(4)
    keys = rng.permutation(np.unique(rng.integers(10_000, 2 ** 32 - 1,
                                                   3000)))[:2500]
    vals = rng.standard_normal((len(keys), 64), dtype=np.float32)
    table = DeviceRaceTable(2039, 8, 64)
    for k, v in zip(keys.tolist(), vals):
        table.insert(k, v)
    for n, impl, route in ((512, "kernel", "race_lookup_tiled_byval"),
                           (CAP + 1, "kernel", "race_lookup_tiled"),
                           (512, "scalar", "race_lookup_scalar_byval"),
                           (CAP + 1, "scalar", "race_lookup_scalar")):
        (v, f), ran = _launched(lambda: table.lookup_batch(keys[:n],
                                                           impl=impl))
        assert ran == {route: 1}
        assert bool(f.all())
        assert torch.equal(v, torch.from_numpy(vals[:n]).to(cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_scalar_launches_one_kernel_a_shard(cuda, dtype):
    """``impl="scalar"``: one ``race_lookup_scalar_byval`` a shard with
    queries, for routing on the host or on the card (read back once); a
    shard with more than the cap takes the device route."""
    fp, vt, host = _sharded_case(cuda, 8, 900, dtype, ns=5)
    host[2][:4] = [2, 2, 3, 4]                    # shard 1 gets no query
    host[2][host[2] == 1] = 0
    want = race_lookup_sharded_ref(fp, vt, *(torch.from_numpy(a).to(cuda)
                                             for a in host))
    for routing in (host, tuple(torch.from_numpy(a).to(cuda)
                                for a in host)):
        got, ran = _launched(lambda: ops.race_lookup_sharded(
            fp, vt, *routing, impl="scalar"))
        _assert_same(got, want)
        assert ran == {"race_lookup_scalar_byval": 4}
    fp, vt, host = _sharded_case(cuda, 8, CAP + 40, dtype, seed=1)
    host[2][:CAP + 20] = 0                        # shard 0 above the cap
    host[2][-1] = 1
    want = race_lookup_sharded_ref(fp, vt, *(torch.from_numpy(a).to(cuda)
                                             for a in host))
    got, ran = _launched(lambda: ops.race_lookup_sharded(fp, vt, *host,
                                                         impl="scalar"))
    _assert_same(got, want)
    assert ran == {"race_lookup_scalar": 1, "race_lookup_scalar_byval": 1}


GCAP = stage.BYVAL_CAP


def _both_gather_routes(cuda, src, rows, valid, chunk=128):
    src = src if isinstance(src, torch.Tensor) \
        else torch.from_numpy(src).to(cuda)
    host = [np.asarray(a, np.int32) for a in (rows, valid)]
    card = [torch.from_numpy(a).to(cuda) for a in host]
    want = chunk_gather_ref(src, *card, chunk=chunk)
    for on_host, routing in ((True, host), (False, card)):
        got, ran = _launched(lambda: chunk_gather_cuda(src, *routing,
                                                       chunk=chunk))
        assert torch.equal(got, want)
        assert ran == ({stage.gather_route(on_host, len(rows)): 1}
                       if len(rows) else {})
    return want


@pytest.mark.parametrize("nout", [0, 1, 9, GCAP - 1, GCAP, GCAP + 1])
@pytest.mark.parametrize("chunk", [128, 4, 6])
def test_chunk_gather_routes_equal_plain(cuda, nout, chunk):
    """Ragged NOUT around the by-value cap, every valid edge, repeated rows
    and ids outside [0, NSRC); chunks of 4 and 6 take the scalar path."""
    rng = np.random.default_rng(nout + chunk)
    nsrc = 37
    src = rng.integers(-2 ** 31, 2 ** 31, (nsrc, chunk),
                       dtype=np.int64).astype(np.int32)
    rows = rng.integers(-nsrc - 3, nsrc + 3, nout)
    valid = rng.choice([0, 1, chunk // 2, chunk - 1, chunk, chunk + 1,
                        4 * chunk, -1, -chunk, -2 ** 31], nout)
    _both_gather_routes(cuda, src, rows, valid, chunk)


def test_chunk_gather_routes_on_one_source_row_and_unaligned(cuda):
    src = np.arange(1, 129, dtype=np.int32).reshape(1, 128)
    got = _both_gather_routes(cuda, src, [0, -1, 5, -9], [128, 3, 200, 0])
    assert int((got != 0).sum()) == 128 + 3 + 128
    flat = torch.arange(1, 6 * 128 + 2, dtype=torch.int32, device=cuda)
    _both_gather_routes(cuda, flat[1:].view(6, 128), [5, 0, -1, 9],
                        [128, 3, 130, 0])              # the scalar path


def test_chunk_gather_routes_refuse_each_others_routing(cuda):
    src = torch.ones((3, 128), dtype=torch.int32, device=cuda)
    out = torch.empty((GCAP + 1, 128), dtype=torch.int32, device=cuda)
    host = np.zeros(GCAP + 1, np.int32)
    card = torch.from_numpy(host).to(cuda)
    lib = _build.library("serverless_stage", stage._SIGNATURES)
    stream = torch.cuda.current_stream().cuda_stream

    def call(symbol, ptr, nout):
        _build.launch(lib, symbol, src.data_ptr(), ptr, ptr, out.data_ptr(),
                      nout, 3, 128, stream)

    _build.launches.clear()
    for symbol, ptr, nout in (
            ("chunk_gather_byval", card.data_ptr(), 4),       # on the card
            ("chunk_gather_byval", host.ctypes.data, GCAP + 1),
            ("chunk_gather", host.ctypes.data, 4)):            # on the host
        with pytest.raises(RuntimeError, match="invalid argument"):
            call(symbol, ptr, nout)
    assert not _build.launches
    call("chunk_gather_byval", host.ctypes.data, GCAP)
    call("chunk_gather", card.data_ptr(), GCAP + 1)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"chunk_gather_byval": 1,
                                     "chunk_gather": 1}


def test_stage_ops_route_by_where_the_routing_lies(cuda):
    """stage_pack keeps its plan on the host (by value); a plan beyond the
    cap, or one already on the card, takes the device route."""
    payloads = np.arange(16 * 300, dtype=np.int32).reshape(16, 300)
    _, ran = _launched(lambda: stage_ops.stage_pack(payloads, [300] * 16,
                                                    device=cuda))
    assert ran == {"chunk_gather_byval": 1}
    src = torch.ones((4, 128), dtype=torch.int32, device=cuda)
    rows = np.zeros(GCAP + 1, np.int32)
    _, ran = _launched(lambda: stage_ops.chunk_gather(src, rows, rows))
    assert ran == {"chunk_gather": 1}
    _, ran = _launched(lambda: stage_ops.chunk_gather(
        src, torch.from_numpy(rows[:5]).to(cuda), rows[:5]))
    assert ran == {"chunk_gather": 1}
    with pytest.raises(ValueError, match="both on the card"):
        chunk_gather_cuda(src, torch.from_numpy(rows[:5]).to(cuda), rows[:5])


# ------------------------------------------------- flash attention and WKV
@pytest.fixture
def fp32_cuda(cuda):
    """The card with both TF32 switches off: float32 products in full
    float32, as the plain versions' tolerances assume."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _qkv(cuda, b, hq, hkv, sq, d, dtype, seed=0, skv=None):
    g = torch.Generator("cpu").manual_seed(seed)
    skv = sq if skv is None else skv
    shapes = ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))
    return [(torch.randn(s, generator=g) * 0.5).to(cuda, dtype)
            for s in shapes]


@pytest.mark.parametrize(
    "b,hq,hkv,sq,skv,d,causal,window,cap,kv_len,dtype,q0,v_cols,layout", [
    (2, 4, 2, 256, 256, 64, True, None, None, None,
     torch.float32, 0, None, "contiguous"),
    (1, 4, 4, 256, 256, 64, True, 128, 50.0, None,
     torch.float32, 0, None, "contiguous"),
    (1, 2, 1, 128, 128, 32, False, None, None, None,
     torch.float32, 0, None, "contiguous"),
    (1, 8, 2, 512, 512, 64, True, None, 30.0, None,
     torch.float32, 0, None, "contiguous"),
    (2, 2, 2, 256, 256, 128, True, 64, None, None,
     torch.float32, 0, None, "contiguous"),
    (1, 4, 2, 256, 256, 64, True, None, None, None,
     torch.bfloat16, 0, None, "contiguous"),
    (2, 14, 2, 200, 200, 64, True, None, None, None,
     torch.bfloat16, 0, None, "contiguous"),
    (1, 14, 2, 544, 544, 64, True, None, None, None,
     torch.float32, 0, None, "contiguous"),
    (1, 4, 2, 33, 77, 96, False, None, 50.0, None,
     torch.float32, 0, None, "contiguous"),
    (1, 8, 4, 130, 130, 256, True, 48, 50.0, None,
     torch.bfloat16, 0, None, "contiguous"),
    (1, 4, 2, 64, 64, 16, True, None, None, None,
     torch.float32, 0, None, "contiguous"),
    (1, 4, 2, 256, 256, 64, True, None, None, 100,
     torch.float32, 0, None, "contiguous"),
    (1, 4, 2, 256, 256, 64, False, None, None, 37,
     torch.bfloat16, 0, None, "contiguous"),
    # float32 on the CUDA-core route at every padded head dim, ragged
    # lengths, q0 with kv_len, rows that are not 16-byte aligned, and MLA's
    # v zero-padded from 128 columns (those output columns exactly 0)
    (2, 8, 8, 256, 256, 192, True, None, None, None, torch.float32, 0, 128,
     "contiguous"),
    (1, 8, 4, 300, 300, 256, True, 128, 50.0, None, torch.float32, 0, None,
     "contiguous"),
    (1, 8, 4, 200, 200, 96, True, None, None, None, torch.float32, 0, None,
     "contiguous"),
    (1, 4, 2, 100, 333, 128, False, None, 30.0, None, torch.float32, 0,
     None, "contiguous"),
    (2, 4, 2, 64, 300, 64, True, None, None, 250, torch.float32, 236, None,
     "contiguous"),
    (2, 4, 2, 64, 300, 192, True, None, None, 250, torch.float32, 236, 128,
     "contiguous"),
    (1, 4, 2, 130, 130, 64, True, 48, None, 100, torch.float32, 0, None,
     "unaligned"),
    (1, 4, 2, 130, 200, 256, False, None, 50.0, None, torch.float32, 0,
     None, "unaligned"),
    (2, 14, 2, 96, 96, 64, True, None, None, None, torch.float32, 0, None,
     "views"),
    (1, 8, 4, 300, 300, 192, True, 128, 50.0, None, torch.float32, 0, None,
     "contiguous"),
    (1, 4, 2, 130, 200, 192, False, None, None, 150, torch.float32, 0, None,
     "unaligned"),
])
def test_flash_kernel_equals_plain(fp32_cuda, b, hq, hkv, sq, skv, d, causal,
                                   window, cap, kv_len, dtype, q0, v_cols,
                                   layout):
    """Each route at its tolerance against the plain version. The float32
    cases cover the CUDA-core route's instances (DP = 32 to 256), its
    plain-load path (k and v rows 4 bytes past a 16-byte boundary) and the
    model's head-transposed views."""
    if layout == "contiguous":
        q, k, v = _qkv(fp32_cuda, b, hq, hkv, sq, d, dtype, skv=skv)
    else:
        q, k, v = _wide_qkv(fp32_cuda, b, hq, hkv, sq, skv, d, layout,
                            sq + skv + d, dtype=dtype, scale=0.5)
    if v_cols:
        v[..., v_cols:] = 0
    _build.launches.clear()
    got = flash_attention_cuda(q, k, v, causal=causal, window=window, cap=cap,
                               kv_len=kv_len, q0=q0)
    want = flash_attention_ref(q, k, v, causal=causal, window=window,
                               cap=cap, kv_len=kv_len, q0=q0)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {flash_route(dtype, d): 1}
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if v_cols:
        assert not got[..., v_cols:].any()


def test_flash_kernel_takes_strided_views_and_counts(fp32_cuda):
    """The model's head-transposed projections go in without a copy."""
    b, s, hq, hkv, d = 2, 96, 14, 2, 64
    g = torch.Generator("cpu").manual_seed(3)
    q = torch.randn(b, s, hq, d, generator=g).to(fp32_cuda).transpose(1, 2)
    kv = torch.randn(b, s, hkv, d, generator=g).to(fp32_cuda).transpose(1, 2)
    _build.launches.clear()
    got = flash_ops.flash_attention(q, kv, kv)
    flash_ops.flash_attention(q, kv, kv, impl="ref")
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"flash_attention": 1}
    torch.testing.assert_close(got, flash_attention_ref(q, kv, kv),
                               atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(*(torch.zeros(1, 1, 4, 300, device=fp32_cuda),)
                             * 3)


def test_flash_launches_are_counted_by_call_shape(cuda):
    """Each accepted launch adds one to its route and call shape in
    ``launches_by_shape``, beside ``_build.launches``; the plain version and
    a refused call add nothing."""
    g = torch.Generator("cpu").manual_seed(5)
    calls = (((1, 4, 2, 96, 96, 64), True, torch.float32),
             ((1, 4, 2, 96, 96, 64), True, torch.float32),
             ((1, 4, 4, 64, 80, 128), False, torch.float32),
             ((1, 4, 2, 96, 96, 64), True, torch.bfloat16))
    _build.launches.clear()
    launches_by_shape.clear()
    for (b, hq, hkv, sq, skv, d), causal, dtype in calls:
        q = torch.randn(b, hq, sq, d, generator=g).to(cuda, dtype)
        kv = torch.randn(b, hkv, skv, d, generator=g).to(cuda, dtype)
        flash_attention_cuda(q, kv, kv, causal=causal)
        flash_ops.flash_attention(q, kv, kv, causal=causal, impl="ref")
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(*(torch.zeros(1, 1, 4, 300, device=cuda),) * 3)
    torch.cuda.synchronize()
    assert dict(launches_by_shape) == {
        ("flash_attention", 1, 4, 2, 96, 96, 64, True): 2,
        ("flash_attention", 1, 4, 4, 64, 80, 128, False): 1,
        ("flash_attention_mma", 1, 4, 2, 96, 96, 64, True): 1}
    assert dict(_build.launches) == {"flash_attention": 3,
                                     "flash_attention_mma": 1}


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window,cap,kv_len,q0", [
    (8, 14, 2, 512, 512, 64, True, None, None, None, 0),      # qwen2
    (1, 8, 8, 300, 300, 96, True, None, None, None, 0),       # phi3's D
    (1, 4, 2, 544, 544, 128, True, None, None, None, 0),
    (2, 14, 2, 200, 200, 64, True, None, None, None, 0),      # ragged
    (1, 14, 2, 544, 544, 64, True, None, None, None, 0),
    (1, 4, 2, 100, 300, 64, False, None, None, None, 0),
    (2, 14, 2, 64, 300, 64, True, None, None, 250, 236),      # q0, kv_len
    (1, 4, 2, 130, 130, 64, True, 48, 50.0, None, 0),         # window, cap
    (1, 32, 32, 1024, 1024, 96, True, 512, 50.0, None, 0),
    (1, 4, 2, 33, 77, 40, False, None, 50.0, None, 0),        # D % 8 != 0
    # every padded head dim, one instance each
    (1, 4, 2, 256, 256, 32, True, None, None, None, 0),
    (1, 4, 2, 256, 256, 64, True, None, None, None, 0),
    (1, 4, 2, 256, 256, 96, True, None, None, None, 0),
    (1, 4, 2, 256, 256, 128, True, None, None, None, 0),
    (1, 4, 2, 256, 256, 192, True, None, None, None, 0),
    (1, 4, 2, 256, 256, 256, True, None, None, None, 0),
    # the CTA's second q tile partial (100, 200) or absent (65, 544)
    (2, 4, 2, 65, 65, 64, True, None, None, None, 0),
    (2, 4, 2, 100, 100, 128, False, None, None, None, 0),
    (2, 4, 2, 200, 200, 192, True, None, None, None, 0),
    (1, 8, 2, 544, 544, 64, True, None, None, None, 0),
    # windows under which the two q tiles' kv ranges start apart
    (1, 4, 2, 512, 512, 64, True, 100, None, None, 0),
    (1, 4, 2, 512, 512, 192, True, 64, None, None, 0),
    (1, 4, 2, 384, 384, 256, True, 130, 50.0, None, 0),
    # kv_len, softcap and q0, with Skv not a multiple of 64
    (2, 4, 2, 128, 400, 96, True, None, 30.0, 300, 272),
    (1, 4, 2, 160, 333, 256, False, None, None, 200, 0),
    (2, 8, 4, 300, 1000, 32, False, None, 50.0, None, 0),
])
def test_flash_mma_route_equals_plain(cuda, b, hq, hkv, sq, skv, d, causal,
                                      window, cap, kv_len, q0):
    """The tensor-core route at bf16, inputs drawn at 1.5 so that 2e-2 lies
    well below the outputs' mean magnitude: its CTA (a producer warpgroup
    feeding K and V by TMA, two consumer warpgroups of one 64-row q tile
    each) at every padded head dim, with a second q tile that is partial
    or absent, windows under which the two tiles' kv ranges differ,
    kv_len, softcap, q0 and ragged Skv."""
    g = torch.Generator("cpu").manual_seed(sq + d)
    q, k, v = ((torch.randn(sh, generator=g) * 1.5).to(cuda, torch.bfloat16)
               for sh in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    _build.launches.clear()
    got = flash_attention_cuda(q, k, v, causal=causal, window=window,
                               cap=cap, kv_len=kv_len, q0=q0)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"flash_attention_mma": 1}
    want = flash_attention_ref(q, k, v, causal=causal, window=window,
                               cap=cap, kv_len=kv_len, q0=q0)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert float(want.float().abs().mean()) > 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_flash_mma_route_takes_strided_views(cuda):
    """The model's head-transposed bf16 projections, without a copy; a view
    whose rows are not 16-byte aligned takes the plain-load path."""
    b, s, hq, hkv, d = 2, 96, 14, 2, 64
    g = torch.Generator("cpu").manual_seed(3)
    q = torch.randn(b, s, hq, d, generator=g).to(cuda, torch.bfloat16) \
        .transpose(1, 2)
    kv = torch.randn(b, s, hkv, d, generator=g).to(cuda, torch.bfloat16) \
        .transpose(1, 2)
    odd = torch.randn(b, hkv, s, d + 1, generator=g).to(
        cuda, torch.bfloat16)[..., 1:]                  # 2-byte aligned rows
    _build.launches.clear()
    for kk, vv in ((kv, kv), (odd, kv), (kv, odd)):
        got = flash_ops.flash_attention(q, kk, vv)
        torch.testing.assert_close(got.float(), flash_attention_ref(
            q, kk, vv).float(), atol=2e-2, rtol=2e-2)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"flash_attention_mma": 3}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 192, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_mma_row_with_all_visited_keys_masked(fp32_cuda, causal, d,
                                                    dtype):
    """kv_len = 0 masks every key: each row averages the keys of the tiles
    it visits (all of them without causality; tiles up to its q tile's
    diagonal with it), p = 1 for each, as the Pallas kernel does; the
    64 x 64 tile holds at the wide heads too, on both routes (bf16 on the
    tensor cores, float32 on the CUDA cores)."""
    b, hq, hkv, s = 1, 2, 1, 200
    g = torch.Generator("cpu").manual_seed(4)
    q, k, v = (torch.randn(sh, generator=g).to(fp32_cuda, dtype)
               for sh in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    _build.launches.clear()
    got = flash_attention_cuda(q, k, v, causal=causal, kv_len=0)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {flash_route(dtype, d): 1}
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    if not causal:
        torch.testing.assert_close(got.float(), flash_attention_ref(
            q, k, v, causal=False, kv_len=0).float(), atol=tol, rtol=tol)
    vf = v[0, 0].float()
    for row in (0, 63, 64, 150, s - 1):
        last = s if not causal else min(s, (row // MMA_TILE + 1) * MMA_TILE)
        want = vf[:last].mean(0).expand(hq, d)
        torch.testing.assert_close(got[0, :, row].float(), want, atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("b,hq,sq,skv,d,causal,dtype,v_cols", [
    (4, 16, 512, 512, 128, True, torch.bfloat16, None),      # olmoe
    (1, 128, 512, 512, 192, True, torch.bfloat16, 128),      # MLA
    (4, 16, 512, 512, 64, False, torch.bfloat16, None),      # seamless x
    (4, 16, 512, 1000, 64, False, torch.bfloat16, None),
    (4, 16, 512, 512, 64, False, torch.float32, None),
    (4, 16, 512, 1000, 64, False, torch.float32, None),
    (4, 128, 512, 512, 192, True, torch.bfloat16, 128),      # MLA served
    (4, 32, 512, 512, 64, True, torch.bfloat16, None),       # zamba2
    (4, 16, 512, 512, 64, True, torch.bfloat16, None),       # seamless dec
])
def test_flash_at_the_new_families_shapes(fp32_cuda, b, hq, sq, skv, d,
                                          causal, dtype, v_cols):
    """chip_smoke.py's new FLASH_CASES and the prefill shapes of
    FLASH_MODEL_SHAPES that no FLASH_CASES case has, each on the route
    flash_route picks (bf16 at any D on the tensor cores, MLA's D = 192
    included; float32 on the CUDA cores); MLA's v zero-padded from 128 to
    192 columns gives output columns 128-191 of exactly 0."""
    g = torch.Generator("cpu").manual_seed(sq + skv + d)
    q, k, v = ((torch.randn(sh, generator=g) * 1.5).to(fp32_cuda, dtype)
               for sh in ((b, hq, sq, d), (b, hq, skv, d), (b, hq, skv, d)))
    if v_cols:
        v[..., v_cols:] = 0
    _build.launches.clear()
    got = flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {flash_route(dtype, d): 1}
    want = flash_attention_ref(q, k, v, causal=causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    assert float(want.float().abs().mean()) > tol
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if v_cols:
        assert not got[..., v_cols:].any()


def test_flash_routes_by_dtype_and_head_dim(fp32_cuda):
    """bf16 at any D up to 256 on the tensor cores, float32 at any D on
    the CUDA cores."""
    qs = {(dtype, d): torch.randn(1, 2, 64, d, device=fp32_cuda).to(dtype)
          for dtype, d in ((torch.bfloat16, 64), (torch.bfloat16, 128),
                           (torch.bfloat16, 192), (torch.bfloat16, 256),
                           (torch.float32, 64), (torch.float32, 256))}
    _build.launches.clear()
    for q in qs.values():
        flash_attention_cuda(q, q, q)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"flash_attention_mma": 4,
                                     "flash_attention": 2}


def _wide_qkv(cuda, b, hq, hkv, sq, skv, d, layout, seed,
              dtype=torch.bfloat16, scale=1.5):
    """q, k, v of ``dtype`` drawn at ``scale``: contiguous; head-transposed
    views of (B, S, H, D) projections, as the model passes them; or k and v
    as views whose rows start one element (2 or 4 bytes) past a 16-byte
    boundary (the plain-load path)."""
    g = torch.Generator("cpu").manual_seed(seed)

    def draw(h, s):
        if layout == "views":
            return (torch.randn(b, s, h, d, generator=g) * scale).to(
                cuda, dtype).transpose(1, 2)
        return (torch.randn(b, h, s, d, generator=g) * scale).to(cuda, dtype)

    q = draw(hq, sq)
    if layout == "unaligned":
        k, v = ((torch.randn(b, hkv, skv, d + 1, generator=g) * scale).to(
            cuda, dtype)[..., 1:] for _ in range(2))
        assert k.data_ptr() % 16 == k.element_size() and k.stride(-1) == 1
    else:
        k, v = draw(hkv, skv), draw(hkv, skv)
    return q, k, v


@pytest.mark.parametrize("d", [160, 192, 256])
@pytest.mark.parametrize(
    "b,hq,hkv,sq,skv,causal,window,cap,kv_len,q0,layout,v_cols", [
        (2, 8, 4, 512, 512, True, None, None, None, 0, "contiguous", None),
        (1, 8, 4, 300, 300, True, 128, 50.0, None, 0, "contiguous", None),
        (2, 4, 2, 64, 300, True, None, None, 250, 236, "contiguous", None),
        (1, 4, 2, 100, 333, False, None, 30.0, None, 0, "contiguous", None),
        (2, 8, 2, 96, 96, True, None, None, None, 0, "views", None),
        (1, 4, 2, 130, 130, True, 48, None, 100, 0, "unaligned", None),
        (2, 16, 16, 512, 512, True, None, None, None, 0, "contiguous", 128),
    ])
def test_flash_mma_wide_heads_equal_plain(cuda, d, b, hq, hkv, sq, skv,
                                          causal, window, cap, kv_len, q0,
                                          layout, v_cols):
    """bf16 at 128 < D <= 256 on the tensor-core route (D = 160 padded to
    192, 192 itself for deepseek-v2's MLA, 256 for gemma2) against the plain
    version at 2e-2: GQA, window, softcap, kv_len, q0 > 0, ragged Sq and
    Skv, head-transposed views, rows that are not 16-byte aligned, and v
    zero-padded from 128 columns as MLA passes it (those output columns
    exactly 0)."""
    q, k, v = _wide_qkv(cuda, b, hq, hkv, sq, skv, d, layout, sq + skv + d)
    if v_cols:
        v[..., v_cols:] = 0
    _build.launches.clear()
    got = flash_attention_cuda(q, k, v, causal=causal, window=window,
                               cap=cap, kv_len=kv_len, q0=q0)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"flash_attention_mma": 1}
    want = flash_attention_ref(q, k, v, causal=causal, window=window,
                               cap=cap, kv_len=kv_len, q0=q0)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert float(want.float().abs().mean()) > 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    if v_cols:
        assert not got[..., v_cols:].any()


@pytest.mark.parametrize("d,pad", [(37, 1), (75, 1), (64, 4), (192, 4)])
def test_flash_mma_views_that_tma_cannot_describe(cuda, d, pad):
    """An odd head dim, or k and v rows 2 (d + pad) bytes apart (a stride
    that is not a multiple of 8 elements), go through the same kernel, the
    producer warpgroup copying by plain loads: one ``flash_attention_mma``
    launch each, within 2e-2 of the plain version."""
    b, hq, hkv, sq, skv = 2, 4, 2, 130, 200
    g = torch.Generator("cpu").manual_seed(d + pad)
    q = (torch.randn(b, hq, sq, d, generator=g) * 1.5).to(cuda,
                                                          torch.bfloat16)
    k, v = ((torch.randn(b, hkv, skv, d + pad, generator=g) * 1.5).to(
        cuda, torch.bfloat16)[..., :d] for _ in range(2))
    assert k.stride(2) % 8 != 0 or d % 8 != 0
    _build.launches.clear()
    got = flash_attention_cuda(q, k, v, causal=True, cap=50.0)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"flash_attention_mma": 1}
    want = flash_attention_ref(q, k, v, causal=True, cap=50.0)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def _wkv_inputs(cuda, b, h, s, dk, dv, dtype=torch.float32,
                wdtype=torch.float32, seed=7, strong=False):
    g = torch.Generator("cpu").manual_seed(seed)
    scale = 1.0 if strong else 0.4
    r, k = (torch.randn(b, h, s, dk, generator=g) * scale for _ in range(2))
    v = torch.randn(b, h, s, dv, generator=g) * scale
    if strong:
        logw = torch.full((b, h, s, dk), -4.25)
        u = torch.zeros(h, dk)
    else:
        logw = torch.clamp(-torch.exp(torch.randn(b, h, s, dk, generator=g)
                                      * 0.3 - 0.6), -4.25, -1e-6)
        u = torch.randn(h, dk, generator=g) * 0.3
    return (r.to(cuda, dtype), k.to(cuda, dtype), v.to(cuda, dtype),
            logw.to(cuda, wdtype), u.to(cuda))


@pytest.mark.parametrize("b,h,s,dk,dv,chunk,dtype,wdtype,strong,state", [
    (2, 3, 128, 16, 16, 16, torch.float32, torch.float32, False, False),
    (1, 2, 64, 32, 32, 16, torch.float32, torch.float32, False, False),
    (1, 1, 256, 64, 64, 16, torch.float32, torch.float32, False, False),
    (2, 2, 96, 16, 32, 16, torch.float32, torch.float32, False, False),
    (1, 2, 64, 16, 16, 16, torch.float32, torch.float32, True, False),
    (2, 4, 128, 64, 64, 16, torch.bfloat16, torch.float32, False, False),
    (2, 4, 128, 64, 64, 16, torch.bfloat16, torch.bfloat16, False, True),
    (1, 2, 48, 16, 32, 8, torch.float32, torch.float32, False, True),
    (1, 1, 8, 64, 64, 16, torch.float32, torch.float32, False, False),
    # the -4.25 clamp on the split route (e^{+-68} in its TF32 operands)
    (1, 2, 64, 64, 64, 16, torch.float32, torch.float32, True, False),
    (1, 2, 64, 64, 64, 16, torch.bfloat16, torch.float32, True, False),
    # rwkv6-7b's training microbatch, from a non-zero state
    (2, 64, 1024, 64, 64, 16, torch.bfloat16, torch.float32, False, True),
    # the masked route's shapes (rwkv6-7b's short prompts, C = 1 and 13,
    # chunks below 16, narrow and unequal heads, the clamp at 32 x 32, a
    # given state), each in float32 and with bf16 r/k/v
    *((*shape, dtype, torch.float32, strong, state)
      for shape, strong, state in (
          ((4, 2, 8, 64, 64, 8), False, False),
          ((2, 2, 1, 64, 64, 1), False, False),
          ((1, 2, 13, 64, 64, 13), False, False),
          ((1, 2, 64, 64, 64, 8), False, False),
          ((2, 3, 128, 16, 16, 16), False, False),
          ((2, 2, 96, 16, 32, 16), False, False),
          ((1, 2, 48, 24, 40, 12), False, False),
          ((1, 2, 64, 32, 32, 16), True, False),
          ((1, 2, 64, 64, 64, 8), False, True),
          # dv not a multiple of 4: the final state's store by floats
          ((2, 3, 24, 7, 5, 8), False, True),
          ((1, 2, 32, 33, 30, 16), False, False))
      for dtype in (torch.float32, torch.bfloat16)),
])
def test_wkv_kernel_equals_plain(fp32_cuda, b, h, s, dk, dv, chunk, dtype,
                                 wdtype, strong, state):
    """Each route against the plain chunked version (and, in float32 from
    a zero state, the sequential recurrence); a second call gives the same
    bits."""
    r, k, v, logw, u = _wkv_inputs(fp32_cuda, b, h, s, dk, dv, dtype, wdtype,
                                   strong=strong)
    s0 = (torch.randn(b, h, dk, dv, generator=torch.Generator("cpu")
                      .manual_seed(1)).to(fp32_cuda) if state
          else torch.zeros(b, h, dk, dv, device=fp32_cuda))
    o, st = wkv_cuda(r, k, v, logw, u, s0 if state else None, chunk=chunk)
    want_o, want_st = wkv_chunked_ref(r, k, v, logw, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    assert o.dtype == dtype and st.dtype == torch.float32
    assert torch.isfinite(o.float()).all()
    tol = dict(atol=5e-4, rtol=1e-3) if dtype == torch.float32 \
        else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(o.float(), want_o.float(), **tol)
    torch.testing.assert_close(st, want_st, atol=5e-4, rtol=1e-3)
    if not state and dtype == torch.float32:
        torch.testing.assert_close(o, wkv_sequential(r, k, v, logw, u),
                                   atol=5e-4, rtol=1e-3)
    o2, st2 = wkv_cuda(r, k, v, logw, u, s0 if state else None, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(o2, o) and torch.equal(st2, st)


def test_wkv_counts_and_refuses_ragged_lengths(cuda):
    r, k, v, logw, u = _wkv_inputs(cuda, 1, 2, 64, 16, 16)
    _build.launches.clear()
    wkv_ops.wkv(r, k, v, logw, u)
    wkv_ops.wkv(r, k, v, logw, u, impl="ref")
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"wkv": 1}
    with pytest.raises(ValueError, match="multiple of the chunk"):
        wkv_cuda(*(t[:, :, :40] for t in (r, k, v, logw)), u)
    with pytest.raises(ValueError, match="chunk 32"):
        wkv_cuda(r, k, v, logw, u, chunk=32)


@pytest.mark.parametrize("b,dtype,wdtype,state", [
    (1, torch.bfloat16, torch.float32, True),      # few CTAs, given state
    (2, torch.bfloat16, torch.float32, False),     # the model's dtypes
    (2, torch.float32, torch.float32, True),
    (1, torch.bfloat16, torch.bfloat16, True),
])
def test_wkv_split_route_on_head_transposed_views(fp32_cuda, b, dtype,
                                                  wdtype, state):
    """rwkv6-7b's heads (64 x 64, chunk 16) through the split route, fed
    the model's head-transposed views of (B, S, H, 64) projections, from a
    given or a zero state."""
    h, s, d = 8, 128, 64
    g = torch.Generator("cpu").manual_seed(b * 10 + int(state))
    r, k, v = ((torch.randn(b, s, h, d, generator=g) * 0.4).to(
        fp32_cuda, dtype).transpose(1, 2) for _ in range(3))
    logw = torch.clamp(-torch.exp(torch.randn(b, s, h, d, generator=g) * 0.3
                                  - 0.6), -4.25, -1e-6).to(
        fp32_cuda, wdtype).transpose(1, 2)
    u = (torch.randn(h, d, generator=g) * 0.3).to(fp32_cuda)
    s0 = torch.randn(b, h, d, d, generator=g).to(fp32_cuda) if state \
        else None
    assert not r.is_contiguous()
    _build.launches.clear()
    o, st = wkv_ops.wkv_with_state(r, k, v, logw, u, s0)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"wkv_split": 1}
    zero = torch.zeros(b, h, d, d, device=fp32_cuda)
    want_o, want_st = wkv_chunked_ref(r, k, v, logw, u,
                                      zero if s0 is None else s0)
    tol = dict(atol=5e-4, rtol=1e-3) if dtype == torch.float32 \
        else dict(atol=2e-2, rtol=2e-2)
    assert o.dtype == dtype and st.dtype == torch.float32
    torch.testing.assert_close(o.float(), want_o.float(), **tol)
    torch.testing.assert_close(st, want_st, atol=5e-4, rtol=1e-3)
    o2, st2 = wkv_cuda(*(t.contiguous() for t in (r, k, v, logw)), u, s0)
    torch.cuda.synchronize()
    torch.testing.assert_close(o2.float(), o.float(), atol=0, rtol=0)
    torch.testing.assert_close(st2, st, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wkv_split_route_takes_views_tma_cannot_describe(fp32_cuda, dtype):
    """Rows 65 elements apart, a stride TMA cannot take: the split route
    copies its chunks with plain loads, within tolerance of the plain
    version and bit for bit what the contiguous copies (by TMA) give."""
    b, h, s, d = 2, 4, 96, 64
    g = torch.Generator("cpu").manual_seed(31)
    r, k, v = ((torch.randn(b, h, s, d + 1, generator=g) * 0.4).to(
        fp32_cuda, dtype)[..., :d] for _ in range(3))
    logw = torch.clamp(-torch.exp(torch.randn(b, h, s, d + 1, generator=g)
                                  * 0.3 - 0.6), -4.25, -1e-6).to(
        fp32_cuda)[..., :d]
    u = (torch.randn(h, d, generator=g) * 0.3).to(fp32_cuda)
    s0 = torch.randn(b, h, d, d, generator=g).to(fp32_cuda)
    assert r.stride(2) == d + 1 and logw.stride(2) == d + 1
    _build.launches.clear()
    o, st = wkv_cuda(r, k, v, logw, u, s0)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"wkv_split": 1}
    want_o, want_st = wkv_chunked_ref(r, k, v, logw, u, s0)
    tol = dict(atol=5e-4, rtol=1e-3) if dtype == torch.float32 \
        else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(o.float(), want_o.float(), **tol)
    torch.testing.assert_close(st, want_st, atol=5e-4, rtol=1e-3)
    o2, st2 = wkv_cuda(*(t.contiguous() for t in (r, k, v, logw)), u, s0)
    torch.cuda.synchronize()
    assert torch.equal(o2, o) and torch.equal(st2, st)


def _head_views(cuda, b, s, h, dk, dv, dtype, seed):
    """r, k, v, logw as the model hands them over: head-transposed views
    of (B, S, H, d) projections (logw float32), u and a state."""
    g = torch.Generator("cpu").manual_seed(seed)
    r, k = ((torch.randn(b, s, h, dk, generator=g) * 0.4).to(
        cuda, dtype).transpose(1, 2) for _ in range(2))
    v = (torch.randn(b, s, h, dv, generator=g) * 0.4).to(
        cuda, dtype).transpose(1, 2)
    logw = torch.clamp(-torch.exp(torch.randn(b, s, h, dk, generator=g)
                                  * 0.3 - 0.6), -4.25, -1e-6).to(
        cuda).transpose(1, 2)
    u = (torch.randn(h, dk, generator=g) * 0.3).to(cuda)
    s0 = torch.randn(b, h, dk, dv, generator=g).to(cuda)
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("b,h,s,dk,dv,chunk,dtype,state", [
    (4, 64, 8, 64, 64, 16, torch.bfloat16, False),  # rwkv6-7b, 8 tokens
    (4, 64, 1, 64, 64, 16, torch.bfloat16, False),  # one token
    (2, 8, 13, 64, 64, 16, torch.bfloat16, True),
    (2, 8, 64, 64, 64, 8, torch.float32, True),
    (2, 3, 48, 32, 32, 16, torch.float32, False),
    (1, 2, 48, 24, 40, 12, torch.bfloat16, True),
])
def test_wkv_route_on_head_transposed_views(fp32_cuda, b, h, s, dk, dv,
                                            chunk, dtype, state):
    """The masked route takes the model's head-transposed views as they
    are: within tolerance of the plain version, the same bits as on
    contiguous copies, and the call launches nothing but ``wkv`` (no copy
    kernel, no allocation but o and the final state)."""
    from torch.profiler import ProfilerActivity, profile
    r, k, v, logw, u, s0 = _head_views(fp32_cuda, b, s, h, dk, dv, dtype,
                                       seed=b * 100 + s)
    s0 = s0 if state else None
    assert s == 1 or not (r.is_contiguous() or v.is_contiguous())
    wkv_cuda(r, k, v, logw, u, s0, chunk=chunk)       # built and warm
    torch.cuda.synchronize()
    _build.launches.clear()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        o, st = wkv_ops.wkv_with_state(r, k, v, logw, u, s0, chunk=chunk)
        torch.cuda.synchronize()
    assert dict(_build.launches) == {"wkv": 1}
    assert torch.cuda.memory_stats()["allocation.all.allocated"] \
        == allocs + 2
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert all("wkv_kernel" in name for name in kernels), kernels
    zero = torch.zeros(b, h, dk, dv, device=fp32_cuda)
    want_o, want_st = wkv_chunked_ref(r, k, v, logw, u,
                                      zero if s0 is None else s0,
                                      chunk=chunk)
    tol = dict(atol=5e-4, rtol=1e-3) if dtype == torch.float32 \
        else dict(atol=2e-2, rtol=2e-2)
    assert o.dtype == dtype and st.dtype == torch.float32
    torch.testing.assert_close(o.float(), want_o.float(), **tol)
    torch.testing.assert_close(st, want_st, atol=5e-4, rtol=1e-3)
    o2, st2 = wkv_cuda(*(t.contiguous() for t in (r, k, v, logw)), u, s0,
                       chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(o2, o) and torch.equal(st2, st)


@pytest.mark.parametrize("case,dtype", [
    ("rows 65 apart", torch.bfloat16), ("rows 65 apart", torch.float32),
    ("bf16 dk = 20", torch.bfloat16),
])
def test_wkv_route_takes_views_tma_cannot_describe(fp32_cuda, case, dtype):
    """Views whose strides TMA cannot take: rows 65 elements apart, and
    bf16 heads of 20 (40-byte rows). The masked route copies their chunks
    with plain loads, padded with the zeros TMA would write: within
    tolerance of the plain version, and the 65-apart view bit for bit what
    its contiguous copy (by TMA) gives."""
    g = torch.Generator("cpu").manual_seed(33)
    if case == "rows 65 apart":
        b, h, s, dk, dv, chunk, pad = 2, 4, 48, 32, 32, 8, 65 - 32
    else:
        b, h, s, dk, dv, chunk, pad = 2, 3, 40, 20, 24, 8, 0
    r, k = ((torch.randn(b, h, s, dk + pad, generator=g) * 0.4).to(
        fp32_cuda, dtype)[..., :dk] for _ in range(2))
    v = (torch.randn(b, h, s, dv + pad, generator=g) * 0.4).to(
        fp32_cuda, dtype)[..., :dv]
    logw = torch.clamp(-torch.exp(torch.randn(b, h, s, dk + pad, generator=g)
                                  * 0.3 - 0.6), -4.25, -1e-6).to(
        fp32_cuda)[..., :dk]
    u = (torch.randn(h, dk, generator=g) * 0.3).to(fp32_cuda)
    s0 = torch.randn(b, h, dk, dv, generator=g).to(fp32_cuda)
    assert (r.stride(2) * r.element_size()) % 16 != 0
    _build.launches.clear()
    o, st = wkv_cuda(r, k, v, logw, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"wkv": 1}
    want_o, want_st = wkv_chunked_ref(r, k, v, logw, u, s0, chunk=chunk)
    tol = dict(atol=5e-4, rtol=1e-3) if dtype == torch.float32 \
        else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(o.float(), want_o.float(), **tol)
    torch.testing.assert_close(st, want_st, atol=5e-4, rtol=1e-3)
    if pad:
        o2, st2 = wkv_cuda(*(t.contiguous() for t in (r, k, v, logw)), u,
                           s0, chunk=chunk)
        torch.cuda.synchronize()
        assert torch.equal(o2, o) and torch.equal(st2, st)


def test_wkv_routes_by_shape(cuda):
    """Only 64 x 64 heads in chunks of 16 take the split route; the
    one-CTA-a-head kernel takes every other shape."""
    r, k, v, logw, u = _wkv_inputs(cuda, 1, 2, 64, 64, 64)
    _build.launches.clear()
    wkv_cuda(r, k, v, logw, u)
    wkv_cuda(r, k, v, logw, u, chunk=8)
    wkv_cuda(*(t[..., :32] for t in (r, k, v, logw)), u[:, :32])
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"wkv_split": 1, "wkv": 2}


# --------------------------------------------------- models through kernels
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "olmo_1b", "phi3_mini_3_8b",
                                  "gemma2_2b", "llava_next_mistral_7b",
                                  "rwkv6_7b", "olmoe_1b_7b",
                                  "deepseek_v2_236b", "zamba2_1_2b",
                                  "seamless_m4t_medium"])
def test_smoke_models_through_kernels_equal_plain(fp32_cuda, arch):
    """forward_full, prefill and decode on the card (the kernels) against
    the same float32 parameters on the CPU (the plain versions), with the
    launches of each step counted: one a layer, zamba2's shared block once
    a period, seamless's encoder, decoder and cross-attention layers. MoE
    at the no-drop capacity of the consistency test (a token's routing
    then does not depend on the others')."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=1000.0)
    params = init_params(cfg, torch.Generator("cpu").manual_seed(0), "cpu")
    gparams = _to(params, fp32_cuda)
    rng = np.random.default_rng(1)
    n_img = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    key = "dec_tokens" if cfg.family == "encdec" else "tokens"
    batch = {key: torch.from_numpy(
        rng.integers(0, cfg.vocab, (2, 48 - n_img)).astype(np.int32))}
    if n_img:
        batch["vision_embeds"] = torch.from_numpy(
            rng.standard_normal((2, n_img, 1024)).astype(np.float32))
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32))
    gbatch = {k: v.to(fp32_cuda) for k, v in batch.items()}
    kernel = "wkv" if cfg.family == "ssm" else "flash_attention"
    calls = {"hybrid": cfg.n_layers // max(cfg.attn_every, 1),
             "encdec": cfg.enc_layers + 2 * cfg.dec_layers}.get(
        cfg.family, cfg.n_layers)
    _build.launches.clear()
    hidden = forward_full(cfg, gparams, gbatch)[0]
    torch.cuda.synchronize()
    assert dict(_build.launches) == {kernel: calls}
    torch.testing.assert_close(hidden.cpu(),
                               forward_full(cfg, params, batch)[0],
                               atol=1e-4, rtol=1e-4)
    pre = dict(batch, **{key: batch[key][:, :32 - n_img]})
    gpre = {k: v.to(fp32_cuda) for k, v in pre.items()}
    logits, cache = prefill(cfg, gparams, gpre, 64)
    want_logits, want_cache = prefill(cfg, params, pre, 64)
    torch.testing.assert_close(logits.cpu(), want_logits, atol=1e-4,
                               rtol=1e-4)
    _build.launches.clear()
    for t in range(4):
        tok = batch[key][:, 32 - n_img + t]
        logits, cache = decode_step(cfg, gparams, cache, tok.to(fp32_cuda),
                                    32 + t)
        want_logits, want_cache = decode_step(cfg, params, want_cache, tok,
                                              32 + t)
        torch.testing.assert_close(logits.cpu(), want_logits, atol=1e-4,
                                   rtol=1e-4)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_sharded_table_routes_equal_simulated_dkv_gets(cuda):
    """The device shard map against the elastic KV service: a seeded
    ``DkvService`` (4 shards x 1,021 buckets) and a ``ShardedDeviceRaceTable``
    on the card hold the same keys; both kernel routes (by value at 512
    keys, routing on the card at 2,800) find exactly what the simulated
    ``DkvClient`` gets return, with their 8 bytes."""
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(1, 2 ** 32, 6_000, dtype=np.int64))
    values = rng.integers(0, 256, (len(keys), 8), dtype=np.uint8)
    cluster = make_cluster(n_nodes=5, n_meta=1)
    svc = DkvService(cluster, ["n3", "n4"], n_shards=4, n_buckets=1021)
    table = ShardedDeviceRaceTable(4, 1021, 8, vdim=8, device=cuda)
    for k, v in zip(keys.tolist(), values):
        svc.seed(k, v.tobytes())
        table.insert(k, v.astype(np.float32))
    absent = rng.integers(1, 2 ** 32, 400, dtype=np.int64)
    absent = absent[~np.isin(absent, keys)][:300]
    queries = rng.permutation(np.concatenate([rng.choice(keys, 2_500),
                                              absent]))

    def scenario():
        cl = DkvClient(cluster.module("n0"))
        yield from cl.bootstrap()
        return (yield from cl.get_many(queries.tolist()))

    sim = cluster.env.run_process(scenario(), "gets")
    want_f = np.array([s is not None for s in sim], np.int32)
    want_v = np.zeros((len(sim), 8), np.float32)
    for j, s in enumerate(sim):
        if s is not None:
            want_v[j] = np.frombuffer(s, np.uint8)
    assert want_f.sum() == 2_500
    _build.launches.clear()
    small = table.lookup_batch(queries[:512])
    full = table.lookup_batch(queries)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"race_lookup_sharded_byval": 1,
                                     "race_lookup_sharded": 1}
    for (v, f), n in ((small, 512), (full, len(queries))):
        np.testing.assert_array_equal(f.cpu().numpy(), want_f[:n])
        np.testing.assert_array_equal(v.cpu().numpy(), want_v[:n])


# ----------------------------------------------------------------- training
def _grads_of(fn, ins, cots):
    ins = [t.detach().requires_grad_() for t in ins]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, cots)
    return [o.detach() for o in outs], [t.grad for t in ins]


def _bits(t):
    view = {2: torch.int16, 4: torch.int32}[t.element_size()]
    return t.view(view)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [
    dict(causal=True), dict(causal=False), dict(causal=True, window=40),
    dict(causal=True, cap=20.0), dict(causal=False, kv_len=70),
    dict(causal=True, q0=30)], ids=lambda kw: "-".join(kw))
def test_flash_autograd_route_gradients_equal_plain(cuda, kw, dtype):
    """The kernel's autograd ``Function`` on the card: its forward launches
    the route, and its gradients equal the plain version's own autograd
    gradients bit for bit (the backward recomputes through it)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    b, hq, hkv, s, d = 2, 6, 2, 96, 64
    q = torch.randn((b, s, hq, d), generator=gen, device=cuda) \
        .to(dtype).transpose(1, 2)
    k, v = (torch.randn((b, hkv, s, d), generator=gen, device=cuda)
            .to(dtype) for _ in range(2))
    do = torch.randn((b, hq, s, d), generator=gen, device=cuda).to(dtype)
    _build.launches.clear()
    got_o, got = _grads_of(lambda *a: flash_ops.flash_attention(*a, **kw),
                           (q, k, v), (do,))
    torch.cuda.synchronize()
    assert dict(_build.launches) == {flash_route(dtype, d): 1}
    want_o, want = _grads_of(lambda *a: flash_attention_ref(*a, **kw),
                             (q, k, v), (do,))
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got_o[0], want_o[0], atol=tol, rtol=tol)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_wkv_autograd_route_gradients_equal_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, h, s, d = 2, 4, 64, 64
    dt = getattr(torch, dtype)
    r, k, v = ((torch.randn((b, s, h, d), generator=gen, device=cuda) * 0.4)
               .to(dt).transpose(1, 2) for _ in range(3))
    logw = torch.clamp(-torch.exp(torch.randn(
        (b, h, s, d), generator=gen, device=cuda) * 0.3 - 0.6), -4.25, -1e-6)
    u = torch.randn((h, d), generator=gen, device=cuda) * 0.3
    state = torch.randn((b, h, d, d), generator=gen, device=cuda) * 0.5
    do = torch.randn((b, h, s, d), generator=gen, device=cuda).to(dt)
    dstate = torch.randn((b, h, d, d), generator=gen, device=cuda)
    ins = (r, k, v, logw, u, state)
    _build.launches.clear()
    got_o, got = _grads_of(lambda *a: wkv_ops.wkv_with_state(*a), ins,
                           (do, dstate))
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"wkv_split": 1}
    want_o, want = _grads_of(lambda *a: wkv_chunked_ref(*a), ins,
                             (do, dstate))
    tol = 2e-2 if dtype == "bfloat16" else 5e-4
    torch.testing.assert_close(got_o[0], want_o[0], atol=tol, rtol=tol)
    torch.testing.assert_close(got_o[1], want_o[1], atol=1e-3, rtol=1e-3)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


def test_qwen2_smoke_train_step_on_the_card_matches_the_cpu(cuda):
    """One float32 ``make_train_step`` of qwen2's smoke config on the card
    against the same step on the CPU, from the same parameters and batch:
    the loss within 1e-5 relative, every gradient leaf within 1e-4 of its
    largest element (the float32 tolerance of the model tests; summation
    order differs), the params after the step within 2 lr + 1e-5 (Adam's
    first step moves an element by lr * sign(g), and a gradient near 0 may
    take either sign). The card's step launches ``flash_attention`` twice a
    layer (the forward and remat's rerun) and nothing else."""
    from repro_torch.data import SyntheticLM, to_device
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import train_loss, trainable
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_smoke_config("qwen2_0_5b"),
                              dtype="float32")
    host = init_params(cfg, torch.Generator().manual_seed(0))
    card = tree_map(lambda t: t.to(cuda), host)
    batch = next(SyntheticLM(cfg.vocab, 128, 4, seed=0))
    hb, cb = to_device(batch, "cpu"), to_device(batch, cuda)

    def grads(params, b):
        leaves = tree_leaves(trainable(params))
        return torch.autograd.grad(train_loss(cfg, params, b), leaves)

    for g, w in zip(grads(card, cb), grads(host, hb)):
        torch.testing.assert_close(g.cpu(), w, rtol=0,
                                   atol=1e-4 * float(w.abs().max()))
    lr = 3e-4
    step = make_train_step(cfg, lr=lr)
    want_loss, host, _ = step(host, adamw_init(host), hb)
    _build.launches.clear()
    loss, card, state = step(card, adamw_init(card), cb)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"flash_attention": 2 * cfg.n_layers}
    assert int(state.step) == 1
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    for p, w in zip(tree_leaves(card), tree_leaves(host)):
        torch.testing.assert_close(p.detach().cpu(), w.detach(), rtol=0,
                                   atol=2 * lr + 1e-5)


# ------------------------------------------------- determinism and elastic
def _nondeterministic_warnings(fn):
    """Run ``fn`` under ``torch.use_deterministic_algorithms(True,
    warn_only=True)``; its result and the warnings of ops without a
    deterministic implementation (cuBLAS's own, which only
    ``CUBLAS_WORKSPACE_CONFIG`` answers, left out)."""
    import warnings
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    return out, [str(w.message) for w in caught
                 if "determinis" in str(w.message)
                 and "CUBLAS_WORKSPACE_CONFIG" not in str(w.message)]


def test_plain_scans_are_deterministic_on_the_card(fp32_cuda):
    """The WKV scan's plain version (the backward's recompute) and the
    Mamba-2 SSD scan take their in-chunk prefix sums with
    ``inclusive_scan`` (shifted float32 adds) on either device: no op warns
    in deterministic mode, two runs agree bit for bit, and each equals the
    CPU's within float32 rounding. The prefix sums themselves equal the
    CPU's bit for bit, with the TF32 switch on as well as off."""
    from repro_torch.kernels.rwkv6.ref import inclusive_scan
    from repro_torch.models.mamba2 import ssd_chunked
    gen = torch.Generator("cpu").manual_seed(3)
    b, h, s, d = 2, 4, 64, 64
    r, k, v = (torch.randn((b, h, s, d), generator=gen) * 0.4
               for _ in range(3))
    logw = torch.clamp(-torch.exp(torch.randn((b, h, s, d), generator=gen)
                                  * 0.3 - 0.6), -4.25, -1e-6)
    u = torch.randn((h, d), generator=gen) * 0.3
    state = torch.randn((b, h, d, d), generator=gen) * 0.5
    wkv_in = (r, k, v, logw, u, state)
    p, n = 16, 32
    x = torch.randn((b, 128, h, p), generator=gen)
    dt = torch.rand((b, 128, h), generator=gen) * 0.5
    a_log = torch.randn((h,), generator=gen) * 0.5
    B, C = (torch.randn((b, 128, n), generator=gen) for _ in range(2))
    D = torch.randn((h,), generator=gen)
    ssd_in = (x, dt, a_log, B, C, D, torch.zeros((b, h, p, n)))
    for fn, ins in ((wkv_chunked_ref, wkv_in), (ssd_chunked, ssd_in)):
        card = [t.to(fp32_cuda) for t in ins]
        first, warned = _nondeterministic_warnings(lambda: fn(*card))
        assert warned == [], (fn.__name__, warned)
        again, _ = _nondeterministic_warnings(lambda: fn(*card))
        want = fn(*ins)
        for a, b_, w in zip(first, again, want):
            assert torch.equal(a, b_), fn.__name__
            torch.testing.assert_close(a.cpu(), w, rtol=1e-5, atol=1e-5)
    lw = logw.reshape(b, h, s // 16, 16, d)
    want = inclusive_scan(lw, dim=3)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            got = inclusive_scan(lw.to(fp32_cuda), dim=3)
            assert torch.equal(got.cpu(), want), tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_elastic_trainer_on_the_card(cuda):
    """``ElasticTrainer`` on one card at qwen2's smoke size in bf16, as
    ``chip_smoke.py``'s elastic phase runs it at full size: it computes on
    the card by default; the ladder trainer's ``scale_to(1)`` is a generic
    hit with no build, the other's is cold with one; both take the same
    three steps from the same state with equal losses, bit for bit, each
    step launching the flash route twice a layer (remat reruns it)."""
    import torch.distributed as dist
    from repro_torch.data import SyntheticLM
    from repro_torch.elastic import ElasticTrainer
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init

    cfg = get_smoke_config("qwen2_0_5b")
    batches = [next(SyntheticLM(cfg.vocab, 64, 4, seed=s)) for s in range(3)]

    def make_step(mesh):
        inner = make_train_step(cfg, mesh=mesh)

        def step(state, b):
            loss, params, opt = inner(*state, b)
            return loss, (params, opt)
        return step

    def init_state():
        p = init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
        return (p, adamw_init(p))

    route = flash_route(cfg.param_dtype, cfg.d_head)
    runs = []
    assert not dist.is_initialized()
    try:
        for ladder in ((1,), ()):
            tr = ElasticTrainer(cfg, make_step, init_state, ladder=ladder,
                                example_batch=batches[0])
            assert tr.device.type == "cuda"
            tr.prewarm()
            built = tr.n_builds
            ev = tr.scale_to(1)
            losses = []
            for b in batches:
                _build.launches.clear()
                losses.append(tr.train_step(b))
                torch.cuda.synchronize()
                assert dict(_build.launches) == {route: 2 * cfg.n_layers}
            runs.append((built, ev["kind"], tr.n_builds - built, losses))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    (hb, hk, hs, hl), (cb, ck, csb, cl) = runs
    assert (hb, hk, hs) == (1, "generic", 0)
    assert (cb, ck, csb) == (0, "cold", 1)
    assert all(torch.isfinite(x) for x in hl)
    assert all(torch.equal(a, b) for a, b in zip(hl, cl))


def test_meta_tensors_take_the_plain_version_cuda_tensors_the_kernel(cuda):
    """The dry run traces on the meta device: there the model kernels'
    wrappers give the plain version's result (shapes and dtypes, nothing
    computed, no launch), while the same call on CUDA tensors still
    launches the kernel its route names."""
    q = torch.empty((1, 14, 256, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 2, 256, 64), dtype=torch.bfloat16, device="meta")
    _build.launches.clear()
    o = flash_ops.flash_attention(q, k, k, causal=True)
    assert o.device.type == "meta" and o.shape == q.shape
    assert o.dtype == torch.bfloat16 and dict(_build.launches) == {}
    gen = torch.Generator(device=cuda).manual_seed(0)
    qc, kc, vc = (torch.randn(t.shape, generator=gen, device=cuda)
                  .to(torch.bfloat16) for t in (q, k, k))
    got = flash_ops.flash_attention(qc, kc, vc, causal=True)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {flash_route(torch.bfloat16, 64): 1}
    want = flash_attention_ref(qc, kc, vc, causal=True)
    assert float((got.float() - want.float()).abs().max()) <= 2e-2

    ins = _wkv_inputs(cuda, 1, 64, 32, 64, 64)
    metas = [torch.empty(t.shape, dtype=t.dtype, device="meta") for t in ins]
    _build.launches.clear()
    o, state = wkv_ops.wkv_with_state(*metas)
    assert o.device.type == "meta" and o.shape == (1, 64, 32, 64)
    assert state.shape == (1, 64, 64, 64) and dict(_build.launches) == {}
    wkv_ops.wkv_with_state(*ins)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"wkv_split": 1}


def test_one_rank_nccl_pipeline_equals_the_sequential_stack(cuda):
    """``pipeline_apply`` over a one-rank NCCL "stage" mesh on the card: a
    small stack of qwen2's smoke layers in bf16, 3 microbatches; the
    outputs equal the stack run microbatch by microbatch bit for bit, each
    microbatch launching the flash route once a layer."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.distributed import pipeline_apply
    from repro_torch.launch.mesh import ensure_process_group
    from repro_torch.models.blocks import dense_layer_full
    from repro_torch.models.model import _layers

    cfg = get_smoke_config("qwen2_0_5b")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    blocks = params["blocks"]
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((3, 1, 64, cfg.d_model), generator=gen,
                    device=cuda).to(cfg.param_dtype)

    def stage_fn(p, h):
        pos = torch.arange(h.shape[1], device=h.device).expand(h.shape[0],
                                                                -1)
        for p_l in _layers(p):
            h = dense_layer_full(cfg, p_l, h, pos, cfg.sliding_window)[0]
        return h

    assert not dist.is_initialized()
    ensure_process_group()
    try:
        assert dist.get_backend() == "nccl"
        mesh = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("stage",))
        _build.launches.clear()
        got = pipeline_apply(stage_fn, blocks, x, mesh)
        torch.cuda.synchronize()
        route = flash_route(cfg.param_dtype, cfg.d_head)
        assert dict(_build.launches) == {route: 3 * cfg.n_layers}
    finally:
        dist.destroy_process_group()
    want = torch.stack([stage_fn(blocks, mb) for mb in x])
    assert got.dtype == want.dtype and torch.equal(got, want)


# ------------------------------------------------------------ decode graphs
#: one smoke config a family: dense, local/global dense, MoE, MLA, SSM,
#: hybrid, encoder-decoder
GRAPH_FAMILIES = ["qwen2_0_5b", "gemma2_2b", "olmoe_1b_7b",
                  "deepseek_v2_236b", "rwkv6_7b", "zamba2_1_2b",
                  "seamless_m4t_medium"]
GRAPH_PROMPT = 32


def _served_model(cuda, arch, batch=4, max_len=64):
    """A smoke config on the card in its own dtype and a prefill of
    ``batch`` prompts of ``GRAPH_PROMPT`` tokens (an encoder-decoder's:
    frames and decoder tokens): (cfg, params, logits, cache)."""
    cfg = get_smoke_config(arch)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = init_params(cfg, gen, cuda)
    tokens = torch.randint(0, cfg.vocab, (batch, GRAPH_PROMPT), generator=gen,
                           device=cuda, dtype=torch.int32)
    inputs = {"tokens": tokens}
    if cfg.family == "encdec":
        inputs = {"frames": torch.randn((batch, GRAPH_PROMPT, cfg.d_model),
                                        generator=gen, device=cuda),
                  "dec_tokens": tokens}
    logits, cache = prefill(cfg, params, inputs, max_len)
    return cfg, params, logits, cache


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone_tree(v) for v in tree)
    return None if tree is None else tree.clone()


def _greedy(step, params, logits, cache, n, start=GRAPH_PROMPT):
    """``n`` greedy calls of ``step``: (logits rows, served tokens,
    cache)."""
    rows, served = [], []
    for j in range(n):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        served.append(tok)
        logits, cache = step(params, cache, tok, start + j)
        rows.append(logits)
    torch.cuda.synchronize()
    return torch.stack(rows), torch.stack(served), cache


def _same_tree(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("arch", GRAPH_FAMILIES)
def test_decode_graph_replays_equal_eager_steps(cuda, arch):
    """``make_decode_step``'s step, 13 greedy calls from a prefill's cache:
    the first captures, the next 12 replay; its logits, served tokens and
    cache equal 13 eager ``decode_step`` calls' bit for bit."""
    cfg, params, logits, cache = _served_model(cuda, arch)
    want = _greedy(functools.partial(decode_step, cfg), params, logits,
                   _clone_tree(cache), 13)
    step = steps.make_decode_step(cfg)
    steps.decode_calls.clear()
    got = _greedy(step, params, logits, cache, 13)
    assert dict(steps.decode_calls) == {"captured": 1, "replayed": 12}
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _same_tree(got[2], want[2])


def test_decode_graph_advances_rwkv6_state_once_a_call(cuda):
    """rwkv6's recurrent state is advanced once by each call, the capturing
    one too (its eager run gives its answer; the capture launches
    nothing): after each call the state equals that many eager steps'."""
    cfg, params, logits, cache = _served_model(cuda, "rwkv6_7b")
    want = _clone_tree(cache)
    step = steps.make_decode_step(cfg)
    steps.decode_calls.clear()
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    for j, path in enumerate(["captured", "replayed", "replayed"]):
        got, cache = step(params, cache, tok, GRAPH_PROMPT + j)
        ref, want = decode_step(cfg, params, want, tok, GRAPH_PROMPT + j)
        torch.cuda.synchronize()
        assert steps.decode_calls[path] == (1 if path == "captured" else j)
        assert torch.equal(got, ref) and _same_tree(cache, want)
        tok = torch.argmax(got, dim=-1).to(torch.int32)


def test_decode_graph_keys_on_the_cache_address(cuda):
    """A cache at a new address captures a graph of its own, which writes
    that cache and no other; a cache seen before replays its graph. Past
    ``MAX_DECODE_GRAPHS`` addresses the oldest graph is dropped."""
    cfg, params, logits, cache_a = _served_model(cuda, "qwen2_0_5b")
    cache_b, ref = _clone_tree(cache_a), _clone_tree(cache_a)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    step = steps.make_decode_step(cfg)
    steps.decode_calls.clear()
    a0, cache_a = step(params, cache_a, tok, GRAPH_PROMPT)
    a1, cache_a = step(params, cache_a, tok, GRAPH_PROMPT + 1)
    b0, cache_b = step(params, cache_b, tok, GRAPH_PROMPT)
    b1, cache_b = step(params, cache_b, tok, GRAPH_PROMPT + 1)
    a2, cache_a = step(params, cache_a, tok, GRAPH_PROMPT + 2)
    torch.cuda.synchronize()
    assert dict(steps.decode_calls) == {"captured": 2, "replayed": 3}
    assert len(step.graphs) == 2
    assert torch.equal(a0, b0) and torch.equal(a1, b1)
    for j, got in enumerate([a0, a1, a2]):
        want, ref = decode_step(cfg, params, ref, tok, GRAPH_PROMPT + j)
        assert torch.equal(got, want)
    assert _same_tree(cache_a, ref)
    others = [_clone_tree(cache_b) for _ in range(steps.MAX_DECODE_GRAPHS)]
    for other in others:
        step(params, other, tok, GRAPH_PROMPT + 2)
    assert len(step.graphs) == steps.MAX_DECODE_GRAPHS
    steps.decode_calls.clear()
    step(params, cache_a, tok, GRAPH_PROMPT + 3)
    assert dict(steps.decode_calls) == {"captured": 1}


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "rwkv6_7b"])
def test_decode_step_does_not_sync_the_host(cuda, arch):
    """Under ``torch.cuda.set_sync_debug_mode("error")``, which raises at
    any op that waits for the card: an eager ``decode_step``, then the
    graph step's capturing call and a replay."""
    cfg, params, logits, cache = _served_model(cuda, arch)
    step = steps.make_decode_step(cfg)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    steps.decode_calls.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        decode_step(cfg, params, cache, tok, GRAPH_PROMPT)
        step(params, cache, tok, GRAPH_PROMPT + 1)
        step(params, cache, tok, GRAPH_PROMPT + 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert dict(steps.decode_calls) == {"captured": 1, "replayed": 1}


def test_decode_step_under_recording_runs_eagerly_with_its_spans(cuda):
    """With a graph captured for the call's key, a call inside
    ``obs.recording()`` still runs eagerly: the profiler sees the port's
    spans and the MoE counters count every layer's choices."""
    from torch.profiler import ProfilerActivity, profile
    cfg, params, logits, cache = _served_model(cuda, "olmoe_1b_7b")
    step = steps.make_decode_step(cfg)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    step(params, cache, tok, GRAPH_PROMPT)
    steps.decode_calls.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with obs.recording() as tallies:
            step(params, cache, tok, GRAPH_PROMPT + 1)
            torch.cuda.synchronize()
    assert dict(steps.decode_calls) == {"eager": 1}
    names = {e.key for e in prof.key_averages()}
    assert {"model.decode_step", "layer", "attn.core", "moe.route",
            "moe.dispatch", "moe.experts", "moe.combine"} <= names
    assert tallies["moe.choices"] == 4 * cfg.top_k * cfg.n_layers


def test_decode_graph_keeps_a_key_eager_where_its_capture_fails(cuda,
                                                                 monkeypatch):
    """A step whose head reads a number back to the host (a sync, which a
    capture refuses): each call still gives the eager answer, counted
    ``eager``, and the key is not captured again; the card stays usable,
    and a step without the sync captures and replays as before."""
    from repro_torch.models import model
    cfg, params, logits, cache = _served_model(cuda, "qwen2_0_5b")
    ref = _clone_tree(cache)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    head = model.unembed_chunk
    reads = []

    def reading_head(cfg_, params_, x):
        reads.append(float(x.float().abs().sum()))
        return head(cfg_, params_, x)

    monkeypatch.setattr(model, "unembed_chunk", reading_head)
    step = steps.make_decode_step(cfg)
    steps.decode_calls.clear()
    for j in range(2):
        got, cache = step(params, cache, tok, GRAPH_PROMPT + j)
        want, ref = decode_step(cfg, params, ref, tok, GRAPH_PROMPT + j)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and _same_tree(cache, ref)
    assert dict(steps.decode_calls) == {"eager": 2}
    assert not step.graphs and len(step.refused) == 1
    monkeypatch.setattr(model, "unembed_chunk", head)
    steps.decode_calls.clear()
    got = _greedy(steps.make_decode_step(cfg), params, logits, cache, 3,
                  GRAPH_PROMPT + 2)
    want = _greedy(functools.partial(decode_step, cfg), params, logits, ref,
                   3, GRAPH_PROMPT + 2)
    assert dict(steps.decode_calls) == {"captured": 1, "replayed": 2}
    assert torch.equal(got[0], want[0]) and _same_tree(got[2], want[2])
