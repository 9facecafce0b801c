"""The port's serverless chain hop (``repro_torch.serverless``) against the
JAX package's ``repro.serverless``: the slab wire format, chain epochs
(krcore hops through the chunk-gather's plain version on the CPU), the
failover epoch, the gates of ``benchmarks/serverless.py::check_gates``,
the warm pool and the listener cache; and a CPU rehearsal of
``chip_smoke.py``'s chain phase.

Tolerance: exact. Slabs and outputs are bytes, and the simulated clock and
every ``ChainReport`` field come from the same deterministic simulation.
"""

import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.serverless as jsl
import repro_torch.core as tcore
import repro_torch.serverless as tsl
from repro_torch.kernels import _build

ROOT = Path(__file__).resolve().parent.parent
CHAIN = ("extract", "transform", "load")
PACKAGES = {"jax": (jcore, jsl), "port": (tcore, tsl)}


def _payloads(rng, k, nbytes):
    return [rng.randint(0, 256, nbytes).astype(np.uint8) for _ in range(k)]


def _fields(rep):
    return dict(transport=rep.transport, k=rep.k, total_us=rep.total_us,
                transfer_us=rep.transfer_us,
                hops=[dataclasses.asdict(h) for h in rep.hops],
                stages=[dataclasses.asdict(s) for s in rep.stages])


def _runner(pkg, transport="krcore", n_nodes=3, payload_bytes=1024,
            **kw):
    core, sl = PACKAGES[pkg]
    cluster = core.make_cluster(n_nodes=n_nodes, n_meta=1)
    reg = sl.default_registry(payload_bytes=payload_bytes)
    pool_kw = {k: kw.pop(k) for k in ("warm_target", "prewarm_threshold")
               if k in kw}
    pool = sl.ContainerPool(cluster, transport, **pool_kw)
    if pkg == "port":
        kw.setdefault("device", "cpu")
    runner = sl.ChainRunner(cluster, reg, pool, transport, **kw)
    return cluster, reg, pool, runner


def _epoch(cluster, runner, payloads, name="chain", before=None):
    def scenario():
        if before is not None:
            yield from before()
        return (yield from runner.run_batch(CHAIN, ["n0", "n1", "n2"],
                                            len(payloads), payloads))

    return cluster.env.run_process(scenario(), name)


# ======================================================= slab wire format
@pytest.mark.parametrize("seq,sizes", [(0, [1]), (3, [700, 0, 4096, 9]),
                                       (7, [100] * 20), (2, []),
                                       (1, [0, 0, 3])])
def test_encode_slab_byte_identical_to_reference(seq, sizes):
    rng = np.random.RandomState(11 + len(sizes))
    payloads = [rng.randint(0, 256, n).astype(np.uint8) for n in sizes]
    raw = tsl.encode_slab(payloads, seq=seq, device="cpu")
    ref = jsl.encode_slab(payloads, seq=seq)
    assert raw.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(raw, ref)
    assert len(raw) % 512 == 0           # chunk-aligned wire size
    got_seq, got = tsl.decode_slab(raw, device="cpu")
    ref_seq, ref_got = jsl.decode_slab(ref)
    assert got_seq == ref_seq == seq
    assert len(got) == len(ref_got) == len(payloads)
    for a, b, p in zip(got, ref_got, payloads):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, p)


def test_slab_capacity_matches_reference():
    for group, nbytes in ((1, 1), (16, 1024), (16, 65536), (4, 900)):
        assert tsl.slab_capacity_bytes(group, nbytes) == \
            jsl.slab_capacity_bytes(group, nbytes)


def test_slab_defaults_to_the_card():
    payloads = [np.arange(10, dtype=np.uint8)]
    if torch.cuda.is_available():
        np.testing.assert_array_equal(tsl.encode_slab(payloads),
                                      jsl.encode_slab(payloads))
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsl.encode_slab(payloads)


# ============================================================ chain epochs
@pytest.mark.parametrize("k,slab,nbytes", [(8, 4, 1024), (5, 16, 333)])
def test_chain_epoch_matches_reference(k, slab, nbytes):
    """Every ChainReport field and every output byte equal across the two
    packages; the port launches no kernel on the CPU."""
    reports = {}
    _build.launches.clear()
    for pkg in PACKAGES:
        cluster, reg, _, runner = _runner(pkg, payload_bytes=nbytes,
                                          slab_payloads=slab)
        payloads = _payloads(np.random.RandomState(k), k, nbytes)
        reports[pkg] = _epoch(cluster, runner, payloads)
        exp = jsl.expected_outputs(reg, CHAIN, payloads)
        assert all(np.array_equal(a, b)
                   for a, b in zip(reports[pkg].outputs, exp)), pkg
    assert not _build.launches
    assert _fields(reports["port"]) == _fields(reports["jax"])
    for a, b in zip(reports["port"].outputs, reports["jax"].outputs):
        np.testing.assert_array_equal(a, b)
    assert [h.groups for h in reports["port"].hops] == \
        [math.ceil(k / slab)] * 2


def _kill_n1(cluster, core):
    """Cache n0's DCT metadata and a checked MR of n1, then kill n1 (the
    scenario of tests/test_serverless.py)."""
    m0 = cluster.module("n0")
    qd = yield from m0.sys_queue()
    yield from m0.sys_qconnect(qd, "n1")
    mr_r = yield from cluster.module("n1").sys_qreg_mr(4096)
    mr_l = yield from m0.sys_qreg_mr(4096)
    rc = yield from m0.sys_qpush(qd, [core.WorkRequest(
        op="READ", wr_id=1, local_mr=mr_l, local_off=0,
        remote_rkey=mr_r.rkey, remote_off=0, nbytes=8)])
    assert rc == 0
    yield from m0.qpop_block(qd)
    assert m0.dccache.get("n1") is not None
    assert m0.mrstore.get("n1", mr_r.rkey) is not None
    cluster.fabric.node("n1").alive = False


def test_failover_chain_matches_reference():
    reports, pools, m0s = {}, {}, {}
    for pkg, (core, sl) in PACKAGES.items():
        cluster, reg, pool, runner = _runner(
            pkg, n_nodes=4, payload_bytes=900, slab_payloads=4,
            standby={"n1": "n3"})
        payloads = _payloads(np.random.RandomState(3), 6, 900)
        reports[pkg] = _epoch(cluster, runner, payloads,
                              before=lambda c=cluster, m=core: _kill_n1(c, m))
        exp = sl.expected_outputs(reg, CHAIN, payloads)
        assert all(np.array_equal(a, b)
                   for a, b in zip(reports[pkg].outputs, exp)), pkg
        pools[pkg], m0s[pkg] = pool, cluster.module("n0")
    rep = reports["port"]
    assert _fields(rep) == _fields(reports["jax"])
    assert sum(h.failovers for h in rep.hops) >= 1
    assert [s.node for s in rep.stages] == ["n0", "n3", "n2"]
    m0 = m0s["port"]
    assert m0.dccache._cache.get("n1") is None
    assert not any(r == "n1" for (r, _) in m0.mrstore._cache)
    assert not any(p.has_rc("n1") for p in m0.pools)
    assert pools["port"].warm_count("n1", "transform") == 0


# ======================================================== check_gates
def test_chain_doorbell_budget_on_the_port():
    """<= ceil(K/slab) sender doorbells per hop (one in practice), and the
    final payloads byte-exact."""
    k, slab = 32, 16
    cluster, reg, _, runner = _runner("port", slab_payloads=slab)
    payloads = _payloads(np.random.RandomState(0), k, 1024)
    rep = _epoch(cluster, runner, payloads)
    exp = tsl.expected_outputs(reg, CHAIN, payloads)
    assert all(np.array_equal(a, b) for a, b in zip(rep.outputs, exp))
    budget = math.ceil(k / slab)
    assert len(rep.hops) == 2
    for hop in rep.hops:
        assert 0 < hop.doorbells <= budget, (hop.doorbells, budget)
        assert hop.groups == budget


@pytest.mark.parametrize("nbytes", [1024, 8192, 16 * 1024])
def test_chain_transfer_beats_verbs_by_90_percent_on_the_port(nbytes):
    """KRCore end-to-end transfer (control + data plane) for payloads <=
    16 KiB is >= 90% below the VerbsProcess transport, and both transports
    give the same simulated times as the reference."""
    k = 4
    transfer = {}
    for transport in ("krcore", "verbs"):
        for pkg in PACKAGES:
            cluster, reg, _, runner = _runner(pkg, transport,
                                              payload_bytes=nbytes)
            payloads = _payloads(np.random.RandomState(1), k, nbytes)
            rep = _epoch(cluster, runner, payloads, transport)
            exp = jsl.expected_outputs(reg, CHAIN, payloads)
            assert all(np.array_equal(a, b)
                       for a, b in zip(rep.outputs, exp)), (transport, pkg)
            transfer[transport, pkg] = rep.transfer_us
    assert transfer["krcore", "port"] == transfer["krcore", "jax"]
    assert transfer["verbs", "port"] == transfer["verbs", "jax"]
    reduction = 1 - transfer["krcore", "port"] / transfer["verbs", "port"]
    assert reduction >= 0.90, reduction      # paper: 99%


def test_chain_second_epoch_hits_warm_pool_on_the_port():
    cluster, reg, _, runner = _runner("port", payload_bytes=512,
                                      slab_payloads=8, warm_target=4,
                                      prewarm_threshold=1)
    rng = np.random.RandomState(2)
    reports = []
    for e in range(2):
        payloads = _payloads(rng, 4, 512)
        rep = _epoch(cluster, runner, payloads, f"e{e}")
        exp = tsl.expected_outputs(reg, CHAIN, payloads)
        assert all(np.array_equal(a, b) for a, b in zip(rep.outputs, exp))
        reports.append(rep)
        cluster.env.run()                    # background prewarm settles
    assert all(s.warm == 0 for s in reports[0].stages)
    assert sum(s.warm for s in reports[1].stages) > 0
    assert (sum(s.fork_wall_us for s in reports[1].stages)
            < sum(s.fork_wall_us for s in reports[0].stages))


def test_chain_listener_cache_drops_hop_control_cost_on_the_port():
    per_pkg = {}
    for pkg in PACKAGES:
        cluster, reg, _, runner = _runner(pkg, payload_bytes=512,
                                          slab_payloads=8, warm_target=4)
        rng = np.random.RandomState(5)
        reports = []
        for e in range(2):
            payloads = _payloads(rng, 8, 512)
            rep = _epoch(cluster, runner, payloads, f"e{e}")
            exp = jsl.expected_outputs(reg, CHAIN, payloads)
            assert all(np.array_equal(a, b)
                       for a, b in zip(rep.outputs, exp))
            reports.append(rep)
        per_pkg[pkg] = [_fields(r) for r in reports]
        if pkg == "port":
            ctl = [sum(h.control_us for h in r.hops) for r in reports]
            assert ctl[0] > 0 and ctl[1] < 0.2 * ctl[0], ctl
            assert set(runner._listeners) == {"n1", "n2"}
            assert [h.doorbells for h in reports[0].hops] == \
                [h.doorbells for h in reports[1].hops]
    assert per_pkg["port"] == per_pkg["jax"]


# ========================================== chip_smoke's chain, rehearsed
def test_chip_smoke_chain_path_rehearsed_on_cpu():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    size = dict(ks=(2, 5), payload_bytes=300, slab_payloads=4, ragged_k=9,
                ragged_max_bytes=5000, seed=1)
    res = smoke.chain_path("cpu", **size)
    # on the CPU the plain version runs: no kernel may have been launched
    assert res["launches"] == {}
    cells = res["cells"]
    assert len(cells) == 4
    for name, row in cells.items():
        for rep in row["reports"]:
            for hop in rep["hops"]:
                assert 0 < hop["doorbells"]
        if "reduction_vs_verbs" in row:
            assert row["reduction_vs_verbs"] >= 0.90
    ragged = smoke._ragged(np.random.default_rng(0), 64, 64 * 1024)
    sizes = [len(p) for p in ragged]
    assert min(sizes) == 1 and max(sizes) == 64 * 1024 and len(sizes) == 64
    # live bytes: row 0 fully, row 1 up to its largest valid (3), row 5
    # fully (valid above the chunk); the row that valid 0 routes is not read
    rows = torch.tensor([0, 1, 1, 5], dtype=torch.int32)
    valid = torch.tensor([128, 3, 0, 200], dtype=torch.int32)
    assert smoke._gather_bytes(rows, valid) == \
        4 * (128 + 3 + 128) + 4 * (4 * 128 + 8)
