"""The port's invocation gateway and traces (``repro_torch.serverless``'s
``gateway`` and ``traces``) against the JAX package's: the gateway and
trace cases of ``tests/test_serverless.py`` and the worker-pull case of
``tests/test_dkv.py`` run through both packages, then the reference's own
assertions hold on the port's result.

Tolerance: exact. Arrivals come from ``np.random.RandomState`` and must be
bit-identical; the gateway runs on the deterministic simulated fabric, so
every record (its ``inv_id`` is the gateway's own count), summary field and
reply byte must be identical. No process-global id (container, node,
session) is compared between the packages.

The last test rehearses ``chip_smoke.py``'s gateway phase on the CPU.
"""

import dataclasses
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest

import repro.core as jcore
import repro.serverless as jsl
import repro_torch.core as tcore
import repro_torch.serverless as tsl

ROOT = Path(__file__).resolve().parent.parent
JAX = types.SimpleNamespace(core=jcore, sl=jsl)
PORT = types.SimpleNamespace(core=tcore, sl=tsl)


def _both(scenario, **kw):
    ref = scenario(JAX, **kw)
    port = scenario(PORT, **kw)
    assert port == ref
    return port


def _records(recs):
    return [dataclasses.asdict(r) for r in recs]


# ========================================================== traces
TRACE_CASES = [
    ("poisson", (300.0, 100_000.0), dict(seed=9)),
    ("poisson", (400.0, 200_000.0), dict(seed=1)),
    ("poisson", (0.0, 1_000.0), dict(seed=1)),
    ("spike", (100.0, 2000.0, 100_000.0, 40_000.0, 20_000.0), dict(seed=4)),
    ("spike", (100.0, 1600.0, 200_000.0, 80_000.0, 40_000.0), dict(seed=2)),
    ("spike", (150.0, 1200.0, 120_000.0, 48_000.0, 24_000.0),
     dict(seed=14)),
    ("diurnal", (400.0, 200_000.0), dict(period_us=200_000.0,
                                        amplitude=0.9, seed=6)),
    ("diurnal", (400.0, 200_000.0), dict(period_us=100_000.0, seed=3)),
]


@pytest.mark.parametrize("shape,args,kw", TRACE_CASES,
                         ids=[f"{c[0]}-{c[2]['seed']}-{i}"
                              for i, c in enumerate(TRACE_CASES)])
def test_traces_bit_identical_to_reference(shape, args, kw):
    got = getattr(tsl.traces, f"{shape}_trace")(*args, **kw)
    want = getattr(jsl.traces, f"{shape}_trace")(*args, **kw)
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def test_traces_deterministic_and_shaped():
    a1 = tsl.poisson_trace(300.0, 100_000.0, seed=9)
    a2 = tsl.poisson_trace(300.0, 100_000.0, seed=9)
    np.testing.assert_array_equal(a1, a2)
    assert len(a1) > 0 and (np.diff(a1) >= 0).all()
    assert a1[-1] < 100_000.0
    sp = tsl.spike_trace(100.0, 2000.0, 100_000.0, 40_000.0, 20_000.0,
                         seed=4)
    burst = ((sp >= 40_000.0) & (sp < 60_000.0)).sum()
    assert burst > 3 * max(len(sp) - burst, 1)
    di = tsl.diurnal_trace(400.0, 200_000.0, period_us=200_000.0,
                           amplitude=0.9, seed=6)
    assert (di < 100_000.0).sum() > 1.5 * (di >= 100_000.0).sum()
    for mod in (tsl, jsl):
        with pytest.raises(ValueError):
            mod.diurnal_trace(10.0, 1000.0, 500.0, amplitude=1.5)
    assert sorted(tsl.traces.TRACES) == sorted(jsl.traces.TRACES)


# ========================================================== gateway
def _open_loop(p):
    cluster = p.core.make_cluster(n_nodes=4, n_meta=1)
    reg = p.sl.default_registry(payload_bytes=1024)
    pool = p.sl.ContainerPool(cluster, "krcore", warm_target=2,
                              prewarm_threshold=2)
    gw = p.sl.InvocationGateway(cluster, reg, pool,
                                worker_nodes=["n0", "n1", "n2"],
                                data_node="n3")
    arrivals = p.sl.poisson_trace(rate_per_s=500.0, duration_us=60_000.0,
                                  seed=5)

    def scenario():
        return (yield from gw.submit_trace("extract", arrivals,
                                           payload_bytes=1024))

    recs = cluster.env.run_process(scenario(), "gw")
    return dict(n_arrivals=len(arrivals), records=_records(recs),
                summary=gw.summary(), now=cluster.env.now,
                fork_us=cluster.fabric.cm.fork_worker_us,
                outstanding=gw.scheduler.outstanding)


def test_gateway_open_loop_admission_and_placement():
    out = _both(_open_loop)
    n = out["n_arrivals"]
    assert n > 5
    assert len(out["records"]) == n and out["summary"]["n"] == n
    assert out["summary"]["max_node_share"] < 0.75
    for r in out["records"]:
        assert r["end_us"] >= r["start_us"] >= r["arrival_us"]
        assert r["kind"] in ("warm", "cold")
        assert r["compute_us"] > 0
        if r["kind"] == "cold":
            assert r["fork_us"] >= out["fork_us"]
    assert out["summary"]["warm"] > 0
    assert set(out["outstanding"].values()) == {0}


def _closed_loop(p):
    cluster = p.core.make_cluster(n_nodes=4, n_meta=1)
    reg = p.sl.default_registry(payload_bytes=256)
    pool = p.sl.ContainerPool(cluster, "krcore", warm_target=2,
                              prewarm_threshold=2)
    gw = p.sl.InvocationGateway(cluster, reg, pool,
                                worker_nodes=["n0", "n1"], data_node="n2",
                                caller_node="n3")
    arrivals = p.sl.poisson_trace(rate_per_s=400.0, duration_us=30_000.0,
                                  seed=8)

    def scenario():
        yield from gw._ensure_data_mr()
        cluster.node("n2").buffer(gw._data_mr.addr)[:256] = 5
        return (yield from gw.submit_trace("extract", arrivals,
                                           payload_bytes=256))

    recs = cluster.env.run_process(scenario(), "gw")
    sess = gw._caller_sessions[recs[0].node]
    fut = sess.call(np.zeros(64, np.uint8),
                    meta={"fn": "extract", "payload_bytes": 256})
    reply = cluster.env.run_process(fut.wait(), "probe")
    expect = reg.get("extract").handler(np.full(256, 5, np.uint8))
    base = gw.last_trace_base
    return dict(n_arrivals=len(arrivals), records=_records(recs),
                summary=gw.summary(),
                window=gw.window_summary(base + 10_000.0, base + 20_000.0),
                reply=bytes(np.asarray(reply.payload)),
                expect=bytes(np.asarray(expect)), now=cluster.env.now)


def test_gateway_closed_loop_returns_function_output_to_caller():
    out = _both(_closed_loop)
    n = out["n_arrivals"]
    assert len(out["records"]) == n and out["summary"]["n"] == n
    for r in out["records"]:
        assert r["response_path"]
        assert r["end_us"] >= r["start_us"] >= r["arrival_us"]
        assert r["compute_us"] > 0
        assert r["kind"] in ("warm", "cold")
    s = out["summary"]
    assert s["p999_us"] >= s["p99_us"] >= s["p50_us"]
    assert out["reply"] == out["expect"]


def _worker_pull(p):
    cluster = p.core.make_cluster(n_nodes=3, n_meta=1)
    reg = p.sl.default_registry(payload_bytes=256)
    pool = p.sl.ContainerPool(cluster, "krcore")
    gw = p.sl.InvocationGateway(cluster, reg, pool,
                                worker_nodes=["n0", "n1"], data_node="n2")
    arrivals = [i * 400.0 for i in range(12)]

    def scenario():
        return (yield from gw.submit_trace_pull(
            "extract", arrivals, payload_bytes=256, max_workers=4,
            check_period_us=500.0))

    recs = cluster.env.run_process(scenario(), "pull")
    scaler = gw.last_autoscaler
    return dict(records=_records(recs), autoscaler=scaler.summary(),
                events=[vars(e) for e in scaler.events],
                summary=gw.summary(), now=cluster.env.now)


def test_gateway_worker_pull_mode_serves_trace():
    out = _both(_worker_pull)
    assert len(out["records"]) == 12
    assert out["autoscaler"]["served"] == 12
    for r in out["records"]:
        assert r["end_us"] >= r["start_us"] >= r["arrival_us"]
        assert r["compute_us"] > 0


def _verbs_gateway(p):
    """The gateway over the verbs transport: its input fetch takes the
    raw-QP branch (``WorkRequest`` READ, polled to completion)."""
    cluster = p.core.make_cluster(n_nodes=3, n_meta=1)
    reg = p.sl.default_registry(payload_bytes=512)
    pool = p.sl.ContainerPool(cluster, "verbs")
    gw = p.sl.InvocationGateway(cluster, reg, pool,
                                worker_nodes=["n0", "n1"], data_node="n2")
    arrivals = p.sl.spike_trace(200.0, 1600.0, 40_000.0, 16_000.0, 8_000.0,
                                seed=3)

    def scenario():
        return (yield from gw.submit_trace("transform", arrivals,
                                           payload_bytes=512))

    recs = cluster.env.run_process(scenario(), "verbs")
    return dict(n_arrivals=len(arrivals), records=_records(recs),
                summary=gw.summary(), now=cluster.env.now)


def test_gateway_verbs_transport_matches_reference():
    out = _both(_verbs_gateway)
    assert len(out["records"]) == out["n_arrivals"] > 0
    assert all(r["data_us"] > 0 for r in out["records"])


def test_scheduler_least_outstanding_round_robin():
    for mod in (tsl, jsl):
        with pytest.raises(ValueError):
            mod.LeastOutstandingScheduler([])
    placed = {}
    for name, mod in (("port", tsl), ("jax", jsl)):
        s = mod.LeastOutstandingScheduler(["a", "b", "c"])
        order = [s.place() for _ in range(4)]
        s.done("a")
        s.done("a")
        order += [s.place() for _ in range(3)]
        placed[name] = (order, dict(s.outstanding))
    assert placed["port"] == placed["jax"]


# ====================================== chip_smoke's gateway phase, rehearsed
def test_chip_smoke_gateway_phase_rehearsed_on_cpu():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    res = smoke.gateway_phase(**smoke.GATEWAY_SMALL)
    assert [r["shape"] for r in res["traces"]] == ["poisson", "spike",
                                                   "diurnal"]
    for row in res["traces"]:
        assert row["n"] == row["arrivals"] > 0
    resp = res["response"]
    assert resp["n"] == resp["arrivals"]
    assert resp["spike_window"]["n"] > 0
    assert res["pull"]["served"] == res["pull"]["n"] == 12
    assert smoke.gateway_gates(res) == []
    # a dropped invocation or an empty spike window fails the gate
    bad = dict(res, response=dict(resp, n=resp["n"] - 1,
                                  spike_window={"n": 0}))
    assert len(smoke.gateway_gates(bad)) == 2
