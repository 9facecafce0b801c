"""The port's copy of the simulated fabric and control plane
(``repro_torch.core``) against the JAX package's ``repro.core``: the same
scenario through both gives the same simulated clock and the same QP
counters.

Tolerance: exact. The simulation is a deterministic discrete-event run
over the same cost constants, so every simulated microsecond and counter
must be identical.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore


def _send_recv(core, n_msgs: int, nbytes: int):
    """n0 connects to a listener on n1, sends ``n_msgs`` payloads in one
    batch scope, and n1 receives them all; then one request/reply call.
    Returns the clock at each step, the sender QP's counters and the
    received bytes."""
    cluster = core.make_cluster(n_nodes=2, n_meta=1)
    env = cluster.env
    m0, m1 = cluster.module("n0"), cluster.module("n1")
    rng = np.random.RandomState(n_msgs * 1000 + nbytes)
    payloads = [rng.randint(0, 256, nbytes).astype(np.uint8)
                for _ in range(n_msgs)]
    marks = {}

    def server(lst):
        msgs = yield from lst.recv_n(1)
        yield from msgs[0].reply(msgs[0].payload[::-1].copy())

    def scenario():
        lst = yield from core.listen(m1, 7000, msg_bytes=nbytes + 64,
                                     window=n_msgs)
        marks["listen"] = env.now
        sess = yield from core.connect(m0, "n1", port=7000)
        marks["connect"] = env.now
        with sess.batch():
            futs = [sess.send(p) for p in payloads]
        yield from sess.wait_all(futs)
        marks["sent"] = env.now
        marks["doorbells_sent"] = sess.qp.stat_doorbells
        got = yield from lst.recv_n(n_msgs)
        marks["received"] = env.now
        env.process(server(lst), "server")
        reply = yield from sess.call(payloads[0]).wait()
        marks["call"] = env.now
        return sess.qp, got, reply

    qp, got, reply = env.run_process(scenario(), "send_recv")
    counters = {name: getattr(qp, name) for name in
                ("stat_posted", "stat_completed", "stat_doorbells",
                 "stat_err_cqes")}
    return dict(marks=marks, now=env.now, counters=counters,
                received=[np.asarray(m.payload) for m in got],
                reply=np.asarray(reply.payload), payloads=payloads)


@pytest.mark.parametrize("n_msgs,nbytes", [(1, 64), (8, 1024), (33, 4000)])
def test_connect_batched_send_recv_matches_reference(n_msgs, nbytes):
    ref = _send_recv(jcore, n_msgs, nbytes)
    port = _send_recv(tcore, n_msgs, nbytes)
    assert port["marks"] == ref["marks"]
    assert port["now"] == ref["now"]
    assert port["counters"] == ref["counters"]
    # the batch scope rang one doorbell for all its sends
    assert port["marks"]["doorbells_sent"] == 1
    assert port["counters"]["stat_err_cqes"] == 0
    assert len(port["received"]) == n_msgs
    for a, b in zip(port["received"], ref["received"]):
        np.testing.assert_array_equal(a, b)
    assert sorted(map(bytes, port["received"])) == \
        sorted(map(bytes, port["payloads"]))
    np.testing.assert_array_equal(port["reply"], ref["reply"])
    np.testing.assert_array_equal(port["reply"], port["payloads"][0][::-1])


def test_core_exports_match_reference():
    assert tcore.__all__ == jcore.__all__
    assert dataclasses.asdict(tcore.DEFAULT) == \
        dataclasses.asdict(jcore.DEFAULT)
