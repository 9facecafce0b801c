"""The port's elastic KV service (``repro_torch.dkv``) and one-sided RACE
clients (``repro_torch.kvs.race``) against the JAX package's ``repro.dkv``
and ``repro.kvs.race``: the scenarios of ``tests/test_dkv.py`` and the
RACE-client cases of ``tests/test_race_and_shardings.py``,
``tests/test_batched_path.py``, ``tests/test_session.py`` and
``tests/test_integration.py`` run through both packages, then the
reference's own assertions hold on the port's result.

Tolerance: exact. The fabric is a deterministic discrete-event simulation
over the same cost constants, so every simulated microsecond, counter,
report field, directory record and stored byte must be identical.

Ids that come from process-global counters (``Node.id``, QPNs, session,
call, epoch, virtqueue and container ids) are never compared between the
packages: the two packages count separately, and how far each counter has
gone depends on which tests ran before in the same process. A directory
record's ``node_id`` is compared as the node's name, and an rkey as its
node-local registration number (``rkey >> 3``; the low bits are
``node.id % 8``). ``test_results_do_not_depend_on_process_global_ids``
shifts the port's counters and runs the scenarios again.

The last test rehearses ``chip_smoke.py``'s ``dkv`` phase on the CPU at a
small size, where the device mirror takes the plain lookup.
"""

import hashlib
import importlib.util
import struct
import types
from pathlib import Path

import numpy as np
import pytest

import repro.core as jcore
import repro.dkv as jdkv
import repro.kvs.race as jrace
import repro_torch.core as tcore
import repro_torch.dkv as tdkv
import repro_torch.kvs.race as trace

ROOT = Path(__file__).resolve().parent.parent
JAX = types.SimpleNamespace(name="jax", core=jcore, dkv=jdkv, race=jrace)
PORT = types.SimpleNamespace(name="port", core=tcore, dkv=tdkv, race=trace)

_VAL = struct.Struct("<II")


def _enc(seq):
    return _VAL.pack(seq & 0xFFFFFFFF, seq & 0xFFFFFFFF)


def _dec(raw):
    a, b = _VAL.unpack_from(raw, 0)
    return a, a != b


def build(p, n_compute=2, n_mem=2, n_shards=4, n_buckets=64, seed_keys=32):
    cluster = p.core.make_cluster(n_nodes=n_compute + n_mem, n_meta=1)
    mem = [f"n{i}" for i in range(n_compute, n_compute + n_mem)]
    svc = p.dkv.DkvService(cluster, mem, n_shards=n_shards,
                           n_buckets=n_buckets)
    for k in range(1, seed_keys + 1):
        svc.seed(k, bytes([k % 250 + 1]))
    return cluster, svc, mem


def _digest(buf) -> str:
    return hashlib.sha256(np.ascontiguousarray(buf).tobytes()).hexdigest()


def _directory(p, svc):
    """Every shard record as the meta server's DrTM-KV holds it, with the
    node id as its name and each rkey as its node-local registration
    number, plus the service record; and the stores' bytes."""
    kv = svc.meta.kv
    buf = kv.node.buffer(kv.addr)
    names = {n.id: name for name, n in svc.cluster.fabric.nodes.items()}

    def raw(key):
        h = p.core.meta.fnv1a(key)
        for probe in range(kv.n_slots):
            off = ((h + probe) % kv.n_slots) * p.core.meta.SLOT
            k, val = kv.parse_slot(buf[off:off + p.core.meta.SLOT])
            if k == h:
                return val
        raise KeyError(key)

    out = {"service": p.dkv.directory.unpack_service(
        raw(p.dkv.service_key(svc.name)))}
    for sid, st in sorted(svc.stores.items()):
        rec = p.core.meta.ShardRecord.unpack(
            raw(p.dkv.shard_key(svc.name, sid)))
        node = svc.cluster.node(names[rec.node_id])
        assert rec.table_rkey & 7 == rec.ctl_rkey & 7 == node.id % 8
        assert rec == svc.record(sid)
        out[sid] = dict(
            epoch=rec.epoch, node=names[rec.node_id],
            table_mr=rec.table_rkey >> 3, ctl_mr=rec.ctl_rkey >> 3,
            n_buckets=rec.n_buckets, state=st.read_state_word(),
            version=st.version, table=_digest(st.node.buffer(st.addr)))
    return out


def _route(route):
    """A resolved route, less its process ids."""
    return dict(shard=route.shard_id, node=route.node, epoch=route.epoch,
                n_buckets=route.record.n_buckets,
                table_mr=route.record.table_rkey >> 3,
                ctl_mr=route.record.ctl_rkey >> 3)


def _cache(cache):
    return dict(hits=cache.hits, misses=cache.misses,
                invalidations=cache.invalidations, epoch=cache.epoch,
                bytes=cache.memory_bytes())


def _both(scenario, **kw):
    ref = scenario(JAX, **kw)
    port = scenario(PORT, **kw)
    assert port == ref
    return port


# ------------------------------------------------- directory + bootstrap
def _bootstrap_resolves(p):
    cluster, svc, _mem = build(p)
    env = cluster.env
    out = {}

    def scenario():
        cl = p.dkv.DkvClient(cluster.module("n0"))
        out["us"] = yield from cl.bootstrap()
        routes = []
        for sid in range(svc.n_shards):
            route = yield from cl.dir.resolve(sid)
            routes.append(_route(route))
        out["routes"] = routes
        out["vals"] = yield from cl.get_many(list(range(1, 17)))
        out["missing"] = yield from cl.get(9_999)
        out["cache"] = _cache(cl.dir.cache)
        out["ops"] = {n: s.stat_ops for n, s in cl._sessions.items()}
        return True

    env.run_process(scenario(), "s")
    out["now"] = env.now
    out["owners"] = [svc.owner(s) for s in range(svc.n_shards)]
    out["directory"] = _directory(p, svc)
    return out


def test_bootstrap_resolves_all_shards_and_serves():
    out = _both(_bootstrap_resolves)
    assert out["us"] < 100.0, out["us"]
    assert [r["node"] for r in out["routes"]] == out["owners"]
    assert out["vals"] == [bytes([k % 250 + 1]) for k in range(1, 17)]
    assert out["missing"] is None


def _cache_hits(p):
    cluster, svc, _mem = build(p)
    env = cluster.env
    out = {}

    def scenario():
        cl = p.dkv.DkvClient(cluster.module("n0"))
        yield from cl.bootstrap()
        misses0 = cl.dir.cache.misses
        for _ in range(8):
            yield from cl.get(3)
        out["extra_misses"] = cl.dir.cache.misses - misses0
        out["cache"] = _cache(cl.dir.cache)
        return True

    env.run_process(scenario(), "s")
    out["now"] = env.now
    return out


def test_directory_cache_hits_after_bootstrap():
    out = _both(_cache_hits)
    assert out["extra_misses"] == 0
    assert out["cache"]["hits"] >= 8


def _put_get(p):
    cluster, svc, _mem = build(p)
    env = cluster.env
    out = {}

    def scenario():
        cl = p.dkv.DkvClient(cluster.module("n0"))
        yield from cl.bootstrap()
        out["off"] = yield from cl.put(500, b"hello")
        out["v"] = yield from cl.get(500)
        out["off2"] = yield from cl.put(500, b"world")
        out["v2"] = yield from cl.get(500)
        out["t"] = env.now
        return True

    env.run_process(scenario(), "s")
    out["version"] = svc.stores[svc.shard_of(500)].version
    out["directory"] = _directory(p, svc)
    return out


def test_put_then_get_roundtrip_one_sided():
    out = _both(_put_get)
    assert out["v"] == b"hello" and out["v2"] == b"world"
    assert out["off"] == out["off2"]          # updated in place
    assert out["version"] > 0


# ------------------------------------------------- cache invalidation
def _epoch_bump(p):
    cache = p.dkv.DirCache()
    cluster, svc, mem = build(p)
    env = cluster.env
    out = {}

    def scenario():
        cl = p.dkv.DkvClient(cluster.module("n0"), cache=cache)
        yield from cl.bootstrap()
        key = 7
        sid = svc.shard_of(key)
        out["old_node"] = (yield from cl.dir.resolve(sid)).node
        dst = mem[1] if out["old_node"] == mem[0] else mem[0]
        rep = yield from svc.migrate(cluster.module("n1"), sid, dst)
        out["report"] = vars(rep)
        yield from cl.dir.service_info()
        out["cached_after_bump"] = cache.get(sid)
        out["val"] = yield from cl.get(key)
        out["new_node"] = (yield from cl.dir.resolve(sid)).node
        out["redirects"] = cl.stat_redirects
        out["cache"] = _cache(cache)
        return True

    env.run_process(scenario(), "s")
    out["now"] = env.now
    out["directory"] = _directory(p, svc)
    return out


def test_dircache_invalidated_on_shard_map_epoch_bump():
    out = _both(_epoch_bump)
    assert out["cached_after_bump"] is None
    assert out["val"] == bytes([7 % 250 + 1])
    assert out["new_node"] != out["old_node"]
    assert out["redirects"] == 0
    assert out["directory"]["service"] == (2, 4)


def _dead_owner(p):
    cluster, svc, mem = build(p)
    env = cluster.env
    out = {}

    def scenario():
        m0 = cluster.module("n0")
        cl = p.dkv.DkvClient(m0)
        yield from cl.bootstrap()
        key = 7
        sid = svc.shard_of(key)
        old = (yield from cl.dir.resolve(sid)).node
        dst = mem[1] if old == mem[0] else mem[0]
        yield from svc.migrate(cluster.module("n1"), sid, dst)
        cluster.node(old).alive = False
        m0.on_node_death(old)
        out["cached"] = cl.dir.cache.get(sid)
        ops_before = {n: s.stat_ops for n, s in cl._sessions.items()}
        out["val"] = yield from cl.get(key)
        out["old"] = old
        dead_sess = cl._sessions.get(old)
        out["ops_to_dead"] = 0 if dead_sess is None else \
            dead_sess.stat_ops - ops_before.get(old, 0)
        out["ops"] = {n: s.stat_ops for n, s in cl._sessions.items()}
        out["cache"] = _cache(cl.dir.cache)
        return True

    env.run_process(scenario(), "s")
    out["now"] = env.now
    return out


def test_dircache_never_routes_to_dead_or_former_owner():
    out = _both(_dead_owner)
    assert out["cached"] is None
    assert out["val"] == bytes([7 % 250 + 1])
    assert out["ops_to_dead"] == 0


def _tombstone(p):
    cluster, svc, mem = build(p)
    env = cluster.env
    out = {}

    def scenario():
        cl = p.dkv.DkvClient(cluster.module("n0"))
        yield from cl.bootstrap()
        key = 7
        sid = svc.shard_of(key)
        old_store = svc.stores[sid]
        out["old_node"] = old_store.node.name
        dst = mem[1] if old_store.node.name == mem[0] else mem[0]
        yield from svc.migrate(cluster.module("n1"), sid, dst)
        out["val"] = yield from cl.get(key)
        out["redirects"] = cl.stat_redirects
        out["old_state"] = p.race.parse_state(old_store.read_state_word())
        out["new_node"] = (yield from cl.dir.resolve(sid)).node
        out["cache"] = _cache(cl.dir.cache)
        return True

    env.run_process(scenario(), "s")
    out["now"] = env.now
    out["directory"] = _directory(p, svc)
    return out


def test_stale_cached_route_redirects_via_moved_tombstone():
    out = _both(_tombstone)
    assert out["val"] == bytes([7 % 250 + 1])
    assert out["redirects"] >= 1
    assert out["old_state"] == (trace.STATE_MOVED, 2)
    assert out["new_node"] != out["old_node"]


# ------------------------------------------------- live resharding
def _linearizable(p):
    cluster, svc, mem = build(p, n_shards=2, n_buckets=64, seed_keys=8)
    env = cluster.env
    key = 7
    sid = svc.shard_of(key)
    svc.seed(key, _enc(0))
    puts, reads = [], []
    state = {"stop": False, "win": None}

    def writer():
        cl = p.dkv.DkvClient(cluster.module("n1"))
        yield from cl.bootstrap()
        seq = 0
        while not state["stop"]:
            seq += 1
            t0 = env.now
            yield from cl.put(key, _enc(seq))
            puts.append((t0, env.now, seq))
            yield env.timeout(4.0)

    def mover():
        while len(reads) < 20:
            yield env.timeout(5.0)
        dst = mem[1] if svc.owner(sid) == mem[0] else mem[0]
        t0 = env.now
        rep = yield from svc.migrate(cluster.module("n1"), sid, dst)
        state["win"] = (t0, env.now)
        state["report"] = vars(rep)

    def reader():
        cl = p.dkv.DkvClient(cluster.module("n0"))
        yield from cl.bootstrap()
        mp = env.process(mover(), "mover")
        for _ in range(70):
            t0 = env.now
            raw = yield from cl.get(key)
            seq, torn = _dec(raw)
            reads.append((t0, env.now, seq, torn))
            yield env.timeout(2.0)
        state["stop"] = True
        state["redirects"] = cl.stat_redirects
        yield mp
        return True

    def scenario():
        wp = env.process(writer(), "writer")
        yield env.process(reader(), "reader")
        yield wp
        cl = p.dkv.DkvClient(cluster.module("n0"))
        yield from cl.bootstrap()
        raw = yield from cl.get(key)
        return _dec(raw)

    final = env.run_process(scenario(), "prop")
    return dict(final=final, puts=puts, reads=reads, now=env.now,
                directory=_directory(p, svc), **state)


def test_live_migration_linearizable_vs_sequential_oracle():
    out = _both(_linearizable)
    assert out["win"] is not None, "migration never ran"
    lo, hi = out["win"]
    reads, puts = out["reads"], out["puts"]
    assert [r for r in reads if r[1] >= lo and r[0] <= hi]
    assert sum(1 for r in reads if r[3]) == 0, "torn read"
    for t0, t1, seq, _ in reads:
        floor = max([s for (_i, pr, s) in puts if pr <= t0], default=0)
        ceil = max([s for (pi, _r, s) in puts if pi <= t1], default=0)
        assert floor <= seq <= ceil, (t0, t1, seq, floor, ceil)
    final_seq, final_torn = out["final"]
    assert not final_torn
    assert final_seq == max(s for (_i, _r, s) in puts)


def _migrate_all(p):
    cluster, svc, mem = build(p, n_shards=2, n_buckets=64, seed_keys=48)
    env = cluster.env
    out = {"reports": []}

    def scenario():
        cl = p.dkv.DkvClient(cluster.module("n0"))
        yield from cl.bootstrap()
        for sid in range(svc.n_shards):
            dst = mem[1] if svc.owner(sid) == mem[0] else mem[0]
            rep = yield from svc.migrate(cluster.module("n1"), sid, dst)
            out["reports"].append(vars(rep))
        out["vals"] = yield from cl.get_many(list(range(1, 49)))
        yield from cl.put(1, b"post-mig")
        out["post"] = yield from cl.get(1)
        out["states"] = [p.race.parse_state(
            svc.stores[s].read_state_word())[0]
            for s in range(svc.n_shards)]
        out["redirects"] = cl.stat_redirects
        return True

    env.run_process(scenario(), "s")
    out["now"] = env.now
    out["directory"] = _directory(p, svc)
    return out


def test_migration_moves_every_key_and_writes_continue():
    out = _both(_migrate_all)
    assert all(r["copy_rounds"] >= 1 for r in out["reports"])
    assert out["vals"] == [bytes([k % 250 + 1]) for k in range(1, 49)]
    assert out["post"] == b"post-mig"
    assert all(s == trace.STATE_SERVING for s in out["states"])


def _migrate_abort(p):
    cluster, svc, mem = build(p, n_shards=1)
    env = cluster.env
    r = p.race
    out = {"errors": []}

    def scenario():
        sid = 0
        store = svc.stores[sid]
        dst = mem[1] if store.node.name == mem[0] else mem[0]
        store.set_state_local(r.STATE_FROZEN)
        try:
            yield from svc.migrate(cluster.module("n1"), sid, dst)
        except p.dkv.DkvError as e:
            out["errors"].append(str(e))
        out["frozen_kept"] = store.read_state_word() == r.state_word(
            r.STATE_FROZEN, store.epoch)
        store.set_state_local(r.STATE_SERVING)
        try:
            yield from svc.migrate(cluster.module("n1"), sid, dst,
                                   max_rounds=0)
        except p.dkv.DkvError as e:
            out["errors"].append(str(e))
        out["thawed"] = store.read_state_word() == r.state_word(
            r.STATE_SERVING, store.epoch)
        out["t_abort"] = env.now
        rep = yield from svc.migrate(cluster.module("n1"), sid, dst)
        out["report"] = vars(rep)
        cl = p.dkv.DkvClient(cluster.module("n0"))
        yield from cl.bootstrap()
        out["v"] = yield from cl.get(1)
        out["dst"] = dst
        return True

    env.run_process(scenario(), "s")
    out["now"] = env.now
    out["directory"] = _directory(p, svc)
    return out


def test_migrate_rejects_non_serving_shard_and_thaws_on_abort():
    out = _both(_migrate_abort)
    assert len(out["errors"]) == 2
    assert "not SERVING" in out["errors"][0]
    assert "never quiesced" in out["errors"][1]
    assert out["frozen_kept"] and out["thawed"]
    assert out["report"]["dst"] == out["dst"]
    assert out["v"] == bytes([1 % 250 + 1])


# ------------------------------------------------------ worker-pull scaler
def _events(scaler):
    return [vars(e) for e in scaler.events]


def _scale_out(p):
    cluster, svc, _mem = build(p, n_shards=2)
    env = cluster.env
    queues = [p.dkv.PullQueue(env, f"s{i}") for i in range(2)]
    served_keys = []

    def spawn(queue):
        cl = p.dkv.DkvClient(cluster.module("n0"))
        yield env.timeout(cluster.fabric.cm.fork_worker_us)
        yield from cl.bootstrap()

        def serve(key):
            v = yield from cl.get(int(key))
            assert v is not None
            served_keys.append(int(key))
            yield env.timeout(1_000.0)

        return serve

    scaler = p.dkv.WorkerPullAutoscaler(
        env, queues, spawn, min_workers=1, max_workers=4, target_pressure=2,
        check_period_us=500.0).start()

    def scenario():
        keys = [1 + (i % 16) for i in range(24)]
        for k in keys:
            queues[p.race.shard_of_key(k, svc.n_shards) % 2].put(k)
        while not all(q.done for q in queues):
            yield env.timeout(250.0)
        scaler.stop()
        scaler.stop_workers()
        return True

    env.run_process(scenario(), "scale")
    return dict(summary=scaler.summary(), events=_events(scaler),
                served=served_keys, now=env.now,
                waits=[q.wait_us for q in queues])


def test_autoscaler_scales_out_under_spike_and_drains():
    out = _both(_scale_out)
    s = out["summary"]
    assert s["served"] == s["enqueued"] == 24
    assert s["workers_peak"] > 2, "burst never scaled the fleet out"
    assert sorted(out["served"]) == sorted([1 + (i % 16) for i in range(24)])


def _scale_in(p):
    cluster, _svc, _mem = build(p, n_shards=1)
    env = cluster.env
    q = p.dkv.PullQueue(env, "q")

    def spawn(queue):
        yield env.timeout(10.0)

        def serve(item):
            yield env.timeout(500.0)

        return serve

    scaler = p.dkv.WorkerPullAutoscaler(
        env, [q], spawn, min_workers=1, max_workers=4, target_pressure=1,
        check_period_us=200.0, idle_checks_to_scale_in=3).start()

    def scenario():
        for i in range(12):
            q.put(i)
        while not q.done:
            yield env.timeout(100.0)
        yield env.timeout(3_000.0)
        scaler.stop()
        scaler.stop_workers()
        return True

    env.run_process(scenario(), "scalein")
    return dict(summary=scaler.summary(), events=_events(scaler),
                now=env.now, waits=q.wait_us)


def test_autoscaler_scales_back_in_when_idle():
    out = _both(_scale_in)
    assert out["summary"]["served"] == 12
    assert out["summary"]["retires"] >= 1, "idle fleet never scaled in"


# ------------------------------------------------------------ RACE clients
def _race_store(p, n_nodes=2, node="n1", n_buckets=512, n_keys=100):
    cluster = p.core.make_cluster(n_nodes=n_nodes, n_meta=1)
    store = p.race.RaceKVStore(cluster.node(node), n_buckets=n_buckets)
    for k in range(1, n_keys + 1):
        store.insert(k, f"v{k}".encode())
    return cluster, store


def _one_sided_lookup(p):
    cluster, store = _race_store(p)
    env = cluster.env
    client = p.race.RaceClient(cluster.module("n0"), store)
    out = {}

    def scenario():
        t0 = env.now
        yield from client.bootstrap()
        out["boot_us"] = env.now - t0
        out["vals"] = []
        for k in (7, 55, 9999):
            out["vals"].append((yield from client.lookup(k)))
        t0 = env.now
        yield from client.lookup(7)
        out["lookup_us"] = env.now - t0
        qp = client.session.qp
        out["qp"] = (qp.stat_posted, qp.stat_completed, qp.stat_doorbells)
        return True

    env.run_process(scenario(), "s")
    out["version"] = store.version
    out["table"] = _digest(store.node.buffer(store.addr))
    return out


def test_race_one_sided_lookup():
    out = _both(_one_sided_lookup)
    assert out["boot_us"] < 20.0
    assert out["vals"] == [b"v7", b"v55", None]
    assert out["lookup_us"] < 8.0
    assert out["version"] == 100          # one bump a server-side insert


def _lookup_many(p):
    cluster, store = _race_store(p)
    env = cluster.env
    client = p.race.RaceClient(cluster.module("n0"), store)
    out = {}

    def scenario():
        yield from client.bootstrap()
        keys = list(range(1, 49)) + [7777, 8888]
        t0 = env.now
        out["batched"] = yield from client.lookup_many(keys)
        out["batched_us"] = env.now - t0
        t0 = env.now
        out["per_key"] = []
        for k in keys:
            out["per_key"].append((yield from client.lookup(k)))
        out["per_key_us"] = env.now - t0
        out["doorbells"] = client.session.qp.stat_doorbells
        return True

    env.run_process(scenario(), "s")
    return out


def test_race_lookup_many_matches_per_key_and_is_faster():
    out = _both(_lookup_many)
    assert out["batched"] == out["per_key"]
    assert out["batched"][0] == b"v1" and out["batched"][-1] is None
    assert out["batched_us"] < out["per_key_us"] / 2


def _insert_and_version(p):
    cluster = p.core.make_cluster(n_nodes=2, n_meta=1)
    env = cluster.env
    store = p.race.RaceKVStore(cluster.node("n1"), n_buckets=256)
    client = p.race.RaceClient(cluster.module("n0"), store, mr_bytes=8192)
    out = {}

    def scenario():
        yield from client.bootstrap()
        v0 = store.version
        out["off"] = yield from client.insert(7, b"seven")
        out["published"] = store.version - v0
        out["lookup"] = yield from client.lookup(7)
        out["versioned"] = yield from client.versioned_lookup(7)
        store.insert(9, b"nine")
        out["after_local"] = store.version - v0
        yield from client.bump_version()
        yield from client.bump_version_casloop()
        qp = client.session.qp
        p0 = qp.stat_posted
        out["faa_old"] = yield from client.bump_version()
        out["faa_ops"] = qp.stat_posted - p0
        p0 = qp.stat_posted
        out["cas_old"] = yield from client.bump_version_casloop()
        out["cas_ops"] = qp.stat_posted - p0
        out["off2"] = yield from client.insert(7, b"SEVEN")
        out["relookup"] = yield from client.lookup(7)
        out["t"] = env.now
        return True

    env.run_process(scenario(), "s")
    out["version"] = store.version
    out["table"] = _digest(store.node.buffer(store.addr))
    return out


def test_race_client_insert_and_faa_version_path():
    out = _both(_insert_and_version)
    assert out["published"] == 1
    assert out["lookup"] == b"seven"
    assert out["versioned"] == (b"seven", 1)
    assert out["after_local"] == 2
    assert out["faa_ops"] == 1 and out["cas_ops"] >= 2
    assert out["off2"] == out["off"] and out["relookup"] == b"SEVEN"


def _spike_bootstrap(p):
    cluster = p.core.make_cluster(n_nodes=3, n_meta=1)
    env = cluster.env
    store = p.race.RaceKVStore(cluster.node("n2"), n_buckets=256)
    for k in range(1, 33):
        store.insert(k, b"val")
    fork = cluster.modules["n0"].cm.fork_worker_us
    n = 16

    def krcore_spike():
        t0 = env.now
        for i in range(n):
            yield env.timeout(fork)
            client = p.race.RaceClient(cluster.module("n0"), store)
            yield from client.bootstrap()
            v = yield from client.lookup(1 + (i % 32))
            assert v == b"val"
        return env.now - t0

    def verbs_spike():
        t0 = env.now
        for _ in range(n):
            yield env.timeout(fork)
            proc = p.core.VerbsProcess(cluster.node("n1"))
            yield from proc.connect(cluster.node("n2"))
        return env.now - t0

    kr = env.run_process(krcore_spike(), "kr")
    vb = env.run_process(verbs_spike(), "vb")
    return dict(kr=kr, vb=vb, fork=fork, n=n)


def test_race_spike_bootstrap_krcore_vs_verbs():
    out = _both(_spike_bootstrap)
    assert out["vb"] > 5 * out["kr"]
    assert out["kr"] < out["n"] * 1.25 * out["fork"]


def _fenced(p):
    """ShardClient alone: a fenced insert and lookup while SERVING, then
    both redirect once the shard is FROZEN, and lookups redirect once it
    is MOVED."""
    cluster, svc, _mem = build(p, n_shards=1, seed_keys=4)
    env = cluster.env
    r = p.race
    st = svc.stores[0]
    out = []

    def scenario():
        sess = yield from p.core.connect(cluster.module("n0"), st.node.name)
        sc = r.ShardClient(sess, st.n_buckets, st.mr.rkey,
                           st.version_mr.rkey, st.epoch)
        out.append((yield from sc.insert_fenced(40, b"forty")))
        out.append((yield from sc.lookup_fenced(40)))
        out.append((yield from sc.lookup_fenced(3)))
        st.set_state_local(r.STATE_FROZEN)
        out.append((yield from sc.insert_fenced(41, b"x")))
        out.append((yield from sc.lookup_fenced(40)))
        st.set_state_local(r.STATE_MOVED, st.epoch + 1)
        out.append((yield from sc.lookup_fenced(40)))
        out.append((yield from sc.read_state()))
        out.append(env.now)
        out.append(sess.stat_ops)
        return True

    env.run_process(scenario(), "s")
    return dict(out=out, version=st.version,
                table=_digest(st.node.buffer(st.addr)))


def test_shard_client_fences_on_frozen_and_moved():
    out = _both(_fenced)["out"]
    assert out[0][0] == "ok" and out[1] == ("ok", b"forty")
    assert out[2] == ("ok", bytes([3 % 250 + 1]))
    assert out[3] == ("redirect", None) and out[4] == ("redirect", None)
    assert out[5] == ("redirect", None)
    assert trace.parse_state(out[6]) == (trace.STATE_MOVED, 2)


def test_copied_constants_and_exports_equal_reference():
    for name in ("NSLOT", "SLOT_BYTES", "CLAIMED", "STATE_OFF",
                 "STATE_SERVING", "STATE_FROZEN", "STATE_MOVED"):
        assert getattr(trace, name) == getattr(jrace, name), name
    assert trace._SLOT.format == jrace._SLOT.format
    import repro.kvs as jkvs
    import repro_torch.kvs as tkvs
    assert tkvs.__all__ == jkvs.__all__
    assert tdkv.__all__ == jdkv.__all__
    assert tdkv.service_key("kv") == jdkv.service_key("kv")
    assert tdkv.shard_key("kv", 3) == jdkv.shard_key("kv", 3)


# ------------------------------------------ independence from global ids
SCENARIOS = [_bootstrap_resolves, _epoch_bump, _linearizable, _scale_out,
             _fenced]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_results_do_not_depend_on_process_global_ids(scenario):
    """Run a scenario through the port, move every process-global counter
    on by building and driving a throwaway cluster (a different number of
    nodes, QPs, sessions and virtqueues), and run it again: the result is
    the same, so the parity tests above cannot depend on the order in
    which test files share a process."""
    first = scenario(PORT)
    junk = tcore.make_cluster(n_nodes=5, n_meta=2)

    def touch():
        for name in ("n1", "n2", "n3"):
            s = yield from tcore.connect(junk.module("n0"), name)
            s.close()
        return True

    junk.env.run_process(touch(), "junk")
    assert scenario(PORT) == first


# ------------------------------------------ chip_smoke's dkv phase, rehearsed
def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_dkv_phase_rehearsed_on_cpu():
    smoke = _smoke()
    size = dict(smoke.DKV_SMALL)
    res = smoke.dkv_phase("cpu", **size)
    # on the CPU the mirror takes the plain lookup: no kernel launched
    assert res["launches"] == {}
    sim = res["sim"]
    n_batches = size["n_workers"] + 1
    assert res["lookups"] == n_batches + 1
    assert sim["found"] == size["n_workers"] * size["batch"]
    assert sim["absent_found"] == 0
    assert res["bootstrap"]["attach_reduction_vs_verbs"] >= 0.80
    mig = res["migration"]
    assert mig["torn_reads"] == 0 and mig["oracle_violations"] == 0
    assert mig["reads_during_migration"] >= 1
    sc = res["autoscaler"]
    assert sc["krcore_served"] == sc["krcore_enqueued"]
    assert sc["wait_p99_reduction_vs_verbs"] >= 0.2
