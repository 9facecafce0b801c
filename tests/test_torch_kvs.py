"""The port's device RACE tables (``repro_torch.kvs``) against the JAX
package's (``repro.kvs.race``), on the same keys and values made from a
seed: bit-identical host state after ``insert``, equal ``lookup_batch``
results, state carried across with ``from_numpy``, the vectorised key
hashing, and the ``chip_smoke.py`` main path rehearsed on the CPU."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kvs import race as jrace
from repro_torch.kvs import race
from repro_torch.kvs import DeviceRaceTable, ShardedDeviceRaceTable

ROOT = Path(__file__).resolve().parent.parent
#: port impl -> the JAX impl that runs the same kernel
IMPLS = [("kernel", "pallas"), ("scalar", "pallas_scalar"), ("ref", "ref")]


def _equal(port, jax_out):
    v, f = port
    assert v.dtype == torch.float32 and f.dtype == torch.int32
    np.testing.assert_array_equal(f.numpy(), np.asarray(jax_out[1]))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jax_out[0]))


def _same_state(port_fp, port_val, port_loads, j):
    np.testing.assert_array_equal(port_fp, j._fp)
    np.testing.assert_array_equal(port_val, j._val)
    np.testing.assert_array_equal(port_loads, j._loads)


def _load_both(rng, nkeys, vdim, port, jax_table, extra_keys=()):
    keys = [int(k) for k in rng.choice(np.arange(2, 5000), size=nkeys,
                                       replace=False)] + list(extra_keys)
    vals = {}
    for k in keys:
        v = rng.randn(vdim).astype(np.float32)
        port.insert(k, v)
        jax_table.insert(k, v)
        vals[k] = v
    return keys, vals


# keys at the edges of the vectorised range [0, 2**32) and beyond it (hashed
# per key), with distinct fingerprints: a fingerprint depends only on
# k mod 2**31, and RACE cannot tell apart keys that share one and a bucket
EDGE_KEYS = [0, 2 ** 31 + 8000, 2 ** 32 - 1, 2 ** 32 + 6000, 2 ** 40 + 7000,
             2 ** 63 - 2, -7, -(2 ** 40) - 9]
HASH_KEYS = EDGE_KEYS + [1, 2 ** 31, 2 ** 32, 2 ** 63 - 1, -1, -(2 ** 40)]


@settings(max_examples=5, deadline=None)
@given(st.integers(0, 10_000))
def test_device_table_insert_and_lookup_match_jax(seed):
    rng = np.random.RandomState(seed % (2 ** 31))
    port = DeviceRaceTable(n_buckets=128, nslot=8, vdim=32, device="cpu")
    jt = jrace.DeviceRaceTable(n_buckets=128, nslot=8, vdim=32)
    keys, vals = _load_both(rng, 60, 32, port, jt, EDGE_KEYS)
    _same_state(port._fp, port._val, port._loads, jt)
    queries = np.concatenate([keys[:20], EDGE_KEYS,
                              rng.randint(10_000, 20_000, 10)])
    for impl, jimpl in IMPLS:
        _equal(port.lookup_batch(queries, impl=impl),
               jt.lookup_batch(queries, impl=jimpl))
    v, f = port.lookup_batch(queries)
    assert f[:20 + len(EDGE_KEYS)].all() and not f[20 + len(EDGE_KEYS):].any()
    for i, k in enumerate(queries[:20 + len(EDGE_KEYS)]):
        np.testing.assert_array_equal(v[i].numpy(), vals[int(k)])


@pytest.mark.parametrize("ns,nb", [(3, 32), (4, 31)])
def test_sharded_table_insert_and_lookup_match_jax(ns, nb):
    rng = np.random.RandomState(9)
    port = ShardedDeviceRaceTable(n_shards=ns, n_buckets=nb, nslot=8,
                                  vdim=32, device="cpu")
    jt = jrace.ShardedDeviceRaceTable(n_shards=ns, n_buckets=nb, nslot=8,
                                      vdim=32)
    keys, vals = _load_both(rng, 59, 32, port, jt, EDGE_KEYS)
    for s in range(ns):
        _same_state(port._fp[s], port._val[s], port._loads[s], jt.shards[s])
    qk = np.concatenate([keys, np.arange(10_000, 10_010)])
    for impl, jimpl in IMPLS:
        _equal(port.lookup_batch(qk, impl=impl),
               jt.lookup_batch(qk, impl=jimpl))
    v, f = port.lookup_batch(qk)
    assert f[:len(keys)].all() and not f[len(keys):].any()
    for i, k in enumerate(keys):
        np.testing.assert_array_equal(v[i].numpy(), vals[k])


@settings(max_examples=6, deadline=None)
@given(st.integers(1, 5), st.integers(0, 10_000))
def test_sharded_table_scalar_lookups_match_jax(ns, seed):
    """``lookup_batch(impl="scalar")``: the host split and one scalar call
    a shard with keys, against JAX's ``"pallas_scalar"``; a batch whose
    keys all lie in one shard leaves the other shards without a call."""
    rng = np.random.RandomState(seed % (2 ** 31))
    port = ShardedDeviceRaceTable(n_shards=ns, n_buckets=29, nslot=8,
                                  vdim=16, device="cpu")
    jt = jrace.ShardedDeviceRaceTable(n_shards=ns, n_buckets=29, nslot=8,
                                      vdim=16)
    keys, vals = _load_both(rng, 40, 16, port, jt)
    shards = np.array([port.shard_of(k) for k in keys])
    one = [k for k, s in zip(keys, shards) if s == shards[0]]
    for qk in (np.array(keys + [70_001, 70_002]), np.array(one)):
        v, f = port.lookup_batch(qk, impl="scalar")
        _equal((v, f), jt.lookup_batch(qk, impl="pallas_scalar"))
        for i, k in enumerate(qk.tolist()):
            if k in vals:
                assert f[i] == 1
                np.testing.assert_array_equal(v[i].numpy(), vals[k])


def test_lookup_batch_hands_numpy_routing_to_the_ops(monkeypatch):
    """Both tables keep the hashed routing on the host: the ops get numpy
    int32 arrays (on the card, the kernels' by-value routes take them with
    no copy)."""
    seen = []

    def spy(fp, val, *routing, impl="kernel"):
        seen.append(routing)
        return impl

    monkeypatch.setattr(race, "race_lookup", spy)
    monkeypatch.setattr(race, "race_lookup_sharded", spy)
    for table in (DeviceRaceTable(31, 8, 4, device="cpu"),
                  ShardedDeviceRaceTable(3, 31, 8, 4, device="cpu")):
        assert table.lookup_batch(np.arange(5, 25), impl="scalar") == "scalar"
    assert [len(r) for r in seen] == [2, 3]
    for routing in seen:
        assert all(isinstance(a, np.ndarray) and a.dtype == np.int32
                   for a in routing)


def test_from_numpy_carries_jax_state():
    rng = np.random.RandomState(4)
    jt = jrace.DeviceRaceTable(n_buckets=64, nslot=4, vdim=16)
    keys = rng.choice(np.arange(1, 3000), size=80, replace=False)
    for k in keys:
        jt.insert(int(k), rng.randn(16).astype(np.float32))
    port = DeviceRaceTable.from_numpy(jt._fp, jt._val, jt._loads,
                                      device="cpu")
    _same_state(port._fp, port._val, port._loads, jt)
    qk = np.concatenate([keys, np.arange(4000, 4010)])
    _equal(port.lookup_batch(qk), jt.lookup_batch(qk))
    assert torch.equal(port.fp_table, torch.from_numpy(jt._fp))
    assert torch.equal(port.val_table, torch.from_numpy(jt._val))
    # inserting after the carry continues from the carried loads
    port.insert(5000, np.ones(16, np.float32))
    jt.insert(5000, np.ones(16, np.float32))
    _same_state(port._fp, port._val, port._loads, jt)

    js = jrace.ShardedDeviceRaceTable(n_shards=3, n_buckets=16, nslot=8,
                                      vdim=8)
    for k in keys:
        js.insert(int(k), rng.randn(8).astype(np.float32))
    ps = ShardedDeviceRaceTable.from_numpy(
        np.stack([s._fp for s in js.shards]),
        np.stack([s._val for s in js.shards]),
        np.stack([s._loads for s in js.shards]), device="cpu")
    _equal(ps.lookup_batch(qk), js.lookup_batch(qk))
    with pytest.raises(ValueError):
        DeviceRaceTable.from_numpy(jt._fp, jt._val, jt._loads[:-1],
                                   device="cpu")


def test_dirty_buckets_upload_on_lookup():
    port = DeviceRaceTable(n_buckets=16, nslot=4, vdim=8, device="cpu")
    port.insert(7, np.full(8, 2.0, np.float32))
    assert not port.fp_table.any()              # not uploaded yet
    v, f = port.lookup_batch([7])
    assert f.tolist() == [1] and (v == 2.0).all()
    assert torch.equal(port.fp_table, torch.from_numpy(port._fp))
    assert torch.equal(port.val_table, torch.from_numpy(port._val))
    assert not port._dirty.any()


def test_vectorised_hashing_equals_per_key_formulas():
    rng = np.random.RandomState(1)
    keys = np.concatenate([rng.randint(0, 2 ** 32, 500, dtype=np.int64),
                           np.array(HASH_KEYS, np.int64)])
    for nb in (1, 7, 131_071, 524_287, 2 ** 20):
        fps, bidx = race.query_hashes(keys, nb)
        for i, k in enumerate(keys.tolist()):
            assert fps[i] == (jrace._fp(k) & 0x7FFFFFFF or 1)
            assert (bidx[i, 0], bidx[i, 1]) == (jrace._h1(k, nb),
                                                jrace._h2(k, nb))
    for ns in (1, 3, 4):
        sidx = race.query_shards(keys, ns)
        assert sidx.tolist() == [jrace.shard_of_key(k, ns)
                                 for k in keys.tolist()]
    big = np.array([2 ** 64 - 1, 2 ** 33, 5], np.uint64)
    fps, bidx = race.query_hashes(big, 97)
    assert bidx[:, 0].tolist() == [jrace._h1(int(k), 97) for k in big]
    obj = np.array([2 ** 70, -5, 3], dtype=object)
    assert race.query_shards(obj, 4).tolist() == [
        jrace.shard_of_key(int(k), 4) for k in obj]


def test_copied_helpers_equal_reference():
    for name in ("NSLOT", "STATE_OFF", "STATE_SERVING", "STATE_FROZEN",
                 "STATE_MOVED"):
        assert getattr(race, name) == getattr(jrace, name)
    for state, epoch in [(1, 0), (3, 2 ** 32 - 1), (2, 12345)]:
        w = race.state_word(state, epoch)
        assert w == jrace.state_word(state, epoch)
        assert race.parse_state(w) == jrace.parse_state(w) == (state, epoch)


def test_bucket_overflow_raises_like_jax():
    port = DeviceRaceTable(n_buckets=1, nslot=2, vdim=4, device="cpu")
    jt = jrace.DeviceRaceTable(n_buckets=1, nslot=2, vdim=4)
    for k in (1, 2):
        port.insert(k, np.zeros(4, np.float32))
        jt.insert(k, np.zeros(4, np.float32))
    with pytest.raises(RuntimeError, match="bucket overflow"):
        jt.insert(3, np.zeros(4, np.float32))
    with pytest.raises(RuntimeError, match="bucket overflow"):
        port.insert(3, np.zeros(4, np.float32))
    _same_state(port._fp, port._val, port._loads, jt)


def test_chip_smoke_main_path_rehearsed_on_cpu():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    res = smoke.main_path("cpu", n_buckets=257, shard_buckets=67, n_shards=4,
                          nslot=8, vdim=16, n_keys=600, batches=(8, 64),
                          reps=2, seed=3)
    # on the CPU the plain versions run: no kernel may have been launched
    assert res["launches"] == {}
    wl = smoke.make_workload(3, 600, 16, (8, 64), 2)
    assert len(np.unique(wl["keys"])) == 600
    assert not np.isin(wl["absent"], wl["keys"]).any()
    assert [len(b) for b in wl["reads"][64]] == [64, 64]
