"""The port's ``ExecutablePool``, ``StragglerPolicy`` and
``speculative_map`` against the JAX package's on the CPU.

Both pools are pure Python. Each test drives the two with the same
sequence of calls and holds every result, the stored entries and the
counters equal: the hybrid lookup through a coarsened key, eviction at
``max_entries``, and the background ``specialize_async`` with
``wait_all``.
"""

import threading

import pytest

from repro.elastic import ExecutablePool as JaxPool
from repro.elastic import StragglerPolicy as JaxPolicy
from repro.elastic import speculative_map as jax_speculative_map
from repro_torch.elastic import (ExecutablePool, PoolEntry, StragglerPolicy,
                                 speculative_map)


def _both(**kw):
    return JaxPool(**kw), ExecutablePool(**kw)


def _state(pool):
    """What a caller can see of a pool, besides ``get``'s answers."""
    entries = {k: (e.value, e.kind, e.uses)
               for k, e in pool._entries.items()}
    return (entries, pool.stat_hits, pool.stat_generic_hits,
            pool.stat_misses)


def _ladder(key):
    return ("ladder", key[1])


@pytest.mark.parametrize("coarsen", [None, _ladder])
def test_hybrid_get_matches_jax(coarsen):
    """Exact hits, generic hits through the coarsened key, and misses."""
    kw = {} if coarsen is None else {"coarsen": coarsen}
    calls = [("put", ("ladder", 4), "generic-4", "generic"),
             ("get", ("exact", 4)),
             ("put", ("exact", 4), "special-4", "specialized"),
             ("get", ("exact", 4)),
             ("get", ("exact", 8)),
             ("get", ("ladder", 4)),
             ("put", ("ladder", 8), "generic-8", "generic"),
             ("get", ("exact", 8)),
             ("get", ("exact", 8))]
    results = []
    for pool in _both(**kw):
        seen = []
        for call in calls:
            if call[0] == "put":
                pool.put(call[1], call[2], kind=call[3])
            else:
                seen.append(pool.get(call[1]))
        results.append((seen, _state(pool)))
    assert results[0] == results[1]
    seen, (_, hits, generic, misses) = results[1]
    if coarsen is None:
        assert (hits, generic, misses) == (2, 0, 4)
        assert seen[0] == ("miss", None)
    else:
        assert (hits, generic, misses) == (2, 3, 1)
        assert seen[0] == ("generic", "generic-4")
        assert seen[-1] == ("generic", "generic-8")


@pytest.mark.parametrize("max_entries", [1, 2, 3])
def test_eviction_matches_jax(max_entries):
    """At ``max_entries`` a put drops the least used entry first."""
    results = []
    for pool in _both(max_entries=max_entries):
        seen = []
        for i in range(5):
            pool.put(("k", i), f"v{i}")
            for _ in range(i % 3):
                seen.append(pool.get(("k", i)))
            seen.append(pool.get(("k", 0)))
        results.append((seen, _state(pool)))
    assert results[0] == results[1]
    entries = results[1][1][0]
    assert len(entries) == max_entries
    assert ("k", 4) in entries                   # the newest always stays


def test_specialize_async_matches_jax():
    """A background build lands as a specialized entry with its build time;
    a key already stored or in flight is not built again."""
    results = []
    for pool in _both():
        built = []
        gate = threading.Event()

        def slow():
            gate.wait(5.0)
            built.append("slow")
            return "slow-built"

        pool.put("stored", "kept")
        pool.specialize_async("stored", lambda: built.append("stored"))
        pool.specialize_async("slow", slow)
        pool.specialize_async("slow", lambda: built.append("again"))
        during = pool.get("slow")
        gate.set()
        pool.wait_all()
        entry = pool._entries["slow"]
        assert isinstance(entry.compile_s, float) and entry.compile_s >= 0
        results.append((built, during, pool.get("slow"), pool.get("stored"),
                        entry.kind, _state(pool)))
    assert results[0] == results[1]
    built, during, after, stored, kind, _ = results[1]
    assert built == ["slow"] and during == ("miss", None)
    assert after == ("specialized", "slow-built")
    assert stored == ("specialized", "kept") and kind == "specialized"


def test_pool_entry_matches_jax():
    from repro.elastic.runtime import PoolEntry as JaxEntry
    e, j = PoolEntry("v", "generic", 0.5), JaxEntry("v", "generic", 0.5)
    assert (e.value, e.kind, e.compile_s, e.uses) == \
        (j.value, j.kind, j.compile_s, j.uses) == ("v", "generic", 0.5, 0)


def test_straggler_policy_and_speculation():
    """The port of ``tests/test_substrates.py::
    test_straggler_policy_and_speculation``."""
    pol = StragglerPolicy(threshold=2.0)
    assert pol.detect([1.0, 1.1, 0.9, 5.0]) == [3]
    assert pol.detect([1.0, 1.0]) == []

    speeds = [1.0, 1.0, 1.0, 10.0]          # one 10x straggler
    res_plain, t_plain, _ = speculative_map(
        lambda t, w: (t, w), 8, speeds,
        policy=StragglerPolicy(threshold=100.0))   # mitigation off
    res_fix, t_fix, stats = speculative_map(
        lambda t, w: (t, w), 8, speeds, policy=StragglerPolicy(2.0))
    assert stats["backups"] >= 1
    assert t_fix < t_plain                  # makespan improved
    assert [r[0] for r in res_fix] == list(range(8))


@pytest.mark.parametrize("speeds,n_tasks,threshold,min_samples", [
    ([1.0, 1.0, 1.0, 10.0], 8, 2.0, 3), ([1.0, 3.0, 0.5], 11, 1.5, 3),
    ([2.0, 2.0], 5, 2.0, 3), ([1.0, 1.0, 1.0, 10.0], 8, 100.0, 3),
    ([0.0, 0.0, 1.0], 4, 2.0, 1)])
def test_speculative_map_matches_jax(speeds, n_tasks, threshold,
                                     min_samples):
    calls, jcalls = [], []
    got = speculative_map(lambda t, w: calls.append((t, w)) or (t, w),
                          n_tasks, speeds,
                          StragglerPolicy(threshold, min_samples))
    want = jax_speculative_map(lambda t, w: jcalls.append((t, w)) or (t, w),
                               n_tasks, speeds,
                               JaxPolicy(threshold, min_samples))
    assert got == want and calls == jcalls
    durations = [speeds[i % len(speeds)] for i in range(n_tasks)]
    assert StragglerPolicy(threshold, min_samples).detect(durations) \
        == JaxPolicy(threshold, min_samples).detect(durations)
