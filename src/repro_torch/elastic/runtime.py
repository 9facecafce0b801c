"""The elastic runtime's pure Python parts (the counterpart of
``repro/elastic/runtime.py``): ``PoolEntry`` and ``ExecutablePool``, and
the straggler mitigation ``StragglerPolicy`` / ``speculative_map``,
copied. ``ElasticTrainer`` waits for the sharding plans of ROADMAP Queue 1
item 9: its meshes, its ahead-of-time builds with input and output
shardings and its resharding on a scale event belong to them.

In JAX the pool caches compiled ``jit`` executables. PyTorch runs eagerly,
so the port's serving workers store the plain step callable; the pool's
``get`` / ``put`` / ``specialize_async`` semantics (the paper's hybrid
pool: a generic entry now, a specialised one built in the background) are
unchanged.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


# =========================================================== executable pool
@dataclasses.dataclass
class PoolEntry:
    value: Any
    kind: str                  # "generic" | "specialized"
    compile_s: float
    uses: int = 0


class ExecutablePool:
    """Compiled-executable cache with background specialization.

    ``get(key)`` never blocks on compilation: it returns a generic entry
    (coarsened key) when the exact one is missing, and (optionally) kicks
    off a background specialize — exactly the DCQP-now / RCQP-later policy
    of the paper's hybrid pool.
    """

    def __init__(self, coarsen: Callable[[Any], Any] = lambda k: None,
                 max_entries: int = 64):
        self._entries: Dict[Any, PoolEntry] = {}
        self._lock = threading.Lock()
        self._inflight: Dict[Any, threading.Thread] = {}
        self._coarsen = coarsen
        self.max_entries = max_entries
        self.stat_hits = 0
        self.stat_generic_hits = 0
        self.stat_misses = 0

    def put(self, key, value, kind="specialized", compile_s=0.0):
        with self._lock:
            if len(self._entries) >= self.max_entries:
                lru = min(self._entries.items(), key=lambda kv: kv[1].uses)
                del self._entries[lru[0]]
            self._entries[key] = PoolEntry(value, kind, compile_s)

    def get(self, key) -> Tuple[str, Optional[Any]]:
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                ent.uses += 1
                self.stat_hits += 1
                return ent.kind, ent.value
            coarse = self._coarsen(key)
            ent = self._entries.get(coarse)
            if ent is not None:
                ent.uses += 1
                self.stat_generic_hits += 1
                return "generic", ent.value
            self.stat_misses += 1
            return "miss", None

    def specialize_async(self, key, builder: Callable[[], Any]) -> None:
        """Background compile (never on the caller's critical path)."""
        with self._lock:
            if key in self._entries or key in self._inflight:
                return

        def work():
            t0 = time.time()
            value = builder()
            self.put(key, value, "specialized", time.time() - t0)
            with self._lock:
                self._inflight.pop(key, None)

        t = threading.Thread(target=work, daemon=True)
        with self._lock:
            self._inflight[key] = t
        t.start()

    def wait_all(self) -> None:
        for t in list(self._inflight.values()):
            t.join()


# ===================================================== straggler mitigation
@dataclasses.dataclass
class StragglerPolicy:
    """Detect laggards from per-worker step durations."""
    threshold: float = 2.0         # x median
    min_samples: int = 3

    def detect(self, durations: Sequence[float]) -> List[int]:
        if len(durations) < self.min_samples:
            return []
        med = float(np.median(durations))
        if med <= 0:
            return []
        return [i for i, d in enumerate(durations)
                if d > self.threshold * med]


def speculative_map(task_fn: Callable[[int, int], Any], n_tasks: int,
                    worker_speeds: Sequence[float],
                    policy: Optional[StragglerPolicy] = None
                    ) -> Tuple[List[Any], float, Dict]:
    """Deterministic simulation of speculative re-execution.

    Tasks are dealt to workers with the given speed factors (duration =
    speed). When a worker's expected finish exceeds policy.threshold x the
    median, its task is re-dispatched to the earliest-free fast worker;
    first copy to finish wins (the standard backup-task trick).
    Returns (results, makespan, stats).
    """
    policy = policy or StragglerPolicy()
    free_at = [0.0] * len(worker_speeds)
    finish: List[Optional[float]] = [None] * n_tasks
    results: List[Any] = [None] * n_tasks
    assigned: List[Tuple[int, int, float]] = []      # (task, worker, done)
    backups = 0
    for t in range(n_tasks):
        w = min(range(len(free_at)), key=lambda i: free_at[i])
        start = free_at[w]
        done = start + worker_speeds[w]
        free_at[w] = done
        assigned.append((t, w, done))
        results[t] = task_fn(t, w)
        finish[t] = done
    durations = [worker_speeds[w] for (_, w, _) in assigned]
    for idx in policy.detect(durations):
        t, w, done = assigned[idx]
        # re-dispatch to the fastest currently-free worker
        cand = min(range(len(free_at)), key=lambda i: free_at[i]
                   + worker_speeds[i])
        alt_done = free_at[cand] + worker_speeds[cand]
        if alt_done < done:
            free_at[cand] = alt_done
            finish[t] = alt_done
            results[t] = task_fn(t, cand)
            backups += 1
    makespan = max(finish)
    return results, makespan, {"backups": backups}
