"""Elastic runtime: the paper's control plane mapped onto training jobs
(the counterpart of ``repro/elastic/runtime.py``).

KRCORE's structure transfers one-to-one:

  hybrid QP pool          -> ``ExecutablePool``: generic ladder-built steps
                             (DC analogue: usable for ANY worker count in
                             the ladder) + specialized per-exact-config
                             entries (RC analogue) built in the background.
  worker bootstrap        -> attach to pre-built pool state instead of a
                             cold mesh formation and build.

``PoolEntry``, ``ExecutablePool``, ``StragglerPolicy`` and
``speculative_map`` are pure Python, copied. In JAX the pool caches compiled
``jit`` executables; PyTorch runs eagerly, so serving workers store the
plain step callable and ``ElasticTrainer`` a (mesh, step) pair.

**What a build is in torch** (``ElasticTrainer``): the ``DeviceMesh`` over
the first n ranks with its process groups, the step made under that mesh
(``make_step(mesh)``), and, when the trainer has an example batch, one
warm-up step on a throwaway state from ``init_state()`` at that batch's
shape, on every rank of the mesh. The warm-up stands where JAX's
``lower().compile()`` stands: it connects the data group's communicator
(its first all-reduce), loads every kernel and library handle the step
launches and fills the allocator's cache, and it costs a train step. A
pool hit skips all of it; the trainer counts its builds (``n_builds``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device
from ..launch.mesh import ensure_process_group, set_mesh
from ..tree import tree_leaves


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


# ============================================================ elastic trainer
class ElasticTrainer:
    """Data-parallel trainer whose worker count can change between steps.

    Scale events go through the KRCORE-style control plane: a lookup in the
    pool (generic hit = microsecond-scale bootstrap; miss = a build, charged
    to the event and recorded), then the state's redistribution onto the new
    mesh, replicated (``P()``).

    Ranks, not devices: the workers are the ranks of the default process
    group (started for this process alone if there is none, see
    ``launch.mesh.ensure_process_group``). Every rank constructs the trainer
    and makes the same calls in the same order (a mesh's process groups are
    made by all ranks together); the mesh of n workers is the first n
    ranks, and a rank outside it keeps its copy of the state and takes no
    step (``train_step`` returns None there). ``make_step(mesh)`` returns
    ``step(state, batch) -> (loss, state)`` for this rank's block of the
    batch; ``make_train_step(cfg, mesh=mesh)`` inside it averages over the
    mesh's "data" group (the trainer also calls ``make_step`` under
    ``set_mesh(mesh)``, the default of that argument). ``init_state()``
    gives the state on ``device`` (default: the CUDA card), the same on
    every rank.
    """

    def __init__(self, cfg, make_step: Callable[[Any], Any],
                 init_state: Callable[[], Any], ladder: Sequence[int] = (),
                 example_batch: Optional[Dict[str, np.ndarray]] = None,
                 device=None):
        self.cfg = cfg
        self.make_step = make_step
        self.device = resolve_device(device)
        ensure_process_group(self.device)
        self.world = dist.get_world_size()
        self.pool = ExecutablePool(coarsen=self._coarsen)
        self.events: List[Dict] = []
        self.n_workers = 0
        self.n_builds = 0
        self.state = None
        self._step_fn = None
        self._mesh = None
        self._ladder = tuple(ladder)
        self._init_state = init_state
        self._example_batch = example_batch

    # -- control plane -----------------------------------------------------
    @staticmethod
    def _coarsen(key):
        """Generic key: ladder builds serve any count of that size."""
        return ("ladder", key[1])

    def _mesh_for(self, n: int) -> DeviceMesh:
        if not 1 <= n <= self.world:
            raise ValueError(f"{n} workers, the process group has "
                             f"{self.world} ranks")
        return DeviceMesh(self.device.type, torch.arange(n).reshape(n, 1),
                          mesh_dim_names=("data", "model"))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _shard_batch(self, batch, mesh) -> Dict[str, torch.Tensor]:
        """This rank's block of each global batch entry, split on "data"
        (``P("data", None, ...)``: the mesh is (n, 1)), on the trainer's
        device."""
        parts, row = mesh.size(0), mesh.get_coordinate()[0]
        out = {}
        for k, v in batch.items():
            t = v if isinstance(v, torch.Tensor) \
                else torch.as_tensor(np.asarray(v))
            if t.shape[0] % parts:
                raise ValueError(f"{k}: {t.shape[0]} rows do not split "
                                 f"over {parts} ranks")
            out[k] = t.chunk(parts, dim=0)[row].to(self.device)
        return out

    @torch.no_grad()
    def _redistribute(self, state, mesh):
        """Every leaf replicated over ``mesh`` from its first rank (spec
        ``P()``), in place: the leaves of one dtype go as one flat buffer,
        one broadcast on the "data" group. A mesh of one rank moves
        nothing."""
        if mesh.size() == 1:
            return state
        group = mesh.get_group("data")
        leaves = tree_leaves(state)
        for dtype in sorted({t.dtype for t in leaves}, key=str):
            same = [t for t in leaves if t.dtype == dtype]
            flat = torch.cat([t.detach().reshape(-1) for t in same])
            dist.broadcast(flat, group_src=0, group=group)
            at = 0
            for t in same:
                t.copy_(flat[at:at + t.numel()].view(t.shape))
                at += t.numel()
        return state

    def _builder(self, n: int):
        def build():
            mesh = self._mesh_for(n)
            with set_mesh(mesh):
                step = self.make_step(mesh)
                if self._example_batch is not None \
                        and mesh.get_coordinate() is not None:
                    # the warm-up step (see the module docstring)
                    step(self._init_state(),
                         self._shard_batch(self._example_batch, mesh))
                    self._sync()
            self.n_builds += 1
            return (mesh, step)
        return build

    def prewarm(self) -> None:
        """Boot-time ladder builds (the statically-initialized DCQPs)."""
        for n in self._ladder:
            key = ("ladder", n)
            t0 = time.perf_counter()
            self.pool.put(key, self._builder(n)(), kind="generic",
                          compile_s=time.perf_counter() - t0)

    def scale_to(self, n: int) -> Dict:
        """Elastic resize; returns the timing event (the paper's metric)."""
        t0 = time.perf_counter()
        key = ("exact", n)
        kind, entry = self.pool.get(key)
        if entry is None:
            # miss: build now (the Verbs-analogue cold path), measured
            entry = self._builder(n)()
            self.pool.put(key, entry, compile_s=time.perf_counter() - t0)
            kind = "cold"
        mesh, fn = entry
        if self.state is None:
            with set_mesh(mesh):
                self.state = self._init_state()
        if mesh.get_coordinate() is not None:
            # state redistribution (weights replicated onto the new mesh)
            self.state = self._redistribute(self.state, mesh)
        self._sync()
        self._mesh, self._step_fn = mesh, fn
        old_n, self.n_workers = self.n_workers, n
        ev = {"kind": kind, "from": old_n, "to": n,
              "control_s": time.perf_counter() - t0}
        self.events.append(ev)
        return ev

    # -- data plane ---------------------------------------------------------
    def train_step(self, batch) -> Optional[torch.Tensor]:
        """One step on the global ``batch`` (numpy arrays or tensors), each
        rank of the mesh on its block; the loss, or None on a rank outside
        the mesh."""
        if self._mesh.get_coordinate() is None:
            return None
        loss, self.state = self._step_fn(
            self.state, self._shard_batch(batch, self._mesh))
        return loss
