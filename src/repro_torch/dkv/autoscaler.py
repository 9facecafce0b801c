"""Worker-pull autoscaler: per-function/per-shard queues, workers drain.

The Fn autoscaling model: instead of a caller-side scheduler
PUSHING each request to a placed worker, requests land in a
:class:`PullQueue` (one per function, or per shard for the dkv service)
and :class:`PullWorker` processes PULL from it — idle workers block on
the queue, so admission never needs to know worker state.

:class:`WorkerPullAutoscaler` closes the loop: it samples queue pressure
(backlog + in-service) on a fixed cadence and spawns workers — each
spawn runs the caller-supplied ``spawn(queue)`` generator, which pays
the REAL bootstrap cost (container fork + KRCORE attach in microseconds,
or the verbs cold-connect milliseconds — which is exactly the difference
the elastic-KV benchmark measures as spike-recovery time). Scale-in
retires workers above ``min_workers`` after a run of idle samples.

Spawns run as background DES processes so a slow bootstrap (verbs)
delays the CAPACITY, never the monitor's sampling — the honest model of
a control-plane-bound scale-out.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Generator, List, Optional, Sequence

import numpy as np

from ..core.sim import Environment, Store

#: queue sentinel that makes a PullWorker exit its drain loop
_STOP = object()


@dataclasses.dataclass
class ScaleEvent:
    t_us: float
    action: str                # "spawn" | "ready" | "retire"
    queue: str
    n_workers: int             # live workers AFTER the action
    depth: int                 # sampled pressure that triggered it


class PullQueue:
    """One pull queue (per function or per shard): FIFO of
    ``(enqueue_us, item)`` with depth/wait accounting."""

    def __init__(self, env: Environment, name: str = "q"):
        self.env = env
        self.name = name
        self._store = Store(env)
        self.enqueued = 0
        self.served = 0
        self.in_service = 0
        self.wait_us: List[float] = []
        self.last_drain_us = 0.0

    def put(self, item) -> None:
        self.enqueued += 1
        self._store.put((self.env.now, item))

    def backlog(self) -> int:
        return len(self._store)

    def pressure(self) -> int:
        """Work not yet finished: queued + being served."""
        return self.backlog() + self.in_service

    @property
    def done(self) -> bool:
        return self.served == self.enqueued

    def _get(self):
        return self._store.get()

    def _put_stop(self) -> None:
        self._store.put((self.env.now, _STOP))


class PullWorker:
    """A drain loop: pull next item, serve it, repeat. ``serve(item)`` is
    a caller-supplied generator (the function body / KV op)."""

    def __init__(self, env: Environment, queue: PullQueue,
                 serve: Callable[[object], Generator], name: str = "w"):
        self.env = env
        self.queue = queue
        self.serve = serve
        self.name = name
        self.busy = False
        self.served = 0
        self.stopped = False
        self.proc = env.process(self._run(), f"pull.{name}")

    def _run(self) -> Generator:
        q = self.queue
        while True:
            t_enq, item = yield q._get()
            if item is _STOP:
                self.stopped = True
                return
            self.busy = True
            q.in_service += 1
            q.wait_us.append(self.env.now - t_enq)
            try:
                yield from self.serve(item)
            finally:
                q.in_service -= 1
                q.served += 1
                q.last_drain_us = self.env.now
                self.busy = False
                self.served += 1

    def stop(self) -> None:
        """Cooperative retire: the worker exits after its current item
        (the sentinel is FIFO behind any backlog)."""
        self.queue._put_stop()


class WorkerPullAutoscaler:
    """Scale a pull-worker fleet from queue pressure.

    ``spawn(queue)`` is a generator that pays the worker's bootstrap
    (fork + attach) and returns a ``serve`` callable; the autoscaler
    wraps it in a :class:`PullWorker` on that queue. Scale-out picks the
    deepest queue; scale-in retires from the shallowest.
    """

    def __init__(self, env: Environment, queues: Sequence[PullQueue],
                 spawn: Callable[[PullQueue], Generator],
                 min_workers: int = 1, max_workers: int = 16,
                 target_pressure: int = 4,
                 check_period_us: float = 2_000.0,
                 spawn_burst: int = 2,
                 idle_checks_to_scale_in: int = 8):
        self.env = env
        self.queues = list(queues)
        self.spawn = spawn
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.target_pressure = target_pressure
        self.check_period_us = check_period_us
        self.spawn_burst = spawn_burst
        self.idle_checks_to_scale_in = idle_checks_to_scale_in
        self.workers: Dict[PullQueue, List[PullWorker]] = \
            {q: [] for q in self.queues}
        self.events: List[ScaleEvent] = []
        self._spawning = 0
        self._idle_streak = 0
        self._stopped = False
        self._proc = None

    # ------------------------------------------------------------ control
    def start(self) -> "WorkerPullAutoscaler":
        if self._proc is None:
            self._proc = self.env.process(self._monitor(), "autoscaler")
        return self

    def stop(self) -> None:
        """Stop sampling (the pending period tick drains and exits)."""
        self._stopped = True

    def stop_workers(self) -> None:
        """Retire every worker (drain-then-exit sentinels)."""
        for q, ws in self.workers.items():
            for w in ws:
                if not w.stopped:
                    w.stop()

    @property
    def n_workers(self) -> int:
        return sum(len(ws) for ws in self.workers.values()) \
            + self._spawning

    def live_workers(self) -> int:
        return sum(1 for ws in self.workers.values()
                   for w in ws if not w.stopped)

    # ------------------------------------------------------------- scaling
    def _spawn_one(self, queue: PullQueue) -> Generator:
        """Background bootstrap: the fleet grows when THIS finishes —
        a slow (verbs) bootstrap is capacity arriving late, which is the
        whole spike-recovery story."""
        try:
            serve = yield from self.spawn(queue)
        finally:
            self._spawning -= 1
        w = PullWorker(self.env, queue, serve,
                       f"{queue.name}.{len(self.workers[queue])}")
        self.workers[queue].append(w)
        self.events.append(ScaleEvent(self.env.now, "ready", queue.name,
                                      self.n_workers, queue.pressure()))
        if self._stopped:
            # the fleet was stopped while this bootstrap was in flight
            # (slow verbs boot finishing after the trace drained): retire
            # immediately so no orphan blocks forever on a dead queue
            w.stop()

    def _kick_spawn(self, queue: PullQueue) -> None:
        self._spawning += 1
        self.events.append(ScaleEvent(self.env.now, "spawn", queue.name,
                                      self.n_workers, queue.pressure()))
        self.env.process(self._spawn_one(queue),
                         f"autoscaler.spawn.{queue.name}")

    def _monitor(self) -> Generator:
        # floor the fleet before any traffic decision
        for q in self.queues:
            while len(self.workers[q]) + self._spawning < self.min_workers:
                self._kick_spawn(q)
        while not self._stopped:
            yield self.env.timeout(self.check_period_us)
            if self._stopped:
                return
            total_pressure = sum(q.pressure() for q in self.queues)
            n = self.n_workers
            if total_pressure > self.target_pressure * max(n, 1):
                self._idle_streak = 0
                deepest = sorted(self.queues, key=lambda q: -q.pressure())
                for q in deepest[:self.spawn_burst]:
                    if self.n_workers >= self.max_workers:
                        break
                    if q.pressure() > self.target_pressure * max(
                            len(self.workers[q]), 1):
                        self._kick_spawn(q)
            elif total_pressure == 0:
                self._idle_streak += 1
                if self._idle_streak >= self.idle_checks_to_scale_in \
                        and self.live_workers() > self.min_workers \
                        * len(self.queues):
                    shallow = min(self.queues,
                                  key=lambda q: len(self.workers[q]))
                    live = [w for w in self.workers[shallow]
                            if not w.stopped]
                    if len(live) > self.min_workers:
                        live[-1].stop()
                        self.events.append(ScaleEvent(
                            self.env.now, "retire", shallow.name,
                            self.n_workers - 1, 0))
                    self._idle_streak = 0
            else:
                self._idle_streak = 0

    # ------------------------------------------------------------- report
    def summary(self) -> Dict[str, float]:
        waits = np.array([w for q in self.queues for w in q.wait_us]
                         or [0.0])
        return {
            "served": sum(q.served for q in self.queues),
            "enqueued": sum(q.enqueued for q in self.queues),
            "workers_peak": max([e.n_workers for e in self.events]
                                or [0]),
            "spawns": sum(1 for e in self.events if e.action == "spawn"),
            "retires": sum(1 for e in self.events
                           if e.action == "retire"),
            "wait_p50_us": float(np.percentile(waits, 50)),
            "wait_p99_us": float(np.percentile(waits, 99)),
            "wait_mean_us": float(waits.mean()),
        }
