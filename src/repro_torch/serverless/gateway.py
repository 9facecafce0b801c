"""Invocation gateway + scheduler: open-loop trace admission on the DES.

The gateway is the Fn front door: a trace (see :mod:`.traces`) is admitted
open-loop — arrivals fire at their trace timestamps regardless of how far
behind the fleet is — and every invocation is placed on a worker node by
the scheduler, leased a container (warm or cold, :mod:`.container`),
optionally pulls its input payload from a data node over the container's
transport, runs, and is released back to the warm pool.

Two completion models:

* **inline** (default, ``caller_node=None``) — the invocation completes
  when the function body finishes on the worker; no response travels.
* **closed loop** (``caller_node=...``) — the request rides
  ``Session.call`` from the caller node to a per-worker listener, the
  worker serves it (lease + input fetch + compute) and delivers the
  function's OUTPUT back as the call's reply, so every record's
  ``total_us`` is true end-to-end latency including response delivery —
  the Fig 14 analogue measured at the caller.

A third admission mode is Fn-style autoscaling:
**worker pull** (:meth:`InvocationGateway.submit_trace_pull`) — arrivals
land in a per-function :class:`~repro_torch.dkv.autoscaler.PullQueue` instead
of being pushed at a placed worker, pull workers (one container each)
drain it, and a :class:`~repro_torch.dkv.autoscaler.WorkerPullAutoscaler`
grows/shrinks the fleet from queue pressure during spike windows. Each
scale-out pays the worker's REAL bootstrap (fork + per-transport
attach), so the control plane's speed is what bounds spike recovery.

Every record decomposes the invocation the way Fig 12a/12b decompose a
request: queueing, fork (container), control plane (connect + MR), data
plane (payload movement), compute. The benchmarks aggregate these into the
paper's headline ratios (plus spike-window p99/p999 for the closed loop);
the tests pin the open-loop and placement invariants.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Generator, List, Optional, Sequence

import numpy as np

from ..core.cluster import Cluster
from ..core.session import (CallTimeout, Listener, Session, connect,
                                listen)

from .container import Container, ContainerPool
from .registry import FunctionDef, FunctionRegistry


@dataclasses.dataclass
class InvocationRecord:
    inv_id: int
    fn: str
    node: str
    kind: str                     # "warm" | "cold"
    arrival_us: float
    start_us: float = 0.0
    end_us: float = 0.0
    fork_us: float = 0.0
    control_us: float = 0.0
    data_us: float = 0.0
    compute_us: float = 0.0
    #: True when this record was measured closed-loop (request + reply
    #: over session.call); the request/response wire time is then
    #: total_us minus queue_us and the worker-side phase fields
    response_path: bool = False
    #: closed loop only: the call burned through its deadline (and any
    #: configured retries) — end_us is the CallTimeout instant, and the
    #: worker-side phase fields are unknown
    timed_out: bool = False

    @property
    def queue_us(self) -> float:
        return self.start_us - self.arrival_us

    @property
    def total_us(self) -> float:
        return self.end_us - self.arrival_us


class LeastOutstandingScheduler:
    """Place each invocation on the worker with the fewest in-flight
    invocations (ties broken round-robin for determinism)."""

    def __init__(self, nodes: Sequence[str]):
        if not nodes:
            raise ValueError("scheduler needs at least one node")
        self.nodes = list(nodes)
        self.outstanding: Dict[str, int] = {n: 0 for n in self.nodes}
        self._rr = 0

    def place(self) -> str:
        lo = min(self.outstanding.values())
        candidates = [n for n in self.nodes if self.outstanding[n] == lo]
        node = candidates[self._rr % len(candidates)]
        self._rr += 1
        self.outstanding[node] += 1
        return node

    def done(self, node: str) -> None:
        self.outstanding[node] = max(0, self.outstanding[node] - 1)


class InvocationGateway:
    """Admit traces, place invocations, account every phase."""

    def __init__(self, cluster: Cluster, registry: FunctionRegistry,
                 pool: ContainerPool,
                 worker_nodes: Optional[Sequence[str]] = None,
                 data_node: Optional[str] = None,
                 caller_node: Optional[str] = None,
                 response_base_port: int = 7040,
                 call_deadline_us: Optional[float] = None,
                 call_retries: int = 0):
        self.cluster = cluster
        self.env = cluster.env
        self.registry = registry
        self.pool = pool
        names = worker_nodes or sorted(cluster.modules)
        self.scheduler = LeastOutstandingScheduler(names)
        #: node holding invocation input payloads (None: skip the fetch)
        self.data_node = data_node
        #: closing the loop: node the responses return to (None: inline)
        self.caller_node = caller_node
        self.response_base_port = response_base_port
        #: closed-loop request deadline: a dropped reply (worker wedged or
        #: died mid-serve) fails ONLY that invocation with CallTimeout at
        #: this bound instead of stalling the whole trace; None = wait
        #: forever (the pre-deadline behaviour)
        self.call_deadline_us = call_deadline_us
        #: opt-in idempotent re-post of a timed-out request (the serve
        #: path is a pure function of the descriptor, so retrying is safe)
        self.call_retries = call_retries
        self._data_mr = None
        self._worker_listeners: Dict[str, Listener] = {}
        self._caller_sessions: Dict[str, Session] = {}
        self.records: List[InvocationRecord] = []
        self._next_id = 0

    # ----------------------------------------------------------- plumbing
    def _ensure_data_mr(self) -> Generator:
        """Input-payload region on the data node, registered once."""
        if self._data_mr is None and self.data_node is not None:
            mod = self.cluster.module(self.data_node)
            self._data_mr = yield from mod.sys_qreg_mr(1 << 20)
        return self._data_mr

    def _ensure_response_path(self, payload_bytes: int) -> Generator:
        """Per-worker serve listeners + caller sessions, created once.

        Caller-side recv buffers must hold the LARGEST reply any
        registered function can emit (replies carry fn output, not the
        input payload), so they are sized from the registry — and
        re-widened on later traces with bigger payloads."""
        if self.caller_node is None:
            return
        max_out = max((self.registry.get(n).out_bytes
                       for n in self.registry.names()), default=1024)
        reply_bytes = max(4096, payload_bytes + 64, max_out + 64)
        for i, node in enumerate(self.scheduler.nodes):
            if node in self._worker_listeners:
                # later traces may need bigger reply buffers: widen
                self._caller_sessions[node].recv_window(32, reply_bytes)
                continue
            mod = self.cluster.module(node)
            lst = yield from listen(mod, self.response_base_port + i,
                                    msg_bytes=4096, window=32)
            self._worker_listeners[node] = lst
            self.env.process(self._serve_worker(node, lst),
                             f"gw.serve.{node}")
            sess = yield from connect(self.cluster.module(self.caller_node),
                                      node, port=lst.port)
            sess.recv_window(32, reply_bytes)
            self._caller_sessions[node] = sess

    # ----------------------------------------------------------- admission
    def submit_trace(self, fn_name: str, arrivals: Sequence[float],
                     payload_bytes: int = 1024) -> Generator:
        """Open-loop admission: spawn one invocation process per arrival
        at its trace timestamp; returns when all have completed."""
        fn = self.registry.get(fn_name)
        yield from self._ensure_data_mr()
        yield from self._ensure_response_path(payload_bytes)
        base = self.env.now
        #: sim-time epoch of the last submitted trace (t=0 of the trace's
        #: own clock — window_summary callers anchor on this)
        self.last_trace_base = base
        procs = []
        for t in arrivals:
            procs.append(self.env.process(
                self._invoke_at(fn, base + float(t), payload_bytes,
                                self._next_id),
                f"inv.{self._next_id}"))
            self._next_id += 1
        for p in procs:
            yield p
        return [p.value for p in procs]

    def _invoke_at(self, fn: FunctionDef, when: float,
                   payload_bytes: int, inv_id: int) -> Generator:
        env = self.env
        if when > env.now:
            yield env.timeout(when - env.now)
        rec = InvocationRecord(inv_id=inv_id, fn=fn.name, node="?",
                               kind="?", arrival_us=env.now)
        node = self.scheduler.place()
        rec.node = node
        rec.start_us = env.now
        try:
            if self.caller_node is not None:
                yield from self._invoke_closed_loop(fn, node, payload_bytes,
                                                    rec)
            else:
                yield from self._invoke_inline(fn, node, payload_bytes, rec)
        finally:
            self.scheduler.done(node)
        rec.end_us = env.now
        self.records.append(rec)
        return rec

    def _invoke_inline(self, fn: FunctionDef, node: str,
                       payload_bytes: int, rec: InvocationRecord
                       ) -> Generator:
        """Inline completion: done when the function body finishes."""
        env = self.env
        t0 = env.now
        kind, container = yield from self.pool.lease(node, fn)
        rec.kind = kind
        rec.fork_us = env.now - t0
        if self.data_node is not None and self.data_node != node:
            yield from self._fetch_input(container, rec, payload_bytes)
        t0 = env.now
        yield env.timeout(fn.compute_us)
        rec.compute_us = env.now - t0
        self.pool.release(container)

    def _invoke_closed_loop(self, fn: FunctionDef, node: str,
                            payload_bytes: int, rec: InvocationRecord
                            ) -> Generator:
        """Closed loop: the request rides session.call to the worker's
        listener; the reply carries the function output + the worker-side
        phase decomposition. end_us lands AFTER response delivery."""
        rec.response_path = True
        sess = self._caller_sessions[node]
        request = np.zeros(64, np.uint8)            # invocation descriptor
        fut = sess.call(request, meta={"fn": fn.name,
                                       "payload_bytes": payload_bytes,
                                       "inv": rec.inv_id},
                        deadline_us=self.call_deadline_us,
                        retries=self.call_retries)
        try:
            reply = yield from fut.wait()
        except CallTimeout:
            # deadline semantics: this invocation fails alone; the caller
            # session (and every other in-flight call on it) is untouched
            rec.timed_out = True
            rec.kind = "timeout"
            return
        t = reply.hdr.get("timings", {})
        rec.kind = t.get("kind", "?")
        rec.fork_us = t.get("fork_us", 0.0)
        rec.control_us = t.get("control_us", 0.0)
        rec.data_us = t.get("data_us", 0.0)
        rec.compute_us = t.get("compute_us", 0.0)

    # ------------------------------------------------ worker-pull admission
    def submit_trace_pull(self, fn_name: str, arrivals: Sequence[float],
                          payload_bytes: int = 1024,
                          min_workers: int = 1, max_workers: int = 8,
                          target_pressure: int = 4,
                          check_period_us: float = 2_000.0) -> Generator:
        """Worker-pull admission (the Fn autoscaling model): arrivals
        enqueue into a per-function PullQueue at their trace timestamps;
        pull workers — each a container leased on a round-robin node —
        drain it; a WorkerPullAutoscaler spawns workers from queue
        pressure (each spawn pays container fork on the worker's clock).
        Returns this trace's records once everything is served; the
        autoscaler is returned on ``self.last_autoscaler`` for scale-
        event inspection."""
        from ..dkv.autoscaler import PullQueue, WorkerPullAutoscaler

        fn = self.registry.get(fn_name)
        yield from self._ensure_data_mr()
        env = self.env
        base = env.now
        self.last_trace_base = base
        queue = PullQueue(env, f"fn.{fn_name}")
        first_id = self._next_id
        rr = itertools.count()
        leased: List[Container] = []

        def spawn(q) -> Generator:
            node = self.scheduler.nodes[next(rr) % len(self.scheduler.nodes)]
            # worker bootstrap: a dedicated container (fork + transport
            # bring-up on the spawn's clock — warm pools only help the
            # steady state, not a spike's marginal worker)
            kind, container = yield from self.pool.lease(node, fn)
            leased.append(container)

            def serve(item) -> Generator:
                inv_id, arrival_us = item
                rec = InvocationRecord(inv_id=inv_id, fn=fn.name,
                                       node=node, kind=kind,
                                       arrival_us=arrival_us,
                                       start_us=env.now)
                if self.data_node is not None and self.data_node != node:
                    yield from self._fetch_input(container, rec,
                                                 payload_bytes)
                t0 = env.now
                yield env.timeout(fn.compute_us)
                rec.compute_us = env.now - t0
                rec.end_us = env.now
                self.records.append(rec)

            return serve

        scaler = WorkerPullAutoscaler(
            env, [queue], spawn, min_workers=min_workers,
            max_workers=max_workers, target_pressure=target_pressure,
            check_period_us=check_period_us).start()
        self.last_autoscaler = scaler
        for t in sorted(float(t) for t in arrivals):
            when = base + t
            if when > env.now:
                yield env.timeout(when - env.now)
            queue.put((self._next_id, env.now))
            self._next_id += 1
        while not queue.done:
            yield env.timeout(check_period_us / 2)
        scaler.stop()
        scaler.stop_workers()
        # retired workers hand their containers back to the warm pool —
        # a long-lived gateway serving repeated pull traces must not
        # strand one leased container per worker per trace
        for container in leased:
            self.pool.release(container)
        return [r for r in self.records if r.inv_id >= first_id]

    def _serve_worker(self, node: str, listener: Listener) -> Generator:
        """Worker-side serve loop (event-driven; lives for the run)."""
        while True:
            msgs = yield from listener.recv()
            for msg in msgs:
                self.env.process(self._serve_one(node, msg),
                                 f"gw.fn.{node}")

    def _serve_one(self, node: str, msg) -> Generator:
        env = self.env
        fn = self.registry.get(msg.hdr["fn"])
        payload_bytes = int(msg.hdr.get("payload_bytes", 1024))
        timings: Dict[str, object] = {}
        t0 = env.now
        kind, container = yield from self.pool.lease(node, fn)
        timings["kind"] = kind
        timings["fork_us"] = env.now - t0
        rec_proxy = InvocationRecord(inv_id=-1, fn=fn.name, node=node,
                                     kind=kind, arrival_us=env.now)
        nbytes = min(payload_bytes, container.mr.length)
        if self.data_node is not None and self.data_node != node:
            yield from self._fetch_input(container, rec_proxy,
                                         payload_bytes)
            # the fetched input IS the function's argument (registry
            # contract: handler(payload bytes) -> output bytes)
            inp = container.node.read_bytes(container.mr.addr, 0, nbytes)
        else:
            inp = np.zeros(nbytes, np.uint8)
        timings["control_us"] = rec_proxy.control_us
        timings["data_us"] = rec_proxy.data_us
        t0 = env.now
        yield env.timeout(fn.compute_us)
        timings["compute_us"] = env.now - t0
        self.pool.release(container)
        out = fn.handler(inp)
        yield from msg.reply(out, meta={"timings": timings})

    def _fetch_input(self, container: Container, rec: InvocationRecord,
                     payload_bytes: int) -> Generator:
        """Pull the invocation's input from the data node over the
        container's transport (control plane on miss, then data plane)."""
        env = self.env
        t0 = env.now
        handle = yield from container.connect(self.data_node)
        rec.control_us += env.now - t0
        t0 = env.now
        nbytes = min(payload_bytes, container.mr.length)
        if container.transport == "krcore":
            sess: Session = handle
            fut = sess.read(self._data_mr.rkey, 0, nbytes,
                            into=(container.mr, 0))
            yield from fut.wait()
        else:
            from ..core import WorkRequest
            qp = handle
            qp.post_send([WorkRequest(
                op="READ", wr_id=1, signaled=True, local_mr=container.mr,
                local_off=0, remote_rkey=self._data_mr.rkey,
                remote_off=0, nbytes=nbytes)])
            while not qp.poll_cq():
                yield env.timeout(0.1)
        rec.data_us += env.now - t0

    # ------------------------------------------------------------- reports
    def summary(self) -> Dict[str, float]:
        """Aggregate stats over all completed records."""
        if not self.records:
            return {"n": 0}
        tot = np.array([r.total_us for r in self.records])
        cold = [r for r in self.records if r.kind == "cold"]
        warm = [r for r in self.records if r.kind == "warm"]
        out = {
            "n": len(self.records),
            "timeouts": sum(1 for r in self.records if r.timed_out),
            "p50_us": float(np.percentile(tot, 50)),
            "p99_us": float(np.percentile(tot, 99)),
            "p999_us": float(np.percentile(tot, 99.9)),
            "mean_us": float(tot.mean()),
            "cold": len(cold),
            "warm": len(warm),
            "warm_ratio": len(warm) / len(self.records),
            "mean_fork_us": float(np.mean(
                [r.fork_us for r in self.records])),
            "mean_control_us": float(np.mean(
                [r.control_us for r in self.records])),
            "mean_data_us": float(np.mean(
                [r.data_us for r in self.records])),
        }
        per_node: Dict[str, int] = {}
        for r in self.records:
            per_node[r.node] = per_node.get(r.node, 0) + 1
        out["max_node_share"] = max(per_node.values()) / len(self.records)
        return out

    def window_summary(self, lo_us: float, hi_us: float) -> Dict[str, float]:
        """Tail latency of records ARRIVING inside [lo, hi) — the
        spike-window slice of the Fig 14 analogue."""
        recs = [r for r in self.records if lo_us <= r.arrival_us < hi_us]
        if not recs:
            return {"n": 0}
        tot = np.array([r.total_us for r in recs])
        return {
            "n": len(recs),
            "p50_us": float(np.percentile(tot, 50)),
            "p99_us": float(np.percentile(tot, 99)),
            "p999_us": float(np.percentile(tot, 99.9)),
            "mean_us": float(tot.mean()),
        }
