"""Warm/cold function containers over the KRCore control plane.

This is the hybrid now-vs-later policy of ``HybridQPPool`` (DC now, RC
later) and ``ExecutablePool`` (generic now, specialized later) applied to
function sandboxes:

* a **cold** lease pays, on the caller's critical path: container fork
  (``fork_worker_us``) + transport bring-up (KRCORE: ``qreg_mr`` at
  Table-2 microsecond scale; Verbs: the user-space registration cost) —
  connection setup itself is charged lazily at first :meth:`Container.
  connect` so the per-transport control-plane gap (Fig 12b) lands where
  the paper measures it;
* **warm** containers are forked, registered, and (when the pool has seen
  the route before) pre-connected in the BACKGROUND — leasing one is a
  queue pop.

Background prewarm mirrors ``KRCoreModule._maybe_promote``: lease misses
are counted per (node, function) and once they cross
``prewarm_threshold`` a background process refills the warm pool to
``warm_target`` — never on an invocation's critical path.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Deque, Dict, Generator, Optional, Tuple

from ..core import LiteKernel, VerbsProcess
from ..core.cluster import Cluster
from ..core.fabric import MemoryRegion
from ..core.session import Session, connect as kr_connect

from .registry import FunctionDef

TRANSPORTS = ("krcore", "verbs", "lite")


class Container:
    """One function sandbox: a (simulated) process on a node holding its
    registered working set and per-remote transport handles."""

    _ids = itertools.count(1)

    def __init__(self, cluster: Cluster, node_name: str, fn: FunctionDef,
                 transport: str = "krcore"):
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {transport!r}")
        self.id = next(Container._ids)
        self.cluster = cluster
        self.node_name = node_name
        self.node = cluster.node(node_name)
        self.fn = fn
        self.transport = transport
        self.env = cluster.env
        self.mr: Optional[MemoryRegion] = None
        #: (remote, port) -> qd (krcore) / QP (verbs, lite)
        self.conns: Dict[Tuple[str, Optional[int]], object] = {}
        self.proc: Optional[VerbsProcess] = None       # verbs only
        self.lite: Optional[LiteKernel] = None         # lite only
        self.booted = False

    @property
    def module(self):
        return self.cluster.module(self.node_name)

    # ----------------------------------------------------------- bring-up
    def boot(self) -> Generator:
        """Fork + register the working set (the cold-start body)."""
        cm = self.node.cm
        yield self.env.timeout(cm.fork_worker_us)          # container fork
        if self.transport == "krcore":
            self.mr = yield from self.module.sys_qreg_mr(self.fn.mr_bytes)
        elif self.transport == "verbs":
            self.proc = VerbsProcess(self.node)
            self.mr = yield from self.proc.reg_mr(self.fn.mr_bytes)
        else:                                              # lite
            self.lite = getattr(self.node, "lite", None) \
                or LiteKernel(self.node)
            yield self.env.timeout(cm.reg_mr_us(self.fn.mr_bytes))
            addr = self.node.alloc(self.fn.mr_bytes)
            self.mr = self.node.reg_mr(addr, self.fn.mr_bytes)
        self.booted = True
        return self

    def connect(self, remote: str,
                port: Optional[int] = None) -> Generator:
        """Transport handle to ``remote`` (cached). KRCORE: a
        :class:`Session` with typed endpoints (microsecond control path);
        Verbs: a private RCQP (the 15.7 ms first-connect control path);
        LITE: the node-shared kernel RCQP (~1.4 ms miss)."""
        key = (remote, port)
        if key in self.conns:
            return self.conns[key]
        if self.transport == "krcore":
            handle: object = yield from kr_connect(self.module, remote,
                                                   port=port)
        elif self.transport == "verbs":
            handle = yield from self.proc.connect(self.cluster.node(remote))
        else:
            handle = yield from self.lite.connect(self.cluster.node(remote))
        self.conns[key] = handle
        return handle

    def drop_connection(self, remote: str) -> None:
        """Forget cached handles to a (dead) remote."""
        for key in [k for k in self.conns if k[0] == remote]:
            handle = self.conns.pop(key)
            if isinstance(handle, Session):
                handle.close()


@dataclasses.dataclass
class LeaseStats:
    cold_starts: int = 0
    warm_hits: int = 0
    prewarms: int = 0

    @property
    def warm_ratio(self) -> float:
        total = self.cold_starts + self.warm_hits
        return self.warm_hits / total if total else 0.0


class ContainerPool:
    """Per-(node, function) warm pools with background prewarm."""

    def __init__(self, cluster: Cluster, transport: str = "krcore",
                 warm_target: int = 2, prewarm_threshold: int = 2):
        self.cluster = cluster
        self.env = cluster.env
        self.transport = transport
        self.warm_target = warm_target
        self.prewarm_threshold = prewarm_threshold
        self._warm: Dict[Tuple[str, str], Deque[Container]] = {}
        self._miss_counts: Dict[Tuple[str, str], int] = {}
        #: route hints: (node, fn) -> (remote, port) to pre-connect
        self._routes: Dict[Tuple[str, str], Tuple[str, Optional[int]]] = {}
        self._prewarms_inflight: set = set()
        self.stats = LeaseStats()

    # -------------------------------------------------------------- lease
    def lease(self, node_name: str, fn: FunctionDef) -> Generator:
        """Returns ("warm" | "cold", Container). Warm leases pop a
        pre-booted container in zero simulated time; cold leases pay the
        fork + registration on the caller's clock and arm the background
        prewarmer (never blocking the caller on it)."""
        key = (node_name, fn.name)
        warm = self._warm.get(key)
        if warm:
            self.stats.warm_hits += 1
            return "warm", warm.popleft()
        self.stats.cold_starts += 1
        self._miss_counts[key] = self._miss_counts.get(key, 0) + 1
        self._maybe_prewarm(key, fn)
        c = Container(self.cluster, node_name, fn, self.transport)
        yield from c.boot()
        return "cold", c

    def release(self, c: Container) -> None:
        """Return a container to its warm pool (sandbox stays booted)."""
        key = (c.node_name, c.fn.name)
        if c.conns:
            # remember the hottest route so prewarmed siblings pre-connect
            self._routes[key] = next(iter(c.conns))
        self._warm.setdefault(key, deque()).append(c)

    def warm_count(self, node_name: str, fn_name: str) -> int:
        return len(self._warm.get((node_name, fn_name), ()))

    def drain_node(self, node_name: str) -> int:
        """Drop every warm container on a (dead) node; returns count."""
        n = 0
        for key in [k for k in self._warm if k[0] == node_name]:
            n += len(self._warm.pop(key))
        return n

    # ------------------------------------------------- background prewarm
    def _maybe_prewarm(self, key: Tuple[str, str], fn: FunctionDef) -> None:
        if (self._miss_counts.get(key, 0) >= self.prewarm_threshold
                and key not in self._prewarms_inflight):
            self._prewarms_inflight.add(key)
            self.env.process(self._prewarm(key, fn),
                             f"prewarm.{key[0]}.{key[1]}")

    def _prewarm(self, key: Tuple[str, str], fn: FunctionDef) -> Generator:
        """Refill the warm pool to ``warm_target`` off the critical path
        (the RCQP-promotion analogue), pre-connecting the last-seen route
        so a warm lease's connect() is already a cache hit."""
        node_name = key[0]
        try:
            while len(self._warm.get(key, ())) < self.warm_target:
                c = Container(self.cluster, node_name, fn, self.transport)
                yield from c.boot()
                route = self._routes.get(key)
                if route is not None:
                    try:
                        yield from c.connect(*route)
                    except Exception:          # noqa: BLE001 — dead remote
                        pass                   # still usable; connect later
                self._warm.setdefault(key, deque()).append(c)
                self.stats.prewarms += 1
        finally:
            self._prewarms_inflight.discard(key)
