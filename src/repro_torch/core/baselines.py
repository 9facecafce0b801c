"""Comparison targets: user-space Verbs and (optimized) LITE (paper §5).

* ``VerbsProcess`` models a fresh user-space process: it pays driver Init
  once, then Create/Configure/Handshake per connection — the 15.7 ms control
  path of Fig 3. Data-path ops go straight to its private QPs (no syscall).

* ``LiteKernel`` models the optimized LITE of the paper: the kernel driver
  is shared (no Init), connections are cached in an all-RC pool, but a miss
  still pays Create+Configure serialized at the NIC (~1.4 ms → 712 QPs/s),
  and the high-level sync API hides the QP (no doorbell batching: one
  round-trip per request — the 1.9x RACE gap of §5.3.1). Crucially LITE
  does **not** prevent queue overflows (Fig 13b: async dies beyond 6
  threads) — we reproduce that failure mode honestly.
"""

from __future__ import annotations

import itertools
from typing import Dict, Generator, List, Optional, Tuple

import numpy as np

from .fabric import Fabric, MemoryRegion, Node
from .qp import QP, QPError, QPType, RecvBuffer, WorkRequest, connect_rc_pair


class VerbsProcess:
    """A user-space RDMA application process on ``node``."""

    def __init__(self, node: Node):
        self.node = node
        self.env = node.env
        self.fabric = node.fabric
        self.cm = node.cm
        self.initialized = False
        self.qps: Dict[str, QP] = {}

    def init_driver(self) -> Generator:
        """ibv_open_device + PD + caches — paid once per process (§2.2.1)."""
        yield self.env.timeout(self.cm.verbs_init_us)
        self.initialized = True

    def connect(self, remote: Node) -> Generator:
        """Full control path: Init (once) + Create + Handshake + Configure."""
        if not self.initialized:
            yield from self.init_driver()
        qa, qb = yield from connect_rc_pair(self.fabric, self.node, remote)
        self.qps[remote.name] = qa
        return qa

    def reg_mr(self, nbytes: int) -> Generator:
        yield self.env.timeout(self.cm.reg_mr_us(nbytes))
        addr = self.node.alloc(nbytes)
        return self.node.reg_mr(addr, nbytes)

    # data path: raw verbs — the baseline KRCORE is compared against
    def read_sync(self, remote: str, local_mr: MemoryRegion, local_off: int,
                  remote_mr: MemoryRegion, remote_off: int,
                  nbytes: int) -> Generator:
        qp = self.qps[remote]
        qp.post_send([WorkRequest(
            op="READ", wr_id=1, signaled=True, local_mr=local_mr,
            local_off=local_off, remote_rkey=remote_mr.rkey,
            remote_off=remote_off, nbytes=nbytes)])
        while not qp.poll_cq():
            yield self.env.timeout(0.1)

    def read_batch_async(self, remote: str, reqs: List[WorkRequest],
                         window: int = 64) -> Generator:
        """Doorbell-batched pipelined reads (RDMA-aware optimization)."""
        qp = self.qps[remote]
        outstanding = 0
        i = 0
        while i < len(reqs) or outstanding > 0:
            while i < len(reqs) and outstanding < window:
                batch = reqs[i:i + 16]
                for r in batch[:-1]:
                    r.signaled = False
                batch[-1].signaled = True
                qp.post_send(batch)
                outstanding += 1           # one signaled CQE per batch
                i += len(batch)
            got = qp.poll_cq(max_n=16)
            if got:
                outstanding -= len(got)
            else:
                yield self.env.timeout(0.1)


class LiteKernel:
    """Kernel-resident LITE instance on a node (shared by its processes)."""

    def __init__(self, node: Node):
        self.node = node
        self.env = node.env
        self.fabric = node.fabric
        self.cm = node.cm
        self.rc_pool: Dict[str, QP] = {}         # caches RCQPs to ALL nodes
        node.lite = self                           # type: ignore

    def connect(self, remote: Node) -> Generator:
        """Decentralized UD-based connect (the paper's optimized LITE):
        no Init, but Create+Configure still serialize at both NICs."""
        if remote.name in self.rc_pool:
            return self.rc_pool[remote.name]
        qa, qb = yield from connect_rc_pair(self.fabric, self.node, remote)
        self.rc_pool[remote.name] = qa
        lite_remote: Optional[LiteKernel] = getattr(remote, "lite", None)
        if lite_remote is not None:
            lite_remote.rc_pool[self.node.name] = qb
        return qa

    def memory_bytes(self) -> int:
        """Fig 13a: RCQP state only (excl. recv queues & message buffers)."""
        return len(self.rc_pool) * self.cm.rcqp_bytes

    # high-level sync API (LITE exposes no raw QP — §2.2.2 Issue#3)
    def lite_read(self, remote: str, local_mr: MemoryRegion, local_off: int,
                  remote_mr: MemoryRegion, remote_off: int,
                  nbytes: int) -> Generator:
        qp = self.rc_pool[remote]
        yield self.env.timeout(self.cm.syscall_us)     # kernel crossing
        qp.post_send([WorkRequest(
            op="READ", wr_id=1, signaled=True, local_mr=local_mr,
            local_off=local_off, remote_rkey=remote_mr.rkey,
            remote_off=remote_off, nbytes=nbytes)])
        while not qp.poll_cq():
            yield self.env.timeout(0.1)

    def lite_read_async_unsafe(self, remote: str, reqs: List[WorkRequest],
                               inflight_budget: int) -> Generator:
        """Async posting WITHOUT overflow protection (§4.4): LITE posts
        blindly; beyond the physical queue depth the QP errors out —
        reproduces the Fig 13b failure beyond 6 threads."""
        qp = self.rc_pool[remote]
        posted = 0
        for r in reqs:
            r.signaled = True
            qp.post_send([r])             # may raise QPError: SQ overflow
            posted += 1
            if posted % inflight_budget == 0:
                # occasional polling, but not tied to queue occupancy
                qp.poll_cq(max_n=4)
                yield self.env.timeout(0.05)
        while qp.poll_cq(max_n=16):
            yield self.env.timeout(0.05)
