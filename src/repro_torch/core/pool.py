"""Hybrid QP pool (paper §4.2) with background LRU RC promotion (§4.3).

Per-CPU pools: each CPU core hosts a dedicated pool and a VirtQueue only
uses QPs from its host CPU's pool, avoiding lock contention (§4.2). DCQPs
are statically initialized at module load; RCQPs are created on-the-fly in
the *background* (never on an application's critical path) and bounded by
``rc_cap`` to constrain memory usage.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Generator, List, Optional, Tuple

from .qp import QP, QPType
from .fabric import Node


@dataclasses.dataclass
class RCEntry:
    qp: QP
    last_used: float = 0.0
    uses: int = 0


class HybridQPPool:
    """One CPU core's pool: a few DCQPs + an LRU-bounded set of RCQPs."""

    def __init__(self, node: Node, cpu: int, n_dcqps: int = 1,
                 rc_cap: int = 32):
        self.node = node
        self.cpu = cpu
        self.rc_cap = rc_cap
        self.dc_qps: List[QP] = []
        self.n_dcqps = n_dcqps
        self._dc_rr = 0
        # addr -> RCEntry, maintained in LRU order (oldest first)
        self.rc: "OrderedDict[str, RCEntry]" = OrderedDict()
        # communication pattern samples for background promotion (§3.2)
        self.use_counts: Dict[str, int] = {}
        self.stat_rc_hits = 0
        self.stat_dc_selects = 0

    # -------------------------------------------------------------- boot
    def boot(self) -> Generator:
        """Statically initialize the DCQPs (module-load time, off any
        application critical path)."""
        for _ in range(self.n_dcqps):
            qp = QP(self.node, QPType.DC)
            yield from qp.create()
            yield from qp.configure()
            self.dc_qps.append(qp)

    # ----------------------------------------------------------- select
    def select(self, addr: str) -> Tuple[str, QP]:
        """Algorithm 1, VirtQueueConnect lines 8-11 (no QP is created)."""
        self.use_counts[addr] = self.use_counts.get(addr, 0) + 1
        ent = self.rc.get(addr)
        if ent is not None and ent.qp.state.name == "RTS":
            ent.last_used = self.node.env.now
            ent.uses += 1
            self.rc.move_to_end(addr)
            self.stat_rc_hits += 1
            return "RC", ent.qp
        self.stat_dc_selects += 1
        qp = self.dc_qps[self._dc_rr % len(self.dc_qps)]
        self._dc_rr += 1
        return "DC", qp

    def has_rc(self, addr: str) -> bool:
        return addr in self.rc

    # ------------------------------------------------- background update
    def hot_candidates(self, threshold: int = 8) -> List[str]:
        """Addresses communicated with often enough to deserve an RCQP."""
        return [a for a, n in sorted(self.use_counts.items(),
                                     key=lambda kv: -kv[1])
                if n >= threshold and a not in self.rc]

    def insert_rc(self, addr: str, qp: QP) -> Optional[Tuple[str, QP]]:
        """Insert a background-created RCQP; returns an evicted (addr, qp)
        if the LRU cap was exceeded (the caller runs the transfer protocol
        on any VirtQueues still using the evicted QP)."""
        evicted = None
        if len(self.rc) >= self.rc_cap:
            old_addr, old_ent = self.rc.popitem(last=False)   # LRU
            evicted = (old_addr, old_ent.qp)
        self.rc[addr] = RCEntry(qp, last_used=self.node.env.now)
        return evicted

    def drop_rc(self, addr: str) -> Optional[QP]:
        ent = self.rc.pop(addr, None)
        return ent.qp if ent else None

    def decay(self, factor: float = 0.5) -> None:
        """Periodically decay use counts so hotness tracks the present.

        Every count is decayed to ``int(n * factor)`` and an address is
        dropped only once its *decayed* count reaches 0. (The old ``n > 1``
        pre-filter deleted count-1 addresses outright — even with
        ``factor == 1.0`` — while keeping higher counts that had decayed to
        0, skewing hot-candidate hysteresis both ways.)
        """
        decayed = ((a, int(n * factor)) for a, n in self.use_counts.items())
        self.use_counts = {a: n for a, n in decayed if n > 0}

    # ------------------------------------------------------------- sizes
    def memory_bytes(self) -> int:
        cm = self.node.cm
        return (len(self.dc_qps) * cm.dcqp_bytes
                + len(self.rc) * cm.rcqp_bytes)
