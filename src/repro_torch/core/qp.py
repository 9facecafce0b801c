"""Queue pairs (RC / DC / UD) over the simulated fabric.

Hardware-faithful accounting (this is what Algorithm 2 of the paper has to
defend against):

* The send queue (sq) has ``sq_depth`` entries. An entry is reclaimed only
  when a *signaled* completion that covers it is **polled** from the CQ
  (unsignaled WRs are covered by the next signaled WR — Mellanox semantics).
  Posting beyond the free space transitions the QP to ERR.
* The completion queue (cq) holds at most ``cq_depth`` CQEs; generating a
  CQE into a full CQ is a CQ overrun -> ERR (this is why LITE(async) falls
  over beyond 6 threads in Fig 13b).
* Malformed requests (bad opcode, invalid MR/rkey, bad bounds) transition
  the QP to ERR; recovery requires a full reconfigure (Configure cost).

DCQPs additionally model the dynamic-connect behaviour: a small per-request
header overhead, plus a sub-microsecond hardware reconnect whenever the
target differs from the currently-connected peer (§3 "Opportunity").
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from collections import deque
from typing import Deque, Dict, Generator, List, Optional, Tuple

import numpy as np

from .fabric import Fabric, MemoryRegion, MRError, Node
from .sim import Broadcast, Store


class QPType(enum.Enum):
    RC = "RC"
    DC = "DC"
    UD = "UD"


class QPState(enum.Enum):
    RESET = 0
    INIT = 1
    RTR = 2
    RTS = 3
    ERR = 4


VALID_OPS = ("READ", "WRITE", "SEND", "CAS", "FAA")
#: the 8-byte one-sided atomics (single-slot compare/exchange + add)
ATOMIC_OPS = ("CAS", "FAA")


@dataclasses.dataclass
class WorkRequest:
    op: str
    wr_id: int = 0
    signaled: bool = True
    # one-sided fields
    local_mr: Optional[MemoryRegion] = None
    local_off: int = 0
    remote_rkey: int = 0
    remote_off: int = 0
    nbytes: int = 0
    # atomic fields (op == "CAS": 8-byte compare-and-swap; op == "FAA":
    # 8-byte fetch-and-add of ``add``; either way the previous remote
    # value lands at (local_mr, local_off))
    compare: int = 0
    swap: int = 0
    add: int = 0
    # two-sided fields
    payload: Optional[np.ndarray] = None
    header: Optional[dict] = None
    # DC routing: target node name (RC ignores; DC requires)
    dst: Optional[str] = None
    dst_qpn: Optional[int] = None
    #: kernel-internal request: skips the remote ValidMR query (kernels
    #: trust kernels — paper §4 security model)
    trusted: bool = False


@dataclasses.dataclass
class Completion:
    wr_id: int
    status: str            # "OK" | "ERR"
    op: str
    byte_len: int = 0
    header: Optional[dict] = None
    #: how many SQ entries this CQE retires (itself + preceding unsignaled).
    covers: int = 1


@dataclasses.dataclass
class RecvBuffer:
    mr: MemoryRegion
    offset: int
    length: int
    wr_id: int


class QPError(Exception):
    pass


class QP:
    """A physical queue pair on a node."""

    _qpn = itertools.count(100)

    def __init__(self, node: Node, qptype: QPType,
                 sq_depth: Optional[int] = None,
                 cq_depth: Optional[int] = None):
        cm = node.cm
        self.node = node
        self.env = node.env
        self.fabric: Fabric = node.fabric
        self.qptype = qptype
        self.qpn = next(QP._qpn)
        self.state = QPState.RESET
        self.sq_depth = sq_depth or cm.sq_depth
        self.cq_depth = cq_depth or cm.cq_depth
        # occupancy counters (hardware view)
        self.sq_occupancy = 0
        #: CQEs still OWED by in-flight signaled WRs (posted, CQE not yet
        #: generated). len(cq) + cq_outstanding is the true CQ pressure: a
        #: completion cascade (_flush_in_order draining an out-of-order
        #: done buffer) can mint that many CQEs at ONE instant, so
        #: overrun-safe posting must reserve against it, not against
        #: len(cq) alone.
        self.cq_outstanding = 0
        self.cq: Deque[Completion] = deque()
        self.recv_cq: Deque[Completion] = deque()
        self.posted_recvs: Deque[RecvBuffer] = deque()
        self._pending_msgs: Deque[Tuple[dict, np.ndarray]] = deque()
        # RC peer
        self.peer: Optional[Tuple[str, int]] = None     # (node name, qpn)
        # DC current hardware connection
        self.dc_connected_to: Optional[str] = None
        # FIFO completion ordering (plain int so error recovery can resync
        # ``_next_complete`` without consuming a sequence number)
        self._next_seq = 0
        self._next_complete = 0
        self._done_buffer: Dict[int, Tuple[WorkRequest, str, int]] = {}
        self._uncovered = 0        # completed-but-not-CQE'd (unsignaled) WRs
        # mailbox for two-sided delivery
        self.mailbox = Store(self.env)
        #: tail of the per-QP send-FIFO chain (RC/DC ordering: a SEND's
        #: delivery waits for the previous SEND's delivery event)
        self._send_fifo_tail = None
        #: tokens pushed whenever a recv CQE is generated (event-driven pumps)
        self.recv_notify = Store(self.env)
        #: poked whenever a send-side CQE is generated into ``cq`` (or the
        #: QP flips to ERR) — the completion-channel analogue the session
        #: reactors block on instead of poll ticks. Broadcast (not Store):
        #: every session sharing this physical CQ must observe the edge.
        self.comp_notify = Broadcast(self.env)
        node.mailboxes[self.qpn] = self.mailbox
        self._rx_proc = self.env.process(self._rx_loop(), f"qp{self.qpn}.rx")
        # stats
        self.stat_posted = 0
        self.stat_completed = 0
        #: doorbell rings (= post_send calls). The batched data plane's
        #: whole point is stat_posted >> stat_doorbells; the serverless
        #: chain tests pin "<= ceil(K/slab) doorbells per hop" on this.
        self.stat_doorbells = 0
        #: ERR CQEs generated so far; once nonzero, selective-signaling
        #: coverage runs may have been split by mid-run error CQEs, so
        #: software covers cross-checks must go lenient
        self.stat_err_cqes = 0

    # ------------------------------------------------------------ control
    def create(self) -> Generator:
        """create_qp+create_cq at the NIC (serialized command interface)."""
        yield from self.fabric.nic_create_qp(self.node)
        self.state = QPState.INIT

    def configure(self, peer: Optional[Tuple[str, int]] = None) -> Generator:
        """modify INIT->RTR->RTS. RC requires a peer."""
        if self.qptype == QPType.RC:
            if peer is None:
                raise QPError("RC configure requires a peer")
            self.peer = peer
        yield from self.fabric.nic_configure_qp(self.node)
        self.state = QPState.RTS

    def reset_from_error(self) -> Generator:
        """Recover an ERR QP: full reconfigure (the cost KRCORE avoids).

        ``_next_complete`` is resynced to the next sequence number that will
        be handed out WITHOUT consuming one: burning a seq here (the old
        behaviour) permanently desynced ``_flush_in_order`` — the first WR
        posted after recovery got seq ``burned+1`` while the flush cursor
        waited on ``burned``, so no completion could ever be generated again.
        WRs still in flight from before the reset complete into
        ``_done_buffer`` with stale (< ``_next_complete``) seqs and are
        dropped on arrival (see :meth:`_execute`).
        """
        self.sq_occupancy = 0
        self.cq.clear()
        self.cq_outstanding = 0
        self._done_buffer.clear()
        self._uncovered = 0
        self._next_complete = self._next_seq
        yield from self.fabric.nic_configure_qp(self.node)
        self.state = QPState.RTS

    def _to_error(self, reason: str) -> None:
        self.state = QPState.ERR
        # wake blocked reactors: an ERR transition without a CQE (SQ/CQ
        # overrun) would otherwise leave notify-driven waiters parked
        self.comp_notify.poke()

    # ------------------------------------------------------------- verbs
    def post_recv(self, buf: RecvBuffer) -> None:
        self.posted_recvs.append(buf)
        # drain any messages that arrived before a buffer was posted
        while self._pending_msgs and self.posted_recvs:
            header, payload = self._pending_msgs.popleft()
            self._deliver(header, payload)

    def post_send(self, wrs: List[WorkRequest]) -> None:
        """Post a doorbell batch. Raises QPError / moves to ERR on misuse.

        This is the *raw* interface: no pre-checks, exactly like hardware.
        KRCORE's qpush (virtqueue.py) is responsible for never tripping the
        failure modes here.
        """
        if self.state != QPState.RTS:
            raise QPError(f"QP{self.qpn} not RTS (state={self.state})")
        if self.sq_occupancy + len(wrs) > self.sq_depth:
            self._to_error("SQ overflow")
            raise QPError(f"QP{self.qpn} send queue overflow")
        for wr in wrs:
            if wr.op not in VALID_OPS:
                self._to_error(f"bad opcode {wr.op}")
                raise QPError(f"QP{self.qpn} invalid opcode {wr.op!r}")
        self.stat_doorbells += 1
        for wr in wrs:
            self.sq_occupancy += 1
            self.cq_outstanding += int(wr.signaled)
            self.stat_posted += 1
            seq = self._next_seq
            self._next_seq += 1
            self.env.process(self._execute(wr, seq), f"qp{self.qpn}.wr{seq}")

    def poll_cq(self, max_n: int = 1) -> List[Completion]:
        """Drain up to ``max_n`` CQEs (pass a large ``max_n`` for a bulk
        drain — one call retires a whole doorbell batch's completions)."""
        out: List[Completion] = []
        while self.cq and len(out) < max_n:
            cqe = self.cq.popleft()
            self.reclaim(cqe.covers)
            out.append(cqe)
        return out

    def poll_recv_cq(self, max_n: int = 1) -> List[Completion]:
        out: List[Completion] = []
        while self.recv_cq and len(out) < max_n:
            out.append(self.recv_cq.popleft())
        return out

    # --------------------------------------------------------- execution
    def _route(self, wr: WorkRequest) -> Tuple[Node, int, bool]:
        """Resolve destination; returns (node, qpn, dct_reconnect)."""
        if self.qptype == QPType.RC:
            if self.peer is None:
                raise QPError("RC QP not connected")
            name, qpn = self.peer
            return self.fabric.node(name), qpn, False
        if self.qptype == QPType.DC:
            if wr.dst is None:
                raise QPError("DC WR missing destination")
            reconnect = wr.dst != self.dc_connected_to
            self.dc_connected_to = wr.dst
            return self.fabric.node(wr.dst), wr.dst_qpn or 0, reconnect
        # UD
        if wr.dst is None:
            raise QPError("UD WR missing destination")
        return self.fabric.node(wr.dst), wr.dst_qpn or 0, False

    def _execute(self, wr: WorkRequest, seq: int) -> Generator:
        status = "OK"
        try:
            dst, dst_qpn, reconnect = self._route(wr)
            dct = self.qptype == QPType.DC
            if wr.op in ("READ", "WRITE", "CAS", "FAA"):
                remote_mr = dst.lookup_mr(wr.remote_rkey)
                if remote_mr is None:
                    raise MRError(f"rkey {wr.remote_rkey} unknown at {dst.name}")
                yield from self.fabric.one_sided(
                    wr.op, self.node, dst, wr.local_mr, wr.local_off,
                    remote_mr, wr.remote_off, wr.nbytes,
                    dct=dct, dct_connect=reconnect,
                    compare=wr.compare, swap=wr.swap, add=wr.add)
            elif wr.op == "SEND":
                header = dict(wr.header or {})
                header.setdefault("src", self.node.name)
                header.setdefault("src_qpn", self.qpn)
                payload = wr.payload if wr.payload is not None else \
                    np.zeros(0, dtype=np.uint8)
                # per-QP send FIFO: chain this delivery behind the
                # previous SEND's (transit still pipelines; see fabric)
                prev, self._send_fifo_tail = \
                    self._send_fifo_tail, self.env.event()
                done = self._send_fifo_tail
                if self.qptype == QPType.UD:
                    yield from self.fabric.ud_send(
                        self.node, dst, dst_qpn, payload, header,
                        prev=prev, done=done)
                else:
                    yield from self.fabric.send_msg(
                        self.node, dst, dst_qpn, payload, header,
                        dct=dct, dct_connect=reconnect,
                        prev=prev, done=done)
        except MRError:
            status = "ERR"
            if seq >= self._next_complete:
                self._to_error("remote/local MR violation")
        if seq < self._next_complete:
            return            # stale in-flight WR from before an error reset
        self._done_buffer[seq] = (wr, status, wr.nbytes)
        self._flush_in_order()

    def _flush_in_order(self) -> None:
        """Generate CQEs strictly in posting order (RC FIFO semantics)."""
        generated = False
        while self._next_complete in self._done_buffer:
            wr, status, nbytes = self._done_buffer.pop(self._next_complete)
            self._next_complete += 1
            self.stat_completed += 1
            self._uncovered += 1
            if wr.signaled:
                self.cq_outstanding = max(0, self.cq_outstanding - 1)
            if wr.signaled or status == "ERR":
                if len(self.cq) >= self.cq_depth:
                    self._to_error("CQ overrun")     # Fig 13b LITE failure
                    return
                if status == "ERR":
                    self.stat_err_cqes += 1
                self.cq.append(Completion(wr.wr_id, status, wr.op, nbytes,
                                          covers=self._uncovered))
                self._uncovered = 0
                generated = True
            # NOTE: sq entries are NOT reclaimed at CQE generation — they
            # are reclaimed when the covering CQE is *polled* (poll_cq).
        if generated:
            # one edge per flush burst: a completion cascade wakes every
            # blocked reactor once, and they bulk-drain what landed
            self.comp_notify.poke()

    def reclaim(self, n: int) -> None:
        """Free ``n`` send-queue entries (a covering CQE was polled)."""
        self.sq_occupancy = max(0, self.sq_occupancy - n)

    # ------------------------------------------------------------ receive
    def _rx_loop(self) -> Generator:
        while True:
            header, payload = yield self.mailbox.get()
            if self.posted_recvs:
                self._deliver(header, payload)
            elif self.qptype == QPType.UD:
                pass                                   # datagram: dropped
            else:
                self._pending_msgs.append((header, payload))

    def _deliver(self, header: dict, payload: np.ndarray) -> None:
        buf = self.posted_recvs.popleft()
        n = min(len(payload), buf.length)
        if n:
            buf.mr.node.write_bytes(buf.mr.addr, buf.offset, payload[:n])
        self.recv_cq.append(Completion(
            buf.wr_id, "OK", "RECV", byte_len=int(len(payload)),
            header=header))
        self.recv_notify.put(1)

    # ------------------------------------------------------------- sizes
    def memory_bytes(self) -> int:
        cm = self.node.cm
        return (self.sq_depth * cm.sq_entry_bytes
                + self.cq_depth * cm.cq_entry_bytes)


# ------------------------------------------------------------------ helpers
def connect_rc_pair(fabric: Fabric, a: Node, b: Node
                    ) -> Generator:
    """Full user-space-style RC connection: QPs on both ends + handshake.

    Returns (qp_a, qp_b). The caller charges driver Init separately if it
    models a fresh process (Verbs) vs a kernel-resident pool (LITE/KRCORE).
    """
    qa, qb = QP(a, QPType.RC), QP(b, QPType.RC)
    pa = fabric.env.process(qa.create(), "create_a")
    pb = fabric.env.process(qb.create(), "create_b")
    yield pa
    yield pb
    # handshake: exchange qpn/gid (UD datagram RTT, §2.2.1: 2.4% of total)
    yield fabric.env.timeout(fabric.cm.handshake_us)
    ca = fabric.env.process(qa.configure((b.name, qb.qpn)), "cfg_a")
    cb = fabric.env.process(qb.configure((a.name, qa.qpn)), "cfg_b")
    yield ca
    yield cb
    return qa, qb
