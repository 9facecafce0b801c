"""Simulated RDMA fabric: nodes, RNICs, registered memory, raw transfers.

The fabric actually moves bytes between per-node heaps (numpy uint8 buffers),
so systems built on top (RACE hashing, the meta server, serverless transfer)
*function* — they are not mocked. Timing comes from
:mod:`repro_torch.core.costmodel`; queueing (NIC command unit, NIC data
engines, per-core RPC handlers) comes from the DES in
:mod:`repro_torch.core.sim`.

Modeled RNIC structure (per ConnectX-4 behaviour in the paper):

  * ``cmd``   — the NIC command interface. QP create/modify commands are
                serialized here; this is the 712-QPs/sec bottleneck of
                Fig 3 / §2.2.2 Issue#1.
  * ``engine``— the data-path processing units (pipelined, capacity > 1).
                Saturation of this resource gives the throughput plateaus in
                Fig 10/11.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Generator, Optional, Tuple

import numpy as np

from .costmodel import CostModel, DEFAULT
from .sim import Environment, Resource, Store


class FabricError(Exception):
    pass


class MRError(FabricError):
    """Invalid memory-region access (would transition a QP to error state)."""


@dataclasses.dataclass
class MemoryRegion:
    node: "Node"
    addr: int
    length: int
    lkey: int
    rkey: int
    valid: bool = True

    def check(self, offset: int, nbytes: int) -> None:
        if not self.valid:
            raise MRError(f"MR rkey={self.rkey} deregistered")
        if offset < 0 or nbytes < 0 or offset + nbytes > self.length:
            raise MRError(
                f"MR rkey={self.rkey} access [{offset}, {offset+nbytes}) "
                f"outside [0, {self.length})")


class Node:
    """A host: heap memory, one RNIC (cmd unit + data engines), CPU cores."""

    _ids = itertools.count()

    def __init__(self, fabric: "Fabric", name: str, n_cores: int = 24,
                 nic_parallelism: int = 16):
        self.fabric = fabric
        self.env = fabric.env
        self.cm = fabric.cm
        self.id = next(Node._ids)
        self.name = name
        # memory: addr -> numpy buffer (addresses are synthetic, page-aligned)
        self._heap: Dict[int, np.ndarray] = {}
        self._next_addr = 0x1000
        self._mrs: Dict[int, MemoryRegion] = {}       # rkey -> MR
        self._next_key = itertools.count(1)
        # NIC resources
        self.nic_cmd = Resource(self.env, capacity=1, name=f"{name}.nic_cmd")
        self.nic_engine = Resource(self.env, capacity=nic_parallelism,
                                   name=f"{name}.nic_engine")
        # CPU cores used by in-kernel / server-side handlers
        self.cores = Resource(self.env, capacity=n_cores, name=f"{name}.cpu")
        # mailboxes: (qpn) -> Store of incoming messages, managed by qp.py
        self.mailboxes: Dict[int, Store] = {}
        #: node liveness: ops targeting a dead node fail (timeout -> the
        #: initiator QP sees an ERR completion), used by the failover tests
        self.alive = True
        # stats
        self.stat_bytes_tx = 0
        self.stat_bytes_rx = 0

    # ---------------------------------------------------------------- mem
    def alloc(self, nbytes: int) -> int:
        addr = self._next_addr
        self._heap[addr] = np.zeros(nbytes, dtype=np.uint8)
        self._next_addr += (nbytes + 0xFFF) & ~0xFFF
        return addr

    def buffer(self, addr: int) -> np.ndarray:
        if addr not in self._heap:
            raise MRError(f"{self.name}: bad base address {addr:#x}")
        return self._heap[addr]

    def reg_mr(self, addr: int, length: int) -> MemoryRegion:
        """Register memory (timing charged by the caller via cm.reg_mr_us)."""
        buf = self.buffer(addr)
        if length > buf.size:
            raise MRError("register beyond allocation")
        key = next(self._next_key) * 8 + self.id % 8
        mr = MemoryRegion(self, addr, length, lkey=key, rkey=key)
        self._mrs[key] = mr
        return mr

    def dereg_mr(self, mr: MemoryRegion) -> None:
        mr.valid = False
        self._mrs.pop(mr.rkey, None)

    def lookup_mr(self, rkey: int) -> Optional[MemoryRegion]:
        return self._mrs.get(rkey)

    def read_bytes(self, addr: int, offset: int, nbytes: int) -> np.ndarray:
        return self.buffer(addr)[offset:offset + nbytes].copy()

    def write_bytes(self, addr: int, offset: int, data: np.ndarray) -> None:
        self.buffer(addr)[offset:offset + len(data)] = data


class Fabric:
    """The cluster: nodes + wire model."""

    def __init__(self, cm: CostModel = DEFAULT, env: Optional[Environment] = None):
        self.cm = cm
        self.env = env or Environment()
        self.nodes: Dict[str, Node] = {}

    def add_node(self, name: str, **kw) -> Node:
        if name in self.nodes:
            raise FabricError(f"duplicate node {name}")
        node = Node(self, name, **kw)
        self.nodes[name] = node
        return node

    def node(self, name: str) -> Node:
        return self.nodes[name]

    # ------------------------------------------------------------ wire ops
    # All are generator processes; they charge time AND move real bytes.

    def _engine(self, node: Node, service_us: float) -> Generator:
        yield from node.nic_engine.serve(service_us)

    def one_sided(self, op: str, src: Node, dst: Node,
                  local_mr: MemoryRegion, local_off: int,
                  remote_mr: MemoryRegion, remote_off: int,
                  nbytes: int, dct: bool = False,
                  dct_connect: bool = False, compare: int = 0,
                  swap: int = 0, add: int = 0) -> Generator:
        """One-sided READ/WRITE/CAS/FAA from ``src`` targeting ``dst``
        memory.

        Bypasses the destination CPU entirely (only NIC engine time there).
        Raises MRError on invalid access — the caller (QP) moves to an error
        state, mirroring hardware behaviour. CAS and FAA are 8-byte
        atomics: the read-modify-write happens at a single simulation
        instant at the destination NIC (no yield between read and write),
        and the previous value returns to (local_mr, local_off). FAA adds
        ``add`` to the remote u64 (mod 2^64) — the wait-free sibling of
        CAS for counters/tickets (no retry loop under contention).
        """
        cm = self.cm
        extra = cm.dct_op_extra_us if dct else 0.0
        if dct_connect:
            extra += cm.dct_connect_us
        if op in ("CAS", "FAA"):
            nbytes = 8
        if not dst.alive:
            # retry timeout at the initiator NIC, then transport error
            yield self.env.timeout(12.0)
            raise MRError(f"{dst.name} unreachable (node down)")
        local_mr.check(local_off, nbytes)
        remote_mr.check(remote_off, nbytes)
        # request issue at the source NIC
        yield from self._engine(src, cm.nic_op_us + extra)
        # request flight (header-only for READ, header+payload for WRITE,
        # compare+swap operands for CAS)
        req_payload = nbytes if op in ("WRITE", "CAS", "FAA") else 0
        yield self.env.timeout(cm.wire_us + cm.payload_us(req_payload))
        # destination NIC DMA (CPU bypass)
        resp_payload = nbytes if op in ("READ", "CAS", "FAA") else 0
        yield from self._engine(dst, cm.nic_op_us
                                + cm.payload_us(max(req_payload, resp_payload)))
        if op == "READ":
            data = dst.read_bytes(remote_mr.addr, remote_off, nbytes)
            src.write_bytes(local_mr.addr, local_off, data)
        elif op == "WRITE":
            data = src.read_bytes(local_mr.addr, local_off, nbytes)
            dst.write_bytes(remote_mr.addr, remote_off, data)
        elif op == "CAS":
            old = dst.read_bytes(remote_mr.addr, remote_off, 8)
            if int(old.view(np.uint64)[0]) == (compare & 0xFFFFFFFFFFFFFFFF):
                new = np.array([swap & 0xFFFFFFFFFFFFFFFF],
                               np.uint64).view(np.uint8)
                dst.write_bytes(remote_mr.addr, remote_off, new)
            src.write_bytes(local_mr.addr, local_off, old)
        elif op == "FAA":
            old = dst.read_bytes(remote_mr.addr, remote_off, 8)
            summed = (int(old.view(np.uint64)[0]) + add) \
                & 0xFFFFFFFFFFFFFFFF
            dst.write_bytes(remote_mr.addr, remote_off,
                            np.array([summed], np.uint64).view(np.uint8))
            src.write_bytes(local_mr.addr, local_off, old)
        else:
            raise FabricError(f"bad one-sided op {op}")
        # response flight + source-side completion
        yield self.env.timeout(cm.wire_us + cm.payload_us(resp_payload))
        yield from self._engine(src, cm.nic_op_us)
        src.stat_bytes_tx += req_payload
        src.stat_bytes_rx += resp_payload
        dst.stat_bytes_rx += req_payload
        dst.stat_bytes_tx += resp_payload

    def send_msg(self, src: Node, dst: Node, dst_qpn: int,
                 payload: np.ndarray, header: dict,
                 dct: bool = False, dct_connect: bool = False,
                 prev=None, done=None) -> Generator:
        """Two-sided SEND: deliver (header, payload) to dst mailbox ``qpn``.

        ``prev``/``done`` implement per-QP send FIFO (RC/DC ordering
        guarantee): transit is pipelined, but delivery into the mailbox
        waits for the QP's previous SEND to deliver first — a later
        message of the same doorbell batch can never overtake an earlier
        one whose first packet was delayed (e.g. by a DCT reconnect).
        ``done`` fires once this message has delivered (or failed), so
        the chain never deadlocks on an errored send.
        """
        cm = self.cm
        nbytes = int(payload.size)
        extra = cm.dct_op_extra_us if dct else 0.0
        if dct_connect:
            extra += cm.dct_connect_us
        try:
            if not dst.alive:
                yield self.env.timeout(12.0)
                raise MRError(f"{dst.name} unreachable (node down)")
            yield from self._engine(src, cm.nic_op_us + extra)
            yield self.env.timeout(cm.wire_us + cm.payload_us(nbytes))
            yield from self._engine(dst, cm.nic_op_us
                                    + cm.payload_us(nbytes))
            if prev is not None and not prev.triggered:
                yield prev                       # per-QP FIFO delivery
            box = dst.mailboxes.get(dst_qpn)
            if box is None:
                raise FabricError(f"{dst.name}: no mailbox qpn={dst_qpn}")
            box.put((dict(header), payload.copy()))
            src.stat_bytes_tx += nbytes
            dst.stat_bytes_rx += nbytes
        finally:
            if done is not None and not done.triggered:
                done.succeed()

    def ud_send(self, src: Node, dst: Node, dst_qpn: int,
                payload: np.ndarray, header: dict,
                prev=None, done=None) -> Generator:
        """Connectionless datagram (UD): like send, capped at the MTU."""
        if payload.size > self.cm.ud_mtu:
            raise FabricError("UD payload exceeds MTU")
        yield from self.send_msg(src, dst, dst_qpn, payload, header,
                                 prev=prev, done=done)

    # ------------------------------------------------------ control (NIC)
    def nic_create_qp(self, node: Node) -> Generator:
        """create_qp + create_cq: software time + serialized NIC commands."""
        cm = self.cm
        yield self.env.timeout(cm.create_qp_sw_us + cm.create_cq_sw_us)
        yield from node.nic_cmd.serve(cm.create_qp_nic_us + cm.create_cq_nic_us)

    def nic_configure_qp(self, node: Node) -> Generator:
        """modify_qp INIT->RTR->RTS at the NIC command interface."""
        cm = self.cm
        yield from node.nic_cmd.serve(cm.modify_qp_rtr_nic_us
                                      + cm.modify_qp_rts_nic_us)
