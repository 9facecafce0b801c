"""Chained-function pipelines (ServerlessBench TestCase5: A -> B -> C).

A chain epoch runs K concurrent invocations through every stage; between
stages the K live payloads must hop to the next stage's node. The hop is
where the three transports diverge — exactly the paper's Fig 12b claim,
extended with the batched data plane:

* ``krcore``  — payloads are packed into contiguous slabs by the
  ``serverless_stage`` CUDA kernel (slab wire format below) and the
  whole hop rides ONE ``qpush_batch`` doorbell carrying ceil(K/slab)
  SEND WRs; the receiver drains them with one batched ``sys_qpop_msgs``
  and unpacks with the same kernel. Large slabs take the §4.5 zero-copy
  path automatically.
* ``lite``    — the node-shared kernel connection (one ~1.4 ms connect,
  then cached) but a syscall + doorbell per message: K doorbells per hop.
* ``verbs``   — the honest serverless baseline: every function instance
  is a fresh process paying the full user-space control path before its
  first byte moves (Fig 3's 15.7 ms).

Slab wire format (int32 elements, CHUNK-aligned):

    [ count | byte_len[0..count-1] | pad to chunk ]  header chunk(s)
    [ payload chunks from stage_pack (chunk-aligned per payload) ]

The header travels inside the slab, so the receiver needs no side channel:
both ends plan the chunk routing from the same length vector.

The pack and unpack gathers run on ``device`` (default: the CUDA card;
``"cpu"`` runs the plain PyTorch version). Their simulated cost is the cost
model's ``memcpy_us`` of the hop's bytes, as in the reference, so every
``ChainReport`` field is the same on either device and in both packages;
the card's own wall times are measured apart from the simulation.

Failover (§4.2 failure handling): when a hop's completions come back ERR
(node died mid-chain), the runner invalidates the dead peer everywhere —
``KRCoreModule.on_node_death`` drops its DCCache/MRStore/RCQP state, the
container pool drains its warm sandboxes — and retries the hop against a
standby node; the chain completes there.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Generator, List, Optional, Sequence, Tuple

import numpy as np

from ..core import (KRCoreError, LiteKernel, MRError, QPError, VerbsProcess,
                    WorkRequest)
from ..core.cluster import Cluster
from ..core.qp import QPState
from ..core.session import (Listener, Session, SessionError, connect,
                            listen)
from ..kernels.serverless_stage.ops import stage_pack, stage_unpack
from ..kernels.serverless_stage.stage import CHUNK

from .container import Container, ContainerPool
from .registry import FunctionDef, FunctionRegistry


class HopError(Exception):
    """A hop's completions came back ERR (destination died mid-chain)."""


# ------------------------------------------------------- slab wire format
def _chunk_bytes(chunk: int = CHUNK) -> int:
    return 4 * chunk


def _header_chunks(count: int, chunk: int = CHUNK) -> int:
    return -(-(2 + count) // chunk)


def slab_capacity_bytes(group: int, max_payload_bytes: int,
                        chunk: int = CHUNK) -> int:
    """Worst-case encoded size of a ``group``-payload slab — what a
    listener's recv buffers must hold."""
    elems = -(-max_payload_bytes // 4)
    per_payload_chunks = max(1, -(-elems // chunk))
    return _chunk_bytes(chunk) * (_header_chunks(group, chunk)
                                  + group * per_payload_chunks)


def encode_slab(payloads: Sequence[np.ndarray], *, seq: int = 0,
                chunk: int = CHUNK, device=None) -> np.ndarray:
    """Pack byte payloads into the self-describing slab (uint8 array); the
    gather runs on ``device`` (default: the CUDA card).

    ``seq`` is the slab's position within its hop: slabs can be delivered
    out of order (small-path messages overtake zero-copy pulls), so the
    receiver reassembles by header sequence, not arrival order.
    """
    k = len(payloads)
    byte_lens = [int(len(p)) for p in payloads]
    elem_lens = np.array([-(-b // 4) for b in byte_lens], np.int32)
    lmax = int(elem_lens.max()) if k else 1
    mat = np.zeros((k, max(lmax, 1)), np.int32)
    for i, p in enumerate(payloads):
        padded = np.zeros(elem_lens[i] * 4, np.uint8)
        padded[:byte_lens[i]] = np.asarray(p, np.uint8)
        mat[i, :elem_lens[i]] = padded.view(np.int32)
    body, _ = stage_pack(mat, elem_lens, chunk=chunk, device=device)
    hdr = np.zeros(_header_chunks(k, chunk) * chunk, np.int32)
    hdr[0] = k
    hdr[1] = seq
    hdr[2:2 + k] = byte_lens
    return np.concatenate([hdr, body]).view(np.uint8)


def decode_slab(raw: np.ndarray, *, chunk: int = CHUNK,
                device=None) -> Tuple[int, List[np.ndarray]]:
    """Inverse of :func:`encode_slab`: returns (seq, payloads); the gather
    runs on ``device`` (default: the CUDA card)."""
    raw = np.ascontiguousarray(np.asarray(raw, np.uint8))
    if len(raw) % 4:
        raw = np.pad(raw, (0, 4 - len(raw) % 4))
    ints = raw.view(np.int32)
    k = int(ints[0])
    seq = int(ints[1])
    byte_lens = [int(b) for b in ints[2:2 + k]]
    elem_lens = np.array([-(-b // 4) for b in byte_lens], np.int32)
    lmax = max(int(elem_lens.max()) if k else 1, 1)
    body = ints[_header_chunks(k, chunk) * chunk:]
    mat = stage_unpack(body, elem_lens, lmax, chunk=chunk, device=device)
    out = []
    for i in range(k):
        row = np.ascontiguousarray(mat[i, :max(int(elem_lens[i]), 1)])
        out.append(row.view(np.uint8)[:byte_lens[i]].copy())
    return seq, out


# ------------------------------------------------------------- reporting
@dataclasses.dataclass
class StageStat:
    name: str
    node: str
    fork_wall_us: float = 0.0       # container lease wall time (cold path)
    compute_wall_us: float = 0.0
    cold: int = 0
    warm: int = 0


@dataclasses.dataclass
class HopStat:
    src: str
    dst: str
    nbytes: int = 0                 # live payload bytes moved
    groups: int = 0                 # slabs (krcore) / messages (baselines)
    doorbells: int = 0              # sender doorbells this hop
    control_us: float = 0.0         # connect + transfer-MR registration
    pack_us: float = 0.0
    send_us: float = 0.0            # doorbell -> all sender CQEs
    drain_us: float = 0.0           # receiver drain + unpack
    failovers: int = 0

    @property
    def data_us(self) -> float:
        return self.pack_us + self.send_us + self.drain_us


@dataclasses.dataclass
class ChainReport:
    transport: str
    k: int
    stages: List[StageStat]
    hops: List[HopStat]
    total_us: float = 0.0
    outputs: Optional[List[np.ndarray]] = None

    @property
    def transfer_us(self) -> float:
        """End-to-end inter-stage transfer time (control + data planes) —
        the Fig 12b metric."""
        return sum(h.control_us + h.data_us for h in self.hops)


# ------------------------------------------------------------ the runner
class ChainRunner:
    """Run chain epochs over a booted cluster.

    KRCORE hops ride the session layer with a **per-node listener cache**
    (ROADMAP open item): the first hop to a node pays the listener + MR
    bring-up once, every later hop — same epoch or a later one — reuses
    the cached listener VirtQueue and the cached sender Session, so the
    per-hop control cost collapses to ~0 (asserted by the serverless
    bench's reuse suite and tests).

    ``device`` is where the krcore hops' pack and unpack gathers run
    (default: the CUDA card; ``"cpu"`` runs the plain version). The
    baselines move no slabs and ignore it.
    """

    def __init__(self, cluster: Cluster, registry: FunctionRegistry,
                 pool: ContainerPool, transport: str = "krcore",
                 slab_payloads: int = 16, chunk: int = CHUNK,
                 standby: Optional[Dict[str, str]] = None,
                 base_port: int = 7100, device=None):
        self.cluster = cluster
        self.env = cluster.env
        self.registry = registry
        self.pool = pool
        self.transport = transport
        self.slab_payloads = slab_payloads
        self.chunk = chunk
        self.standby = dict(standby or {})
        self._next_port = base_port
        self.device = device
        #: per-node listener cache: dst node -> Listener (long-lived)
        self._listeners: Dict[str, Listener] = {}
        #: sender-session cache: (src, dst, port) -> Session
        self._sessions: Dict[Tuple[str, str, int], Session] = {}

    # ------------------------------------------------------------- stages
    def _lease_stage(self, node: str, fn: FunctionDef, k: int,
                     stat: StageStat) -> Generator:
        """Lease k containers concurrently (one per invocation)."""
        t0 = self.env.now
        procs = [self.env.process(self.pool.lease(node, fn),
                                  f"lease.{fn.name}.{i}")
                 for i in range(k)]
        for p in procs:
            yield p
        out: List[Container] = []
        for p in procs:
            kind, c = p.value
            stat.cold += int(kind == "cold")
            stat.warm += int(kind == "warm")
            out.append(c)
        stat.fork_wall_us += self.env.now - t0
        return out

    def _run_stage(self, containers: List[Container], fn: FunctionDef,
                   payloads: List[np.ndarray],
                   stat: StageStat) -> Generator:
        """Apply the stage handler to every payload concurrently."""
        t0 = self.env.now

        def body(c: Container, p: np.ndarray) -> Generator:
            yield self.env.timeout(fn.compute_us)
            return fn.handler(np.asarray(p, np.uint8))

        procs = [self.env.process(body(c, p), f"fn.{fn.name}.{i}")
                 for i, (c, p) in enumerate(zip(containers, payloads))]
        for p in procs:
            yield p
        stat.compute_wall_us += self.env.now - t0
        return [p.value for p in procs]

    # --------------------------------------------------------- hop: krcore
    def _get_listener(self, node: str, cap: int,
                      window: int) -> Generator:
        """The node's cached listener (created once per node; recreated
        only if a later hop needs bigger recv buffers)."""
        lst = self._listeners.get(node)
        if lst is not None and not lst.closed and lst.msg_bytes >= cap:
            yield from lst.grow_window(window)
            return lst
        if lst is not None:
            # recreating moves the node to a new port: retire the old
            # listener AND the sender sessions keyed to the old route
            lst.close()
            for key in [k for k in self._sessions if k[1] == node]:
                self._sessions.pop(key).close()
        mod = self.cluster.module(node)
        port = self._next_port
        self._next_port += 1
        lst = yield from listen(mod, port, msg_bytes=cap, window=window)
        self._listeners[node] = lst
        return lst

    def _get_session(self, src: str, dst: str, port: int) -> Generator:
        """The cached sender session for a (src, dst, port) route."""
        key = (src, dst, port)
        sess = self._sessions.get(key)
        if sess is None or sess.closed:
            sess = yield from connect(self.cluster.module(src), dst,
                                      port=port)
            self._sessions[key] = sess
        return sess

    def _drop_peer(self, node: str) -> None:
        """Failover hygiene: drop every cached listener/session touching a
        dead node so the retry rebuilds fresh state."""
        lst = self._listeners.pop(node, None)
        if lst is not None:
            lst.close()
        for key in [k for k in self._sessions
                    if k[0] == node or k[1] == node]:
            self._sessions.pop(key).close()

    def _hop_krcore(self, src: str, dst: str, payloads: List[np.ndarray],
                    hop: HopStat) -> Generator:
        env = self.env
        cm = self.cluster.module(src).cm
        groups = [payloads[i:i + self.slab_payloads]
                  for i in range(0, len(payloads), self.slab_payloads)]
        hop.groups = len(groups)
        max_p = max((len(p) for p in payloads), default=1)
        cap = slab_capacity_bytes(self.slab_payloads, max_p, self.chunk)

        # control plane: cached listener + cached session (first hop to a
        # node pays Table-2 microseconds ONCE; reuse is ~free — this is
        # the 99%-reduction side of Fig 12b plus the listener-cache win)
        t0 = env.now
        listener = yield from self._get_listener(dst, cap,
                                                 window=len(groups))
        sess = yield from self._get_session(src, dst, listener.port)
        hop.control_us += env.now - t0

        # pack: one staging-kernel pass over all groups (modeled as a
        # single aggregated copy of the hop's bytes)
        t0 = env.now
        slabs = [encode_slab(g, seq=i, chunk=self.chunk, device=self.device)
                 for i, g in enumerate(groups)]
        total = sum(len(s) for s in slabs)
        yield env.timeout(cm.memcpy_us(total))
        hop.pack_us += env.now - t0

        # send: ALL slabs in one batch scope -> the planner lowers them as
        # ONE doorbell for the whole hop (<= ceil(K/slab) always)
        t0 = env.now
        qp = sess.qp
        d0 = qp.stat_doorbells
        with sess.batch():
            futs = [sess.send(slab) for slab in slabs]
        try:
            yield from sess.wait_all(futs)
        except SessionError as e:
            # reclaim before the failover retry: cancel any slab sends
            # still planner-pending (never posted) so they neither ride a
            # later flush to the dead node nor leak their futures
            for f in futs:
                f.cancel()
            raise HopError(f"hop {src}->{dst} completions errored: {e}") \
                from e
        hop.doorbells += qp.stat_doorbells - d0
        hop.send_us += env.now - t0

        # drain: event-driven listener recv + one unpack pass
        t0 = env.now
        msgs = yield from listener.recv_n(len(groups))
        out: List[Optional[List[np.ndarray]]] = [None] * len(groups)
        for msg in msgs:
            seq, group = decode_slab(msg.payload, chunk=self.chunk,
                                     device=self.device)
            out[seq] = group        # slabs reassemble by header sequence
        yield env.timeout(cm.memcpy_us(total))       # unpack pass
        hop.drain_us += env.now - t0
        result = [p for group in out for p in group]  # type: ignore
        hop.nbytes += sum(len(p) for p in payloads)
        return result

    # ------------------------------------------------------ hop: baselines
    def _hop_verbs(self, src: str, dst: str, payloads: List[np.ndarray],
                   hop: HopStat) -> Generator:
        """One fresh user-space process per function instance: the full
        control path precedes every payload (Fig 3 / Fig 12b)."""
        env = self.env
        src_node, dst_node = self.cluster.node(src), self.cluster.node(dst)
        cap = max((len(p) for p in payloads), default=1)
        addr = dst_node.alloc(cap * len(payloads))
        mr_dst = dst_node.reg_mr(addr, cap * len(payloads))
        t0 = env.now
        doorbells = 0

        def one(i: int, payload: np.ndarray) -> Generator:
            proc = VerbsProcess(src_node)
            yield from proc.connect(dst_node)
            mr = yield from proc.reg_mr(max(len(payload), 1))
            src_node.write_bytes(mr.addr, 0, np.asarray(payload, np.uint8))
            qp = proc.qps[dst]
            qp.post_send([WorkRequest(
                op="WRITE", wr_id=1, signaled=True, local_mr=mr,
                local_off=0, remote_rkey=mr_dst.rkey, remote_off=i * cap,
                nbytes=len(payload))])
            while True:
                cqes = qp.poll_cq()
                if cqes:
                    break
                yield env.timeout(0.1)
            if cqes[0].status != "OK":
                return None          # ERR completion: surfaced by parent
            return qp.stat_doorbells

        procs = [self.env.process(one(i, p), f"verbs.{i}")
                 for i, p in enumerate(payloads)]
        for p in procs:
            yield p
        if any(p.value is None for p in procs):
            # raise in the hop generator (not the child process) so
            # _hop_with_failover can catch it and retry on the standby
            raise HopError(f"verbs hop {src}->{dst} WRITE(s) errored")
        doorbells = sum(p.value for p in procs)
        hop.doorbells += doorbells
        hop.groups = len(payloads)
        hop.send_us += env.now - t0
        hop.nbytes += sum(len(p) for p in payloads)
        return [dst_node.read_bytes(addr, i * cap, len(p))
                for i, p in enumerate(payloads)]

    def _hop_lite(self, src: str, dst: str, payloads: List[np.ndarray],
                  hop: HopStat) -> Generator:
        """Shared kernel connection, but a syscall + doorbell per message
        (LITE's high-level sync API — no doorbell batching)."""
        env = self.env
        src_node, dst_node = self.cluster.node(src), self.cluster.node(dst)
        lk = getattr(src_node, "lite", None) or LiteKernel(src_node)
        cm = src_node.cm
        cap = max((len(p) for p in payloads), default=1)
        addr = dst_node.alloc(cap * len(payloads))
        mr_dst = dst_node.reg_mr(addr, cap * len(payloads))
        t0 = env.now
        qp = yield from lk.connect(dst_node)
        hop.control_us += env.now - t0
        mr = src_node.reg_mr(src_node.alloc(cap), cap)
        t0 = env.now
        d0 = qp.stat_doorbells
        for i, p in enumerate(payloads):
            src_node.write_bytes(mr.addr, 0, np.asarray(p, np.uint8))
            yield env.timeout(cm.syscall_us)          # one crossing per msg
            qp.post_send([WorkRequest(
                op="WRITE", wr_id=i, signaled=True, local_mr=mr,
                local_off=0, remote_rkey=mr_dst.rkey, remote_off=i * cap,
                nbytes=len(p))])
            while True:
                cqes = qp.poll_cq()
                if cqes:
                    break
                yield env.timeout(0.1)
            if cqes[0].status != "OK":
                raise HopError(f"lite hop {src}->{dst} WRITE errored")
        hop.doorbells += qp.stat_doorbells - d0
        hop.groups = len(payloads)
        hop.send_us += env.now - t0
        hop.nbytes += sum(len(p) for p in payloads)
        return [dst_node.read_bytes(addr, i * cap, len(p))
                for i, p in enumerate(payloads)]

    # ------------------------------------------------------------ failover
    def _hop_with_failover(self, src: str, dst: str,
                           payloads: List[np.ndarray],
                           hop: HopStat) -> Generator:
        """Run a hop; on ERR completions fail over to the standby node.

        Returns (delivered payloads, node they landed on).
        """
        target = dst
        for _ in range(1 + len(self.standby)):
            try:
                if self.transport == "krcore":
                    out = yield from self._hop_krcore(src, target,
                                                      payloads, hop)
                elif self.transport == "verbs":
                    out = yield from self._hop_verbs(src, target,
                                                     payloads, hop)
                else:
                    out = yield from self._hop_lite(src, target,
                                                    payloads, hop)
                return out, target
            except (HopError, QPError, KRCoreError, MRError, SessionError):
                standby = self.standby.get(target)
                if standby is None:
                    raise
                # §4.2 failure handling: flush every cache keyed by the
                # dead peer — module caches, warm sandboxes, AND the
                # runner's own listener/session caches — then retry
                mod_src = self.cluster.module(src)
                mod_src.on_node_death(target)
                self.pool.drain_node(target)
                self._drop_peer(target)
                hop.failovers += 1
                yield from self._await_recovery(src)
                target = standby
        raise HopError(f"hop from {src} failed on all targets")

    def _await_recovery(self, node: str) -> Generator:
        """Wait for the node's pool QPs to be reconfigured out of ERR
        (background _recover); bounded spin."""
        mod = self.cluster.module(node)
        for _ in range(10_000):
            qps = [qp for pool in mod.pools for qp in pool.dc_qps]
            if all(qp.state == QPState.RTS for qp in qps):
                return
            yield self.env.timeout(5.0)
        raise HopError(f"{node}: pool QPs never recovered")

    # ------------------------------------------------------------- epochs
    def run_batch(self, stage_names: Sequence[str],
                  stage_nodes: Sequence[str], k: int,
                  payloads: Sequence[np.ndarray]) -> Generator:
        """One chain epoch: K invocations through every stage, payloads
        hopping between stage nodes. Returns a ChainReport whose
        ``outputs`` are the final stage's K result payloads (byte-exact
        verifiable against the handler composition)."""
        fns = self.registry.chain(*stage_names)
        if len(stage_nodes) != len(fns):
            raise ValueError("one node per stage required")
        payloads = [np.asarray(p, np.uint8) for p in payloads]
        if len(payloads) != k:
            raise ValueError("need exactly k payloads")
        env = self.env
        t_start = env.now
        nodes = list(stage_nodes)
        stages: List[StageStat] = []
        hops: List[HopStat] = []
        current = payloads
        for s, fn in enumerate(fns):
            stat = StageStat(name=fn.name, node=nodes[s])
            containers = yield from self._lease_stage(nodes[s], fn, k, stat)
            current = yield from self._run_stage(containers, fn, current,
                                                 stat)
            for c in containers:
                self.pool.release(c)
            stages.append(stat)
            if s + 1 < len(fns):
                hop = HopStat(src=nodes[s], dst=nodes[s + 1])
                current, landed = yield from self._hop_with_failover(
                    nodes[s], nodes[s + 1], current, hop)
                if landed != nodes[s + 1]:       # failover moved the stage
                    nodes[s + 1] = landed
                hops.append(hop)
        return ChainReport(transport=self.transport, k=k, stages=stages,
                           hops=hops, total_us=env.now - t_start,
                           outputs=current)


def expected_outputs(registry: FunctionRegistry,
                     stage_names: Sequence[str],
                     payloads: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Oracle: the handler composition applied to each input payload."""
    out = []
    for p in payloads:
        cur = np.asarray(p, np.uint8)
        for fn in registry.chain(*stage_names):
            cur = fn.handler(cur)
        out.append(cur)
    return out
