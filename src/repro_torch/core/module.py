"""KRCoreModule: the per-node 'kernel module' (paper Fig 6, §4).

Hosts the per-CPU hybrid QP pools, the DC target, the DCCache/MRStore, the
meta-server clients, and implements the system-call surface of Table 1:

    queue / qconnect / qbind / qreg_mr          (control path, socket-like)
    qpush / qpop / qpush_recv / qpop_msgs       (data path, verbs-like)

plus the zero-copy protocol (§4.5) and the DC<->RC transfer protocol (§4.6).

All blocking operations are DES generators (yield sim events).
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Dict, Generator, List, Optional, Tuple

import numpy as np

from .costmodel import CostModel, DEFAULT
from .fabric import Fabric, MemoryRegion, MRError, Node
from .meta import (SLOT, DCCache, DCTMeta, DrTMKV, KVClient, MetaServer,
                   MRStore, ValidMRStore, fnv1a)
from .pool import HybridQPPool
from .qp import (ATOMIC_OPS, QP, Completion, QPError, QPState, QPType,
                 RecvBuffer, VALID_OPS, WorkRequest, connect_rc_pair)
from .sim import Store
from .virtqueue import (NOT_READY, READY, CompEntry, PolledMsg, RecvEntry,
                        VirtQueue, decode_wr_id, encode_wr_id)

KERNEL_RECV_SLOTS = 64


class KRCoreError(Exception):
    pass


class KRCoreModule:
    """One node's KRCORE instance."""

    def __init__(self, node: Node, meta_servers: List[MetaServer],
                 n_pools: int = 1, n_dcqps: int = 1, rc_cap: int = 32,
                 promote_threshold: int = 8):
        self.node = node
        self.env = node.env
        self.fabric: Fabric = node.fabric
        self.cm: CostModel = node.cm
        self.meta_servers = meta_servers
        self.promote_threshold = promote_threshold
        self.pools = [HybridQPPool(node, cpu, n_dcqps=n_dcqps, rc_cap=rc_cap)
                      for cpu in range(n_pools)]
        self.dccache = DCCache()
        self.mrstore = MRStore(self.env, self.cm.mr_flush_period_us)
        self.validmr = ValidMRStore(node)
        self.vqs: Dict[int, VirtQueue] = {}
        self.ports: Dict[int, VirtQueue] = {}
        self.dc_target: Optional[QP] = None
        self.dct_key: int = 0
        self.ud: Optional[QP] = None
        self.flush_mr: Optional[MemoryRegion] = None
        self._meta_clients: List[KVClient] = []
        self._server_qps: List[QP] = []
        self._kernel_slab = 0
        self._kernel_slab_mr: Optional[MemoryRegion] = None
        self._slab_slots: deque = deque()
        self._scratch_mr: Optional[MemoryRegion] = None
        # kernel-staged small messages per vq id, waiting for a user buffer
        self._staged: Dict[int, deque] = {}
        # zero-copy descriptors waiting for a user buffer
        self._staged_zc: Dict[int, deque] = {}
        # (src, src_vq, listener_vq) -> reply qd (accept-semantics cache)
        self._reply_qds: Dict[Tuple[str, int, int], int] = {}
        self._promotions_inflight: set = set()
        #: callables invoked (with the dead peer's name) at the END of
        #: on_node_death — lets application-level caches keyed by node
        #: (e.g. the dkv shard-directory cache) invalidate in lockstep
        #: with the kernel's own DCCache/MRStore/RC-pool invalidation
        self._death_hooks: List = []
        self.booted = False
        # stats
        self.stat_promotions = 0
        self.stat_transfers = 0
        self.stat_zc_reads = 0

    # ===================================================== module load/boot
    def boot(self) -> Generator:
        """Module load: static initialization of all shared state (§4.2).

        This cost is paid once per node at boot, *never* on an application
        control path — the whole point of the paper.
        """
        node, cm = self.node, self.cm
        # kernel message slab (pre-posted two-sided receive buffers)
        slab_bytes = KERNEL_RECV_SLOTS * cm.kernel_msg_buf_bytes * 4
        self._kernel_slab = node.alloc(slab_bytes)
        self._kernel_slab_mr = node.reg_mr(self._kernel_slab, slab_bytes)
        for i in range(KERNEL_RECV_SLOTS * 4):
            self._slab_slots.append(i * cm.kernel_msg_buf_bytes)
        # flush region for the transfer protocol's fake READ (§4.6)
        flush_addr = node.alloc(64)
        self.flush_mr = node.reg_mr(flush_addr, 64)
        # scratch for meta lookups / internal reads
        scratch = node.alloc(4096)
        self._scratch_mr = node.reg_mr(scratch, 4096)
        # DC target (one per node): receives all DC traffic
        self.dc_target = QP(node, QPType.DC)
        yield from self.dc_target.create()
        yield from self.dc_target.configure()
        self.dct_key = (hash(node.name) & 0x7FFFFFFF) or 1
        self._watch_server_qp(self.dc_target)
        # UD QP for control messages
        self.ud = QP(node, QPType.UD)
        yield from self.ud.create()
        yield from self.ud.configure()
        self._watch_server_qp(self.ud)
        # per-CPU pools: static DCQPs
        for pool in self.pools:
            yield from pool.boot()
        # register DCT metadata (+ flush MR info) at every meta server
        meta = DCTMeta(self.node.id, self.dc_target.qpn, self.dct_key)
        payload = meta.pack() + np.frombuffer(
            np.array([self.flush_mr.rkey], dtype=np.uint32).tobytes(),
            dtype=np.uint8).tobytes()
        for ms in self.meta_servers:
            ms.kv.put(node.name.encode(), payload)
        # pre-connect an RCQP to each (nearby) meta server (§4.2)
        for ms in self.meta_servers:
            qa, _qb = yield from connect_rc_pair(self.fabric, node, ms.node)
            self._meta_clients.append(
                KVClient(qa, ms.kv, self._scratch_mr, 0))
        self.booted = True

    def _watch_server_qp(self, qp: QP) -> None:
        """Pre-post kernel buffers + start the receive pump for ``qp``."""
        self._server_qps.append(qp)
        for _ in range(KERNEL_RECV_SLOTS):
            self._post_kernel_recv(qp)
        self.env.process(self._recv_pump(qp), f"{self.node.name}.pump{qp.qpn}")

    def _post_kernel_recv(self, qp: QP) -> None:
        if not self._slab_slots:
            return
        off = self._slab_slots.popleft()
        qp.post_recv(RecvBuffer(self._kernel_slab_mr, off,
                                self.cm.kernel_msg_buf_bytes, wr_id=off))

    # ===================================================== control path
    def sys_queue(self, cpu: int = 0) -> Generator:
        """queue(): allocate a VirtQueue (Table 2: 0.36us)."""
        yield self.env.timeout(self.cm.queue_us)
        vq = VirtQueue(owner_cpu=cpu)
        self.vqs[vq.id] = vq
        return vq.id

    def sys_qconnect(self, qd: int, addr: str,
                     port: Optional[int] = None) -> Generator:
        """qconnect(): Algorithm 1, VirtQueueConnect. No QP is created."""
        vq = self._vq(qd)
        pool = self.pools[vq.owner_cpu % len(self.pools)]
        kind, qp = pool.select(addr)
        vq.remote = addr
        vq.remote_port = port
        if kind == "RC":
            yield self.env.timeout(self.cm.qconnect_rc_hit_us)
            vq.qp, vq.kind = qp, "RC"
            vq.remote_qpn = qp.peer[1]
            self._maybe_promote(pool, addr)
            return 0
        meta = self.dccache.get(addr)
        if meta is not None:
            yield self.env.timeout(self.cm.qconnect_dc_cached_us)
        else:
            # worst case: one-sided lookup at a meta server (Fig 8 path)
            yield self.env.timeout(self.cm.qconnect_dc_cached_us)
            meta = yield from self._meta_lookup(addr)
            if meta is None:
                return -1
            self.dccache.put(addr, meta)
        vq.qp, vq.kind = qp, "DC"
        vq.dct_meta = meta
        vq.remote_qpn = meta.dct_num
        self._maybe_promote(pool, addr)
        return 0

    def sys_qbind(self, qd: int, port: int) -> Generator:
        yield self.env.timeout(self.cm.qbind_us)
        vq = self._vq(qd)
        if port in self.ports:
            return -1
        vq.bound_port = port
        self.ports[port] = vq
        return 0

    def sys_qreg_mr(self, nbytes: int) -> Generator:
        """qreg_mr(): allocate + register ``nbytes`` of user memory.

        Kernel-space registration reuses the shared driver context, so the
        cost is Table-2-scale (1.4us for 4MB), not the 50us+ user-space cost.
        """
        frac = max(nbytes / (4 * 1024 * 1024), 0.1)
        yield self.env.timeout(self.cm.qreg_mr_4mb_us * min(frac, 16.0))
        addr = self.node.alloc(nbytes)
        mr = self.node.reg_mr(addr, nbytes)
        self.validmr.add(mr)
        return mr

    def sys_qdereg_mr(self, mr: MemoryRegion) -> Generator:
        """Deregister: remove from ValidMR now, release after a flush period
        so stale MRStore entries elsewhere can never outlive it (§4.2)."""
        self.validmr.remove(mr.rkey)
        yield self.env.timeout(self.cm.mr_flush_period_us)
        self.node.dereg_mr(mr)
        return 0

    def _meta_lookup(self, addr: str) -> Generator:
        """Query meta servers in order; fail over to the next replica when
        one is down (§4.2: "each node keeps multiple connections to
        different meta servers"). All-replicas-dead falls back to an RPC
        to the target node itself (the rare path)."""
        for client in self._meta_clients:
            if not client.server.node.alive:
                continue
            val = yield from client.lookup(addr.encode())
            if val is not None:
                return DCTMeta.unpack(val)
        # RPC fallback: ask the target's kernel directly over UD
        target = self.fabric.node(addr)
        if target.alive and hasattr(target, "krcore"):
            tm: KRCoreModule = target.krcore            # type: ignore
            yield self.env.timeout(self.cm.rpc_handler_us
                                   + 2 * self.cm.wire_us)
            if tm.booted:
                return DCTMeta(target.id, tm.dc_target.qpn, tm.dct_key)
        return None

    # -------------------------------------------- kernel-internal transfers
    def _internal_vq(self, addr: str) -> Generator:
        """A kernel-owned VirtQueue to ``addr`` (cached), for module-to-
        module one-sided reads (ValidMR checks, zero-copy pulls)."""
        cache = getattr(self, "_ivqs", None)
        if cache is None:
            cache = self._ivqs = {}
        if addr in cache:
            return cache[addr]
        vq = VirtQueue(owner_cpu=0)
        self.vqs[vq.id] = vq
        pool = self.pools[0]
        kind, qp = pool.select(addr)
        vq.remote, vq.qp, vq.kind = addr, qp, kind
        if kind == "RC":
            vq.remote_qpn = qp.peer[1]
        else:
            meta = self.dccache.get(addr)
            if meta is None:
                meta = yield from self._meta_lookup(addr)
                if meta is None:
                    raise KRCoreError(f"no meta for {addr}")
                self.dccache.put(addr, meta)
            vq.dct_meta, vq.remote_qpn = meta, meta.dct_num
        cache[addr] = vq
        return vq

    def _internal_read(self, addr: str, rkey: int, remote_off: int,
                       nbytes: int, local_mr: MemoryRegion,
                       local_off: int) -> Generator:
        """Trusted kernel read via the shared-QP discipline (qpush/qpop)."""
        vq = yield from self._internal_vq(addr)
        wr = WorkRequest(op="READ", signaled=True, wr_id=0,
                         local_mr=local_mr, local_off=local_off,
                         remote_rkey=rkey, remote_off=remote_off,
                         nbytes=nbytes, trusted=True)
        rc = yield from self.sys_qpush(vq.id, [wr])
        if rc != 0:
            raise KRCoreError(f"internal read failed rc={rc}")
        ent = yield from self.qpop_block(vq.id)
        if ent.err:
            raise KRCoreError("internal read errored")
        return 0

    # ===================================================== data path: Alg. 2
    def sys_qpush(self, qd: int, wr_list: List[WorkRequest]) -> Generator:
        """Algorithm 2, qpush. Returns 0 or raises KRCoreError pre-post.

        One syscall crossing per call; the caller controls per-WR
        ``signaled`` flags. For the batch-first fast path (automatic
        selective signaling, one crossing for arbitrarily many WRs) see
        :meth:`qpush_batch`.
        """
        vq = self._vq(qd)
        qp = self._require_qp(vq)
        yield self.env.timeout(self.cm.syscall_us)
        return (yield from self._qpush_locked(vq, qp, wr_list))

    def qpush_batch(self, qd: int, wr_list: List[WorkRequest],
                    signal_interval: Optional[int] = None) -> Generator:
        """Batched qpush: ONE doorbell / syscall crossing for the whole
        batch, with automatic selective signaling.

        Every ``signal_interval``-th WR plus the batch's last WR is
        signaled, so N WRs generate exactly ``ceil(N / signal_interval)``
        CQEs (and that many poppable CompEntries, each ``covers``-ing its
        unsignaled run). ``signal_interval=None`` signals only the last WR
        of each hardware-sized segment. The interval is clamped to
        ``min(sq_depth, cq_depth - 1)``: a longer unsignaled run could
        never be reclaimed (reclaim happens at poll of the covering CQE)
        and would deadlock the SQ. Caller-set ``signaled`` flags are
        overwritten — this is the batch-discipline entry point.

        Returns the number of CompEntries queued (= ``ceil(N / interval)``,
        what :meth:`qpop_batch` will eventually yield), or -1 if a WR
        failed validation. Segmentation splits at signal boundaries (see
        :meth:`_qpush_locked`) so it never inflates that count.
        """
        vq = self._vq(qd)
        qp = self._require_qp(vq)
        yield self.env.timeout(self.cm.syscall_us)
        if not wr_list:
            return 0
        limit = self._segment_limit(qp)
        k = limit if signal_interval is None else \
            max(1, min(signal_interval, limit))
        n = len(wr_list)
        n_entries = 0
        for i, req in enumerate(wr_list):
            req.signaled = ((i + 1) % k == 0) or (i == n - 1)
            n_entries += int(req.signaled)
        rc = yield from self._qpush_locked(vq, qp, wr_list)
        return n_entries if rc == 0 else rc

    @staticmethod
    def _segment_limit(qp: QP) -> int:
        """Largest batch one doorbell may carry. The limit must leave BOTH
        reservation loops satisfiable: the SQ needs len <= sq_depth and the
        CQ reservation needs len <= cq_depth - 1 (a batch of exactly
        cq_depth could never reserve its CQEs)."""
        return min(qp.sq_depth, qp.cq_depth - 1)

    def _qpush_locked(self, vq: VirtQueue, qp: QP,
                      wr_list: List[WorkRequest]) -> Generator:
        """Post a batch (Alg. 2 body), segmenting at signal boundaries.

        The validity pre-checks run over the ENTIRE batch before any
        segment is posted, so a malformed WR anywhere in the batch rejects
        the whole batch atomically — no orphaned in-flight WRs or queued
        CompEntries from earlier segments (Alg.2 line 7's "before any
        mutation" guarantee, kept across segmentation).

        Splitting at the last signaled WR within the hardware limit (paper
        §4.4: "achieved by segmenting") keeps every segment's tail signaled
        whenever the caller's signaling pattern allows it, so segmentation
        never inflates the CQE count of a selectively-signaled batch.
        """
        cm = self.cm
        # ---- validity pre-checks (Alg.2 line 7; done before any mutation
        # so a malformed batch leaves no queueing elements behind) --------
        for req in wr_list:
            yield self.env.timeout(cm.precheck_us)
            try:
                self._check_request(vq, req)
            except KRCoreError:
                return -1                                   # Alg.2 line 8
            if req.op in ("READ", "WRITE") + ATOMIC_OPS:
                ok = yield from self._check_remote_mr(vq, req)
                if not ok:
                    return -1                               # Alg.2 line 8
        yield from self._post_segments(vq, qp, wr_list)
        return 0

    def _post_segments(self, vq: VirtQueue, qp: QP,
                       wr_list: List[WorkRequest]) -> Generator:
        """Segment an already-validated batch and post each doorbell."""
        cm = self.cm
        limit = self._segment_limit(qp)
        if len(wr_list) > limit:
            split = limit
            for j in range(limit, 0, -1):
                if wr_list[j - 1].signaled:
                    split = j
                    break
            yield from self._post_segments(vq, qp, wr_list[:split])
            yield from self._post_segments(vq, qp, wr_list[split:])
            return

        # ---- clear space (Alg.2 lines 2-4) -------------------------------
        while qp.sq_depth - qp.sq_occupancy < len(wr_list):
            progressed = self._qpop_inner(vq)
            if not progressed:
                yield self.env.timeout(0.2)
        # keep the CQ from overrunning too: reserve against BOTH queued
        # CQEs and CQEs still owed by in-flight signaled WRs — an
        # out-of-order completion cascade can mint all of the owed ones
        # at a single instant, faster than any voluntary poll cadence
        while (len(qp.cq) + qp.cq_outstanding
               > qp.cq_depth - len(wr_list) - 1):
            if not self._qpop_inner(vq):
                yield self.env.timeout(0.2)

        # ---- selective signaling + wr_id encoding (lines 5-22) ----------
        unsignaled_cnt = 0
        entries: List[CompEntry] = []
        for req in wr_list:
            self._fill_routing(vq, req)
            if req.signaled:
                entries.append(CompEntry(NOT_READY, req.wr_id,
                                         covers=unsignaled_cnt + 1))
                req.wr_id = encode_wr_id(vq.id, unsignaled_cnt + 1)
                unsignaled_cnt = 0
            else:
                # unsignaled WRs also carry vq ownership (comp_cnt == 0 is
                # the unsignaled marker: an OK CQE is never generated for
                # them, so the only CQE carrying this encoding is an ERR
                # completion — which _qpop_inner can now route to the
                # owning VirtQueue instead of dropping it on the floor)
                req.wr_id = encode_wr_id(vq.id, 0)
                unsignaled_cnt += 1
        last = wr_list[-1]
        if not last.signaled:
            # in the worst case only the last request is force-signaled
            last.signaled = True
            last.wr_id = encode_wr_id(0, unsignaled_cnt)   # NULL vq
        # zero-copy path for large two-sided payloads (§4.5)
        for req in wr_list:
            if req.op == "SEND" and req.nbytes > cm.kernel_msg_buf_bytes:
                self._to_zero_copy(vq, req)
        # post first, queue after: post_send validates before mutating, so
        # a raise here (QP flipped to ERR by an earlier in-flight failure)
        # leaves NO never-ready CompEntries behind — earlier segments stay
        # consistent and the caller can account exactly what posted
        qp.post_send(wr_list)                               # line 23
        vq.comp_queue.extend(entries)
        vq.uncomp_cnt += sum(e.covers for e in entries)
        vq.stat_entries_queued += len(entries)

    def sys_qpop(self, qd: int) -> Generator:
        """Algorithm 2, qpop: non-blocking; returns CompEntry or None."""
        vq = self._vq(qd)
        yield self.env.timeout(self.cm.syscall_us)
        self._qpop_inner(vq)
        return vq.pop_ready()

    def qpop_batch(self, qd: int, max_n: int = 64) -> Generator:
        """Batched qpop: ONE syscall crossing, bulk CQ drain, returns up to
        ``max_n`` Ready CompEntries in FIFO order (possibly empty)."""
        vq = self._vq(qd)
        yield self.env.timeout(self.cm.syscall_us)
        self._qpop_inner(vq)
        return vq.pop_ready_batch(max_n)

    def qpop_wait(self, qd: int, max_n: int = 64) -> Generator:
        """Blocking batched qpop — completion-channel semantics.

        ONE kernel crossing that parks on the physical QP's CQE edge when
        nothing is consumable (``ibv_get_cq_event`` and the follow-up CQ
        poll fused into a single syscall). The crossing charge is paid at
        ENTRY, so for a blocked caller it overlaps the in-flight op's
        wire time instead of trailing the CQE the way a poll tick does —
        the session reactor rides this for one-sided waits, which is how
        a blocked single-op caller gets CQE-instant wakeup with zero
        idle-poll syscalls.

        Readiness includes the message queue: if messages are already
        consumable the call returns (possibly empty) instead of sleeping
        past them. Returns immediately with whatever is ready when the
        QP is in ERR — recovery pacing is the caller's job.
        """
        vq = self._vq(qd)
        yield self.env.timeout(self.cm.syscall_us)
        while True:
            self._qpop_inner(vq)
            out = vq.pop_ready_batch(max_n)
            if out or vq.msg_queue:
                return out
            qps = [q for q in (vq.qp, vq.old_qp) if q is not None]
            if not qps or any(q.state == QPState.ERR for q in qps):
                return out               # ERR escape: caller paces recovery
            ev = self.env.event()
            for q in qps:
                q.comp_notify.subscribe(ev)
            if any(q.cq for q in qps):
                continue                 # CQE raced the arm: re-poll now
            yield ev

    def qpop_block(self, qd: int, poll_us: float = 0.2) -> Generator:
        """Convenience: spin qpop until a completion arrives."""
        while True:
            ent = yield from self.sys_qpop(qd)
            if ent is not None:
                return ent
            yield self.env.timeout(poll_us)

    def qpop_batch_block(self, qd: int, n: int,
                         poll_us: float = 0.2) -> Generator:
        """Convenience: drain exactly ``n`` completions via qpop_batch."""
        out: List[CompEntry] = []
        while len(out) < n:
            ents = yield from self.qpop_batch(qd, max_n=n - len(out))
            out.extend(ents)
            if len(out) < n:
                yield self.env.timeout(poll_us)
        return out

    def sys_qpush_recv(self, qd: int, mr: MemoryRegion, offset: int,
                       length: int, wr_id: int) -> Generator:
        vq = self._vq(qd)
        yield self.env.timeout(self.cm.syscall_us)
        vq.recv_queue.append(RecvEntry(mr, offset, length, wr_id))
        # drain kernel-staged small messages / pending zero-copy descriptors
        yield from self._drain_staged(vq)
        return 0

    def sys_qpop_msgs(self, qd: int,
                      max_n: Optional[int] = None) -> Generator:
        """qpop_msgs: poll received messages; returns list of PolledMsg.

        ONE syscall crossing drains up to ``max_n`` queued messages (all
        of them when ``max_n`` is None) — the recv-side analogue of
        ``qpop_batch``, so a whole SEND doorbell batch is consumed with a
        single kernel crossing.

        Each message carries ``reply_qd`` — a VirtQueue already connected
        back to the sender (accept semantics, §4.1), built from the DCT
        metadata piggybacked in the message header (§4.4) so no meta-server
        query is needed.
        """
        vq = self._vq(qd)
        yield self.env.timeout(self.cm.syscall_us)
        out: List[PolledMsg] = []
        while vq.msg_queue and (max_n is None or len(out) < max_n):
            out.append(vq.msg_queue.popleft())
        return out

    # ------------------------------------------------------------ internals
    def _vq(self, qd: int) -> VirtQueue:
        if qd not in self.vqs:
            raise KRCoreError(f"bad queue descriptor {qd}")
        return self.vqs[qd]

    def _require_qp(self, vq: VirtQueue) -> QP:
        if vq.qp is None:
            raise KRCoreError("VirtQueue not connected")
        return vq.qp

    def _check_request(self, vq: VirtQueue, req: WorkRequest) -> None:
        """Malformed-request detection (§4.4 factor 1)."""
        if req.op not in VALID_OPS:
            raise KRCoreError(f"invalid opcode {req.op!r}")
        if req.op in ATOMIC_OPS and req.nbytes != 8:
            raise KRCoreError(f"{req.op} is an 8-byte atomic")
        if req.op in ("READ", "WRITE") + ATOMIC_OPS:
            if req.local_mr is None:
                raise KRCoreError("missing local MR")
            try:
                req.local_mr.check(req.local_off, req.nbytes)
            except MRError as e:
                raise KRCoreError(f"local MR violation: {e}") from e
        elif req.op == "SEND":
            if req.local_mr is None and req.payload is None:
                raise KRCoreError("SEND without payload or local MR")
            if req.local_mr is not None:
                try:
                    req.local_mr.check(req.local_off, req.nbytes)
                except MRError as e:
                    raise KRCoreError(f"local MR violation: {e}") from e

    def _check_remote_mr(self, vq: VirtQueue, req: WorkRequest) -> Generator:
        """ValidMR / MRStore check (§4.2; Fig 12a '+4.54us' on miss).

        On an MRStore miss the remote node's ValidMR table is probed with
        one-sided READs (CPU-bypass) through the normal shared-QP path. The
        remote table's own rkey is kernel-trusted state (exchanged at module
        bring-up in a real deployment; read directly here).
        """
        if req.trusted:
            return True
        cached = self.mrstore.get(vq.remote, req.remote_rkey)
        if cached is None:
            remote_node = self.fabric.node(vq.remote)
            remote_mod: KRCoreModule = remote_node.krcore  # type: ignore
            kv = remote_mod.validmr.kv
            key = ValidMRStore._key(req.remote_rkey)
            h = fnv1a(key)
            val = None
            for probe in range(8):
                idx = (h + probe) % kv.n_slots
                yield from self._internal_read(
                    vq.remote, kv.mr.rkey, idx * SLOT, SLOT,
                    self._scratch_mr, 64)
                raw = self.node.read_bytes(self._scratch_mr.addr, 64, SLOT)
                k, v = DrTMKV.parse_slot(raw)
                if k == h:
                    val = v
                    break
                if k == 0:
                    break
            if val is None:
                return False
            addr, length, valid = ValidMRStore.parse(val)
            if not valid:
                return False
            self.mrstore.put(vq.remote, req.remote_rkey, addr, length)
            cached = (addr, length)
        addr, length = cached
        if req.remote_off < 0 or req.remote_off + req.nbytes > length:
            return False
        return True

    def _fill_routing(self, vq: VirtQueue, req: WorkRequest) -> None:
        req.dst = vq.remote
        req.dst_qpn = vq.remote_qpn
        if req.op == "SEND":
            hdr = dict(req.header or {})
            hdr.update({
                "src": self.node.name,
                "src_vq": vq.id,
                "dst_vq": vq.remote_vq,
                "dst_port": getattr(vq, "remote_port", None),
                # piggybacked DCT metadata of *this* node (§4.4)
                "dct": (self.node.id, self.dc_target.qpn, self.dct_key),
                "kind": hdr.get("kind", "DATA"),
            })
            req.header = hdr
            if req.payload is None and req.local_mr is not None:
                req.payload = self.node.read_bytes(
                    req.local_mr.addr, req.local_off, req.nbytes)

    def _to_zero_copy(self, vq: VirtQueue, req: WorkRequest) -> None:
        """Rewrite a large SEND into a small descriptor send (§4.5)."""
        req.header = dict(req.header or {})
        req.header["kind"] = "ZC_DESC"
        req.header["zc"] = (req.local_mr.rkey, req.local_off, req.nbytes)
        req.header["zc_len"] = req.nbytes
        req.payload = np.zeros(32, dtype=np.uint8)   # descriptor only
        # ensure our MR is remotely checkable
        # (already in ValidMR via qreg_mr)

    def _qpop_inner(self, vq: VirtQueue, max_n: int = 64) -> bool:
        """Algorithm 2, QPopInner: bulk-poll the physical CQ(s), dispatch.

        One poll drains up to ``max_n`` CQEs — a whole doorbell batch's
        completions retire in a single pass instead of one per call.
        """
        progressed = False
        qps = [vq.qp] + ([vq.old_qp] if vq.old_qp is not None else [])
        for qp in qps:
            if qp is None:
                continue
            for cqe in qp.poll_cq(max_n=max_n):
                progressed = True
                vq_id, comp_cnt = decode_wr_id(cqe.wr_id)
                # hardware covers == encoded comp_cnt (see qp.py) — the
                # assert is a free cross-check of the Alg.2 accounting.
                # comp_cnt == 0 marks an unsignaled WR (only its ERR CQE
                # ever reaches here); a prior ERR CQE may also have split
                # a coverage run mid-batch, so go lenient once one exists.
                assert (cqe.covers == max(comp_cnt, 1) or comp_cnt == 0
                        or cqe.status != "OK" or qp.stat_err_cqes), \
                    (cqe.covers, comp_cnt)
                if vq_id:
                    target = self.vqs.get(vq_id)
                    if target is not None:
                        ent = target.mark_ready()
                        # software covers bookkeeping must mirror hardware
                        # — except for unsignaled-WR ERR CQEs (comp_cnt 0:
                        # the marked entry is the *covering* signaled one)
                        # or after an ERR CQE has split a coverage run
                        # mid-batch (the vq.errored path handles that)
                        assert (ent is None or comp_cnt == 0
                                or cqe.status != "OK"
                                or qp.stat_err_cqes
                                or ent.covers == cqe.covers), \
                            (ent.covers, cqe.covers)
                        if cqe.status != "OK":
                            target.errored = True
                            if ent is not None:
                                ent.err = True
                if cqe.status != "OK" and qp.state == QPState.ERR:
                    self.env.process(self._recover(qp),
                                     f"{self.node.name}.recover")
        return progressed

    def _recover(self, qp: QP) -> Generator:
        """Reconfigure an errored physical QP in the background (§3.1 C#3:
        the stall KRCORE's pre-checks are designed to make impossible on
        well-formed workloads)."""
        yield from qp.reset_from_error()

    def _drain_staged(self, vq: VirtQueue) -> Generator:
        staged = self._staged.get(vq.id)
        if staged and vq.recv_queue:
            items: List[Tuple[dict, np.ndarray]] = []
            while staged and len(items) < len(vq.recv_queue):
                items.append(staged.popleft())
            yield from self._deliver_data_run(vq, items)
        staged_zc = self._staged_zc.get(vq.id)
        while staged_zc and vq.recv_queue:
            header = staged_zc.popleft()
            yield from self._zc_pull(vq, header)

    # =============================================== receive pump & dispatch
    def _recv_pump(self, qp: QP) -> Generator:
        """Batched receive pump (ROADMAP open item: batched two-sided path).

        One wake drains EVERY available recv CQE in bulk: payloads are
        copied out of the kernel slab and the slots recycled + re-posted
        BEFORE dispatch (so a SEND burst larger than the pre-posted window
        keeps landing while earlier messages are still being delivered),
        then the whole batch is dispatched with consecutive same-queue
        DATA runs merged into one delivery (single aggregated memcpy
        charge) instead of one kernel pass per message.
        """
        while True:
            yield qp.recv_notify.get()
            while len(qp.recv_notify):         # collapse burst notifies
                yield qp.recv_notify.get()
            while True:
                cqes = qp.poll_recv_cq(max_n=KERNEL_RECV_SLOTS)
                if not cqes:
                    break
                msgs: List[Tuple[dict, np.ndarray]] = []
                for cqe in cqes:
                    header = cqe.header or {}
                    payload = self.node.read_bytes(
                        self._kernel_slab_mr.addr, cqe.wr_id,
                        min(cqe.byte_len, self.cm.kernel_msg_buf_bytes))
                    msgs.append((header, payload[:cqe.byte_len]))
                    self._slab_slots.append(cqe.wr_id)
                for _ in cqes:                 # bulk slab replenish
                    self._post_kernel_recv(qp)
                yield from self._dispatch_batch(msgs)

    def _dispatch_batch(self,
                        msgs: List[Tuple[dict, np.ndarray]]) -> Generator:
        """Dispatch a drained CQE batch. Only ADJACENT messages routed to
        the same VirtQueue are merged, so per-queue FIFO order — and the
        relative order of DATA vs. control messages on one queue — is
        exactly what per-message dispatch would have produced."""
        i = 0
        while i < len(msgs):
            header, payload = msgs[i]
            if header.get("kind", "DATA") != "DATA":
                yield from self._dispatch_control(header)
                i += 1
                continue
            self._learn_sender(header)
            vq = self._route_incoming(header)
            j = i + 1
            while j < len(msgs):
                h2 = msgs[j][0]
                if h2.get("kind", "DATA") != "DATA" \
                        or self._route_incoming(h2) is not vq:
                    break
                self._learn_sender(h2)
                j += 1
            if vq is not None:                 # no listener: drop the run
                staged = self._staged.get(vq.id)
                if staged:
                    # earlier messages are still kernel-staged waiting
                    # for user buffers: queue behind them (FIFO) — a new
                    # run must never overtake the staged backlog
                    staged.extend(msgs[i:j])
                else:
                    yield from self._deliver_data_run(vq, msgs[i:j])
            i = j

    def _dispatch_control(self, header: dict) -> Generator:
        kind = header.get("kind")
        if kind == "ZC_DESC":
            yield from self._on_zc_desc(header)
        elif kind == "XFER_NOTIFY":
            yield from self._on_xfer_notify(header)
        elif kind == "XFER_ACK":
            self._on_xfer_ack(header)
        # "FLUSH": transfer-protocol no-op

    def _route_incoming(self, header: dict) -> Optional[VirtQueue]:
        vq_id = header.get("dst_vq")
        if vq_id:
            return self.vqs.get(vq_id)
        port = header.get("dst_port")
        if port is not None:
            return self.ports.get(port)
        return None

    def _learn_sender(self, header: dict) -> None:
        """Cache the piggybacked DCT metadata of the sender (§4.4)."""
        dct = header.get("dct")
        src = header.get("src")
        if dct and src:
            self.dccache.put(src, DCTMeta(*dct))

    def _deliver_data_run(self, vq: VirtQueue,
                          items: List[Tuple[dict, np.ndarray]]) -> Generator:
        """Deliver a FIFO run of small DATA messages to one VirtQueue.

        Every message with a posted user buffer is copied in ONE
        aggregated kernel pass (a single memcpy charge over the run's
        total bytes — the batched analogue of the §4.5 baseline path);
        messages beyond the posted buffers are kernel-staged until
        qpush_recv supplies more.
        """
        n_buf = len(vq.recv_queue)
        now, later = items[:n_buf], items[n_buf:]
        if now:
            run = []
            total = 0
            for header, payload in now:
                ent = vq.recv_queue.popleft()
                n = min(len(payload), ent.length)
                total += n
                run.append((ent, header, payload, n))
            yield self.env.timeout(self.cm.memcpy_us(total))
            for ent, header, payload, n in run:
                self.node.write_bytes(ent.mr.addr, ent.offset, payload[:n])
                vq.msg_queue.append(PolledMsg(
                    reply_qd=self._make_reply_qd(header, vq),
                    wr_id=ent.wr_id, byte_len=n,
                    src=header.get("src", "?"),
                    src_vq=header.get("src_vq", 0), hdr=dict(header)))
            if vq.msg_notify is not None:
                vq.msg_notify.put(len(run))
        for header, payload in later:
            self._staged.setdefault(vq.id, deque()).append((header, payload))

    def _on_zc_desc(self, header: dict) -> Generator:
        self._learn_sender(header)
        vq = self._route_incoming(header)
        if vq is None:
            return
        if vq.recv_queue:
            yield from self._zc_pull(vq, header)
        else:
            self._staged_zc.setdefault(vq.id, deque()).append(header)

    def _zc_pull(self, vq: VirtQueue, header: dict) -> Generator:
        """Zero-copy: one-sided READ straight into the user buffer (§4.5)."""
        rkey, off, nbytes = header["zc"]
        src = header["src"]
        ent = vq.recv_queue.popleft()
        n = min(nbytes, ent.length)
        pool = self.pools[vq.owner_cpu % len(self.pools)]
        kind, qp = pool.select(src)
        wr = WorkRequest(op="READ", wr_id=encode_wr_id(0, 1), signaled=True,
                         local_mr=ent.mr, local_off=ent.offset,
                         remote_rkey=rkey, remote_off=off, nbytes=n,
                         dst=src, dst_qpn=None)
        qp.post_send([wr])
        while not qp.poll_cq():
            yield self.env.timeout(0.1)
        self.stat_zc_reads += 1
        vq.msg_queue.append(PolledMsg(
            reply_qd=self._make_reply_qd(header, vq),
            wr_id=ent.wr_id, byte_len=n,
            src=src, src_vq=header.get("src_vq", 0), hdr=dict(header)))
        if vq.msg_notify is not None:
            vq.msg_notify.put(1)

    def _make_reply_qd(self, header: dict, listener: VirtQueue) -> int:
        """accept semantics: a VirtQueue connected back to the sender, built
        from piggybacked metadata — zero network ops (§4.4). Cached per
        (sender, sender-vq, listener) so a batched SEND stream reuses ONE
        reply queue instead of minting one per message."""
        src = header.get("src")
        src_vq = header.get("src_vq", 0)
        key = (src, src_vq, listener.id)
        cached = self._reply_qds.get(key)
        if cached is not None and cached in self.vqs:
            rvq = self.vqs[cached]
            if rvq.kind == "DC":
                # _learn_sender just refreshed the DCCache from this
                # message's piggybacked metadata — don't serve a stale
                # snapshot if the sender reconnected with a new DCT
                meta = self.dccache.get(src)
                if meta is not None:
                    rvq.dct_meta, rvq.remote_qpn = meta, meta.dct_num
            return cached
        vq = VirtQueue(owner_cpu=listener.owner_cpu)
        self.vqs[vq.id] = vq
        pool = self.pools[vq.owner_cpu % len(self.pools)]
        kind, qp = pool.select(src)
        vq.qp, vq.kind, vq.remote = qp, kind, src
        vq.remote_vq = src_vq
        if kind == "RC":
            vq.remote_qpn = qp.peer[1]
        else:
            meta = self.dccache.get(src)
            vq.dct_meta = meta
            vq.remote_qpn = meta.dct_num if meta else None
        self._reply_qds[key] = vq.id
        return vq.id

    # ======================================================== transfer (§4.6)
    def _maybe_promote(self, pool: HybridQPPool, addr: str) -> None:
        """Background RCQP creation for hot peers — *never* blocks callers."""
        if (pool.use_counts.get(addr, 0) >= self.promote_threshold
                and not pool.has_rc(addr)
                and (pool.cpu, addr) not in self._promotions_inflight
                and addr != self.node.name):
            self._promotions_inflight.add((pool.cpu, addr))
            self.env.process(self._promote(pool, addr),
                             f"{self.node.name}.promote.{addr}")

    def _promote(self, pool: HybridQPPool, addr: str) -> Generator:
        """Create an RCQP pair to ``addr`` in the background, insert it into
        the pool, then transparently transfer DC-bound VirtQueues (§4.3)."""
        remote = self.fabric.node(addr)
        qa, qb = yield from connect_rc_pair(self.fabric, self.node, remote)
        remote_mod: KRCoreModule = remote.krcore            # type: ignore
        remote_mod._adopt_server_rc(self.node.name, qb)
        evicted = pool.insert_rc(addr, qa)
        self.stat_promotions += 1
        self._promotions_inflight.discard((pool.cpu, addr))
        # upgrade existing DC virtqueues talking to addr
        for vq in list(self.vqs.values()):
            if vq.remote == addr and vq.kind == "DC" and vq.qp is not None:
                yield from self.transfer(vq, "RC", qa)
        if evicted is not None:
            ev_addr, ev_qp = evicted
            # demote virtqueues still on the evicted RCQP back to DC
            for vq in list(self.vqs.values()):
                if vq.qp is ev_qp:
                    dc = pool.dc_qps[0]
                    meta = self.dccache.get(ev_addr)
                    if meta is None:
                        meta = yield from self._meta_lookup(ev_addr)
                        if meta is not None:
                            self.dccache.put(ev_addr, meta)
                    vq.dct_meta = meta
                    yield from self.transfer(vq, "DC", dc)

    def _adopt_server_rc(self, peer: str, qp: QP) -> None:
        """Install the passive end of a background RC pair."""
        self._watch_server_qp(qp)
        self.pools[0].insert_rc(peer, qp)

    def transfer(self, vq: VirtQueue, new_kind: str, new_qp: QP) -> Generator:
        """Physical QP transfer preserving FIFO (§4.6).

        1. Post a *fake* signaled request on the source QP and wait for its
           completion — all previously posted requests are then complete.
        2. Notify the remote kernel (control message) so its reply path
           follows; do not wait for the ack — lazy switch: keep polling the
           old QP until the ack arrives.
        """
        old_qp = vq.qp
        if old_qp is new_qp:
            return
        self.stat_transfers += 1
        # (1) FIFO flush via a fake request
        fake = WorkRequest(op="SEND", wr_id=encode_wr_id(0, 1), signaled=True,
                           payload=np.zeros(1, dtype=np.uint8),
                           header={"kind": "FLUSH"},
                           dst=vq.remote, dst_qpn=vq.remote_qpn)
        old_qp.post_send([fake])
        while not old_qp.poll_cq():
            yield self.env.timeout(0.1)
        # (2) notify remote, switch immediately, poll old lazily until ack
        vq.old_qp = old_qp
        vq.in_transfer = True
        vq.qp = new_qp
        vq.kind = new_kind
        if new_kind == "RC":
            vq.remote_qpn = new_qp.peer[1]
        else:
            vq.remote_qpn = vq.dct_meta.dct_num if vq.dct_meta else None
        notify = WorkRequest(
            op="SEND", wr_id=encode_wr_id(0, 1), signaled=True,
            payload=np.zeros(1, dtype=np.uint8),
            header={"kind": "XFER_NOTIFY", "src": self.node.name,
                    "xfer_vq": vq.remote_vq, "src_vq": vq.id,
                    "dct": (self.node.id, self.dc_target.qpn, self.dct_key)},
            dst=vq.remote, dst_qpn=vq.remote_qpn)
        new_qp.post_send([notify])
        while not new_qp.poll_cq():
            yield self.env.timeout(0.1)

    def _on_xfer_notify(self, header: dict) -> Generator:
        """Remote switched QPs for a vq pair: re-bind our reply vq and ack."""
        self._learn_sender(header)
        vq_id = header.get("xfer_vq")
        src = header.get("src")
        if vq_id and vq_id in self.vqs:
            vq = self.vqs[vq_id]
            pool = self.pools[vq.owner_cpu % len(self.pools)]
            kind, qp = pool.select(src)
            vq.qp, vq.kind = qp, kind
            if kind == "RC":
                vq.remote_qpn = qp.peer[1]
            else:
                meta = self.dccache.get(src)
                vq.remote_qpn = meta.dct_num if meta else vq.remote_qpn
        # ack so the sender can stop lazy-polling its old QP
        if src is not None:
            ack = WorkRequest(
                op="SEND", wr_id=encode_wr_id(0, 1), signaled=True,
                payload=np.zeros(1, dtype=np.uint8),
                header={"kind": "XFER_ACK", "ack_vq": header.get("src_vq")},
                dst=src, dst_qpn=None)
            pool = self.pools[0]
            kind, qp = pool.select(src)
            if kind == "DC":
                meta = self.dccache.get(src)
                ack.dst_qpn = meta.dct_num if meta else None
            else:
                ack.dst_qpn = qp.peer[1]
            qp.post_send([ack])
            while not qp.poll_cq():
                yield self.env.timeout(0.1)

    def _on_xfer_ack(self, header: dict) -> None:
        vq_id = header.get("ack_vq")
        if vq_id and vq_id in self.vqs:
            vq = self.vqs[vq_id]
            vq.old_qp = None
            vq.in_transfer = False

    # ====================================================== failure handling
    def on_node_death(self, addr: str) -> None:
        """Invalidate every cache keyed by a dead peer (§4.2 failure
        handling): its DCT metadata (DCCache), its checked remote MRs
        (MRStore), and any cached RCQP to it — so the next qconnect
        re-resolves through the (replicated) meta service instead of
        talking to a ghost. Called by failover-aware applications (e.g.
        the serverless chain runner) when an in-flight request against
        ``addr`` returns an ERR completion.
        """
        self.dccache.invalidate(addr)
        self.mrstore.invalidate_remote(addr)
        for pool in self.pools:
            pool.drop_rc(addr)
            pool.use_counts.pop(addr, None)
        ivqs = getattr(self, "_ivqs", None)
        if ivqs is not None:
            ivqs.pop(addr, None)
        # reply-qd cache entries hold the dead peer's DCT metadata frozen
        # at creation; drop them so a restarted peer gets fresh reply vqs
        for key in [k for k in self._reply_qds if k[0] == addr]:
            self.vqs.pop(self._reply_qds.pop(key), None)
        for hook in list(self._death_hooks):
            hook(addr)

    def add_death_hook(self, hook) -> None:
        """Register ``hook(addr)`` to run whenever :meth:`on_node_death`
        fires — application caches keyed by node invalidate here."""
        self._death_hooks.append(hook)

    def meta_client(self) -> Optional[KVClient]:
        """The first live pre-connected meta-server KV client (boot-time
        raw-QP session, §4.2) — the one-sided lookup path applications
        like the dkv shard directory ride for metadata resolution."""
        for client in self._meta_clients:
            if client.server.node.alive:
                return client
        return None

    # ========================================================== accounting
    def memory_bytes(self) -> int:
        """Kernel memory attributable to connection state (Fig 13a)."""
        total = sum(p.memory_bytes() for p in self.pools)
        total += self.dccache.memory_bytes()
        return total


def install(node: Node, meta_servers: List[MetaServer], **kw) -> KRCoreModule:
    """Create a module on ``node`` and expose it as ``node.krcore``."""
    mod = KRCoreModule(node, meta_servers, **kw)
    node.krcore = mod                                        # type: ignore
    return mod
