"""Session layer: typed endpoints + completion futures over the queue
syscalls (the application-facing dataplane API).

KRCORE exposes a LITE-style syscall surface (``qconnect``/``qpush``/
``qpop``) so applications get microsecond connections without touching
verbs — but every client ended up re-implementing doorbell batching,
scratch-MR management, reply routing and error recovery against
``KRCoreModule.sys_q*``. This module owns all of that once:

* :func:`connect` returns a :class:`Session` per peer with typed
  endpoints — ``session.read/write/cas`` (one-sided), ``session.send/
  recv/call`` (two-sided; ``call`` = send + awaited reply) — every op
  returning a :class:`Future` resolved by the session's completion
  reactor.
* Scratch memory is leased from a per-session :class:`BufferPool`
  (context-manager leases) instead of caller-managed ``sys_qreg_mr``
  offsets.
* An **op planner** (:mod:`repro_torch.core.plan`) collects ops posted in the
  same scheduler tick — or inside an explicit ``with session.batch():``
  scope — and lowers them through ``qpush_batch`` segmentation, so
  auto-batched code hits the exact same ``ceil(N / interval)``
  doorbell/CQE budget as the hand-rolled paths (property-tested in
  ``tests/test_session.py``).
* :func:`listen` + :class:`Listener` are the server side: a bound
  VirtQueue with a leased receive window, delivering :class:`Message`
  objects with ``accept``-semantics reply sessions.
* Completions are **event-driven**: a per-session reactor process blocks
  on completion-notify events (the per-QP :class:`~repro_torch.core.sim.
  Broadcast` poked at CQE generation, plus the vq's message notify) and
  only pops when a notify edge or a user-visible queue peek says a pop
  will be productive — a blocked single-op caller issues ZERO idle-poll
  syscalls (``Session.stat_idle_polls`` proves it; gated in
  ``benchmarks/run.py --smoke``).
* ``call`` has real RPC semantics: ``deadline_us=`` fails that call's
  Future with a typed :class:`CallTimeout` (the session stays usable and
  a late reply is dropped by call-id epoch, so a stale reply can never
  resolve a reincarnated call), ``retries=`` opt-in idempotent re-post
  through the planner, and :meth:`Future.cancel` retires planner-pending
  ops / awaiting calls.

Two transports share the machinery: the syscall transport (a VirtQueue
``qd`` on a booted module — what applications use) and a raw-QP
transport (kernel-internal sessions over a bare :class:`QP`, used by the
meta-server clients), both lowered through the same :class:`BatchPlan`.

Error scoping: a QP ERR during a planner-batched flush fails **only the
futures of the errored flush's WRs** (ERR CQEs route by vq ownership),
and the session is usable again once the module's background
``_recover`` has reconfigured the QP.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
from collections import deque
from typing import (Any, Deque, Dict, Generator, List, Optional, Sequence,
                    Set, Tuple)

import numpy as np

from .fabric import MemoryRegion, MRError
from .plan import BatchPlan, plan_batch
from .qp import QP, QPError, QPState, WorkRequest
from .sim import Broadcast, Store
from .virtqueue import READY, CompEntry, PolledMsg

__all__ = ["Session", "SessionError", "CallTimeout", "Cancelled", "Future",
           "BufferPool", "Lease", "Listener", "Message", "connect",
           "listen"]

_LOG = logging.getLogger(__name__)

_ERROR_TYPES: Optional[tuple] = None


def _error_types() -> tuple:
    """(QPError, MRError, KRCoreError, SessionError) — KRCoreError is
    imported lazily to avoid the module->meta->session import cycle."""
    global _ERROR_TYPES
    if _ERROR_TYPES is None:
        from .module import KRCoreError
        _ERROR_TYPES = (QPError, MRError, KRCoreError, SessionError)
    return _ERROR_TYPES


class SessionError(Exception):
    """A session op failed (validation reject, QP error, pool exhausted)."""


class CallTimeout(SessionError):
    """``session.call(..., deadline_us=)`` missed its deadline.

    Scope: ONLY the timed-out call's Future fails; the session stays
    usable, its recv window stays posted, and the call-id epoch is
    retired so a late reply is dropped instead of resolving anything.
    """


class Cancelled(SessionError):
    """:meth:`Future.cancel` won the race against completion."""


def _as_u8(data) -> np.ndarray:
    """Coerce payload-like input (bytes / bytearray / array) to uint8."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(data), np.uint8).copy()
    return np.asarray(data, np.uint8)


# ======================================================================
# Futures
# ======================================================================
class Future:
    """Handle for one in-flight session op.

    Resolved by the session's completion reactor when the covering
    CompEntry (or, for ``call``, the reply message) arrives. ``wait()``
    flushes the op if it is still planner-pending, then parks on the
    future's own wake event until the reactor (or a deadline watchdog,
    or ``cancel``) transitions it; it returns the op's value, raising
    the recorded error class (:class:`SessionError` / :class:`CallTimeout`
    / :class:`Cancelled`) on failure.

    Transitions are **first-writer-wins**: once resolved or failed, a
    late second transition (e.g. an ERR CQE for an op whose deadline
    already fired, or a reply racing a cancel) is dropped, counted on
    ``session.stat_double_transitions``, and logged — it can never
    overwrite the recorded outcome.
    """

    __slots__ = ("_session", "_done", "_value", "_error", "_error_kind",
                 "_waiters", "_op")

    def __init__(self, session: "Session"):
        self._session = session
        self._done = False
        self._value: Any = None
        self._error: Optional[str] = None
        self._error_kind = SessionError
        self._waiters: List = []
        self._op: Optional["_Op"] = None       # backref for cancel()

    @property
    def done(self) -> bool:
        return self._done

    @property
    def value(self) -> Any:
        return self._value

    @property
    def error(self) -> Optional[str]:
        return self._error

    @property
    def cancelled(self) -> bool:
        return self._done and self._error_kind is Cancelled

    def _wake(self) -> None:
        waiters, self._waiters = self._waiters, []
        for ev in waiters:
            if not ev.triggered:
                ev.succeed()

    def _subscribe(self):
        """An event that fires when this future transitions (already
        triggered if it is done)."""
        ev = self._session.env.event()
        if self._done:
            ev.succeed()
        else:
            self._waiters.append(ev)
        return ev

    def _log_double(self, what: str) -> None:
        sess = self._session
        if sess is not None:
            sess.stat_double_transitions += 1
        prior = "resolved" if self._error is None \
            else f"failed ({self._error_kind.__name__}: {self._error})"
        _LOG.warning("Future double-transition: late %s dropped, already "
                     "%s (first-writer-wins)", what, prior)

    def _resolve(self, value: Any) -> bool:
        if self._done:
            self._log_double("resolve")
            return False
        self._done, self._value = True, value
        self._wake()
        return True

    def _fail(self, reason: str, kind=None) -> bool:
        if self._done:
            self._log_double(f"fail ({reason})")
            return False
        self._done, self._error = True, reason
        self._error_kind = kind or SessionError
        self._wake()
        return True

    def cancel(self) -> bool:
        """Cancel the op if it has not taken effect yet. Returns True
        when this future transitions to :class:`Cancelled`:

        * a planner-pending op (posted this tick / inside ``batch()``,
          not yet flushed) is removed before anything reaches the wire;
        * an awaited ``call`` is deregistered — its call-id epoch is
          retired, so a reply arriving later is dropped as stale.

        A one-sided op already in flight (or a done future) cannot be
        cancelled: returns False and the future resolves normally.
        """
        return self._session._cancel(self)

    def wait(self) -> Generator:
        """yield sim events until resolved; returns the op's value."""
        yield from self._session._await(self)
        if self._error is not None:
            raise self._error_kind(self._error)
        return self._value


# ======================================================================
# BufferPool: leased scratch MRs
# ======================================================================
class Lease:
    """A leased scratch range inside a pool-owned MR. Context manager:
    ``with (yield from pool.lease(n)) as lease: ...`` releases on exit."""

    __slots__ = ("pool", "mr", "off", "nbytes", "released")

    def __init__(self, pool: "BufferPool", mr: MemoryRegion, off: int,
                 nbytes: int):
        self.pool, self.mr, self.off, self.nbytes = pool, mr, off, nbytes
        self.released = False

    def read(self, nbytes: Optional[int] = None) -> np.ndarray:
        n = self.nbytes if nbytes is None else min(nbytes, self.nbytes)
        return self.mr.node.read_bytes(self.mr.addr, self.off, n)

    def write(self, data) -> None:
        arr = _as_u8(data)
        if len(arr) > self.nbytes:
            raise SessionError(f"write of {len(arr)}B into {self.nbytes}B "
                               f"lease")
        self.mr.node.write_bytes(self.mr.addr, self.off, arr)

    def release(self) -> None:
        if not self.released:
            self.released = True
            self.pool._release(self)

    def __enter__(self) -> "Lease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class BufferPool:
    """Per-session scratch allocator over registered memory.

    Backed either by a booted module (``sys_qreg_mr`` growth, charged at
    Table-2 scale), a bare node (kernel-internal, uncharged — used by the
    raw-QP meta clients), or a fixed caller-provided MR region (no
    growth: lease beyond capacity raises).
    """

    ALIGN = 64

    def __init__(self, module=None, node=None, mr: Optional[MemoryRegion]
                 = None, base_off: int = 0, grow_bytes: int = 64 * 1024,
                 align: Optional[int] = None):
        self._module = module
        self._node = node
        self.grow_bytes = grow_bytes
        self.align = align or BufferPool.ALIGN
        #: free extents: list of [mr, off, nbytes]
        self._free: List[List] = []
        self._mrs: List[MemoryRegion] = []
        self.bytes_total = 0
        if mr is not None:
            self._mrs.append(mr)
            span = mr.length - base_off
            if span > 0:
                self._free.append([mr, base_off, span])
                self.bytes_total += span

    def _align(self, n: int) -> int:
        a = self.align
        return max(((max(n, 1) + a - 1) // a) * a, a)

    @property
    def bytes_free(self) -> int:
        return sum(e[2] for e in self._free)

    def capacity(self, nbytes: int) -> int:
        """How many ``nbytes`` leases the CURRENT extents could hold
        (growth not counted — what a fixed pool can pipeline)."""
        a = self._align(nbytes)
        return sum(e[2] // a for e in self._free)

    def lease(self, nbytes: int) -> Generator:
        """Lease ``nbytes`` of registered scratch (first-fit; grows the
        pool when backed by a module or node). yields sim events."""
        a = self._align(nbytes)
        ext = self._find(a)
        if ext is None:
            yield from self._grow(a)
            ext = self._find(a)
            if ext is None:
                raise SessionError("buffer pool exhausted")
        mr, off, span = ext
        if span == a:
            self._free.remove(ext)
        else:
            ext[1], ext[2] = off + a, span - a
        return Lease(self, mr, off, a)

    def _find(self, a: int) -> Optional[List]:
        for ext in self._free:
            if ext[2] >= a:
                return ext
        return None

    def _grow(self, a: int) -> Generator:
        n = max(self.grow_bytes, a)
        if self._module is not None:
            mr = yield from self._module.sys_qreg_mr(n)
        elif self._node is not None:
            # kernel-internal pool: registration shares the driver
            # context and is not on any application critical path
            mr = self._node.reg_mr(self._node.alloc(n), n)
        else:
            raise SessionError(
                f"fixed buffer pool exhausted (need {a}B, "
                f"free {self.bytes_free}B)")
        self._mrs.append(mr)
        self._free.append([mr, 0, mr.length])
        self.bytes_total += mr.length
        return mr

    def _release(self, lease: Lease) -> None:
        self._free.append([lease.mr, lease.off, lease.nbytes])
        self._coalesce()

    def _coalesce(self) -> None:
        self._free.sort(key=lambda e: (id(e[0]), e[1]))
        out: List[List] = []
        for ext in self._free:
            if out and out[-1][0] is ext[0] \
                    and out[-1][1] + out[-1][2] == ext[1]:
                out[-1][2] += ext[2]
            else:
                out.append(ext)
        self._free = out


# ======================================================================
# Transports
# ======================================================================
class _VqTransport:
    """Syscall transport: a connected VirtQueue qd on a booted module."""

    two_sided = True

    def __init__(self, module, qd: int):
        self.module = module
        self.qd = qd

    @property
    def env(self):
        return self.module.env

    @property
    def vq(self):
        return self.module.vqs.get(self.qd)

    @property
    def qp(self) -> Optional[QP]:
        vq = self.vq
        return vq.qp if vq is not None else None

    @property
    def cm(self):
        return self.module.cm

    def fill_dst(self, wr: WorkRequest) -> None:
        pass                                   # module fills routing itself

    def entries_queued(self) -> int:
        vq = self.vq
        return vq.stat_entries_queued if vq is not None else 0

    def has_entries(self) -> bool:
        """Free (no-syscall) peek: would an entry pop be productive?
        The vq comp queue and the hardware CQ buffer are both mapped
        user-readable (LITE shared queues / verbs CQ buffers), so this is
        a load, not a crossing."""
        vq = self.vq
        if vq is None:
            return False
        if vq.ready_head():
            return True
        qp = vq.qp
        if qp is not None and qp.cq:
            return True
        return vq.old_qp is not None and bool(vq.old_qp.cq)

    def has_msgs(self) -> bool:
        vq = self.vq
        return vq is not None and bool(vq.msg_queue)

    def push(self, wrs: List[WorkRequest],
             signal_interval: Optional[int]) -> Generator:
        n = yield from self.module.qpush_batch(
            self.qd, wrs, signal_interval=signal_interval)
        if n < 0:
            raise SessionError("qpush_batch rejected the batch "
                               "(validation failed)")
        return n

    def pop(self, max_n: int = 64) -> Generator:
        return (yield from self.module.qpop_batch(self.qd, max_n=max_n))

    def pop_wait(self, max_n: int = 64) -> Generator:
        """Blocking pop: parks in-kernel on the CQE edge (one crossing,
        paid at entry — see :meth:`KRCoreModule.qpop_wait`)."""
        return (yield from self.module.qpop_wait(self.qd, max_n=max_n))

    def push_recv(self, mr: MemoryRegion, off: int, length: int,
                  wr_id: int) -> Generator:
        yield from self.module.sys_qpush_recv(self.qd, mr, off, length,
                                              wr_id)

    def pop_msgs(self, max_n: Optional[int] = None) -> Generator:
        return (yield from self.module.sys_qpop_msgs(self.qd, max_n=max_n))


class _RawQPTransport:
    """Kernel-internal transport over a bare QP (no syscall crossings).

    Lowers batches through the SAME :class:`BatchPlan` as the syscall
    path — one ``post_send`` per planned segment, selective signaling,
    clear-space polling — so raw sessions obey the identical doorbell /
    CQE budget. Used by the meta-server clients (module boot path).
    """

    two_sided = False

    def __init__(self, qp: QP, dst: Optional[str] = None):
        self.qp = qp
        self.dst = dst
        self._cqes: Deque[CompEntry] = deque()
        self._entries_posted = 0

    @property
    def env(self):
        return self.qp.env

    @property
    def vq(self):
        return None

    @property
    def cm(self):
        return self.qp.node.cm

    def fill_dst(self, wr: WorkRequest) -> None:
        if wr.dst is None:
            wr.dst = self.dst

    def entries_queued(self) -> int:
        return self._entries_posted

    def has_entries(self) -> bool:
        return bool(self._cqes) or bool(self.qp.cq)

    def has_msgs(self) -> bool:
        return False

    def _drain_cq(self) -> bool:
        got = self.qp.poll_cq(max_n=64)
        for c in got:
            self._cqes.append(CompEntry(READY, c.wr_id,
                                        err=(c.status != "OK"),
                                        covers=c.covers))
        return bool(got)

    def push(self, wrs: List[WorkRequest],
             signal_interval: Optional[int]) -> Generator:
        qp = self.qp
        plan = plan_batch(len(wrs), qp.sq_depth, qp.cq_depth,
                          signal_interval)
        plan.apply(wrs)
        i = 0
        for seg in plan.segments:
            seg_wrs = wrs[i:i + seg]
            i += seg
            # clear space (mirror of KRCoreModule._post_segments,
            # including the owed-CQE reservation against cascades)
            while qp.sq_depth - qp.sq_occupancy < len(seg_wrs):
                if not self._drain_cq():
                    yield self.env.timeout(0.2)
            while (len(qp.cq) + qp.cq_outstanding
                   > qp.cq_depth - len(seg_wrs) - 1):
                if not self._drain_cq():
                    yield self.env.timeout(0.2)
            qp.post_send(seg_wrs)
            self._entries_posted += sum(1 for w in seg_wrs if w.signaled)
        return plan.n_cqes

    def pop(self, max_n: int = 64) -> Generator:
        self._drain_cq()
        out: List[CompEntry] = []
        while self._cqes and len(out) < max_n:
            out.append(self._cqes.popleft())
        return out
        yield                                  # generator marker (unreached)

    def pop_wait(self, max_n: int = 64) -> Generator:
        """Blocking pop over the bare QP: kernel-internal, so no syscall
        charge — just park on the CQE edge and drain."""
        while True:
            self._drain_cq()
            out: List[CompEntry] = []
            while self._cqes and len(out) < max_n:
                out.append(self._cqes.popleft())
            if out or self.qp.state == QPState.ERR:
                return out
            ev = self.env.event()
            self.qp.comp_notify.subscribe(ev)
            if self.qp.cq:
                continue                       # CQE raced the arm
            yield ev

    def push_recv(self, *a, **kw) -> Generator:
        raise SessionError("raw-QP session has no two-sided path")
        yield                                  # generator marker (unreached)

    def pop_msgs(self, *a, **kw) -> Generator:
        raise SessionError("raw-QP session has no two-sided path")
        yield                                  # generator marker (unreached)


# ======================================================================
# Ops
# ======================================================================
@dataclasses.dataclass
class _Op:
    kind: str                           # read | write | cas | faa | send
    future: Future
    nbytes: int = 0
    remote_rkey: int = 0
    remote_off: int = 0
    data: Optional[np.ndarray] = None
    into: Optional[Tuple[MemoryRegion, int]] = None
    src: Optional[Tuple[MemoryRegion, int, int]] = None
    compare: int = 0
    swap: int = 0
    add: int = 0
    meta: Optional[dict] = None
    call_id: Optional[int] = None
    lease: Optional[Lease] = None
    hold_lease: bool = False
    deadline_us: Optional[float] = None
    retries: int = 0
    #: True for the implicit lost-reply stall guard on deadline-less
    #: calls: fails with plain SessionError (not CallTimeout) at the
    #: legacy spin_limit * poll_us bound, so a swallowed reply stays a
    #: LOUD failure instead of a silent forever-park
    stall_guard: bool = False


@dataclasses.dataclass
class Message:
    """One received two-sided message (accept semantics: ``reply`` goes
    back over a kernel-built VirtQueue, zero network ops)."""
    payload: np.ndarray
    src: str
    src_vq: int
    hdr: dict
    reply_qd: int
    _owner: Optional["Listener"] = None

    def reply(self, data, meta: Optional[dict] = None) -> Generator:
        """Send ``data`` back to the sender and wait for the send to
        complete. Correlates with the sender's ``call`` automatically."""
        if self._owner is None:
            raise SessionError("message has no owning listener")
        sess = self._owner.reply_session(self.reply_qd)
        m = dict(meta or {})
        if "call_id" in self.hdr:
            m["reply_to"] = self.hdr["call_id"]
        if "sess_epoch" in self.hdr:
            # epoch handshake: echo the REQUEST's incarnation epoch so
            # the caller can drop replies meant for a previous life
            m["reply_epoch"] = self.hdr["sess_epoch"]
        fut = sess.send(data, meta=m)
        return (yield from fut.wait())


class _RecvWindow:
    """Posted receive window over pool leases — the one implementation of
    the lease/post/copy-then-recycle dance that both Session (call/recv
    replies) and Listener (server side) ride. Invariant owned here: a
    slot's payload is copied out BEFORE the slot is re-posted."""

    def __init__(self, pool: BufferPool, msg_bytes: int, window: int):
        self.pool = pool
        self.msg_bytes = msg_bytes
        self.window = window
        self.slots: Dict[int, Lease] = {}
        self.closed = False
        self._next_id = itertools.count(1)
        #: slots posted at a pre-resize (smaller) size, awaiting lazy
        #: retirement: a posted recv is hardware-owned and cannot be
        #: recalled, so each drains in place and is REPLACED (released +
        #: re-leased at the new size) instead of re-posted — resize
        #: defers to the recv drain rather than stranding posted slots
        self._retire: Set[int] = set()
        self.stat_retired = 0

    def resize(self, window: int, msg_bytes: int) -> None:
        """Widen targets (never shrinks; new slots use the new size).

        Growing ``msg_bytes`` while recvs are in flight cannot touch the
        already-posted smaller slots — the NIC owns them. They are marked
        for retirement instead: when such a slot's recv completes it is
        released (not recycled) and ``ensure`` immediately posts a
        replacement at the new size, so the window converges to the new
        geometry without ever abandoning a posted slot.
        """
        self.window = max(self.window, window)
        new_mb = max(self.msg_bytes, msg_bytes)
        if new_mb != self.msg_bytes:
            self.msg_bytes = new_mb
            want = self.pool._align(new_mb)
            for wr_id, lease in self.slots.items():
                if lease.nbytes < want:
                    self._retire.add(wr_id)

    def ensure(self, push_recv) -> Generator:
        """Post leases until ``window`` slots stand; ``push_recv(mr, off,
        length, wr_id)`` is the transport's recv-post generator.

        The ``closed`` re-checks matter: an ensure generator in flight
        when the owning session closes (the reactor posts its window
        concurrently with a flush) must NOT resurrect the drained window
        — it would repost slots from a released pool under a successor
        session's live window on the same qd (crash-restart aliasing)."""
        while not self.closed and len(self.slots) < self.window:
            lease = yield from self.pool.lease(self.msg_bytes)
            if self.closed:
                lease.release()
                return
            wr_id = next(self._next_id)
            self.slots[wr_id] = lease
            yield from push_recv(lease.mr, lease.off, lease.nbytes, wr_id)

    def take_payload(self, wr_id: int, byte_len: int) -> np.ndarray:
        lease = self.slots.get(wr_id)
        if lease is None:
            return np.zeros(0, np.uint8)
        return lease.read(byte_len)

    def recycle(self, wr_id: int, push_recv) -> Generator:
        lease = self.slots.get(wr_id)
        if lease is None:
            return
        if wr_id in self._retire:
            # deferred resize: the drained slot retires here; its
            # replacement (new size) posts via ensure
            self._retire.discard(wr_id)
            del self.slots[wr_id]
            lease.release()
            self.stat_retired += 1
            yield from self.ensure(push_recv)
            return
        yield from push_recv(lease.mr, lease.off, lease.nbytes, wr_id)

    def close(self) -> None:
        self.closed = True
        for lease in self.slots.values():
            lease.release()
        self.slots.clear()
        self._retire.clear()


class _NotifyFwd:
    """Store-compatible shim installed as ``vq.msg_notify``: the module
    calls ``.put(n)`` when messages land on the queue; a session forwards
    that edge into its own :class:`Broadcast` hub so the reactor wakes."""

    __slots__ = ("hub",)

    def __init__(self, hub: Broadcast):
        self.hub = hub

    def put(self, n: int) -> None:
        self.hub.poke()


class _BatchScope:
    """``with session.batch():`` — ops inside lower as ONE flush."""

    def __init__(self, session: "Session"):
        self._s = session

    def __enter__(self) -> "_BatchScope":
        self._s._batch_depth += 1
        return self

    def __exit__(self, *exc) -> None:
        self._s._batch_depth -= 1
        if self._s._batch_depth == 0 and self._s._pending:
            self._s._arm_tick()


# ======================================================================
# Session
# ======================================================================
class Session:
    """Typed dataplane endpoint to one peer.

    One-sided: ``read`` / ``write`` / ``cas``. Two-sided: ``send`` /
    ``recv`` / ``call``. All return :class:`Future`; ops posted in the
    same scheduler tick (or inside ``with session.batch():``) are lowered
    as one planned ``qpush_batch``.
    """

    _ids = itertools.count(1)
    _call_ids = itertools.count(1)
    #: incarnation epochs: every Session draws a fresh one, carried in
    #: every SEND header (``sess_epoch``) and echoed back by the peer on
    #: replies (``reply_epoch``) — the listener-side epoch handshake of
    #: the paper's lease story. A crash-restarted client that reuses a
    #: session id (same qd / same call-id space) gets a HIGHER epoch, so
    #: replies addressed to the previous incarnation are dropped instead
    #: of resolving the reincarnated call, and the listener stops serving
    #: the dead incarnation's late requests.
    _epochs = itertools.count(1)

    def __init__(self, transport, pool: BufferPool,
                 signal_interval: Optional[int] = None,
                 poll_us: float = 0.2, spin_limit: int = 200_000,
                 epoch: Optional[int] = None):
        self.id = next(Session._ids)
        self.epoch = next(Session._epochs) if epoch is None else epoch
        self._t = transport
        self.pool = pool
        self.env = transport.env
        self.signal_interval = signal_interval
        #: DEPRECATED: the reactor is notify-driven and never poll-ticks;
        #: kept for source compatibility with pre-notify callers
        self.poll_us = poll_us
        #: bound on the ERR-state recovery wait (NOT an idle-poll budget:
        #: the hot path never spins)
        self.spin_limit = spin_limit
        self._pending: List[_Op] = []
        self._groups: Deque[List[_Op]] = deque()
        self._batch_depth = 0
        self._tick_armed = False
        self._flush_busy = False
        self._errored = False
        self._held: List[Lease] = []          # zero-copy send leases
        # two-sided state
        self._calls: Dict[int, Future] = {}
        self._recv_waiters: Deque[Future] = deque()
        self._msg_backlog: Deque[Message] = deque()
        self._window: Optional[_RecvWindow] = None
        self.closed = False
        # completion-notify reactor state
        self._notify = Broadcast(self.env)    # message / local wake edges
        self._seen_pokes: Dict[Broadcast, int] = {}
        self._reactor_running = False
        self._err_spins = 0
        vq = self._t.vq
        if vq is not None and self._t.two_sided:
            vq.msg_notify = _NotifyFwd(self._notify)
        for hub in self._hubs():              # prime "seen" so pre-session
            self._seen_pokes[hub] = hub.stat_pokes   # history isn't "new"
        # stats
        self.stat_ops = 0
        self.stat_flushes = 0
        self.stat_batched_ops = 0
        #: reactor wake-ups that popped NOTHING (the idle-poll syscall
        #: charge the notify-driven design exists to eliminate; gated == 0
        #: for a single blocked call in benchmarks/run.py --smoke)
        self.stat_idle_polls = 0
        self.stat_notify_blocks = 0           # event-driven parks
        self.stat_stale_replies = 0           # epoch-dropped late replies
        self.stat_double_transitions = 0      # first-writer-wins drops
        self.stat_timeouts = 0                # CallTimeout-failed calls
        self.stat_retries = 0                 # idempotent call re-posts
        self.stat_cancelled = 0               # Future.cancel wins

    # ------------------------------------------------------- introspection
    @property
    def qd(self) -> Optional[int]:
        return getattr(self._t, "qd", None)

    @property
    def qp(self) -> Optional[QP]:
        return self._t.qp

    @property
    def module(self):
        return getattr(self._t, "module", None)

    @property
    def remote(self) -> Optional[str]:
        vq = self._t.vq
        if vq is not None:
            return vq.remote
        return getattr(self._t, "dst", None)

    # ------------------------------------------------------ typed endpoints
    def read(self, remote_rkey: int, remote_off: int, nbytes: int,
             into: Optional[Tuple[MemoryRegion, int]] = None) -> Future:
        """One-sided READ. Future value: the bytes read (ndarray) when
        scratch is pool-leased, or the CompEntry when ``into`` is given."""
        return self._post(_Op("read", Future(self), nbytes=nbytes,
                              remote_rkey=remote_rkey,
                              remote_off=remote_off, into=into))

    def write(self, remote_rkey: int, remote_off: int, data=None,
              src: Optional[Tuple[MemoryRegion, int, int]] = None) -> Future:
        """One-sided WRITE of ``data`` bytes (pool-leased staging) or of
        an explicit ``src=(mr, off, nbytes)`` range."""
        if (data is None) == (src is None):
            raise SessionError("write needs exactly one of data/src")
        arr = None if data is None else _as_u8(data)
        nbytes = len(arr) if arr is not None else src[2]
        return self._post(_Op("write", Future(self), nbytes=nbytes,
                              remote_rkey=remote_rkey,
                              remote_off=remote_off, data=arr, src=src))

    def cas(self, remote_rkey: int, remote_off: int, compare: int,
            swap: int) -> Future:
        """One-sided 8-byte compare-and-swap. Future value: the previous
        remote u64 (the swap happened iff value == compare)."""
        return self._post(_Op("cas", Future(self), nbytes=8,
                              remote_rkey=remote_rkey,
                              remote_off=remote_off,
                              compare=int(compare), swap=int(swap)))

    def faa(self, remote_rkey: int, remote_off: int, add: int) -> Future:
        """One-sided 8-byte fetch-and-add — CAS's wait-free sibling.
        Future value: the previous remote u64; the remote word becomes
        ``old + add`` (mod 2^64) atomically at the destination NIC, so a
        shared counter/ticket needs ONE op where a CAS loop needs a READ
        plus at least one (contended: many) CAS round trips."""
        return self._post(_Op("faa", Future(self), nbytes=8,
                              remote_rkey=remote_rkey,
                              remote_off=remote_off, add=int(add)))

    def send(self, data, meta: Optional[dict] = None) -> Future:
        """Two-sided SEND. Future value: the send CompEntry. Payloads
        above the kernel message size take the §4.5 zero-copy path; their
        staging lease is held until the session's next flush."""
        arr = _as_u8(data)
        return self._post(_Op("send", Future(self), nbytes=len(arr),
                              data=arr, meta=meta))

    def call(self, data, meta: Optional[dict] = None,
             deadline_us: Optional[float] = None,
             retries: int = 0) -> Future:
        """send + awaited reply. Future value: the reply
        :class:`Message` (``.payload`` bytes + ``.hdr`` metadata).
        Correlated via header ``call_id`` (FIFO-independent).

        ``deadline_us``: fail THIS call's Future with :class:`CallTimeout`
        once the deadline elapses without a reply. The session stays
        usable, scratch/window accounting is untouched, and the call-id
        epoch is retired — a reply arriving after the deadline is dropped
        (``stat_stale_replies``) instead of resolving a reincarnated call
        or leaking into ``recv()``.

        ``retries``: opt-in for **idempotent** requests — each elapsed
        deadline re-posts the request through the planner under a fresh
        call-id (same Future) up to ``retries`` times before the final
        :class:`CallTimeout`. Requires ``deadline_us``.
        """
        if retries and deadline_us is None:
            raise SessionError("call(retries=...) requires a deadline_us")
        if deadline_us is not None and deadline_us <= 0:
            raise SessionError(f"bad deadline_us {deadline_us}")
        cid = next(Session._call_ids)
        fut = Future(self)
        arr = _as_u8(data)
        # no explicit deadline: keep the lost-reply failure LOUD at the
        # legacy stall bound (spin_limit polls of poll_us each) — an
        # event-driven watchdog now, not 200k wasted syscalls
        stall_guard = deadline_us is None
        guard_us = deadline_us if deadline_us is not None \
            else self.spin_limit * self.poll_us
        op = _Op("send", fut, nbytes=len(arr), data=arr,
                 meta=None if meta is None else dict(meta), call_id=cid,
                 deadline_us=guard_us, retries=int(retries),
                 stall_guard=stall_guard)
        self._calls[cid] = fut
        self.env.process(self._deadline_watch(op, cid),
                         f"sess{self.id}.deadline{cid}")
        return self._post(op)

    def recv(self) -> Future:
        """Receive one message on this session's queue. Future value: a
        :class:`Message`."""
        fut = Future(self)
        if self.closed:
            fut._fail("session closed")
        elif self._msg_backlog:
            fut._resolve(self._msg_backlog.popleft())
        else:
            self._recv_waiters.append(fut)
            self._ensure_reactor()
        return fut

    def batch(self) -> _BatchScope:
        """Explicit batching scope: every op posted inside lowers as one
        planned flush (one ``qpush_batch``)."""
        return _BatchScope(self)

    def wait_all(self, futs: Sequence[Future]) -> Generator:
        """Wait every future; returns their values in order. Raises
        SessionError if any failed."""
        out = []
        for f in futs:
            out.append((yield from f.wait()))
        return out

    def flush(self) -> Generator:
        """Explicitly lower all pending ops now (normally the tick / wait
        does this for you)."""
        yield from self._flush()

    def close(self) -> None:
        self.closed = True
        # fail (and reclaim) everything still pending: planner-queued ops
        # release nothing (not yet lowered), awaiting calls retire their
        # epochs, parked recv waiters fail — no Future is left dangling
        pending, self._pending = self._pending, []
        self._fail_ops(pending, "session closed")
        # in-flight groups: their CQEs will never be popped (the reactor
        # dies with the session), so their futures fail here rather than
        # strand any late waiter. Their scratch leases are deliberately
        # LEAKED, not released: the NIC still owns those landing buffers
        # (a READ completing after close would DMA into them), and the
        # pool may be shared with live sessions — re-leasing bytes
        # mid-DMA would corrupt whoever gets them next.
        while self._groups:
            for op in self._groups.popleft():
                op.lease = None
                self._fail_op(op, "session closed")
        for cid in list(self._calls):
            self._calls.pop(cid)._fail("session closed")
        while self._recv_waiters:
            self._recv_waiters.popleft()._fail("session closed")
        if self._window is not None:
            # unpost this window's still-queued recv slots BEFORE the
            # leases release: a message delivered after close would land
            # in freed pool bytes, and a successor session on the same qd
            # (crash-restart) would alias its window wr_ids against the
            # dead incarnation's stale entries
            vq = self._t.vq
            if vq is not None:
                mine = {(id(l.mr), l.off)
                        for l in self._window.slots.values()}
                vq.recv_queue = deque(
                    e for e in vq.recv_queue
                    if (id(e.mr), e.offset) not in mine)
            self._window.close()
            self._window = None
        for lease in self._held:
            lease.release()
        self._held.clear()
        vq = self._t.vq
        if vq is not None and isinstance(vq.msg_notify, _NotifyFwd):
            vq.msg_notify = None

    # ------------------------------------------------------------- plumbing
    def _post(self, op: _Op) -> Future:
        op.future._op = op
        if self.closed:
            self._fail_op(op, "session closed")
            return op.future
        self.stat_ops += 1
        self._pending.append(op)
        if self._batch_depth == 0:
            self._arm_tick()
        return op.future

    def _drop_pending(self, op: _Op) -> bool:
        """Remove a planner-queued op before it is flushed."""
        try:
            self._pending.remove(op)
            return True
        except ValueError:
            return False

    def _cancel(self, fut: Future) -> bool:
        if fut._done:
            return False
        op = fut._op
        if op is None:
            return False
        removed = self._drop_pending(op)
        cid = op.call_id
        awaiting_reply = cid is not None and self._calls.get(cid) is fut
        if not removed and not awaiting_reply:
            return False          # one-sided op already on the wire
        if awaiting_reply:
            self._calls.pop(cid, None)
        if removed and op.lease is not None:     # defensive: pre-lower ops
            op.lease.release()                   # hold no lease normally
            op.lease = None
        self.stat_cancelled += 1
        fut._fail("cancelled", kind=Cancelled)
        return True

    def _deadline_watch(self, op: _Op, cid: int) -> Generator:
        """Deadline watchdog for one call epoch: fires exactly at the
        deadline; a reply that beat it wins for free (first check)."""
        yield self.env.timeout(op.deadline_us)
        fut = op.future
        if fut._done or self._calls.get(cid) is not fut:
            if self._calls.get(cid) is fut:
                # future settled elsewhere (e.g. send-side failure raced a
                # live retry epoch): still retire the registration
                self._calls.pop(cid, None)
            return                # resolved / cancelled / superseded in time
        # retire the epoch FIRST (popping cid from _calls IS the epoch
        # mechanism: _on_msg drops any reply whose cid is unregistered):
        # from this instant a late reply is stale and can never resolve
        # the (possibly reincarnated) call
        self._calls.pop(cid, None)
        self._drop_pending(op)    # never-flushed request: unpost it
        if op.retries > 0:
            # idempotent retry: fresh epoch, fresh _Op (the timed-out
            # instance may still be in flight and must keep its own lease
            # accounting), same Future, re-posted through the planner
            self.stat_retries += 1
            new_cid = next(Session._call_ids)
            new_op = _Op("send", fut, nbytes=op.nbytes, data=op.data,
                         meta=op.meta, call_id=new_cid,
                         deadline_us=op.deadline_us,
                         retries=op.retries - 1)
            self._calls[new_cid] = fut
            self.env.process(self._deadline_watch(new_op, new_cid),
                             f"sess{self.id}.deadline{new_cid}")
            self._post(new_op)
            return
        self.stat_timeouts += 1
        if op.stall_guard:
            fut._fail(f"call {cid} stalled for {op.deadline_us}us with no "
                      f"reply (lost reply? pass deadline_us= for typed "
                      f"timeouts)", kind=SessionError)
        else:
            fut._fail(f"call {cid} missed its {op.deadline_us}us deadline "
                      f"(reply lost or peer slow)", kind=CallTimeout)

    def _arm_tick(self) -> None:
        if not self._tick_armed:
            self._tick_armed = True
            self.env.process(self._tick(), f"sess{self.id}.tick")

    def _tick(self) -> Generator:
        """Auto-batching: everything posted in the same scheduler tick
        lowers as one flush."""
        yield self.env.timeout(0.0)
        self._tick_armed = False
        if self._pending and self._batch_depth == 0:
            yield from self._flush()

    def _flush(self) -> Generator:
        while True:
            while self._flush_busy:
                yield self.env.timeout(0.05)
            if not self._pending or self._batch_depth:
                return
            self._flush_busy = True
            ops, self._pending = self._pending, []
            try:
                yield from self._flush_ops(ops)
            finally:
                self._flush_busy = False

    def _flush_ops(self, ops: List[_Op]) -> Generator:
        # zero-copy staging leases from prior flushes are safe to reclaim
        # once the application issues new ops on this session
        for lease in self._held:
            lease.release()
        self._held.clear()
        self.stat_flushes += 1
        self.stat_batched_ops += len(ops)
        try:
            yield from self._await_ready()
            wrs: List[WorkRequest] = []
            for i, op in enumerate(ops):
                wr = yield from self._lower(op, i)
                self._t.fill_dst(wr)
                wrs.append(wr)
            if any(op.call_id is not None for op in ops):
                yield from self._ensure_window()
        except _error_types() as e:
            self._fail_ops(ops, f"flush failed: {e}")
            return
        qp = self._t.qp
        plan = plan_batch(len(wrs), qp.sq_depth, qp.cq_depth,
                          self.signal_interval)
        for attempt in range(8):
            base = self._t.entries_queued()
            try:
                n_cqes = yield from self._t.push(wrs, self.signal_interval)
            except QPError as e:
                # the shared QP flipped to ERR under us (another vq's WR
                # died in flight). _post_segments leaves no queueing
                # elements for the raising segment, so:
                posted = self._t.entries_queued() - base
                if posted == 0:
                    # nothing of ours posted — wait out the background
                    # recovery and retry the whole batch
                    yield from self._await_ready()
                    continue
                # partial post: the posted prefix resolves (or errs) via
                # its own CQEs; only the never-posted suffix fails here —
                # segment-scoped failure, not whole-batch
                groups = plan.groups(ops)
                for g in groups[:posted]:
                    self._groups.append(g)
                for g in groups[posted:]:
                    self._fail_ops(g, f"flush segment not posted: {e}")
                self._ensure_reactor()
                return
            except _error_types() as e:
                self._fail_ops(ops, f"flush failed: {e}")
                return
            assert plan.n_cqes == n_cqes, (plan.n_cqes, n_cqes)
            for group in plan.groups(ops):
                self._groups.append(group)
            self._ensure_reactor()
            return
        self._fail_ops(ops, "flush failed: QP would not stay RTS")

    def _await_ready(self) -> Generator:
        """Block until the underlying QP is usable again (a previous
        errored flush may still be recovering in the background)."""
        for _ in range(self.spin_limit):
            qp = self._t.qp
            if qp is None or qp.state == QPState.RTS:
                return
            # reaping surfaces the ERR CQEs, which is what kicks the
            # module's background _recover
            yield from self._reap_entries()
            yield self.env.timeout(0.5)
        raise SessionError("QP never recovered")

    def _lower(self, op: _Op, idx: int) -> Generator:
        if op.kind == "read":
            if op.into is not None:
                mr, off = op.into
            else:
                op.lease = yield from self.pool.lease(op.nbytes)
                mr, off = op.lease.mr, op.lease.off
            return WorkRequest(op="READ", wr_id=idx, local_mr=mr,
                               local_off=off, remote_rkey=op.remote_rkey,
                               remote_off=op.remote_off, nbytes=op.nbytes)
        if op.kind == "write":
            if op.src is not None:
                mr, off, nbytes = op.src
            else:
                op.lease = yield from self.pool.lease(op.nbytes)
                op.lease.write(op.data)
                mr, off, nbytes = op.lease.mr, op.lease.off, op.nbytes
            return WorkRequest(op="WRITE", wr_id=idx, local_mr=mr,
                               local_off=off, remote_rkey=op.remote_rkey,
                               remote_off=op.remote_off, nbytes=nbytes)
        if op.kind == "cas":
            op.lease = yield from self.pool.lease(8)
            return WorkRequest(op="CAS", wr_id=idx, local_mr=op.lease.mr,
                               local_off=op.lease.off,
                               remote_rkey=op.remote_rkey,
                               remote_off=op.remote_off, nbytes=8,
                               compare=op.compare, swap=op.swap)
        if op.kind == "faa":
            op.lease = yield from self.pool.lease(8)
            return WorkRequest(op="FAA", wr_id=idx, local_mr=op.lease.mr,
                               local_off=op.lease.off,
                               remote_rkey=op.remote_rkey,
                               remote_off=op.remote_off, nbytes=8,
                               add=op.add)
        if op.kind == "send":
            op.lease = yield from self.pool.lease(max(op.nbytes, 1))
            op.lease.write(op.data)
            cm = self._t.cm
            op.hold_lease = op.nbytes > cm.kernel_msg_buf_bytes
            meta = dict(op.meta or {})
            meta["sess_epoch"] = self.epoch
            if op.call_id is not None:
                meta["call_id"] = op.call_id
            return WorkRequest(op="SEND", wr_id=idx, local_mr=op.lease.mr,
                               local_off=op.lease.off, nbytes=op.nbytes,
                               header=meta or None)
        raise SessionError(f"unknown op kind {op.kind!r}")

    def _fail_ops(self, ops: List[_Op], reason: str) -> None:
        for op in ops:
            self._fail_op(op, reason)

    def _fail_op(self, op: _Op, reason: str) -> None:
        if op.lease is not None:
            op.lease.release()
            op.lease = None
        if op.call_id is not None:
            # retire the epoch even on send-side failure: a half-delivered
            # request's reply must not resolve a recv() or a later call
            self._calls.pop(op.call_id, None)
        op.future._fail(reason)

    # -------------------------------------------------- completion reactor
    def _await(self, fut: Future) -> Generator:
        """Wait for one future: flush it if still planner-pending, then
        park on the future's own wake event. The session's reactor
        process (one per session, spawned lazily while work is
        outstanding) does all the popping — waiters never poll."""
        while not fut._done:
            if self._pending and self._batch_depth == 0:
                yield from self._flush()
                continue
            self._ensure_reactor()
            ev = fut._subscribe()
            if fut._done:
                break
            yield ev

    def _hubs(self) -> List[Broadcast]:
        """The transport's current completion-notify sources: the physical
        QP's CQE edge (plus the old QP's during a §4.6 transfer) and this
        session's message hub."""
        hubs = [self._notify]
        qp = self._t.qp
        if qp is not None:
            hubs.append(qp.comp_notify)
        vq = self._t.vq
        if vq is not None and vq.old_qp is not None:
            hubs.append(vq.old_qp.comp_notify)
        return hubs

    def _fresh_pokes(self, hubs: Sequence[Broadcast],
                     consume: bool = True) -> bool:
        """Has any source poked since the reactor last looked? A plain
        integer compare — no event, no syscall."""
        fresh = False
        for h in hubs:
            seen = self._seen_pokes.get(h, 0)
            if h.stat_pokes != seen:
                fresh = True
                if consume:
                    self._seen_pokes[h] = h.stat_pokes
        return fresh

    def _has_outstanding(self) -> bool:
        return bool(self._groups or self._calls or self._recv_waiters)

    def _ensure_reactor(self) -> None:
        if not self._reactor_running and not self.closed \
                and self._has_outstanding():
            self._reactor_running = True
            self.env.process(self._reactor(), f"sess{self.id}.reactor")

    def _reactor(self) -> Generator:
        """Event-driven completion reactor (ONE per session).

        Blocks on completion-notify edges — never on poll ticks — and
        pops only when an edge (or a free user-visible queue peek) says a
        pop will be productive. Exits when nothing is outstanding; the
        next flush / call / recv respawns it. A reactor that dies on a
        transport error fails every outstanding Future with the reason
        instead of crashing the simulation.
        """
        try:
            while self._has_outstanding() and not self.closed:
                if self._calls or self._recv_waiters:
                    # a recv()-only session must still get its window
                    # posted (calls post it at flush; bare recv doesn't)
                    yield from self._ensure_window()
                hubs = self._hubs()
                if self._fresh_pokes(hubs) or self._t.has_entries() \
                        or self._t.has_msgs():
                    progressed = yield from self._reap_once()
                    if not progressed:
                        self.stat_idle_polls += 1
                    continue
                qp = self._t.qp
                if qp is not None and qp.state == QPState.ERR \
                        and self._groups:
                    # silent ERR (no CQEs flowing): drive recovery with a
                    # BOUNDED poll — the one place the reactor may tick
                    self._err_spins += 1
                    if self._err_spins > self.spin_limit:
                        while self._groups:
                            self._fail_ops(self._groups.popleft(),
                                           "QP never recovered from ERR")
                        continue
                    yield from self._reap_entries()
                    yield self.env.timeout(0.5)
                    continue
                self._err_spins = 0
                if self._groups:
                    # entry-side wait: ONE blocking crossing parked on the
                    # CQE edge (qpop_wait) — the syscall charge lands at
                    # entry and overlaps the wire flight, so the wake is
                    # at the CQE instant with zero idle pops
                    self.stat_notify_blocks += 1
                    yield from self._reap_entries(block=True)
                    # edges observed in-kernel are consumed; anything they
                    # raced is still caught by the has_* peeks next loop
                    self._fresh_pokes(self._hubs())
                    continue
                # message-side wait (calls / recv): park in user space on
                # the notify hubs. Subscribe FIRST, then re-check the poke
                # counters, so an edge racing this instant cannot be lost
                ev = self.env.event()
                for hub in hubs:
                    hub.subscribe(ev)
                if self._fresh_pokes(hubs, consume=False):
                    continue
                self.stat_notify_blocks += 1
                yield ev
        except _error_types() as e:
            reason = f"session transport failed: {e}"
            while self._groups:
                self._fail_ops(self._groups.popleft(), reason)
            for cid in list(self._calls):
                self._calls.pop(cid)._fail(reason)
            while self._recv_waiters:
                self._recv_waiters.popleft()._fail(reason)
        finally:
            self._reactor_running = False
            # work posted while the except-branch unwound (or a racing
            # flush) must not strand: respawn — except on a closed
            # session, whose in-flight groups die with it
            if not self.closed:
                self._ensure_reactor()

    def _reap_once(self) -> Generator:
        """One productive pop cycle: entries if the entry side has (or may
        have) something, messages if the message queue shows something."""
        progressed = False
        if self._groups or self._errored or self._t.has_entries():
            progressed = yield from self._reap_entries()
        if (self._calls or self._recv_waiters) and self._t.has_msgs():
            progressed = (yield from self._reap_msgs()) or progressed
        return progressed

    def _reap_entries(self, block: bool = False) -> Generator:
        # pop unconditionally: even with no groups of our own pending, the
        # poll drives _qpop_inner over the SHARED physical CQ — routing
        # other vqs' ERR CQEs to their owners and kicking the module's
        # background _recover (a stuck peer session must not depend on the
        # erroring session being the one that polls)
        if block:
            entries = yield from self._t.pop_wait(max_n=64)
        else:
            entries = yield from self._t.pop(max_n=64)
        for ent in entries:
            self._resolve_entry(ent)
        if self._errored and not self._groups:
            # every group of the errored flush has resolved; the vq is
            # re-armed so the session stays usable post-_recover
            vq = self._t.vq
            if vq is not None:
                vq.errored = False
            self._errored = False
        return bool(entries)

    def _resolve_entry(self, ent: CompEntry) -> None:
        if not self._groups:
            return                           # spurious (legacy path mixed in)
        group = self._groups.popleft()
        if ent.err:
            self._errored = True
            for op in group:
                self._fail_op(op, "completion error (QP ERR — peer dead "
                                  "or remote MR revoked)")
            return
        for op in group:
            self._complete_op(op, ent)

    def _complete_op(self, op: _Op, ent: CompEntry) -> None:
        if op.kind == "read":
            if op.lease is not None:
                op.future._resolve(op.lease.read(op.nbytes))
                op.lease.release()
            else:
                op.future._resolve(ent)
        elif op.kind in ("cas", "faa"):
            raw = op.lease.read(8)
            op.lease.release()
            op.future._resolve(int(raw.view(np.uint64)[0]))
        elif op.kind == "send":
            if op.lease is not None:
                if op.hold_lease:
                    self._held.append(op.lease)
                else:
                    op.lease.release()
            if op.call_id is None:
                op.future._resolve(ent)
            # calls resolve on reply arrival (_on_msg)
        else:                                  # write
            if op.lease is not None:
                op.lease.release()
            op.future._resolve(ent)

    # ------------------------------------------------------ two-sided recv
    def recv_window(self, window: int, msg_bytes: int) -> None:
        """Size the posted receive window (buffers come from the pool)."""
        if self._window is None:
            self._window = _RecvWindow(self.pool, msg_bytes, window)
        else:
            self._window.resize(window, msg_bytes)

    def _ensure_window(self) -> Generator:
        if not self._t.two_sided:
            raise SessionError("transport has no two-sided path")
        if self._window is None:
            self._window = _RecvWindow(
                self.pool, self._t.cm.kernel_msg_buf_bytes, 8)
        yield from self._window.ensure(self._t.push_recv)

    def _reap_msgs(self) -> Generator:
        if not self._t.two_sided or self._window is None \
                or not self._window.slots:
            return False
        msgs = yield from self._t.pop_msgs(max_n=None)
        for m in msgs:
            self._on_msg(m)
            # copy-out happened in _on_msg; recycle the consumed slot
            yield from self._window.recycle(m.wr_id, self._t.push_recv)
        return bool(msgs)

    def _on_msg(self, m: PolledMsg) -> None:
        payload = self._window.take_payload(m.wr_id, m.byte_len)
        hdr = dict(m.hdr or {})
        msg = Message(payload=payload, src=m.src, src_vq=m.src_vq,
                      hdr=hdr, reply_qd=m.reply_qd, _owner=None)
        if self.module is not None:
            msg._owner = _SessionReplyHub.for_module(self.module, self.pool)
        reply_to = hdr.get("reply_to")
        rep_epoch = hdr.get("reply_epoch")
        if rep_epoch is not None and rep_epoch != self.epoch:
            # epoch handshake: this reply answers a request sent by a
            # PREVIOUS incarnation of this endpoint (crash-restart that
            # reused the session id / qd). Its call-id space aliases
            # ours, so the per-call registry alone cannot tell it apart
            # — the epoch can. Drop it.
            self.stat_stale_replies += 1
            _LOG.debug("session %d: dropped reply for stale epoch %s "
                       "(ours %s)", self.id, rep_epoch, self.epoch)
            return
        if reply_to is not None:
            fut = self._calls.pop(reply_to, None)
            if fut is not None:
                fut._resolve(msg)
            else:
                # stale epoch: the call this reply answers timed out, was
                # cancelled, or failed. DROP it — it must resolve neither
                # a reincarnated call (fresh call-id) nor a recv() waiter.
                # Its window slot still recycles normally in _reap_msgs.
                self.stat_stale_replies += 1
                _LOG.debug("session %d: dropped stale reply to call %s",
                           self.id, reply_to)
            return
        if self._recv_waiters:
            self._recv_waiters.popleft()._resolve(msg)
        else:
            self._msg_backlog.append(msg)


class _SessionReplyHub:
    """Shared reply-session cache so Message.reply works from both
    Listener messages and Session.recv messages. Stored ON the module
    (not in a process-global table) so it dies with its cluster."""

    def __init__(self, module, pool: BufferPool):
        self.module = module
        self.pool = pool
        self._sessions: Dict[int, Session] = {}

    @classmethod
    def for_module(cls, module, pool: BufferPool) -> "_SessionReplyHub":
        hub = getattr(module, "_session_reply_hub", None)
        if hub is None:
            hub = cls(module, pool)
            module._session_reply_hub = hub
        return hub

    def reply_session(self, reply_qd: int) -> Session:
        sess = self._sessions.get(reply_qd)
        if sess is None or sess.qd not in self.module.vqs:
            sess = Session(_VqTransport(self.module, reply_qd), self.pool)
            self._sessions[reply_qd] = sess
        return sess


# ======================================================================
# Listener (server side)
# ======================================================================
class Listener:
    """A bound VirtQueue with a leased receive window: the server half of
    the session API. ``recv`` is event-driven (no busy spinning), so
    long-lived server loops never wedge the DES heap."""

    def __init__(self, module, qd: int, port: int, pool: BufferPool,
                 msg_bytes: int, window: int):
        self.module = module
        self.qd = qd
        self.port = port
        self.pool = pool
        self._window = _RecvWindow(pool, msg_bytes, window)
        self._notify = Store(module.env)
        vq = module.vqs[qd]
        vq.msg_notify = self._notify
        self._hub = _SessionReplyHub.for_module(module, pool)
        #: epoch handshake (paper's lease story): highest incarnation
        #: epoch seen per (src, src_vq). A request carrying a LOWER epoch
        #: comes from a crashed previous incarnation of that endpoint and
        #: is dropped unserved — serving it would emit a reply that races
        #: the restarted client's identically-numbered calls.
        self._peer_epochs: Dict[Tuple[str, int], int] = {}
        self.stat_stale_msgs = 0
        self.closed = False

    @property
    def msg_bytes(self) -> int:
        return self._window.msg_bytes

    @property
    def window(self) -> int:
        return self._window.window

    def grow_window(self, window: int) -> Generator:
        """Widen the posted receive window to ``window`` buffers."""
        self._window.resize(window, self._window.msg_bytes)
        yield from self._ensure_window()

    def _push_recv(self, mr, off, length, wr_id) -> Generator:
        yield from self.module.sys_qpush_recv(self.qd, mr, off, length,
                                              wr_id)

    def _ensure_window(self) -> Generator:
        yield from self._window.ensure(self._push_recv)

    def recv(self, max_n: Optional[int] = None,
             wait: bool = True) -> Generator:
        """Drain received messages (>= 1 when ``wait``); event-driven.

        Messages from a stale incarnation (a sender epoch LOWER than the
        highest seen for that endpoint — see the epoch handshake) are
        dropped unserved; their window slots recycle normally."""
        yield from self._ensure_window()
        out: List[Message] = []
        while True:
            polled = yield from self.module.sys_qpop_msgs(self.qd,
                                                          max_n=max_n)
            for m in polled:
                hdr = dict(m.hdr or {})
                ep = hdr.get("sess_epoch")
                if ep is not None:
                    key = (m.src, m.src_vq)
                    cur = self._peer_epochs.get(key, 0)
                    if ep < cur:
                        # stale incarnation: drop, recycle the slot
                        self.stat_stale_msgs += 1
                        yield from self._window.recycle(m.wr_id,
                                                        self._push_recv)
                        continue
                    self._peer_epochs[key] = ep
                out.append(Message(
                    payload=self._window.take_payload(m.wr_id, m.byte_len),
                    src=m.src, src_vq=m.src_vq, hdr=hdr,
                    reply_qd=m.reply_qd, _owner=self))
                yield from self._window.recycle(m.wr_id, self._push_recv)
            if out or not wait:
                break
            yield self._notify.get()
            while len(self._notify):          # collapse burst notifies
                yield self._notify.get()
        return out

    def recv_n(self, n: int) -> Generator:
        """Accumulate exactly ``n`` messages."""
        out: List[Message] = []
        while len(out) < n:
            got = yield from self.recv(max_n=n - len(out))
            out.extend(got)
        return out

    def reply_session(self, reply_qd: int) -> Session:
        return self._hub.reply_session(reply_qd)

    def close(self) -> None:
        self.closed = True
        vq = self.module.vqs.get(self.qd)
        if vq is not None:
            vq.msg_notify = None
            # unpost our still-queued recv slots (see Session.close)
            mine = {(id(l.mr), l.off)
                    for l in self._window.slots.values()}
            vq.recv_queue = deque(
                e for e in vq.recv_queue
                if (id(e.mr), e.offset) not in mine)
        self._window.close()


# ======================================================================
# Factories
# ======================================================================
def connect(module, addr: str, port: Optional[int] = None,
            signal_interval: Optional[int] = None,
            pool_bytes: int = 64 * 1024, cpu: int = 0) -> Generator:
    """``Session = krcore.connect(addr)``: queue + qconnect + a session
    with a fresh buffer pool. Microsecond control path (Table 2).

    Every connect draws a fresh incarnation epoch (``session.epoch``),
    piggybacked on every SEND and echoed on replies — the listener-side
    epoch handshake that makes a crash-restarted client reusing a
    session id safe against its predecessor's stale replies."""
    qd = yield from module.sys_queue(cpu=cpu)
    rc = yield from module.sys_qconnect(qd, addr, port=port)
    if rc != 0:
        raise SessionError(f"qconnect({addr}) failed")
    pool = BufferPool(module=module, grow_bytes=pool_bytes)
    return Session(_VqTransport(module, qd), pool,
                   signal_interval=signal_interval)


def from_qd(module, qd: int, pool: Optional[BufferPool] = None,
            signal_interval: Optional[int] = None) -> Session:
    """Wrap an existing connected qd (e.g. a reply queue) in a Session."""
    return Session(_VqTransport(module, qd),
                   pool or BufferPool(module=module),
                   signal_interval=signal_interval)


def raw_session(qp: QP, dst: Optional[str] = None,
                pool: Optional[BufferPool] = None,
                signal_interval: Optional[int] = None) -> Session:
    """Kernel-internal session over a bare QP (meta clients)."""
    return Session(_RawQPTransport(qp, dst=dst),
                   pool or BufferPool(node=qp.node),
                   signal_interval=signal_interval)


def listen(module, port: int, msg_bytes: Optional[int] = None,
           window: int = 8, pool: Optional[BufferPool] = None) -> Generator:
    """Bind ``port`` and return a :class:`Listener` with a posted
    receive window leased from a buffer pool."""
    qd = yield from module.sys_queue()
    rc = yield from module.sys_qbind(qd, port)
    if rc != 0:
        raise SessionError(f"port {port} already bound")
    pool = pool or BufferPool(module=module)
    lst = Listener(module, qd, port, pool,
                   msg_bytes or module.cm.kernel_msg_buf_bytes, window)
    yield from lst._ensure_window()
    return lst
