"""VirtQueue: the virtualized queue abstraction (paper §4.1–§4.4).

A VirtQueue gives each application the *semantics* of an exclusively-owned
RCQP (FIFO, reliable, one- and two-sided verbs) while physically sharing a
QP from the node's hybrid pool. The three hazards of sharing a low-level
API (§4.4) are handled exactly as in the paper:

1. malformed request detection (opcode + ValidMR/MRStore checks),
2. NIC queue-overflow prevention (software ``uncomp_cnt`` accounting with
   selective signaling and voluntary polling),
3. completion dispatch via wr_id encoding.

wr_id encoding: ``(vq_id << 20) | comp_cnt`` with vq_id 0 == NULL.

Batched data path
-----------------

``KRCoreModule.qpush_batch`` / ``qpop_batch`` post/drain whole doorbell
batches through this abstraction with *selective signaling*: only every
``signal_interval``-th WR (and always the batch's last WR) is signaled, so a
batch of N WRs generates exactly ``ceil(N / signal_interval)`` CQEs — one
doorbell, one syscall crossing, a handful of CQEs. The accounting lives
here:

* each :class:`CompEntry` records ``covers`` — how many SQ entries its CQE
  retires (itself plus the preceding unsignaled run, Mellanox semantics);
* :attr:`VirtQueue.uncomp_cnt` tracks this queue's outstanding WRs that a
  still-unpolled CompEntry will retire. It rises by ``covers`` for every
  entry queued at push time and falls by ``covers`` when the entry is
  popped, so at quiescence it is exactly 0 — the invariant the batched
  property tests pin down.

``signal_interval`` is clamped to ``min(sq_depth, cq_depth - 1)``: a run of
unsignaled WRs longer than the SQ could never be reclaimed (reclaim happens
only when the covering CQE is *polled*), which would deadlock the queue.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Deque, List, Optional, Tuple

from .qp import QP, WorkRequest

NOT_READY = 0
READY = 1

_CNT_BITS = 20
_CNT_MASK = (1 << _CNT_BITS) - 1


def encode_wr_id(vq_id: int, comp_cnt: int) -> int:
    if comp_cnt > _CNT_MASK:
        raise ValueError("comp_cnt too large")
    return (vq_id << _CNT_BITS) | comp_cnt


def decode_wr_id(wr_id: int) -> Tuple[int, int]:
    return wr_id >> _CNT_BITS, wr_id & _CNT_MASK


@dataclasses.dataclass
class CompEntry:
    """Software completion-queue entry: [status, user_wr_id] (Alg. 2 l.11).

    ``covers`` mirrors the hardware CQE's coverage: how many of this
    VirtQueue's SQ entries (itself + the preceding unsignaled run) this
    entry retires when popped.
    """
    status: int
    user_wr_id: int
    err: bool = False
    covers: int = 1


@dataclasses.dataclass
class RecvEntry:
    """User receive buffer registered via qpush_recv."""
    mr: "object"
    offset: int
    length: int
    wr_id: int


@dataclasses.dataclass
class PolledMsg:
    """What qpop_msgs returns per message (paper adds `accept` semantics).

    ``hdr`` carries the sender's application header (routing keys plus any
    caller metadata set via Session.send(meta=...)) — the session layer
    correlates call/reply pairs through it."""
    reply_qd: int
    wr_id: int
    byte_len: int
    src: str
    src_vq: int
    hdr: Optional[dict] = None


class VirtQueue:
    """Kernel virtual queue (Algorithm 1, VirtQueueCreate)."""

    _ids = itertools.count(1)          # 0 reserved for NULL

    def __init__(self, owner_cpu: int = 0):
        self.id = next(VirtQueue._ids)
        self.owner_cpu = owner_cpu
        # software queues (Alg. 1 lines 3-4)
        self.comp_queue: Deque[CompEntry] = deque()
        self.recv_queue: Deque[RecvEntry] = deque()
        self.msg_queue: Deque[PolledMsg] = deque()
        # physical binding (Alg. 1 line 5; updated by VirtQueueConnect)
        self.qp: Optional[QP] = None
        self.kind: Optional[str] = None          # "RC" | "DC"
        self.remote: Optional[str] = None        # target node name
        self.remote_qpn: Optional[int] = None    # DC target / server qpn
        self.dct_meta = None                     # DCTMeta when kind == "DC"
        self.remote_vq: Optional[int] = None     # peer VirtQueue id (2-sided)
        self.remote_port: Optional[int] = None   # server port (first contact)
        self.bound_port: Optional[int] = None
        # transfer protocol state (§4.6): old QP polled lazily post-switch
        self.old_qp: Optional[QP] = None
        self.in_transfer = False
        self.errored = False
        #: outstanding WRs a queued-but-unpopped CompEntry will retire
        #: (selective-signaling software accounting; 0 at quiescence)
        self.uncomp_cnt = 0
        #: optional Store the module pokes whenever a message lands in
        #: msg_queue — lets Listener.recv block event-driven instead of
        #: busy-spinning (set by the session layer, None otherwise)
        self.msg_notify = None
        #: monotonic count of CompEntries ever queued on this vq — lets
        #: the session layer tell how much of a batch actually posted
        #: when a push dies part-way (QP flipped to ERR mid-batch)
        self.stat_entries_queued = 0

    # ------------------------------------------------------------ helpers
    @property
    def connected(self) -> bool:
        return self.qp is not None

    def ready_head(self) -> bool:
        """User-visible peek: is the head CompEntry Ready to pop?

        The software completion queue is shared memory in the LITE/KRCORE
        model (Alg. 1's queues are mapped into the caller), so this is a
        free load, not a syscall crossing. The notify-driven session
        reactor uses it to decide whether a pop would be productive —
        the mechanism that takes a blocked single-op caller's idle-poll
        syscall count to zero.
        """
        return bool(self.comp_queue) and self.comp_queue[0].status == READY

    def mark_ready(self) -> Optional[CompEntry]:
        """Mark the first NotReady completion entry Ready (Alg. 2 l.30);
        returns the entry (truthy) or None."""
        for ent in self.comp_queue:
            if ent.status == NOT_READY:
                ent.status = READY
                return ent
        return None

    def pop_ready(self) -> Optional[CompEntry]:
        if self.comp_queue and self.comp_queue[0].status == READY:
            ent = self.comp_queue.popleft()
            self.uncomp_cnt = max(0, self.uncomp_cnt - ent.covers)
            return ent
        return None

    def pop_ready_batch(self, max_n: int) -> List[CompEntry]:
        """Pop up to ``max_n`` Ready entries in FIFO order (bulk drain)."""
        out: List[CompEntry] = []
        while len(out) < max_n:
            ent = self.pop_ready()
            if ent is None:
                break
            out.append(ent)
        return out
