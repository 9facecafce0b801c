"""Op planner: doorbell / CQE budgeting for batched pushes (§4.4).

This module is the *pure* half of the batched data plane: given a batch
size and the hardware queue limits it computes, without touching any
simulated state, exactly what :meth:`KRCoreModule.qpush_batch` +
:meth:`KRCoreModule._post_segments` will do —

* which WRs are signaled (every ``interval``-th plus the batch's last),
* how the batch is segmented into doorbells (split at the last signal
  boundary within the hardware segment limit),
* how many CQEs come back and what each one ``covers``.

The :class:`Session` layer lowers auto-collected ops through this plan so
auto-batched code hits the exact same ``ceil(N / interval)`` doorbell/CQE
budget as a hand-rolled ``qpush_batch`` call — and the property tests in
``tests/test_session.py`` pin plan-vs-hardware equality for random mixes.

The raw-QP transport (kernel-internal sessions, e.g. the meta-server
clients) uses the same plan to drive ``QP.post_send`` directly, so both
the syscall path and the in-kernel path share one signaling discipline.

Plans are op-agnostic: READ/WRITE/SEND and the 8-byte atomics (CAS and
its fetch-and-add sibling FAA) all cost one WR slot, so a mixed batch —
e.g. a RACE client's bucket READs plus a version-bump FAA — lowers
through one plan with the same doorbell/CQE budget. Cancellation
(:meth:`repro_torch.core.session.Future.cancel`) happens strictly BEFORE
planning: a cancelled op is removed from the pending list, and the plan
is computed over what actually posts — a plan never contains holes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple


def segment_limit(sq_depth: int, cq_depth: int) -> int:
    """Largest batch one doorbell may carry (KRCoreModule._segment_limit):
    the SQ reservation needs len <= sq_depth and the CQ reservation needs
    len <= cq_depth - 1."""
    return min(sq_depth, cq_depth - 1)


def effective_interval(signal_interval: Optional[int], sq_depth: int,
                       cq_depth: int) -> int:
    """The clamped signaling interval qpush_batch actually uses: an
    unsignaled run longer than min(sq_depth, cq_depth - 1) could never be
    reclaimed and would deadlock the SQ."""
    limit = segment_limit(sq_depth, cq_depth)
    if signal_interval is None:
        return limit
    return max(1, min(signal_interval, limit))


def signal_flags(n: int, interval: int) -> List[bool]:
    """qpush_batch's selective-signaling pattern: every ``interval``-th WR
    plus the batch's last WR."""
    return [((i + 1) % interval == 0) or (i == n - 1) for i in range(n)]


def split_segments(flags: Sequence[bool], limit: int) -> List[int]:
    """Mirror KRCoreModule._post_segments: recursively split an (already
    flagged) batch at the last signaled WR within the hardware limit.
    Returns the per-doorbell segment sizes, in posting order."""
    sizes: List[int] = []

    def rec(lo: int, hi: int) -> None:
        if hi - lo <= limit:
            if hi > lo:
                sizes.append(hi - lo)
            return
        split = limit
        for j in range(limit, 0, -1):
            if flags[lo + j - 1]:
                split = j
                break
        rec(lo, lo + split)
        rec(lo + split, hi)

    rec(0, len(flags))
    return sizes


def covers_runs(flags: Sequence[bool]) -> List[int]:
    """CQE coverage sequence: each signaled WR's CQE retires itself plus
    the preceding unsignaled run (Mellanox semantics). A trailing
    unsignaled run never occurs on qpush_batch flags (the last WR is
    always signaled); for caller-set flags the tail is force-signaled at
    post time, which this mirrors."""
    covers: List[int] = []
    run = 0
    for f in flags:
        run += 1
        if f:
            covers.append(run)
            run = 0
    if run:                       # force-signaled tail (per-WR qpush path)
        covers.append(run)
    return covers


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """What one batched push will cost: doorbells, CQEs, coverage."""
    n: int
    interval: int                 # effective (clamped) signaling interval
    limit: int                    # hardware segment limit
    flags: Tuple[bool, ...]       # per-WR signaled flag
    segments: Tuple[int, ...]     # per-doorbell WR counts, posting order
    covers: Tuple[int, ...]       # per-CQE coverage, FIFO order

    @property
    def n_doorbells(self) -> int:
        return len(self.segments)

    @property
    def n_cqes(self) -> int:
        return len(self.covers)

    def apply(self, wrs: Sequence) -> None:
        """Stamp the plan's signaled flags onto a WorkRequest list."""
        if len(wrs) != self.n:
            raise ValueError(f"plan is for {self.n} WRs, got {len(wrs)}")
        for wr, f in zip(wrs, self.flags):
            wr.signaled = f

    def groups(self, items: Sequence) -> List[List]:
        """Partition ``items`` (one per WR, posting order) into per-CQE
        groups: group g resolves when the g-th CompEntry is popped."""
        if len(items) != self.n:
            raise ValueError(f"plan is for {self.n} items, got {len(items)}")
        out: List[List] = []
        i = 0
        for c in self.covers:
            out.append(list(items[i:i + c]))
            i += c
        return out


def plan_batch(n: int, sq_depth: int, cq_depth: int,
               signal_interval: Optional[int] = None) -> BatchPlan:
    """Plan a ``qpush_batch`` of ``n`` WRs: exact doorbell count, CQE
    count (= ceil(n / effective_interval)) and coverage sequence."""
    if n < 0:
        raise ValueError("negative batch size")
    limit = segment_limit(sq_depth, cq_depth)
    if limit < 1:
        raise ValueError(f"unusable queue depths sq={sq_depth} cq={cq_depth}")
    k = effective_interval(signal_interval, sq_depth, cq_depth)
    flags = signal_flags(n, k)
    return BatchPlan(n=n, interval=k, limit=limit, flags=tuple(flags),
                     segments=tuple(split_segments(flags, limit)),
                     covers=tuple(covers_runs(flags)))
