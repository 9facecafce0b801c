"""Meta server, DrTM-KV, DCCache, ValidMR and MRStore (paper §4.2, C#1).

The meta server replicates every node's DCT metadata (12 B each) in an
RDMA-enabled KV store modeled after DrTM-KV: the table lives in *registered
server memory* and clients look a key up with **one one-sided READ in the
common case** (linear probing adds a READ per collision). No server CPU is
involved — this is what gives the stable microsecond query latency of
Fig 9a vs. the RPC alternative.

Layout: ``n_slots`` fixed slots of 32 B::

    [ key: 8B (0 = empty) | vlen: 4B | value: 20B ]
"""

from __future__ import annotations

import dataclasses
import struct
from collections import deque
from typing import Deque, Dict, Generator, List, Optional, Tuple

import numpy as np

from .fabric import MemoryRegion, Node
from .qp import QP
from .session import BufferPool, SessionError, raw_session

SLOT = 32
_KEY = struct.Struct("<Q")
_HDR = struct.Struct("<QI")          # key, vlen
MAX_VAL = SLOT - _HDR.size


def fnv1a(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h or 1                      # 0 is the empty marker


class DrTMKV:
    """Server side of the RDMA-friendly KV store (host-resident table)."""

    def __init__(self, node: Node, n_slots: int = 16384):
        self.node = node
        self.n_slots = n_slots
        self.addr = node.alloc(n_slots * SLOT)
        self.mr = node.reg_mr(self.addr, n_slots * SLOT)
        self._n = 0

    # server-local (storage-side) operations ---------------------------------
    def put(self, key: bytes, value: bytes) -> None:
        if len(value) > MAX_VAL:
            raise ValueError(f"value too large ({len(value)} > {MAX_VAL})")
        if self._n >= self.n_slots // 2:
            raise RuntimeError("DrTMKV over half full; grow n_slots")
        h = fnv1a(key)
        buf = self.node.buffer(self.addr)
        for probe in range(self.n_slots):
            idx = (h + probe) % self.n_slots
            off = idx * SLOT
            k = _KEY.unpack_from(buf, off)[0]
            if k == 0 or k == h:
                if k == 0:
                    self._n += 1
                _HDR.pack_into(buf, off, h, len(value))
                buf[off + _HDR.size: off + _HDR.size + len(value)] = \
                    np.frombuffer(value, dtype=np.uint8)
                return
        raise RuntimeError("DrTMKV full")

    def delete(self, key: bytes) -> None:
        h = fnv1a(key)
        buf = self.node.buffer(self.addr)
        for probe in range(self.n_slots):
            idx = (h + probe) % self.n_slots
            off = idx * SLOT
            k = _KEY.unpack_from(buf, off)[0]
            if k == 0:
                return
            if k == h:
                _HDR.pack_into(buf, off, 0, 0)
                self._n -= 1
                return

    def slot_of(self, key: bytes) -> int:
        return fnv1a(key) % self.n_slots

    @staticmethod
    def parse_slot(raw: np.ndarray) -> Tuple[int, bytes]:
        k, vlen = _HDR.unpack_from(raw.tobytes(), 0)
        return k, raw.tobytes()[_HDR.size:_HDR.size + vlen]


class KVClient:
    """Client handle: one-sided lookups through a kernel-internal
    :class:`~repro_torch.core.session.Session` over an established QP.

    ``lookup`` issues one READ future per probe; ``get_many`` posts one
    probe READ *per key* inside a ``session.batch()`` scope, so each round
    lowers to a single planned doorbell (selective signaling: one CQE per
    round) and only collided keys advance to the next round — the
    Storm-style batched one-sided discipline, now owned by the session's
    op planner instead of hand-rolled WR lists.

    Scratch is leased from a :class:`BufferPool` wrapped around the
    caller's ``scratch_mr`` starting at ``batch_scratch_off``, so client
    probes can never stomp the module's MR-check slot (offset 64) when
    sharing the module scratch region.
    """

    def __init__(self, qp: QP, server: DrTMKV, scratch_mr: MemoryRegion,
                 scratch_off: int = 0, batch_scratch_off: int = 128):
        # scratch_off is accepted for source compatibility with the
        # pre-session constructor but unused: ALL lookups (single-key
        # included) lease from the pool region at batch_scratch_off now,
        # so the dedicated single-slot region no longer exists.
        del scratch_off
        self.qp = qp
        self.server = server
        self.scratch_mr = scratch_mr
        self.batch_scratch_off = batch_scratch_off
        pool = BufferPool(mr=scratch_mr, base_off=batch_scratch_off,
                          align=SLOT)
        if pool.capacity(SLOT) < 1:
            # fail loudly at construction: a silent lease failure inside
            # lookup() would read as "key absent" for every key
            raise ValueError(
                f"scratch_mr too small for lookups: need "
                f"batch_scratch_off ({batch_scratch_off}) + SLOT ({SLOT}) "
                f"bytes, have {scratch_mr.length}")
        # completion delivery is notify-driven (the session reactor blocks
        # on the QP's CQE edge), so no poll-cadence tuning is needed: a
        # lookup wakes at the instant its CQE is generated
        self.session = raw_session(qp, dst=server.node.name, pool=pool)

    def lookup(self, key: bytes, max_probes: int = 8) -> Generator:
        """yields sim events; returns value bytes or None."""
        h = fnv1a(key)
        for probe in range(max_probes):
            fut = self.session.read(
                self.server.mr.rkey,
                ((h + probe) % self.server.n_slots) * SLOT, SLOT)
            try:
                raw = yield from fut.wait()
            except SessionError:
                return None                   # server down / MR revoked
            k, val = DrTMKV.parse_slot(raw)
            if k == h:
                return val
            if k == 0:
                return None
        return None

    def get_many(self, keys: List[bytes], max_probes: int = 8
                 ) -> Generator:
        """Batched lookup: returns ``List[Optional[bytes]]`` aligned with
        ``keys``. Each round batches one probe READ per still-unresolved
        key into ONE planned doorbell; only collided keys re-probe.

        Rounds are PIPELINED through the scratch pool: two rounds' leases
        fit side by side, and round r+1 is posted behind round r's
        doorbell while r is still in flight (futures decouple posting
        from completion), instead of synchronizing per chunk.
        """
        results: List[Optional[bytes]] = [None] * len(keys)
        if not keys:
            return results
        hashes = [fnv1a(k) for k in keys]
        cap = min(self.session.pool.capacity(SLOT),
                  self.qp.sq_depth, self.qp.cq_depth - 1)
        if cap < 1:
            raise ValueError("scratch too small for batched lookup")
        n_banks = 2 if cap >= 2 else 1
        bank_cap = cap // n_banks
        inflight: Deque[Tuple[List[Tuple[int, int]], List]] = deque()
        pending: List[Tuple[int, int]] = [(i, 0) for i in range(len(keys))]
        failed = False
        while pending or inflight:
            if pending and len(inflight) < n_banks and not failed:
                chunk, pending = pending[:bank_cap], pending[bank_cap:]
                with self.session.batch():
                    futs = [self.session.read(
                        self.server.mr.rkey,
                        ((hashes[i] + probe) % self.server.n_slots) * SLOT,
                        SLOT) for (i, probe) in chunk]
                inflight.append((chunk, futs))
                continue                      # post before waiting
            chunk, futs = inflight.popleft()
            try:
                raws = yield from self.session.wait_all(futs)
            except SessionError:
                failed = True                 # server down / MR revoked:
                pending = []                  # drain in-flight, then stop
                continue
            for (i, probe), raw in zip(chunk, raws):
                k, val = DrTMKV.parse_slot(raw)
                if k == hashes[i]:
                    results[i] = val
                elif k != 0 and probe + 1 < max_probes:
                    pending.append((i, probe + 1))   # collision: re-probe
        return results


@dataclasses.dataclass(frozen=True)
class DCTMeta:
    """12 bytes: what an initiator needs to reach a node's DC target (§3.1)."""
    node_id: int
    dct_num: int
    dct_key: int

    def pack(self) -> bytes:
        return struct.pack("<III", self.node_id, self.dct_num, self.dct_key)

    @staticmethod
    def unpack(raw: bytes) -> "DCTMeta":
        a, b, c = struct.unpack_from("<III", raw, 0)
        return DCTMeta(a, b, c)


_SHARD_REC = struct.Struct("<IIIII")


@dataclasses.dataclass(frozen=True)
class ShardRecord:
    """One dkv shard-directory record: everything a compute worker needs
    to reach a shard with pure one-sided ops — the DCTMeta analogue for
    disaggregated KV shards. Exactly 20 bytes, so a record fills a
    DrTM-KV slot's value (``MAX_VAL``) and resolves with ONE one-sided
    READ like every other meta-service lookup.

    ``epoch`` is the shard-map epoch this record was published under
    (bumped by every migration of this shard); ``ctl_rkey`` names the
    shard's control MR (table version u64 at offset 0, state word u64 at
    offset :data:`repro_torch.kvs.race.STATE_OFF`)."""
    epoch: int
    node_id: int
    table_rkey: int
    ctl_rkey: int
    n_buckets: int

    def pack(self) -> bytes:
        return _SHARD_REC.pack(self.epoch, self.node_id, self.table_rkey,
                               self.ctl_rkey, self.n_buckets)

    @staticmethod
    def unpack(raw: bytes) -> "ShardRecord":
        return ShardRecord(*_SHARD_REC.unpack_from(bytes(raw), 0))


assert _SHARD_REC.size == MAX_VAL, "ShardRecord must fill a DrTM-KV slot"


class MetaServer:
    """A global meta server: DrTM-KV mapping node name -> DCTMeta."""

    def __init__(self, node: Node, n_slots: int = 32768):
        self.node = node
        self.kv = DrTMKV(node, n_slots)

    def register(self, node_name: str, meta: DCTMeta) -> None:
        self.kv.put(node_name.encode(), meta.pack())

    def unregister(self, node_name: str) -> None:
        self.kv.delete(node_name.encode())

    def memory_bytes(self) -> int:
        """Metadata footprint (the 117KB-for-10k-nodes claim of §3.1)."""
        return self.kv._n * (self.node.cm.dct_meta_bytes + 8)


class DCCache:
    """Local cache of DCT metadata (§4.2). Invalidated only on node death."""

    def __init__(self) -> None:
        self._cache: Dict[str, DCTMeta] = {}
        self.hits = 0
        self.misses = 0

    def get(self, addr: str) -> Optional[DCTMeta]:
        meta = self._cache.get(addr)
        if meta is not None:
            self.hits += 1
        else:
            self.misses += 1
        return meta

    def put(self, addr: str, meta: DCTMeta) -> None:
        self._cache[addr] = meta

    def invalidate(self, addr: str) -> None:
        self._cache.pop(addr, None)

    def memory_bytes(self) -> int:
        return len(self._cache) * 12


class ValidMRStore:
    """Per-node registry of valid MRs, itself stored in a DrTM-KV so that
    *remote* kernels can validate an (rkey, range) with one-sided READs
    before posting a request (§4.2 ValidMR, §4.4 factor 1)."""

    def __init__(self, node: Node, n_slots: int = 8192):
        self.node = node
        self.kv = DrTMKV(node, n_slots)

    @staticmethod
    def _key(rkey: int) -> bytes:
        return struct.pack("<Q", rkey)

    def add(self, mr: MemoryRegion) -> None:
        self.kv.put(self._key(mr.rkey),
                    struct.pack("<QQI", mr.addr, mr.length, 1))

    def remove(self, rkey: int) -> None:
        self.kv.delete(self._key(rkey))

    @staticmethod
    def parse(value: bytes) -> Tuple[int, int, bool]:
        addr, length, valid = struct.unpack_from("<QQI", value, 0)
        return addr, length, bool(valid)


class MRStore:
    """Local cache of *checked remote* MRs with periodic flush (§4.2).

    Deregistration on the owner side waits one flush period before the MR is
    physically released, so a stale positive cache entry can never outlive
    the registration it refers to.
    """

    def __init__(self, env, flush_period_us: float):
        self.env = env
        self.flush_period_us = flush_period_us
        self._cache: Dict[Tuple[str, int], Tuple[int, int]] = {}
        self._last_flush = 0.0
        self.hits = 0
        self.misses = 0

    def _maybe_flush(self) -> None:
        now = self.env.now
        if now - self._last_flush >= self.flush_period_us:
            self._cache.clear()
            self._last_flush = now

    def get(self, remote: str, rkey: int) -> Optional[Tuple[int, int]]:
        self._maybe_flush()
        ent = self._cache.get((remote, rkey))
        if ent is not None:
            self.hits += 1
        else:
            self.misses += 1
        return ent

    def put(self, remote: str, rkey: int, addr: int, length: int) -> None:
        self._maybe_flush()
        self._cache[(remote, rkey)] = (addr, length)

    def invalidate_remote(self, remote: str) -> int:
        """Drop every checked-MR entry of one remote (node-death handling:
        a dead node's registrations must not survive as cache hits when a
        restarted instance reuses its name). Returns entries dropped."""
        stale = [k for k in self._cache if k[0] == remote]
        for k in stale:
            del self._cache[k]
        return len(stale)
