"""Device-resident RACE tables (counterparts of ``DeviceRaceTable`` and
``ShardedDeviceRaceTable`` in ``repro/kvs/race.py``).

The bucket arrays live on the card, where ``lookup_batch`` gathers from
them through the CUDA lookup kernels: the device side of the paper's
one-sided READ into the meta server / DrTM-KV. ``insert`` places a key on
the host, exactly as the reference does (sequential two-choice per key, so
the tables come out bit-identical), writes a host mirror and marks its
bucket dirty; the next ``lookup_batch`` uploads all dirty buckets in one
copy per table.

The rest is this package's own copy of the reference's numpy code over the
simulated fabric (``repro_torch.core``): the hash helpers, the shard-state
constants, and the one-sided clients. ``RaceKVStore`` keeps a store (one
shard of the elastic dkv service) in a memory node's registered memory;
``RaceClient`` reads it with two bucket READs in one doorbell (the paper's
Fig 7 example) and inserts with a CAS claim, a WRITE and an FAA publish;
``ShardClient`` is the directory-driven client that ``repro_torch.dkv``
uses, fenced against live resharding by the shard-state word. Bucket layout
in a store (little-endian): bucket b, slot s at offset (b * NSLOT + s) * 16
holds ``[fingerprint: u32 | vlen: u32 | value: 8B]``. The clients give the
same simulated microseconds, counters and bytes as the reference's.
"""

from __future__ import annotations

import struct
from typing import Generator, List, Optional, Tuple

import numpy as np
import torch

from ..core.fabric import Node
from ..core.module import KRCoreModule
from ..core.session import Session, connect
from ..device import resolve_device
from ..kernels.race_lookup.ops import race_lookup, race_lookup_sharded

NSLOT = 8
SLOT_BYTES = 16
_SLOT = struct.Struct("<II8s")
#: vlen sentinel marking a slot claimed (CAS won) but not yet published —
#: readers treat it as absent until the final header lands
CLAIMED = 0xFFFFFFFF

# ------------------------------------------------ shard lifecycle (dkv)
#: byte offset of the shard-state word inside the control MR (the table
#: version u64 lives at offset 0 — its own cacheline)
STATE_OFF = 64
#: shard states, encoded with the shard epoch as ``(epoch << 8) | state``
#: in one u64 so a single 8B CAS can fence both at once
STATE_SERVING = 1
STATE_FROZEN = 2          # migration in progress: writes redirect
STATE_MOVED = 3           # shard left this node: reads+writes redirect


def state_word(state: int, epoch: int) -> int:
    """Encode (state, epoch) into the shard's u64 state word."""
    return ((epoch & 0xFFFFFFFF) << 8) | (state & 0xFF)


def parse_state(word: int) -> Tuple[int, int]:
    """Decode the state word -> (state, epoch)."""
    return word & 0xFF, (word >> 8) & 0xFFFFFFFF


def shard_of_key(key: int, n_shards: int) -> int:
    """key -> shard id. The reference's docstring calls it independent of
    the intra-shard bucket hashes; it is not (it shares ``_h1``'s
    multiplier), so keep bucket counts coprime to the shard count."""
    return ((key * 0x9E3779B1 + 0x85EBCA77) & 0xFFFFFFFF) % n_shards


def _h1(k: int, nb: int) -> int:
    return (k * 2654435761 + 7) % nb

def _h2(k: int, nb: int) -> int:
    return (k * 40503 + 0x9E3779B9) % nb

def _fp(k: int) -> int:
    fp = (k * 2246822519 + 1) & 0xFFFFFFFF
    return fp or 1


def _slot_fp(k: int) -> int:
    """The 31-bit fingerprint stored in a slot (0 marks an empty slot)."""
    return (_fp(k) & 0x7FFFFFFF) or 1


# ------------------------------------------- one-sided fabric clients
class RaceKVStore:
    """Server side: owns the bucket array and a control MR (table-version
    word + shard-state word) in registered memory.

    A store doubles as ONE SHARD of the elastic dkv service: ``shard_id``
    / ``epoch`` identify it in the shard directory, and the state word at
    ``STATE_OFF`` of the control MR drives the live-resharding fence
    (SERVING -> FROZEN -> MOVED, CAS-transitioned by the migrator)."""

    def __init__(self, node: Node, n_buckets: int = 4096,
                 shard_id: int = 0, epoch: int = 1,
                 state: int = STATE_SERVING):
        self.node = node
        self.n_buckets = n_buckets
        self.shard_id = shard_id
        self.epoch = epoch
        nbytes = n_buckets * NSLOT * SLOT_BYTES
        self.addr = node.alloc(nbytes)
        self.mr = node.reg_mr(self.addr, nbytes)
        # control MR: table version u64 at offset 0 (its own cacheline,
        # bumped by every mutation — server-local inserts and client FAA
        # publishes) and the shard-state word u64 at STATE_OFF
        self.version_addr = node.alloc(128)
        self.version_mr = node.reg_mr(self.version_addr, 128)
        self.set_state_local(state, epoch)
        if hasattr(node, "krcore"):
            node.krcore.validmr.add(self.mr)
            node.krcore.validmr.add(self.version_mr)

    @property
    def table_bytes(self) -> int:
        return self.n_buckets * NSLOT * SLOT_BYTES

    @property
    def version(self) -> int:
        raw = self.node.read_bytes(self.version_addr, 0, 8)
        return int(raw.view(np.uint64)[0])

    def set_version_local(self, v: int) -> None:
        buf = self.node.buffer(self.version_addr)
        buf[:8].view(np.uint64)[0] = v & 0xFFFFFFFFFFFFFFFF

    def read_state_word(self) -> int:
        raw = self.node.read_bytes(self.version_addr, STATE_OFF, 8)
        return int(raw.view(np.uint64)[0])

    def set_state_local(self, state: int, epoch: Optional[int] = None) -> None:
        if epoch is not None:
            self.epoch = epoch
        buf = self.node.buffer(self.version_addr)
        buf[STATE_OFF:STATE_OFF + 8].view(np.uint64)[0] = \
            state_word(state, self.epoch)

    def _bump_version_local(self) -> None:
        buf = self.node.buffer(self.version_addr)
        v = buf[:8].view(np.uint64)
        v[0] = (int(v[0]) + 1) & 0xFFFFFFFFFFFFFFFF

    # storage-side insert (clients of the *elastic* app do one-sided GETs;
    # inserts can also come from clients one-sided — RaceClient.insert)
    def insert(self, key: int, value: bytes) -> None:
        assert len(value) <= 8
        buf = self.node.buffer(self.addr)
        for b in (_h1(key, self.n_buckets), _h2(key, self.n_buckets)):
            for s in range(NSLOT):
                off = (b * NSLOT + s) * SLOT_BYTES
                fp, vlen, _ = _SLOT.unpack_from(buf, off)
                if fp == 0 or fp == _fp(key):
                    _SLOT.pack_into(buf, off, _fp(key), len(value),
                                    value.ljust(8, b"\0"))
                    self._bump_version_local()
                    return
        raise RuntimeError("RACE bucket overflow")

    def bucket_offsets(self, key: int) -> Tuple[int, int]:
        return (_h1(key, self.n_buckets) * NSLOT * SLOT_BYTES,
                _h2(key, self.n_buckets) * NSLOT * SLOT_BYTES)


class RaceClient:
    """Compute-node client: one-sided lookups through a KRCORE Session.

    ``lookup`` is the paper's Fig 7 example (2 READs, one doorbell — the
    session's op planner coalesces the two futures posted in one batch
    scope); ``lookup_many`` extends the same discipline across keys: ALL
    bucket READs of a chunk ride one planned doorbell (one syscall
    crossing, one CQE per chunk), then every key's slots are compared
    locally.
    """

    BUCKET_BYTES = NSLOT * SLOT_BYTES

    def __init__(self, module: KRCoreModule, store: RaceKVStore,
                 mr_bytes: int = 4096, session: Optional[Session] = None):
        self.module = module
        self.store = store
        self.mr_bytes = mr_bytes
        #: shard-aware deployments pass a shared per-node session so ONE
        #: connection serves every shard hosted on that memory node
        self.session: Optional[Session] = session
        self.qd: Optional[int] = session.qd if session is not None else None

    def bootstrap(self) -> Generator:
        """The elastic-scaling critical path: connect() = queue +
        qconnect + a scratch pool. With KRCORE this is microseconds; with
        Verbs it is ~16 ms. A no-op when a shared session was injected."""
        if self.session is None:
            self.session = yield from connect(self.module,
                                              self.store.node.name,
                                              pool_bytes=self.mr_bytes)
            self.qd = self.session.qd
        return self.qd

    def lookup(self, key: int) -> Generator:
        """Two bucket READs in ONE doorbell batch (Fig 7), then local
        slot compare. Returns value bytes or None."""
        off1, off2 = self.store.bucket_offsets(key)
        with self.session.batch():
            futs = [self.session.read(self.store.mr.rkey, off,
                                      self.BUCKET_BYTES)
                    for off in (off1, off2)]
        b1, b2 = yield from self.session.wait_all(futs)
        return self._scan_buckets(b1.tobytes() + b2.tobytes(), key)

    @staticmethod
    def _scan_buckets(raw: bytes, key: int) -> Optional[bytes]:
        """Local fingerprint compare over two gathered buckets. A slot
        still carrying the CLAIMED sentinel is an in-flight insert: not
        yet published, reported absent."""
        want = _fp(key)
        for s in range(2 * NSLOT):
            fp, vlen, val = _SLOT.unpack_from(raw, s * SLOT_BYTES)
            if fp == want and vlen != CLAIMED:
                return bytes(val[:vlen])
        return None

    # ----------------------------------------- bucket-version path (FAA)
    def read_version(self) -> Generator:
        """One-sided READ of the table version (u64)."""
        raw = yield from self.session.read(self.store.version_mr.rkey,
                                           0, 8).wait()
        return int(raw.view(np.uint64)[0])

    def bump_version(self, n: int = 1) -> Generator:
        """Publish a mutation: fetch-and-add the table version. ONE
        wait-free atomic — this replaced the read-modify-write bump
        (READ + WRITE of version+1) that dropped increments under
        concurrent writers. Returns the pre-bump version."""
        old = yield from self.session.faa(self.store.version_mr.rkey,
                                          0, n).wait()
        return old

    def bump_version_casloop(self, n: int = 1) -> Generator:
        """The retired read-modify-write idiom, made lossless the hard
        way: READ + CAS, retried until the CAS wins. Kept ONLY as the
        FAA-vs-CAS-loop equivalence/contention oracle for the tests —
        under contention it costs 2+ round trips where faa costs one.
        Returns the version this caller's increment applied to."""
        while True:
            cur = yield from self.read_version()
            old = yield from self.session.cas(
                self.store.version_mr.rkey, 0, compare=cur,
                swap=(cur + n) & 0xFFFFFFFFFFFFFFFF).wait()
            if old == cur:
                return cur

    def versioned_lookup(self, key: int, max_retries: int = 8) -> Generator:
        """Torn-read-guarded lookup: version READ rides the same doorbell
        as the two bucket READs, and a trailing version READ detects a
        concurrent mutation — retry instead of returning a half-written
        slot. Returns (value-or-None, version)."""
        off1, off2 = self.store.bucket_offsets(key)
        vkey = self.store.version_mr.rkey
        for _ in range(max_retries):
            with self.session.batch():
                vf = self.session.read(vkey, 0, 8)
                futs = [self.session.read(self.store.mr.rkey, off,
                                          self.BUCKET_BYTES)
                        for off in (off1, off2)]
            v0_raw, b1, b2 = yield from self.session.wait_all([vf] + futs)
            v0 = int(v0_raw.view(np.uint64)[0])
            v1_raw = yield from self.session.read(vkey, 0, 8).wait()
            v1 = int(v1_raw.view(np.uint64)[0])
            if v0 == v1:
                return (self._scan_buckets(b1.tobytes() + b2.tobytes(),
                                           key), v1)
        # writer storm: fall back to an unguarded read of the last state
        val = yield from self.lookup(key)
        ver = yield from self.read_version()
        return (val, ver)

    def insert(self, key: int, value: bytes) -> Generator:
        """Fully one-sided client insert (RACE's CAS-claim protocol):

        1. READ both buckets (one doorbell);
        2. CAS an empty slot's ``[fp|vlen]`` header from 0 to
           ``[fp|CLAIMED]`` — the sentinel keeps readers from consuming
           the slot before its value lands;
        3. WRITE the final ``[fp|vlen|value]`` slot image;
        4. publish with :meth:`bump_version` — ONE fetch-and-add, where
           the pre-FAA idiom was a racy READ + WRITE of version+1.

        A lost CAS (another client claimed first) re-reads and retries.
        Re-inserting an existing key updates its slot in place. Returns
        the slot's byte offset."""
        assert len(value) <= 8
        fp = _fp(key)
        final = _SLOT.pack(fp, len(value), value.ljust(8, b"\0"))
        claim = np.uint64(fp | (CLAIMED << 32))
        for _ in range(4 * NSLOT):
            off1, off2 = self.store.bucket_offsets(key)
            with self.session.batch():
                futs = [self.session.read(self.store.mr.rkey, off,
                                          self.BUCKET_BYTES)
                        for off in (off1, off2)]
            b1, b2 = yield from self.session.wait_all(futs)
            raw = b1.tobytes() + b2.tobytes()

            def slot_off(s: int) -> int:
                return (off1 if s < NSLOT else off2) \
                    + (s % NSLOT) * SLOT_BYTES

            for s in range(2 * NSLOT):       # update-in-place on re-insert
                sfp, vlen, _val = _SLOT.unpack_from(raw, s * SLOT_BYTES)
                if sfp == fp and vlen != CLAIMED:
                    yield from self.session.write(
                        self.store.mr.rkey, slot_off(s), final).wait()
                    yield from self.bump_version()
                    return slot_off(s)
            for s in range(2 * NSLOT):
                sfp, _vlen, _val = _SLOT.unpack_from(raw, s * SLOT_BYTES)
                if sfp != 0:
                    continue
                old = yield from self.session.cas(
                    self.store.mr.rkey, slot_off(s), compare=0,
                    swap=int(claim)).wait()
                if old != 0:
                    break                    # lost the claim: re-read
                yield from self.session.write(
                    self.store.mr.rkey, slot_off(s), final).wait()
                yield from self.bump_version()
                return slot_off(s)
        raise RuntimeError("RACE insert: no claimable slot")

    def lookup_many(self, keys: List[int]) -> Generator:
        """Batched lookup: both bucket READs of EVERY key in a chunk ride
        one planned doorbell (one syscall + one CQE per chunk vs two
        syscalls + a CQE per key). Returns values aligned with ``keys``."""
        results: List[Optional[bytes]] = [None] * len(keys)
        per_key = 2 * self.BUCKET_BYTES
        cap = max(self.mr_bytes // per_key, 1)
        for base in range(0, len(keys), cap):
            chunk = keys[base:base + cap]
            with self.session.batch():
                futs = []
                for key in chunk:
                    for off in self.store.bucket_offsets(key):
                        futs.append(self.session.read(
                            self.store.mr.rkey, off, self.BUCKET_BYTES))
            bufs = yield from self.session.wait_all(futs)
            for j, key in enumerate(chunk):
                results[base + j] = self._scan_buckets(
                    bufs[2 * j].tobytes() + bufs[2 * j + 1].tobytes(), key)
        return results


class ShardClient:
    """Shard-aware RACE client: the directory-driven sibling of
    :class:`RaceClient`. Bound to one shard through its directory
    geometry (rkeys + n_buckets + epoch) instead of a server-object ref,
    and riding a SHARED per-memory-node session, so an elastic worker
    holds one connection per node no matter how many shards live there
    (multi-table, single session).

    Both ops are **fenced** against live resharding: the shard-state word
    rides the same doorbell as the data READs, and a state that is not
    ``SERVING`` at this client's epoch makes the op return
    ``("redirect", ...)`` instead of stale data — the caller re-resolves
    the directory and retries at the new owner. Inserts additionally
    re-check the state AFTER the FAA publish: an insert racing the
    migration freeze may not have made the copy, so it reports redirect
    and is re-applied (idempotently) at the destination.
    """

    BUCKET_BYTES = NSLOT * SLOT_BYTES

    def __init__(self, session: Session, n_buckets: int, table_rkey: int,
                 ctl_rkey: int, epoch: int):
        self.session = session
        self.n_buckets = n_buckets
        self.table_rkey = table_rkey
        self.ctl_rkey = ctl_rkey
        self.epoch = epoch

    def bucket_offsets(self, key: int) -> Tuple[int, int]:
        return (_h1(key, self.n_buckets) * NSLOT * SLOT_BYTES,
                _h2(key, self.n_buckets) * NSLOT * SLOT_BYTES)

    def _serving(self, word: int) -> bool:
        st, ep = parse_state(word)
        return st == STATE_SERVING and ep == self.epoch

    def read_state(self) -> Generator:
        raw = yield from self.session.read(self.ctl_rkey, STATE_OFF,
                                           8).wait()
        return int(raw.view(np.uint64)[0])

    def lookup_fenced(self, key: int, max_retries: int = 16) -> Generator:
        """Torn-read-guarded, migration-fenced lookup.

        One doorbell carries [state, version, bucket1, bucket2] READs; a
        trailing version READ detects a concurrent mutation (retry) and
        the state word detects a migration (redirect). Returns
        ``("ok", value-or-None)`` or ``("redirect", None)``.
        """
        off1, off2 = self.bucket_offsets(key)
        for _ in range(max_retries):
            with self.session.batch():
                sf = self.session.read(self.ctl_rkey, STATE_OFF, 8)
                vf = self.session.read(self.ctl_rkey, 0, 8)
                futs = [self.session.read(self.table_rkey, off,
                                          self.BUCKET_BYTES)
                        for off in (off1, off2)]
            s_raw, v0_raw, b1, b2 = yield from self.session.wait_all(
                [sf, vf] + futs)
            if not self._serving(int(s_raw.view(np.uint64)[0])):
                return ("redirect", None)
            v0 = int(v0_raw.view(np.uint64)[0])
            v1_raw = yield from self.session.read(self.ctl_rkey, 0,
                                                  8).wait()
            if v0 == int(v1_raw.view(np.uint64)[0]):
                return ("ok", RaceClient._scan_buckets(
                    b1.tobytes() + b2.tobytes(), key))
        raise RuntimeError(
            f"lookup_fenced: version storm on shard (epoch {self.epoch}) "
            f"— {max_retries} retries exhausted")

    def insert_fenced(self, key: int, value: bytes) -> Generator:
        """Fully one-sided fenced insert (CAS-claim + WRITE + FAA publish
        + state re-check). Returns ``("ok", slot_off)`` or
        ``("redirect", None)`` when the shard froze/moved under us —
        the caller re-resolves and re-applies (idempotent)."""
        assert len(value) <= 8
        fp = _fp(key)
        final = _SLOT.pack(fp, len(value), value.ljust(8, b"\0"))
        claim = np.uint64(fp | (CLAIMED << 32))
        off1, off2 = self.bucket_offsets(key)

        def slot_off(s: int) -> int:
            return (off1 if s < NSLOT else off2) + (s % NSLOT) * SLOT_BYTES

        for _ in range(4 * NSLOT):
            with self.session.batch():
                sf = self.session.read(self.ctl_rkey, STATE_OFF, 8)
                futs = [self.session.read(self.table_rkey, off,
                                          self.BUCKET_BYTES)
                        for off in (off1, off2)]
            s_raw, b1, b2 = yield from self.session.wait_all([sf] + futs)
            if not self._serving(int(s_raw.view(np.uint64)[0])):
                return ("redirect", None)
            raw = b1.tobytes() + b2.tobytes()
            target: Optional[int] = None
            for s in range(2 * NSLOT):      # update-in-place on re-insert
                sfp, vlen, _v = _SLOT.unpack_from(raw, s * SLOT_BYTES)
                if sfp == fp and vlen != CLAIMED:
                    target = slot_off(s)
                    break
            if target is None:
                for s in range(2 * NSLOT):
                    sfp, _vl, _v = _SLOT.unpack_from(raw, s * SLOT_BYTES)
                    if sfp != 0:
                        continue
                    old = yield from self.session.cas(
                        self.table_rkey, slot_off(s), compare=0,
                        swap=int(claim)).wait()
                    if old != 0:
                        break               # lost the claim: re-read
                    target = slot_off(s)
                    break
                if target is None:
                    continue
            yield from self.session.write(self.table_rkey, target,
                                          final).wait()
            yield from self.session.faa(self.ctl_rkey, 0, 1).wait()
            # migration fence: a freeze between our bucket READ and the
            # FAA means the copy may have missed this write — report
            # redirect so the caller re-applies at the new owner
            post = yield from self.read_state()
            if not self._serving(post):
                return ("redirect", None)
            return ("ok", target)
        raise RuntimeError("insert_fenced: no claimable slot")


# --------------------------------------------- vectorised key hashing
# For 0 <= k < 2**32 every product below is < 2**64, so uint64 arithmetic
# is exact and ``% nb`` equals Python's; other keys take the per-key
# formulas.
_U64 = np.uint64


def _u32_mask(keys: np.ndarray) -> np.ndarray:
    if keys.dtype.kind not in "iu":
        return np.zeros(keys.shape, bool)
    return (keys >= 0) & (keys < 2 ** 32)


def query_hashes(keys, n_buckets: int):
    """keys -> (fingerprints (NQ,) int32, bucket ids (NQ, 2) int32), equal
    to ``_slot_fp`` / ``_h1`` / ``_h2`` key by key."""
    keys = np.asarray(keys).reshape(-1)
    fps = np.empty(len(keys), np.int32)
    bidx = np.empty((len(keys), 2), np.int32)
    small = _u32_mask(keys)
    k = keys[small].astype(_U64)
    f = (k * _U64(2246822519) + _U64(1)) & _U64(0x7FFFFFFF)
    fps[small] = np.where(f == 0, _U64(1), f)
    nb = _U64(n_buckets)
    bidx[small, 0] = (k * _U64(2654435761) + _U64(7)) % nb
    bidx[small, 1] = (k * _U64(40503) + _U64(0x9E3779B9)) % nb
    for i in np.flatnonzero(~small):
        key = int(keys[i])
        fps[i] = _slot_fp(key)
        bidx[i] = _h1(key, n_buckets), _h2(key, n_buckets)
    return fps, bidx


def query_shards(keys, n_shards: int) -> np.ndarray:
    """keys -> shard ids (NQ,) int32, equal to ``shard_of_key`` key by key."""
    keys = np.asarray(keys).reshape(-1)
    out = np.empty(len(keys), np.int32)
    small = _u32_mask(keys)
    k = keys[small].astype(_U64)
    out[small] = ((k * _U64(0x9E3779B1) + _U64(0x85EBCA77))
                  & _U64(0xFFFFFFFF)) % _U64(n_shards)
    for i in np.flatnonzero(~small):
        out[i] = shard_of_key(int(keys[i]), n_shards)
    return out


# ------------------------------------------------------ resident tables
def _place(fp, val, loads, dirty, key: int, value) -> None:
    """Insert one key into one shard's host arrays, as the reference's
    ``DeviceRaceTable.insert`` does, and mark its bucket dirty. The key is
    hashed as a Python int (the reference hashes a numpy integer key in
    fixed width, which wraps for keys above about 3.5e9)."""
    key = int(key)
    nb, nslot = fp.shape
    b1, b2 = _h1(key, nb), _h2(key, nb)
    b = b1 if loads[b1] <= loads[b2] else b2
    if loads[b] >= nslot:
        b = b2 if b == b1 else b1
        if loads[b] >= nslot:
            raise RuntimeError("bucket overflow")
    s = loads[b]
    fp[b, s] = _slot_fp(key)
    val[b, s, :len(value)] = value
    loads[b] += 1
    dirty[b] = True


class _ResidentTables:
    """Host mirror (``_fp``, ``_val``, ``_loads``) and device copy
    (``fp_table``, ``val_table``) of bucket tables of shape ``(*lead, NB,
    NSLOT[, VDIM])``; dirty buckets are uploaded by :meth:`sync`."""

    def __init__(self, lead: tuple, n_buckets: int, nslot: int, vdim: int,
                 device):
        self.device = resolve_device(device)
        self.n_buckets, self.nslot, self.vdim = n_buckets, nslot, vdim
        shape = (*lead, n_buckets)
        self._fp = np.zeros((*shape, nslot), np.int32)
        self._val = np.zeros((*shape, nslot, vdim), np.float32)
        self._loads = np.zeros(shape, np.int32)
        self._dirty = np.zeros(shape, bool)
        self.fp_table = torch.zeros(self._fp.shape, dtype=torch.int32,
                                    device=self.device)
        self.val_table = torch.zeros(self._val.shape, dtype=torch.float32,
                                     device=self.device)

    def _load(self, fp, val, loads):
        for name, a in (("fp", fp), ("val", val), ("loads", loads)):
            mine = getattr(self, f"_{name}")
            if np.shape(a) != mine.shape:
                raise ValueError(f"{name} has shape {np.shape(a)}, expected "
                                 f"{mine.shape}")
            mine[...] = a
        self._dirty[...] = True
        return self

    def sync(self) -> None:
        """Upload every dirty bucket: one copy per table."""
        rows = np.flatnonzero(self._dirty)
        if rows.size == 0:
            return
        n = self._dirty.size
        idx = torch.from_numpy(rows).to(self.device)
        for host, dev in ((self._fp, self.fp_table),
                          (self._val, self.val_table)):
            part = torch.from_numpy(host.reshape(n, -1)[rows])
            dev.view(n, -1).index_copy_(0, idx, part.to(self.device))
        self._dirty[...] = False


class DeviceRaceTable(_ResidentTables):
    """Device-resident RACE table: batched lookups through the CUDA lookup
    kernels. ``device=None`` means the CUDA card (raises without one)."""

    def __init__(self, n_buckets: int = 1024, nslot: int = 8,
                 vdim: int = 128, device=None):
        super().__init__((), n_buckets, nslot, vdim, device)

    @classmethod
    def from_numpy(cls, fp, val, loads, device=None) -> "DeviceRaceTable":
        """A table holding the given state: ``fp`` (NB, NSLOT), ``val`` (NB,
        NSLOT, VDIM) and ``loads`` (NB,), e.g. a reference table's ``_fp``,
        ``_val`` and ``_loads``."""
        nb, nslot = np.shape(fp)
        return cls(nb, nslot, np.shape(val)[-1], device)._load(fp, val, loads)

    def insert(self, key: int, value: np.ndarray) -> None:
        _place(self._fp, self._val, self._loads, self._dirty, key, value)

    def lookup_batch(self, keys: np.ndarray, impl: str = "kernel"):
        """keys -> (values (NQ, VDIM) float32, found (NQ,) int32), on the
        table's device. ``impl`` as in ``ops.race_lookup``. The hashed
        routing stays on the host: the kernel takes up to 2,032 keys by
        value, with no copy to the card, and more in one copy."""
        fps, bidx = query_hashes(keys, self.n_buckets)
        self.sync()
        return race_lookup(self.fp_table, self.val_table, fps, bidx,
                           impl=impl)


class ShardedDeviceRaceTable(_ResidentTables):
    """Multi-shard device-resident RACE table: the device form of the dkv
    shard map. The shards share one geometry and stay stacked on the
    device as one ``(NS, NB, NSLOT[, VDIM])`` tensor per table; batched
    lookups run through the sharded kernel."""

    def __init__(self, n_shards: int = 4, n_buckets: int = 256,
                 nslot: int = 8, vdim: int = 128, device=None):
        self.n_shards = n_shards
        super().__init__((n_shards,), n_buckets, nslot, vdim, device)

    @classmethod
    def from_numpy(cls, fp_tables, val_tables, loads,
                   device=None) -> "ShardedDeviceRaceTable":
        """A table holding the given stacked state: ``fp_tables`` (NS, NB,
        NSLOT), ``val_tables`` (NS, NB, NSLOT, VDIM), ``loads`` (NS, NB)."""
        ns, nb, nslot = np.shape(fp_tables)
        return cls(ns, nb, nslot, np.shape(val_tables)[-1],
                   device)._load(fp_tables, val_tables, loads)

    def shard_of(self, key: int) -> int:
        return shard_of_key(int(key), self.n_shards)

    def insert(self, key: int, value: np.ndarray) -> None:
        s = self.shard_of(key)
        _place(self._fp[s], self._val[s], self._loads[s], self._dirty[s],
               key, value)

    def lookup_batch(self, keys: np.ndarray, impl: str = "kernel"):
        """keys -> (values (NQ, VDIM) float32, found (NQ,) int32) in input
        order. ``impl`` as in ``ops.race_lookup_sharded``. The hashed
        routing stays on the host: the kernel takes up to 2,032 keys by
        value, with no copy to the card, and more in one copy;
        ``impl="scalar"`` splits it by shard there, each shard's call by
        value up to 2,032 keys."""
        fps, bidx = query_hashes(keys, self.n_buckets)
        sidx = query_shards(keys, self.n_shards)
        self.sync()
        return race_lookup_sharded(self.fp_table, self.val_table, fps, bidx,
                                   sidx, impl=impl)
