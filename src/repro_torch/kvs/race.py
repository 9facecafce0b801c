"""Device-resident RACE tables (counterparts of ``DeviceRaceTable`` and
``ShardedDeviceRaceTable`` in ``repro/kvs/race.py``).

The bucket arrays live on the card, where ``lookup_batch`` gathers from
them through the CUDA lookup kernels: the device side of the paper's
one-sided READ into the meta server / DrTM-KV. ``insert`` places a key on
the host, exactly as the reference does (sequential two-choice per key, so
the tables come out bit-identical), writes a host mirror and marks its
bucket dirty; the next ``lookup_batch`` uploads all dirty buckets in one
copy per table.

The hash helpers and shard-state constants are this package's own copies
of the reference's. ``RaceKVStore``, ``RaceClient`` and ``ShardClient``
need the simulated fabric and are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.race_lookup.ops import race_lookup, race_lookup_sharded

NSLOT = 8

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
