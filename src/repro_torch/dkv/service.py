"""DkvService: the control plane of the elastic disaggregated KV.

Owns the shard set (one :class:`~repro_torch.kvs.race.RaceKVStore` per shard,
spread over the memory nodes), publishes the epoch-numbered shard map
into the meta server's DrTM-KV, and runs **live resharding**.

Migration protocol (freeze -> copy/quiesce -> cut over -> publish), all
data movement through batched one-sided session ops with the
CAS/FAA fences:

1. **Freeze**: one 8B CAS flips the source shard's state word
   ``SERVING(e) -> FROZEN(e)`` — from this instant new writers redirect
   (their fenced pre-check reads the word in the same doorbell as their
   bucket READs); then one FAA bumps the table version so every
   in-flight torn-read-guarded lookup retries rather than spanning the
   fence.
2. **Copy + quiesce**: the bucket array streams out in batched one-sided
   READs (a window of chunk READs per doorbell). Version is read before
   and after each pass; a straggler write that slipped in before the
   freeze bumps the version (its FAA publish), so the pass repeats until
   a pass sees no bump — bounded, because post-freeze writers redirect.
3. **Cut over**: the image lands at the destination in batched one-sided
   WRITEs, destination version set to the quiesced source version; src
   flips ``FROZEN -> MOVED`` (reads now redirect too) **before** the
   destination flips ``FROZEN -> SERVING(e+1)`` — so there is never an
   instant with two serving copies.
4. **Publish**: the shard record (epoch+1, new owner) and the bumped
   service epoch land in the directory; redirected clients re-resolve
   and converge.

A lookup concurrent with any step either reads the source pre-MOVED
(correct: no writes have committed elsewhere yet) or redirects and reads
the destination post-SERVING — never a torn or stale value. The property
tests in ``tests/test_dkv.py`` and ``tests/test_torch_dkv.py`` check
exactly this against a sequential oracle.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Generator, List, Optional, Sequence

import numpy as np

from ..core.cluster import Cluster
from ..core.meta import MetaServer, ShardRecord
from ..core.session import connect
from ..kvs.race import (STATE_FROZEN, STATE_MOVED, STATE_OFF,
                            STATE_SERVING, RaceKVStore, shard_of_key,
                            state_word)

from .directory import Directory, DkvError


@dataclasses.dataclass
class MigrationReport:
    shard_id: int
    src: str
    dst: str
    epoch: int                 # epoch the shard serves at AFTER the move
    copy_rounds: int           # quiesce passes (1 = no straggler writes)
    table_bytes: int
    freeze_us: float           # wall time the shard was not SERVING
    total_us: float


class DkvService:
    """Coordinator handle for one named KV service."""

    def __init__(self, cluster: Cluster, mem_nodes: Sequence[str],
                 n_shards: int = 4, n_buckets: int = 512,
                 name: str = "kv", meta: Optional[MetaServer] = None):
        if not mem_nodes:
            raise DkvError("need at least one memory node")
        self.cluster = cluster
        self.env = cluster.env
        self.name = name
        self.n_shards = n_shards
        self.n_buckets = n_buckets
        self.meta = meta or cluster.meta_servers[0]
        self.directory = Directory(self.meta, name)
        self.epoch = 1
        self.stores: Dict[int, RaceKVStore] = {}
        for sid in range(n_shards):
            node = cluster.node(mem_nodes[sid % len(mem_nodes)])
            self.stores[sid] = RaceKVStore(node, n_buckets, shard_id=sid,
                                           epoch=self.epoch)
            self.publish_shard(sid)
        self.publish_service()
        self.migrations: List[MigrationReport] = []

    # ------------------------------------------------------------ publish
    def record(self, sid: int) -> ShardRecord:
        st = self.stores[sid]
        return ShardRecord(epoch=st.epoch, node_id=st.node.id,
                           table_rkey=st.mr.rkey,
                           ctl_rkey=st.version_mr.rkey,
                           n_buckets=st.n_buckets)

    def publish_shard(self, sid: int) -> None:
        self.directory.publish_shard(sid, self.record(sid))

    def publish_service(self) -> None:
        self.directory.publish_service(self.epoch, self.n_shards)

    # ------------------------------------------------------------- seeding
    def shard_of(self, key: int) -> int:
        return shard_of_key(key, self.n_shards)

    def owner(self, sid: int) -> str:
        return self.stores[sid].node.name

    def seed(self, key: int, value: bytes) -> None:
        """Server-local insert (bulk load / test seeding)."""
        self.stores[self.shard_of(key)].insert(key, value)

    # ---------------------------------------------------- live resharding
    def migrate(self, mover, sid: int, dst_name: str,
                chunk_bytes: int = 4096, window: int = 8,
                max_rounds: int = 32) -> Generator:
        """Move shard ``sid`` to ``dst_name`` while it serves traffic.

        ``mover`` is the KRCoreModule doing the data movement (a compute
        node acting as migration coordinator); the whole copy is batched
        one-sided READs out of the source and WRITEs into the
        destination, fenced by the CAS state transitions and the FAA
        version bump documented in the module docstring.
        """
        src = self.stores[sid]
        src_name = src.node.name
        if src_name == dst_name:
            raise DkvError(f"shard {sid} already on {dst_name}")
        old_epoch = src.epoch
        new_epoch = self.epoch + 1
        t0 = self.env.now
        s_src = yield from connect(mover, src_name, pool_bytes=64 * 1024)
        s_dst = yield from connect(mover, dst_name, pool_bytes=64 * 1024)
        frozen = False
        try:
            # (1) freeze: CAS SERVING(e) -> FROZEN(e), then FAA-fence the
            # version so in-flight guarded lookups retry across the edge
            expect = state_word(STATE_SERVING, old_epoch)
            old = yield from s_src.cas(
                src.version_mr.rkey, STATE_OFF, compare=expect,
                swap=state_word(STATE_FROZEN, old_epoch)).wait()
            if old != expect:
                raise DkvError(f"shard {sid} not SERVING (state {old:#x})"
                               f" — concurrent migration?")
            frozen = True
            t_freeze = self.env.now
            yield from s_src.faa(src.version_mr.rkey, 0, 1).wait()

            # destination shell, FROZEN while it fills
            dst_store = RaceKVStore(self.cluster.node(dst_name),
                                    src.n_buckets, shard_id=sid,
                                    epoch=new_epoch, state=STATE_FROZEN)

            # (2) copy + quiesce: batched one-sided READ passes until a
            # pass sees no version bump (straggler pre-freeze writers)
            nbytes = src.table_bytes
            img = np.zeros(nbytes, np.uint8)
            rounds = 0
            while True:
                rounds += 1
                if rounds > max_rounds:
                    raise DkvError(f"shard {sid} never quiesced "
                                   f"({max_rounds} copy passes)")
                v0_raw = yield from s_src.read(src.version_mr.rkey,
                                               0, 8).wait()
                v0 = int(v0_raw.view(np.uint64)[0])
                offs = list(range(0, nbytes, chunk_bytes))
                for base in range(0, len(offs), window):
                    grp = offs[base:base + window]
                    with s_src.batch():
                        futs = [s_src.read(src.mr.rkey, off,
                                           min(chunk_bytes, nbytes - off))
                                for off in grp]
                    bufs = yield from s_src.wait_all(futs)
                    for off, buf in zip(grp, bufs):
                        img[off:off + len(buf)] = buf
                v1_raw = yield from s_src.read(src.version_mr.rkey,
                                               0, 8).wait()
                v1 = int(v1_raw.view(np.uint64)[0])
                if v0 == v1:
                    break

            # (3) cut over: image + version into dst (batched WRITEs) ...
            for base in range(0, len(offs), window):
                grp = offs[base:base + window]
                with s_dst.batch():
                    futs = [s_dst.write(
                        dst_store.mr.rkey, off,
                        img[off:off + min(chunk_bytes, nbytes - off)])
                        for off in grp]
                yield from s_dst.wait_all(futs)
            yield from s_dst.write(
                dst_store.version_mr.rkey, 0,
                np.array([v1], np.uint64).view(np.uint8)).wait()
            # ... src stops serving reads BEFORE dst starts serving
            # writes: never two serving copies
            yield from s_src.cas(
                src.version_mr.rkey, STATE_OFF,
                compare=state_word(STATE_FROZEN, old_epoch),
                swap=state_word(STATE_MOVED, new_epoch)).wait()
            yield from s_dst.cas(
                dst_store.version_mr.rkey, STATE_OFF,
                compare=state_word(STATE_FROZEN, new_epoch),
                swap=state_word(STATE_SERVING, new_epoch)).wait()
            t_serve = self.env.now

            # (4) publish: shard record (epoch+1, new owner) + service
            # epoch bump — redirected clients re-resolve and converge
            self.stores[sid] = dst_store
            self.epoch = new_epoch
            self.publish_shard(sid)
            self.publish_service()
        except BaseException:
            if frozen:
                # abort: thaw the source (FROZEN(e) -> SERVING(e)) so a
                # failed migration (dst died mid-copy, quiesce bound hit)
                # degrades to "shard stayed put" instead of a permanent
                # outage behind a frozen state word. Best-effort: if the
                # SOURCE is what died, the shard is lost either way
                # (single-copy: a shard has no replica).
                try:
                    yield from s_src.cas(
                        src.version_mr.rkey, STATE_OFF,
                        compare=state_word(STATE_FROZEN, old_epoch),
                        swap=state_word(STATE_SERVING, old_epoch)).wait()
                except Exception:      # noqa: BLE001 — src unreachable
                    pass
            raise
        finally:
            s_src.close()
            s_dst.close()
        rep = MigrationReport(shard_id=sid, src=src_name, dst=dst_name,
                              epoch=new_epoch, copy_rounds=rounds,
                              table_bytes=nbytes,
                              freeze_us=t_serve - t_freeze,
                              total_us=self.env.now - t0)
        self.migrations.append(rep)
        return rep
