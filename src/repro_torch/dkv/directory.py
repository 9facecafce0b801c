"""Shard directory: epoch-numbered shard map in the MetaServer's DrTM-KV.

The directory is metadata, so it lives where KRCORE keeps metadata: the
meta server's DrTM-KV, resolved with **one one-sided READ per record** in
the common case (the Fig 9a discipline — no server CPU on the lookup
path). Three record kinds:

* the **service record** (``dkv:<svc>`` -> 8 bytes ``<epoch u32 |
  n_shards u32>``): the shard-map epoch, bumped by every migration;
* one **shard record** per shard (``dkv:<svc>:s<id>`` -> a 20-byte
  :class:`~repro_torch.core.meta.ShardRecord`): where the shard lives and how
  to reach it one-sided (table rkey, control rkey, n_buckets, epoch).

Client side mirrors the DCCache story: :class:`DirCache` caches resolved
routes and is invalidated on **node death** (via the module's death
hooks) and on **shard-map epoch bumps** (any cached record older than
the observed service epoch may describe a moved shard and is dropped —
re-resolution is one one-sided READ, so over-invalidation is cheap).
:class:`DirectoryClient` rides the module's pre-connected meta-server KV
client, so ``resolve_many`` batches ALL of a worker's shard lookups into
one doorbell (``KVClient.get_many``) — the microsecond-bootstrap path.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Generator, List, Optional, Sequence, Tuple

from ..core.meta import MetaServer, ShardRecord

_SVC_REC = struct.Struct("<II")            # epoch, n_shards


class DkvError(Exception):
    """dkv control-plane failure (unknown shard, migration stuck, ...)."""


def service_key(service: str) -> bytes:
    return f"dkv:{service}".encode()


def shard_key(service: str, shard_id: int) -> bytes:
    return f"dkv:{service}:s{shard_id}".encode()


def pack_service(epoch: int, n_shards: int) -> bytes:
    return _SVC_REC.pack(epoch, n_shards)


def unpack_service(raw: bytes) -> Tuple[int, int]:
    return _SVC_REC.unpack_from(bytes(raw), 0)


@dataclasses.dataclass(frozen=True)
class ShardRoute:
    """A resolved shard: its directory record plus the owner's node name
    (node_id -> name resolved once against the fabric)."""
    shard_id: int
    record: ShardRecord
    node: str

    @property
    def epoch(self) -> int:
        return self.record.epoch


class Directory:
    """Server/coordinator side: publishes directory records into the meta
    server's DrTM-KV (a control-plane write, like DCT registration)."""

    def __init__(self, meta: MetaServer, service: str):
        self.meta = meta
        self.service = service

    def publish_service(self, epoch: int, n_shards: int) -> None:
        self.meta.kv.put(service_key(self.service),
                         pack_service(epoch, n_shards))

    def publish_shard(self, shard_id: int, record: ShardRecord) -> None:
        self.meta.kv.put(shard_key(self.service, shard_id), record.pack())


class DirCache:
    """Client-local cache of resolved shard routes (the DCCache of the
    shard map). Stale entries are removed on node death and on shard-map
    epoch bumps; a stale entry that slips through is still harmless —
    the shard-state fence redirects the op and the caller invalidates."""

    def __init__(self) -> None:
        self._routes: Dict[int, ShardRoute] = {}
        self.epoch = 0
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def get(self, shard_id: int) -> Optional[ShardRoute]:
        route = self._routes.get(shard_id)
        if route is not None:
            self.hits += 1
        else:
            self.misses += 1
        return route

    def put(self, route: ShardRoute) -> None:
        # NOTE: a route's epoch must NOT advance self.epoch — that is the
        # OBSERVED service epoch (observe_epoch), and advancing it here
        # would turn a later observe_epoch(e) into a no-op while other
        # shards' stale routes are still cached
        self._routes[route.shard_id] = route

    def invalidate_shard(self, shard_id: int) -> None:
        if self._routes.pop(shard_id, None) is not None:
            self.invalidations += 1

    def invalidate_node(self, addr: str) -> int:
        """Node-death hook: drop every route through ``addr`` so no
        lookup is ever sent to a dead (or restarted) owner."""
        stale = [sid for sid, r in self._routes.items() if r.node == addr]
        for sid in stale:
            del self._routes[sid]
        self.invalidations += len(stale)
        return len(stale)

    def observe_epoch(self, epoch: int) -> int:
        """Shard-map epoch bump: drop every route older than the observed
        service epoch (it may describe a moved shard). Returns dropped
        count. Unmoved shards re-resolve to identical records — one
        one-sided READ each, the price of a coarse epoch."""
        if epoch <= self.epoch:
            return 0
        stale = [sid for sid, r in self._routes.items()
                 if r.epoch < epoch]
        for sid in stale:
            del self._routes[sid]
        self.invalidations += len(stale)
        self.epoch = epoch
        return len(stale)

    def memory_bytes(self) -> int:
        return len(self._routes) * 20


class DirectoryClient:
    """Worker-side resolver: one-sided directory READs over the module's
    pre-connected meta-server KV client, fronted by a :class:`DirCache`
    that the module's death hooks invalidate."""

    def __init__(self, module, service: str = "kv",
                 cache: Optional[DirCache] = None):
        self.module = module
        self.service = service
        self.cache = cache or DirCache()
        module.add_death_hook(self.cache.invalidate_node)
        self._id2name: Optional[Dict[int, str]] = None

    def _kv(self):
        client = self.module.meta_client()
        if client is None:
            raise DkvError("no live meta server")
        return client

    def node_name(self, node_id: int) -> str:
        if self._id2name is None:
            self._id2name = {n.id: name for name, n in
                             self.module.fabric.nodes.items()}
        try:
            return self._id2name[node_id]
        except KeyError:
            raise DkvError(f"unknown node id {node_id}") from None

    def service_info(self) -> Generator:
        """One one-sided READ: (epoch, n_shards). Observing the epoch
        invalidates cached routes older than it."""
        raw = yield from self._kv().lookup(service_key(self.service))
        if raw is None:
            raise DkvError(f"service {self.service!r} not published")
        epoch, n_shards = unpack_service(raw)
        self.cache.observe_epoch(epoch)
        return epoch, n_shards

    def resolve(self, shard_id: int) -> Generator:
        """shard id -> :class:`ShardRoute`; cache hit costs zero reads,
        a miss costs one one-sided READ at the meta server."""
        route = self.cache.get(shard_id)
        if route is not None:
            return route
        raw = yield from self._kv().lookup(shard_key(self.service,
                                                     shard_id))
        if raw is None:
            raise DkvError(f"shard {shard_id} not in directory")
        rec = ShardRecord.unpack(raw)
        route = ShardRoute(shard_id, rec, self.node_name(rec.node_id))
        self.cache.put(route)
        return route

    def resolve_many(self, shard_ids: Sequence[int]) -> Generator:
        """Batched resolution: every missing record's READ rides ONE
        planned doorbell (``KVClient.get_many``) — the bootstrap path:
        a new worker resolves its whole shard map in one crossing."""
        out: Dict[int, ShardRoute] = {}
        missing: List[int] = []
        for sid in shard_ids:
            route = self.cache.get(sid)
            if route is not None:
                out[sid] = route
            else:
                missing.append(sid)
        if missing:
            raws = yield from self._kv().get_many(
                [shard_key(self.service, sid) for sid in missing])
            for sid, raw in zip(missing, raws):
                if raw is None:
                    raise DkvError(f"shard {sid} not in directory")
                rec = ShardRecord.unpack(raw)
                route = ShardRoute(sid, rec, self.node_name(rec.node_id))
                self.cache.put(route)
                out[sid] = route
        return [out[sid] for sid in shard_ids]

    def invalidate(self, shard_id: int) -> None:
        self.cache.invalidate_shard(shard_id)
