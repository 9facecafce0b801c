"""DkvClient: the elastic compute worker's handle on the sharded KV.

The paper's Fig 10/11 bootstrap story, realized over the session API:

* :meth:`bootstrap` is the elastic-scaling critical path — ONE batched
  directory resolution (every shard record READ in one planned doorbell
  via ``KVClient.get_many``) plus one microsecond ``connect()`` per
  distinct memory node. A fresh worker attaches to the whole shard map
  in tens of microseconds; the verbs-style cold-connect baseline pays
  driver init + per-connection QP bring-up (~16 ms) before its first
  lookup.
* :meth:`get` / :meth:`put` route by ``shard_of_key`` through the
  :class:`~repro_torch.dkv.directory.DirCache` and execute the FENCED one-
  sided protocols of :class:`~repro_torch.kvs.race.ShardClient`. A redirect
  (shard frozen/moved under us) invalidates the cached route,
  re-resolves the directory, and retries at the new owner — lookups stay
  torn-read-safe across a live migration (version fence) and writes are
  re-applied idempotently when they race the freeze.

Sessions are per memory NODE, shared by every shard the node hosts
(multi-table, one connection) and by every retry epoch.
"""

from __future__ import annotations

from typing import Dict, Generator, Optional, Tuple

from ..core.session import Session, SessionError, connect
from ..kvs.race import ShardClient, shard_of_key

from .directory import DirCache, DirectoryClient, DkvError, ShardRoute


class DkvClient:
    """One elastic worker's client: directory cache + per-node sessions
    + per-shard fenced RACE clients."""

    #: redirect retry budget: a migration publish races the redirect by
    #: microseconds, so a handful of re-resolutions always converges
    MAX_REDIRECTS = 64

    def __init__(self, module, service: str = "kv",
                 cache: Optional[DirCache] = None,
                 pool_bytes: int = 32 * 1024):
        self.module = module
        self.env = module.env
        self.pool_bytes = pool_bytes
        self.dir = DirectoryClient(module, service, cache)
        self.n_shards: Optional[int] = None
        self._sessions: Dict[str, Session] = {}
        #: (shard, epoch) -> ShardClient; epochs key the cache so a
        #: post-migration route never reuses a stale-geometry client
        self._shards: Dict[Tuple[int, int], ShardClient] = {}
        self.bootstrap_us: Optional[float] = None
        self.stat_redirects = 0

    # ----------------------------------------------------------- plumbing
    def _session(self, node: str) -> Generator:
        sess = self._sessions.get(node)
        if sess is None or sess.closed:
            sess = yield from connect(self.module, node,
                                      pool_bytes=self.pool_bytes)
            self._sessions[node] = sess
        return sess

    def _shard_client(self, route: ShardRoute) -> Generator:
        key = (route.shard_id, route.epoch)
        sc = self._shards.get(key)
        if sc is None:
            sess = yield from self._session(route.node)
            rec = route.record
            sc = ShardClient(sess, rec.n_buckets, rec.table_rkey,
                             rec.ctl_rkey, rec.epoch)
            self._shards[key] = sc
        return sc

    def shard_of(self, key: int) -> int:
        if self.n_shards is None:
            raise DkvError("bootstrap() first")
        return shard_of_key(key, self.n_shards)

    def _op_failed(self, route: ShardRoute) -> None:
        """A fenced op on ``route`` raised SessionError: drop the cached
        session (it may be errored) and its shard clients. Declare node
        death — which invalidates MODULE-wide caches and fires every
        death hook — only when the node really is dead: a SessionError
        scoped to one flush must not nuke a live node's state."""
        sess = self._sessions.pop(route.node, None)
        if sess is not None:
            self._shards = {k: sc for k, sc in self._shards.items()
                            if sc.session is not sess}
            if not sess.closed:
                sess.close()
        if not self.module.fabric.node(route.node).alive:
            self.module.on_node_death(route.node)

    # ---------------------------------------------------------- bootstrap
    def bootstrap(self) -> Generator:
        """Attach to every shard: service record READ + ONE batched
        directory doorbell + a microsecond connect() per memory node.
        Returns the attach latency in us (also kept on
        ``self.bootstrap_us``)."""
        t0 = self.env.now
        _epoch, self.n_shards = yield from self.dir.service_info()
        routes = yield from self.dir.resolve_many(range(self.n_shards))
        for route in routes:
            yield from self._shard_client(route)
        self.bootstrap_us = self.env.now - t0
        return self.bootstrap_us

    # ------------------------------------------------------------ data ops
    def get(self, key: int) -> Generator:
        """Fenced lookup; returns value bytes or None. Redirects (live
        migration) re-resolve and retry transparently."""
        for attempt in range(self.MAX_REDIRECTS):
            route = yield from self.dir.resolve(self.shard_of(key))
            sc = yield from self._shard_client(route)
            try:
                status, val = yield from sc.lookup_fenced(key)
            except SessionError:
                # op-scoped failure or owner death: drop the session,
                # declare death only if the node is really gone, retry
                self._op_failed(route)
                status, val = "redirect", None
            if status == "ok":
                return val
            self.stat_redirects += 1
            self.dir.invalidate(route.shard_id)
            # a migration's publish step races this redirect by us-scale;
            # back off one beat before re-resolving
            yield self.env.timeout(1.0)
        raise DkvError(f"get({key}): no serving owner after "
                       f"{self.MAX_REDIRECTS} redirects")

    def put(self, key: int, value: bytes) -> Generator:
        """Fenced one-sided insert (CAS-claim + WRITE + FAA publish).
        A write racing a migration freeze reports redirect and is
        re-applied at the new owner — idempotent, so the copy either
        carried it or the retry lands it."""
        for attempt in range(self.MAX_REDIRECTS):
            route = yield from self.dir.resolve(self.shard_of(key))
            sc = yield from self._shard_client(route)
            try:
                status, off = yield from sc.insert_fenced(key, value)
            except SessionError:
                self._op_failed(route)
                status, off = "redirect", None
            if status == "ok":
                return off
            self.stat_redirects += 1
            self.dir.invalidate(route.shard_id)
            yield self.env.timeout(1.0)
        raise DkvError(f"put({key}): no serving owner after "
                       f"{self.MAX_REDIRECTS} redirects")

    def get_many(self, keys) -> Generator:
        """Convenience loop over :meth:`get` (per-shard doorbell batching
        happens inside each fenced lookup)."""
        out = []
        for k in keys:
            out.append((yield from self.get(k)))
        return out

    def close(self) -> None:
        for sess in self._sessions.values():
            sess.close()
        self._sessions.clear()
        self._shards.clear()
