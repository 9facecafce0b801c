"""Elastic disaggregated KV service on the KRCore control plane.

The paper's §6 elasticity result (83% faster RACE worker bootstrap under
load spikes) as a subsystem: sharded RACE stores on memory nodes, an
epoch-numbered shard directory in the MetaServer's DrTM-KV (one
one-sided READ per resolution, DCCache-style client caching), elastic
worker bootstrap over microsecond sessions, live resharding with
CAS/FAA fences, and a worker-pull autoscaler.

The port's own copy of ``repro.dkv``: numpy over ``repro_torch.core``,
with the same simulated microseconds, counters and records. Module map
(``src/repro/dkv/README.md`` has the wire formats + protocol):

  directory.py   ShardRecord routing: Directory (publish), DirCache
                 (client cache: death-hook + epoch-bump invalidation),
                 DirectoryClient (batched one-sided resolution)
  service.py     DkvService — shard placement, seeding, live migration
                 (freeze -> copy/quiesce -> cut over -> publish)
  client.py      DkvClient — microsecond bootstrap (one directory
                 doorbell + connect per node), fenced get/put with
                 transparent redirect across migrations
  autoscaler.py  PullQueue / PullWorker / WorkerPullAutoscaler — the
                 Fn worker-pull scaling model (also drives the
                 serverless gateway's pull mode)
"""

from .autoscaler import (PullQueue, PullWorker, ScaleEvent,
                         WorkerPullAutoscaler)
from .client import DkvClient
from .directory import (DirCache, Directory, DirectoryClient, DkvError,
                        ShardRoute, service_key, shard_key)
from .service import DkvService, MigrationReport

__all__ = [
    "PullQueue", "PullWorker", "ScaleEvent", "WorkerPullAutoscaler",
    "DkvClient", "DirCache", "Directory", "DirectoryClient", "DkvError",
    "ShardRoute", "service_key", "shard_key", "DkvService",
    "MigrationReport",
]
