"""KRCORE core library: the paper's contribution (control plane + virtualized
queues over a hybrid DC/RC pool), implemented against a simulated RDMA fabric
with the paper's measured cost constants.

The port's own copy of ``repro.core``: the same modules, names and
behaviour, numpy only (a simulated fabric, not device code). The simulation
is deterministic and gives the same simulated microseconds as the
reference. ``legacy.py`` (the deprecated raw ``sys_q*`` helpers) is not
copied.

Layer map:
  sim.py        discrete-event engine
  costmodel.py  measured microsecond constants (each cites its figure/table)
  fabric.py     nodes, NICs, registered memory, raw transfers (moves bytes)
  qp.py         RC/DC/UD queue pairs, hardware-faithful queue accounting
  meta.py       DrTM-KV, MetaServer, DCCache, ValidMR/MRStore
  pool.py       per-CPU hybrid QP pools, LRU promotion state
  virtqueue.py  the virtualized queue abstraction + wr_id encoding
  module.py     the per-node 'kernel module': Table-1 syscalls, Alg. 1+2,
                zero-copy protocol, DC<->RC transfer protocol
  plan.py       the op planner: doorbell/CQE budgeting for batched pushes
  session.py    the application-facing API: Session / Future / BufferPool
                / Listener over the queue syscalls (API reference:
                ``src/repro/core/README.md``)
  baselines.py  Verbs / LITE comparison targets
  cluster.py    bring-up helpers
"""

from .costmodel import CostModel, DEFAULT, validate
from .sim import Broadcast, Environment, Resource, Store
from .fabric import Fabric, MemoryRegion, MRError, Node
from .qp import (QP, Completion, QPError, QPState, QPType, RecvBuffer,
                 WorkRequest, connect_rc_pair)
from .meta import (DCCache, DCTMeta, DrTMKV, KVClient, MetaServer, MRStore,
                   ShardRecord, ValidMRStore)
from .pool import HybridQPPool
from .virtqueue import (CompEntry, PolledMsg, VirtQueue, decode_wr_id,
                        encode_wr_id)
from .module import KRCoreError, KRCoreModule, install
from .plan import BatchPlan, plan_batch
from .session import (BufferPool, CallTimeout, Cancelled, Future, Lease,
                      Listener, Message, Session, SessionError, connect,
                      from_qd, listen, raw_session)
from .baselines import LiteKernel, VerbsProcess
from .cluster import Cluster, make_cluster

__all__ = [
    "CostModel", "DEFAULT", "validate", "Broadcast", "Environment",
    "Resource", "Store", "Fabric", "MemoryRegion", "MRError", "Node", "QP",
    "Completion", "QPError", "QPState", "QPType", "RecvBuffer",
    "WorkRequest", "connect_rc_pair", "DCCache", "DCTMeta", "DrTMKV",
    "KVClient", "MetaServer", "MRStore", "ShardRecord", "ValidMRStore",
    "HybridQPPool",
    "CompEntry", "PolledMsg", "VirtQueue", "decode_wr_id", "encode_wr_id",
    "KRCoreError", "KRCoreModule", "install", "BatchPlan", "plan_batch",
    "BufferPool", "CallTimeout", "Cancelled", "Future", "Lease", "Listener",
    "Message", "Session", "SessionError", "connect", "from_qd", "listen",
    "raw_session", "LiteKernel", "VerbsProcess", "Cluster", "make_cluster",
]
