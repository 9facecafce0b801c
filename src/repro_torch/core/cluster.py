"""Cluster bring-up helpers: build a fabric with meta servers + KRCORE on
every node, booted and ready (the state a production cluster idles in)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .costmodel import CostModel, DEFAULT
from .fabric import Fabric, Node
from .meta import MetaServer
from .module import KRCoreModule, install
from .sim import Environment


class Cluster:
    def __init__(self, fabric: Fabric, meta_servers: List[MetaServer],
                 modules: Dict[str, KRCoreModule]):
        self.fabric = fabric
        self.env = fabric.env
        self.meta_servers = meta_servers
        self.modules = modules

    def node(self, name: str) -> Node:
        return self.fabric.node(name)

    def module(self, name: str) -> KRCoreModule:
        return self.modules[name]


def make_cluster(n_nodes: int, n_meta: int = 1,
                 cm: CostModel = DEFAULT,
                 rc_cap: int = 32, n_dcqps: int = 1, n_pools: int = 1,
                 promote_threshold: int = 8,
                 node_prefix: str = "n") -> Cluster:
    """Build and boot an ``n_nodes`` cluster with ``n_meta`` meta servers.

    Boot happens at simulated time 0..boot_end; callers should treat
    ``env.now`` after this returns as the cluster's steady-state epoch
    (applications launched later never pay boot costs — the paper's core
    premise).
    """
    fabric = Fabric(cm)
    meta_nodes = [fabric.add_node(f"meta{i}") for i in range(n_meta)]
    meta_servers = [MetaServer(n) for n in meta_nodes]
    nodes = [fabric.add_node(f"{node_prefix}{i}") for i in range(n_nodes)]
    modules: Dict[str, KRCoreModule] = {}
    for node in nodes:
        modules[node.name] = install(
            node, meta_servers, n_pools=n_pools, n_dcqps=n_dcqps,
            rc_cap=rc_cap, promote_threshold=promote_threshold)
    # boot all modules concurrently (cluster cold start)
    procs = [fabric.env.process(m.boot(), f"boot.{name}")
             for name, m in modules.items()]
    fabric.env.run()
    for p in procs:
        assert p.triggered, "module boot did not complete"
    return Cluster(fabric, meta_servers, modules)
