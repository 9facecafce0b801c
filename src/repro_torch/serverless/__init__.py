"""Fn-style serverless runtime on the KRCore control plane (paper §5.3.2):
the port's copy of ``repro.serverless``, so far its chain hop.

  registry.py   FunctionDef / FunctionRegistry — the deployable catalog
  container.py  warm/cold sandboxes with background prewarm
  chain.py      A->B->C pipelines; staged slab hops whose pack and unpack
                run the CUDA chunk-gather kernel, vs. the VerbsProcess /
                LiteKernel baselines; mid-chain failover

The reference's ``gateway.py`` and ``traces.py`` are not ported yet.
"""

from .chain import (ChainReport, ChainRunner, HopStat, StageStat,
                    decode_slab, encode_slab, expected_outputs,
                    slab_capacity_bytes)
from .container import Container, ContainerPool, LeaseStats
from .registry import FunctionDef, FunctionRegistry, default_registry

__all__ = [
    "ChainReport", "ChainRunner", "HopStat", "StageStat", "decode_slab",
    "encode_slab", "expected_outputs", "slab_capacity_bytes", "Container",
    "ContainerPool", "LeaseStats", "FunctionDef", "FunctionRegistry",
    "default_registry",
]
