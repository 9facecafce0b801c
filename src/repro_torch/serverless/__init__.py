"""Fn-style serverless runtime on the KRCore control plane (paper §5.3.2):
the port's copy of ``repro.serverless``.

  registry.py   FunctionDef / FunctionRegistry — the deployable catalog
  container.py  warm/cold sandboxes with background prewarm
  gateway.py    open-loop trace admission + least-outstanding placement,
                closed-loop responses, worker-pull autoscaling
  chain.py      A->B->C pipelines; staged slab hops whose pack and unpack
                run the CUDA chunk-gather kernel, vs. the VerbsProcess /
                LiteKernel baselines; mid-chain failover
  traces.py     synthetic Poisson / spike / diurnal arrival processes

The gateway and the traces are numpy over the simulated fabric and launch
no kernel; the chain hop's gathers are the one device path here.
"""

from .chain import (ChainReport, ChainRunner, HopStat, StageStat,
                    decode_slab, encode_slab, expected_outputs,
                    slab_capacity_bytes)
from .container import Container, ContainerPool, LeaseStats
from .gateway import (InvocationGateway, InvocationRecord,
                      LeastOutstandingScheduler)
from .registry import FunctionDef, FunctionRegistry, default_registry
from .traces import diurnal_trace, poisson_trace, spike_trace

__all__ = [
    "ChainReport", "ChainRunner", "HopStat", "StageStat", "decode_slab",
    "encode_slab", "expected_outputs", "slab_capacity_bytes", "Container",
    "ContainerPool", "LeaseStats", "InvocationGateway", "InvocationRecord",
    "LeastOutstandingScheduler", "FunctionDef", "FunctionRegistry",
    "default_registry", "diurnal_trace", "poisson_trace", "spike_trace",
]
