"""Elastic runtime pieces of the port: the executable pool that serving
workers bootstrap from. ``ElasticTrainer``, ``StragglerPolicy`` and
``speculative_map`` wait for the mesh slice (ROADMAP Queue 1 item 8)."""

from .runtime import ExecutablePool, PoolEntry

__all__ = ["ExecutablePool", "PoolEntry"]
