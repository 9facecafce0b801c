"""Elastic runtime pieces of the port: the executable pool that serving
workers bootstrap from, and straggler mitigation (``StragglerPolicy``,
``speculative_map``). ``ElasticTrainer`` waits for the sharding plans of
ROADMAP Queue 1 item 9."""

from .runtime import (ExecutablePool, PoolEntry, StragglerPolicy,
                      speculative_map)

__all__ = ["ExecutablePool", "PoolEntry", "StragglerPolicy",
           "speculative_map"]
