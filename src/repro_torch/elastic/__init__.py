"""Elastic runtime of the port: the executable pool that serving workers
bootstrap from, ``ElasticTrainer`` (data parallel over a mesh of the first
n ranks, rescaled through the pool), and straggler mitigation
(``StragglerPolicy``, ``speculative_map``)."""

from .runtime import (ElasticTrainer, ExecutablePool, PoolEntry,
                      StragglerPolicy, speculative_map)

__all__ = ["ExecutablePool", "ElasticTrainer", "PoolEntry",
           "StragglerPolicy", "speculative_map"]
