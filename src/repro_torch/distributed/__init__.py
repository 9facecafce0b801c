"""Distribution pieces of the port: the sharding plans (``shardings.py``:
the reference's spec rules as data, and their DTensor placements), int8
gradient compression with error feedback and its all-reduce
(``compression.py``), and the GPipe pipeline over a mesh dimension
(``pipeline.py``: point-to-point hops, differentiable)."""

from .compression import (compressed_all_reduce, compressed_grad_tree,
                          dequantize_int8, ef_compress, ef_init,
                          quantize_int8)
from .pipeline import pipeline_apply, split_microbatches
from .shardings import (P, batch_specs, cache_specs, kv_shard_mode,
                        opt_state_specs, param_specs, to_placements)

__all__ = ["param_specs", "batch_specs", "cache_specs", "kv_shard_mode",
           "opt_state_specs", "P", "to_placements", "quantize_int8",
           "dequantize_int8", "ef_compress", "ef_init",
           "compressed_grad_tree", "compressed_all_reduce",
           "pipeline_apply", "split_microbatches"]
