"""Distribution pieces of the port. So far: int8 gradient compression with
error feedback and its all-reduce (``compression.py``). The sharding plans
and the pipeline wait for ROADMAP Queue 1 item 9."""

from .compression import (compressed_all_reduce, compressed_grad_tree,
                          dequantize_int8, ef_compress, ef_init,
                          quantize_int8)

__all__ = ["quantize_int8", "dequantize_int8", "ef_compress", "ef_init",
           "compressed_grad_tree", "compressed_all_reduce"]
