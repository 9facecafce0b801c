"""RWKV-6 "Finch" 7B [arXiv:2404.05892; hf:RWKV/rwkv-6-world-7b].

32L, d=4096, attention-free (64 heads of 64 for the WKV state),
channel-mix d_ff=14336, vocab 65536. Data-dependent decay. Decode state is
O(1) in sequence length -> runs the long_500k cell.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    ssm="rwkv6",
    n_layers=32,
    d_model=4096,
    n_heads=64,              # head size 64
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    tie_embeddings=False,
    grad_accum=2,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke",
    family="ssm",
    ssm="rwkv6",
    n_layers=2,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    tie_embeddings=False,
    q_chunk=64, kv_chunk=64, loss_chunk=32,
)

SKIP_SHAPES = {}
