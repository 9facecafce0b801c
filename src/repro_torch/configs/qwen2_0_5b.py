"""Qwen2-0.5B [arXiv:2407.10671; hf:Qwen/Qwen2-0.5B].

24L, d=896, 14 heads, GQA kv=2, d_ff=4864, vocab 151936, QKV bias,
tied embeddings, rope_theta=1e6.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151_936,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen2-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    qkv_bias=True,
    tie_embeddings=True,
    q_chunk=64, kv_chunk=64, loss_chunk=32,
)

SKIP_SHAPES = {
    "long_500k": "pure full-attention arch; 512k attention is quadratic",
}
