"""Phi-3-mini 3.8B [arXiv:2404.14219].

32L, d=3072, 32 heads (GQA kv=32 = MHA), d_ff=8192, vocab 32064,
RoPE + SwiGLU, untied embeddings.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    rope_theta=10_000.0,
    tie_embeddings=False,
    grad_accum=2,
)

SMOKE = ModelConfig(
    name="phi3-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    tie_embeddings=False,
    q_chunk=64, kv_chunk=64, loss_chunk=32,
)

SKIP_SHAPES = {
    "long_500k": "pure full-attention arch; 512k attention is quadratic",
}
