"""llava-next (llava-v1.6) with Mistral-7B backbone.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]

Backbone: Mistral-7B-Instruct-v0.2 (32L, d=4096, 32 heads, GQA kv=8,
d_ff=14336, vocab 32000, rope_theta=1e6, NO sliding window in v0.2).
The anyres vision tower (CLIP-ViT-L/336 + 2x2 tile grid) is a STUB:
input_specs provides precomputed patch embeddings (B, 2880, 1024)
(= 5 tiles x 576 patches), projected by a learned mm_proj.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    frontend="vision",
    n_frontend_tokens=2880,
    grad_accum=4,
    seq_shard=True,      # §Perf B1
    remat="dots",        # §Perf B2
)

SMOKE = ModelConfig(
    name="llava-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    tie_embeddings=False,
    frontend="vision",
    n_frontend_tokens=8,
    q_chunk=64, kv_chunk=64, loss_chunk=32,
)

SKIP_SHAPES = {
    "long_500k": "pure full-attention backbone (Mistral v0.2 disables the "
                 "sliding window); 512k full attention is quadratic",
}
