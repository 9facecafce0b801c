"""OLMo-1B [arXiv:2402.00838; hf:allenai/OLMo-1B].

16L, d=2048, 16 heads (MHA), d_ff=8192, vocab 50304, NON-PARAMETRIC
LayerNorm (no learnable scale/bias), tied embeddings, SwiGLU.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    norm="nonparam",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="olmo-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    norm="nonparam",
    tie_embeddings=True,
    q_chunk=64, kv_chunk=64, loss_chunk=32,
)

SKIP_SHAPES = {
    "long_500k": "pure full-attention arch; 512k attention is quadratic",
}
