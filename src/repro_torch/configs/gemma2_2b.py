"""Gemma-2 2B [arXiv:2408.00118; hf:google/gemma-2-2b].

26L, d=2304, 8 heads (head_dim 256), GQA kv=4, d_ff=9216 (GeGLU),
vocab 256000; alternating local(4096-window)/global attention; attention
logit softcap 50, final logit softcap 30; sandwich (post) norms; tied
embeddings scaled by sqrt(d_model).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=9216,
    vocab=256_000,
    act="gelu",
    attn_softcap=50.0,
    logit_softcap=30.0,
    sliding_window=4096,
    layer_pattern="local_global",
    post_norms=True,
    tie_embeddings=True,
    embed_scale=True,
)

SMOKE = ModelConfig(
    name="gemma2-smoke",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=256,
    act="gelu",
    attn_softcap=50.0,
    logit_softcap=30.0,
    sliding_window=32,
    layer_pattern="local_global",
    post_norms=True,
    tie_embeddings=True,
    embed_scale=True,
    q_chunk=64, kv_chunk=64, loss_chunk=32,
)

SKIP_SHAPES = {
    "long_500k": "alternating local/global: the global layers are full "
                 "attention -> not sub-quadratic overall",
}
