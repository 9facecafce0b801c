"""OLMoE-1B-7B [arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924].

16L, d=2048, 16 heads (MHA), vocab 50304; every FFN is MoE: 64 experts,
top-8, expert d_ff=1024. ~7B total / ~1.3B active params.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    n_experts=64,
    top_k=8,
    d_expert=1024,
    tie_embeddings=False,
    router_blocked_cumsum=True,   # §Perf A1
)

SMOKE = ModelConfig(
    name="olmoe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=64,
    vocab=256,
    n_experts=4,
    top_k=2,
    d_expert=64,
    tie_embeddings=False,
    q_chunk=64, kv_chunk=64, loss_chunk=32,
)

SKIP_SHAPES = {
    "long_500k": "pure full-attention arch; 512k attention is quadratic",
}
