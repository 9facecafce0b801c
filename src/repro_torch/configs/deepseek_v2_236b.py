"""DeepSeek-V2 236B [arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2].

60L, d=5120, 128 heads with MLA (q_lora 1536, kv_lora 512, qk_nope 128,
qk_rope 64, v_head 128), vocab 102400; MoE: 160 routed experts top-6 +
2 shared, expert d_ff=1536; first layer dense (d_ff 12288). ~236B total /
~21B active. MLA decode caches only (kv_lora+rope)=576 dims per token.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,                 # routed-expert width (assigned spec)
    vocab=102_400,
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=160,
    top_k=6,
    d_expert=1536,
    n_shared_experts=2,
    first_k_dense=1,
    tie_embeddings=False,
    fsdp=True,          # 236B: weights+optimizer must shard over "data" too
    router_blocked_cumsum=True,   # §Perf A1
    donate=True,                  # §Perf C3
    grad_accum=8,
)

SMOKE = ModelConfig(
    name="deepseek-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=64,
    vocab=256,
    mla=True,
    q_lora_rank=32,
    kv_lora_rank=32,
    qk_nope_dim=16,
    qk_rope_dim=8,
    v_head_dim=16,
    n_experts=4,
    top_k=2,
    d_expert=64,
    n_shared_experts=1,
    first_k_dense=1,
    tie_embeddings=False,
    q_chunk=64, kv_chunk=64, loss_chunk=32,
)

SKIP_SHAPES = {
    "long_500k": "full-attention (MLA is a cache compression, attention is "
                 "still quadratic in sequence length)",
}
