"""Zamba2-1.2B [arXiv:2411.15242; hf:Zyphra/Zamba2-1.2B].

38 Mamba-2 layers (d=2048, d_inner=4096, ssm_state=64) with ONE shared
transformer block (32 heads, d_ff=8192) invoked every 6 layers (6 shared
applications + 2 tail mamba layers). Deviation noted in DESIGN.md: the
per-invocation LoRA adapters and embedding-concat of the original are
omitted; the shared block reuses identical weights at every invocation.
SSM decode state is O(1) -> runs the long_500k cell.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    ssm="mamba2",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    attn_every=6,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    ssm="mamba2",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    ssm_state=16,
    attn_every=2,
    tie_embeddings=True,
    q_chunk=64, kv_chunk=64, loss_chunk=32,
)

SKIP_SHAPES = {}
