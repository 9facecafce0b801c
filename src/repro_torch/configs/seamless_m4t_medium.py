"""SeamlessM4T-medium text backbone [arXiv:2308.11596; hf:facebook/seamless-m4t-medium].

Encoder-decoder, 12+12L, d=1024, 16 heads (MHA), d_ff=4096, vocab 256206.
The speech/audio frontend (w2v-BERT conformer) is a STUB: input_specs
provides precomputed frame embeddings (B, S_enc, 1024).

Shape conventions (see DESIGN.md): train/prefill split seq_len as
enc_len = dec_len = seq_len/2; decode cells use a 4096-frame encoder
memory and a decoder-side KV cache of seq_len.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=24,
    enc_layers=12,
    dec_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256_206,
    frontend="audio",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="seamless-smoke",
    family="encdec",
    n_layers=4,
    enc_layers=2,
    dec_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    frontend="audio",
    tie_embeddings=True,
    q_chunk=64, kv_chunk=64, loss_chunk=32,
)

SKIP_SHAPES = {
    "long_500k": "full-attention encoder-decoder; 512k attention is "
                 "quadratic",
}
