"""Model + shape configuration schema for all assigned architectures
(copy of ``repro/models/config.py``; ``param_dtype`` is a ``torch.dtype``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    #: dense | moe | ssm | hybrid | encdec
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                      # 0 -> d_model // n_heads

    # ---- attention details ----
    rope_theta: float = 10_000.0
    qkv_bias: bool = False               # qwen2
    attn_softcap: Optional[float] = None  # gemma2: 50.0
    logit_softcap: Optional[float] = None  # gemma2: 30.0
    sliding_window: Optional[int] = None  # window size for local layers
    #: "global" (all layers full attn) | "local_global" (alternating, gemma2)
    layer_pattern: str = "global"
    norm: str = "rms"                    # rms | nonparam (olmo) | ln
    act: str = "silu"                    # silu | gelu
    post_norms: bool = False             # gemma2 sandwich norms
    tie_embeddings: bool = True
    embed_scale: bool = False            # gemma-style sqrt(d_model) scaling

    # ---- MoE ----
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0                    # per-expert FFN width
    n_shared_experts: int = 0            # deepseek-v2: 2
    first_k_dense: int = 0               # deepseek-v2: 1 dense first layer
    capacity_factor: float = 1.25

    # ---- MLA (deepseek-v2) ----
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # ---- SSM ----
    ssm: Optional[str] = None            # "rwkv6" | "mamba2"
    ssm_state: int = 64                  # mamba2 d_state / rwkv6 head size
    d_inner: int = 0                     # mamba2 expansion (0 -> 2*d_model)
    conv_kernel: int = 4
    attn_every: int = 0                  # zamba2: shared attn period

    # ---- encoder-decoder ----
    enc_layers: int = 0
    dec_layers: int = 0

    # ---- modality frontend (STUB: precomputed embeddings) ----
    frontend: Optional[str] = None       # "vision" | "audio"
    n_frontend_tokens: int = 0           # e.g. llava anyres: 5 tiles x 576

    # ---- compute knobs (not architecture) ----
    moe_impl: str = "gather"             # gather | einsum (small oracle)
    router_blocked_cumsum: bool = False  # two-level routing scan (§Perf A)
    moe_ep_data: bool = False            # experts over "data" too (§Perf C)
    donate: bool = False                 # donate cache/opt buffers (§Perf C)
    moe_shard_hints: bool = False        # EP dispatch constraints (§Perf A)
    seq_shard: bool = False              # sequence-sharded residual (§Perf B)
    grad_accum: int = 1                  # microbatches per train step
    fsdp: bool = False                   # also shard weights over "data"
    dtype: str = "bfloat16"
    remat: str = "block"                 # none | block | dots
    attn_impl: str = "scan_kv"           # scan_kv | tri_unroll | dense
    q_chunk: int = 1024
    kv_chunk: int = 1024
    loss_chunk: int = 512
    scan_layers: bool = True

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.ssm == "mamba2" and self.d_inner == 0:
            object.__setattr__(self, "d_inner", 2 * self.d_model)

    @property
    def param_dtype(self) -> torch.dtype:
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        return dt

    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"

    @property
    def group_size(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def n_params(self) -> int:
        """Approximate parameter count (used for MODEL_FLOPS and sanity)."""
        from . import params as _p
        return _p.count_params_config(self)

    def n_active_params(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        from . import params as _p
        return _p.count_params_config(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                            # train | prefill | decode


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}
