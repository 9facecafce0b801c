"""Attention: GQA with RoPE, sliding window, logit softcap (the counterpart
of ``repro/models/attention.py``).

Shapes: q (B, Hq, Sq, D); k/v (B, Hkv, Skv, D). GQA groups Hq into Hkv
groups of ``G = Hq // Hkv``.

``attention`` calls the flash-attention op for every full-sequence call,
whatever ``cfg.attn_impl`` names: JAX's ``dense``, ``scan_kv`` and
``tri_unroll`` compute the same function and differ only in how XLA
schedules it, which the hand-written kernel decides for itself. The op
launches the CUDA kernel on a CUDA tensor and runs its plain dense version
on a CPU tensor, the same function as ``dense_attention`` (the oracle). ``scan_kv_attention`` and
``tri_unroll_attention`` are therefore not ported. ``decode_attention``
(one query against the cache) is plain PyTorch: JAX has no kernel for it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels.flash_attention import ops as flash_ops
from .common import softcap

NEG_INF = -1e30
IMPLS = ("scan_kv", "tri_unroll", "dense")


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: Optional[int], kv_len=None) -> torch.Tensor:
    """Boolean keep-mask of shape (Sq, Skv)."""
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        m &= kpos[None, :] > (qpos[:, None] - window)
    if kv_len is not None:
        m &= kpos[None, :] < kv_len
    return m


def _sdpa(q, k, v, qpos, kpos, *, causal, window, cap, kv_len=None):
    """Dense scaled-dot-product attention; q: (B, Hkv, G, Sq, D),
    k/v: (B, Hkv, Skv, D). Scores and softmax in float32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.float(), k.float()) * scale
    s = softcap(s, cap)
    keep = _mask(qpos, kpos, causal, window, kv_len)
    s = torch.where(keep[None, None, None], s, NEG_INF)
    p = torch.softmax(s.float(), dim=-1)
    return torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype), v)


def dense_attention(q, k, v, *, causal=True, window=None, cap=None,
                    q0: int = 0, kv_len=None):
    """q: (B,Hq,Sq,D), k/v: (B,Hkv,Skv,D) -> (B,Hq,Sq,D)."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, sq, d)
    qpos = q0 + torch.arange(sq, device=q.device)
    kpos = torch.arange(k.shape[2], device=q.device)
    out = _sdpa(qg, k, v, qpos, kpos, causal=causal, window=window, cap=cap,
                kv_len=kv_len)
    return out.reshape(b, hq, sq, d)


def attention(cfg, q, k, v, *, causal=True, window=None, cap=None,
              q0: int = 0, impl: Optional[str] = None):
    """Full-sequence attention: the CUDA kernel on the card, the dense plain
    version on the CPU. Any Sq and Skv."""
    impl = impl or cfg.attn_impl
    if impl not in IMPLS:
        raise ValueError(f"unknown attn impl {impl}")
    return flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                     cap=cap, q0=q0)


def decode_attention(q, kcache, vcache, cur_len, *, window=None, cap=None):
    """Single-token decode: q (B,Hq,1,D) vs cache (B,Hkv,Smax,D).

    ``cur_len``: number of valid cache entries (the new token's position is
    cur_len-1 after insertion). Memory-bound by design.
    """
    b, hq, _, d = q.shape
    hkv, smax = kcache.shape[1], kcache.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, 1, d)
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), kcache.float()) * scale
    s = softcap(s, cap)
    kpos = torch.arange(smax, device=q.device)
    keep = kpos[None] < cur_len                     # (1, Smax)
    if window is not None:
        keep = keep & (kpos[None] > cur_len - 1 - window)
    s = torch.where(keep[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s.float(), dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p.to(vcache.dtype), vcache)
    return out.reshape(b, hq, 1, d)
