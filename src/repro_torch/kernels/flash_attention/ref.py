"""Plain PyTorch version of the flash-attention kernel: dense GQA attention
with window, softcap and ``kv_len`` masks (the counterpart of
``repro/kernels/flash_attention/ref.py``). The CPU tests use it, and
``chip_smoke.py`` holds the kernel against it on the card."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=None, cap=None,
                        kv_len=None, q0: int = 0):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D); query i
    sits at position q0 + i."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, sq, d)
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    qpos = q0 + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    keep = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        keep &= kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    if kv_len is not None:
        keep &= kpos < kv_len
    s = torch.where(keep[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype), v)
    return o.reshape(b, hq, sq, d)
