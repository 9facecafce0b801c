"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434): the
counterpart of ``repro/models/mla.py``.

Keys and values are compressed into a per-token latent c_kv of rank
``kv_lora_rank`` plus one RoPE key of ``qk_rope_dim`` shared by the heads.
Train/prefill expand the latent into per-head K/V and call the shared
``attention`` (on the card: the flash-attention kernel, at the q/k head dim
nope + rope, with v zero-padded to it). Decode uses the absorbed form: the
K/V up-projections fold into the query and the output, so the cache holds
(kv_lora + rope) values a token whatever the head count. Decode is plain
PyTorch, as in JAX, and writes the new token's latents into the caches it
is given, in place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .attention import NEG_INF, attention
from .common import apply_rope, decode_positions, rms_norm, write_at


def _query(cfg, p, x, positions):
    """q_nope (B,S,H,nope) and roped q_rope (B,S,H,rope)."""
    h = cfg.n_heads
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    cq = rms_norm(torch.einsum("bsd,dr->bsr", x, p["q_a"]), p["q_norm"])
    q = torch.einsum("bsr,rhe->bshe", cq,
                     p["q_b"].reshape(cfg.q_lora_rank, h, nope + rope))
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope.transpose(1, 2), positions[:, None],
                        cfg.rope_theta).transpose(1, 2)
    return q_nope, q_rope


def mla_project_qkv(cfg, p, x, positions):
    """Naive expansion used by train/prefill.

    Returns q (B,H,S,nope+rope), k (B,H,S,nope+rope), v (B,H,S,v_dim) as
    head-transposed views, ckv (B,S,r) and k_rope (B,1,S,rope)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rope, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    q_nope, q_rope = _query(cfg, p, x, positions)
    # --- compressed kv ---
    ckv_full = torch.einsum("bsd,dr->bsr", x, p["kv_a"])
    ckv, k_rope = ckv_full[..., :r], ckv_full[..., r:]
    ckv = rms_norm(ckv, p["kv_norm"])
    k_rope = apply_rope(k_rope[:, None], positions[:, None],
                        cfg.rope_theta)                      # (B,1,S,rope)
    kv = torch.einsum("bsr,rhe->bshe", ckv,
                      p["kv_b"].reshape(r, h, nope + vdim))
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k_rope_bshe = k_rope.transpose(1, 2).expand(b, s, h, rope)
    k = torch.cat([k_nope, k_rope_bshe], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), ckv,
            k_rope)


def mla_attention_train(cfg, p, x, positions, *, impl=None,
                        return_cache=False):
    """Full-sequence MLA attention (naive expansion).

    return_cache: also return (ckv (B,S,r), k_rope (B,S,rope)), the
    compressed per-token latents that seed the absorbed decode cache."""
    q, k, v, ckv, k_rope = mla_project_qkv(cfg, p, x, positions)
    # pad v to the q/k head dim for the shared attention, then slice
    dqk = cfg.qk_nope_dim + cfg.qk_rope_dim
    vdim = cfg.v_head_dim
    vp = F.pad(v, (0, dqk - vdim)) if vdim < dqk else v
    out = attention(cfg, q, k, vp, causal=True, impl=impl)
    out = out[..., :vdim]                                  # (B,H,S,v)
    b, h, s, _ = out.shape
    out = out.transpose(1, 2).reshape(b, s, h * vdim)
    out = torch.einsum("bsf,fd->bsd", out, p["o"]).to(x.dtype)
    if return_cache:
        return out, (ckv, k_rope[:, 0])                    # krope (B,S,rope)
    return out


def mla_decode_step(cfg, p, x, ckv_cache, krope_cache, cur_len: int):
    """Absorbed decode. x: (B,1,d); caches ckv (B,Smax,kv_lora) and k_rope
    (B,Smax,rope), written in place at position cur_len - 1.
    Returns (out (B,1,d), ckv_cache, krope_cache)."""
    b = x.shape[0]
    h = cfg.n_heads
    nope, rope, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    pos = cur_len - 1
    positions = decode_positions(pos, b, x.device)
    q_nope, q_rope = _query(cfg, p, x, positions)           # (B,1,H,*)

    # new latent kv, inserted into the cache
    ckv_full = torch.einsum("bsd,dr->bsr", x, p["kv_a"])
    ckv_new = rms_norm(ckv_full[..., :r], p["kv_norm"])     # (B,1,r)
    krope_new = apply_rope(ckv_full[..., r:], positions,
                           cfg.rope_theta)                  # (B,1,rope)
    write_at(ckv_cache, 1, pos, ckv_new)
    write_at(krope_cache, 1, pos, krope_new)

    # absorb W_kv_b (its K part) into the query: q_lat (B,H,r)
    wkb = p["kv_b"].reshape(r, h, nope + vdim)
    wk, wv = wkb[..., :nope], wkb[..., nope:]
    q_lat = torch.einsum("bshe,rhe->bhr", q_nope, wk)

    # scores in float32, as JAX's preferred_element_type
    scale = 1.0 / math.sqrt(nope + rope)
    s_lat = torch.einsum("bhr,bkr->bhk", q_lat.float(),
                         ckv_cache.to(q_lat.dtype).float())
    s_rope = torch.einsum("bhse,bke->bhk", q_rope.transpose(1, 2).float(),
                          krope_cache.to(q_rope.dtype).float())
    s = (s_lat + s_rope) * scale                            # (B,H,Smax)
    kpos = torch.arange(ckv_cache.shape[1], device=x.device)
    s = torch.where(kpos[None, None, :] < cur_len, s, NEG_INF)
    pr = torch.softmax(s.float(), dim=-1)
    ctx = torch.einsum("bhk,bkr->bhr", pr.to(ckv_cache.dtype),
                       ckv_cache)                           # (B,H,r)
    out_h = torch.einsum("bhr,rhe->bhe", ctx, wv)           # (B,H,v)
    out = out_h.reshape(b, h * vdim)[:, None, :]            # (B,1,H*v)
    out = torch.einsum("bsf,fd->bsd", out, p["o"]).to(x.dtype)
    return out, ckv_cache, krope_cache
