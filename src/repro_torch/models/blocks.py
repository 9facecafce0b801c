"""Layer application per family (the counterpart of
``repro/models/blocks.py``).

Every full-sequence layer fn has the signature
    fn(cfg, p_layer, x, ...) -> (x, cache_entry[, aux])
and every decode layer fn
    fn(cfg, p_layer, x, cache_entry...) -> (x, new_cache_entry...)
so ``model.py`` drives them with a Python loop over the stacked layer axis
(JAX's ``lax.scan``). JAX's remat wrappers have no counterpart: the port
serves, it does not train.

MLA, MoE, Mamba-2 and cross-attention layers wait for their modules
(ROADMAP Queue 1 item 6); ``model.py`` raises ``NotImplementedError`` for
their families.
"""

from __future__ import annotations

import torch

from .attention import attention, decode_attention
from .common import act_fn, apply_norm, apply_rope
from .rwkv6 import channel_mix, time_mix


# ------------------------------------------------------------- primitives
def _norm(cfg, p, key, x):
    return apply_norm(cfg, x, p.get(key))


def qkv_project(cfg, p, x, positions):
    """x (B,S,d), positions (B,S) -> q (B,Hq,S,hd), k/v (B,Hkv,S,hd), each a
    head-transposed view."""
    b, s, d = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = torch.einsum("bsd,de->bse", x, p["wq"])
    k = torch.einsum("bsd,de->bse", x, p["wk"])
    v = torch.einsum("bsd,de->bse", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, hq, hd).transpose(1, 2)
    k = k.reshape(b, s, hkv, hd).transpose(1, 2)
    v = v.reshape(b, s, hkv, hd).transpose(1, 2)
    q = apply_rope(q, positions[:, None], cfg.rope_theta)
    k = apply_rope(k, positions[:, None], cfg.rope_theta)
    return q, k, v


def attn_out(cfg, p, o):
    b, h, s, hd = o.shape
    o = o.transpose(1, 2).reshape(b, s, h * hd)
    return torch.einsum("bse,ed->bsd", o, p["wo"])


def self_attention_full(cfg, p, x, positions, window, *, causal=True):
    q, k, v = qkv_project(cfg, p, x, positions)
    o = attention(cfg, q, k, v, causal=causal, window=window,
                  cap=cfg.attn_softcap)
    return attn_out(cfg, p, o), (k, v)


def self_attention_decode(cfg, p, x, kcache, vcache, cur_len: int, window):
    """x: (B,1,d); caches (B,Hkv,Smax,hd). Inserts then attends.

    The insert writes the new k and v into ``kcache`` / ``vcache`` in place
    (JAX's ``dynamic_update_slice`` returns a new buffer); the caches are
    returned all the same."""
    b = x.shape[0]
    positions = torch.full((b, 1), cur_len, device=x.device)
    q, k, v = qkv_project(cfg, p, x, positions)
    kcache[:, :, cur_len:cur_len + 1] = k.to(kcache.dtype)
    vcache[:, :, cur_len:cur_len + 1] = v.to(vcache.dtype)
    o = decode_attention(q, kcache, vcache, cur_len + 1, window=window,
                         cap=cfg.attn_softcap)
    return attn_out(cfg, p, o), kcache, vcache


def mlp(cfg, p, x):
    a = act_fn(cfg.act)
    h = a(torch.einsum("bsd,df->bsf", x, p["wg"])) \
        * torch.einsum("bsd,df->bsf", x, p["wu"])
    return torch.einsum("bsf,fd->bsd", h, p["wd"])


# --------------------------------------------------------- residual layers
def dense_layer_full(cfg, p, x, positions, window, *, causal=True,
                     ffn: str = "mlp"):
    """Pre-norm transformer layer; gemma2 adds post (sandwich) norms."""
    if ffn != "mlp":
        raise NotImplementedError("MoE FFN layers wait for the moe module "
                                  "(ROADMAP Queue 1 item 6)")
    h = _norm(cfg, p, "ln1", x)
    attn, kv = self_attention_full(cfg, p, h, positions, window,
                                   causal=causal)
    if cfg.post_norms:
        attn = apply_norm(cfg, attn, p.get("post_ln1"))
    x = x + attn
    h = _norm(cfg, p, "ln2", x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    out = mlp(cfg, p, h)
    if cfg.post_norms:
        out = apply_norm(cfg, out, p.get("post_ln2"))
    return x + out, kv, aux


def dense_layer_decode(cfg, p, x, kcache, vcache, cur_len: int, window,
                       ffn: str = "mlp"):
    if ffn != "mlp":
        raise NotImplementedError("MoE FFN layers wait for the moe module "
                                  "(ROADMAP Queue 1 item 6)")
    h = _norm(cfg, p, "ln1", x)
    attn, kcache, vcache = self_attention_decode(
        cfg, p, h, kcache, vcache, cur_len, window)
    if cfg.post_norms:
        attn = apply_norm(cfg, attn, p.get("post_ln1"))
    x = x + attn
    h = _norm(cfg, p, "ln2", x)
    out = mlp(cfg, p, h)
    if cfg.post_norms:
        out = apply_norm(cfg, out, p.get("post_ln2"))
    return x + out, kcache, vcache


def rwkv_layer_full(cfg, p, x, att_state, chunk=16):
    """att_state: (B,H,dk,dv) f32 initial state. Returns final states for
    streaming handoff (prefill->decode)."""
    b = x.shape[0]
    h = _norm(cfg, p, "ln1", x)
    xprev0 = torch.zeros((b, cfg.d_model), dtype=x.dtype, device=x.device)
    att, att_xprev, att_state = time_mix(cfg, p, h, xprev0, att_state,
                                         chunk=chunk)
    x = x + att
    h = _norm(cfg, p, "ln2", x)
    ffn, cmix_xprev = channel_mix(cfg, p, h, torch.zeros_like(xprev0))
    return x + ffn, (att_xprev, att_state, cmix_xprev)


def rwkv_layer_decode(cfg, p, x, cache):
    att_xprev, att_state, cmix_xprev = cache
    h = _norm(cfg, p, "ln1", x)
    att, att_xprev, att_state = time_mix(cfg, p, h, att_xprev, att_state,
                                         decode=True)
    x = x + att
    h = _norm(cfg, p, "ln2", x)
    ffn, cmix_xprev = channel_mix(cfg, p, h, cmix_xprev)
    return x + ffn, (att_xprev, att_state, cmix_xprev)
