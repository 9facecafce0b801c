"""Layer application per family (the counterpart of
``repro/models/blocks.py``).

Every full-sequence layer fn has the signature
    fn(cfg, p_layer, x, ...) -> (x, cache_entry[, aux])
and every decode layer fn
    fn(cfg, p_layer, x, cache_entry...) -> (x, new_cache_entry...)
so ``model.py`` drives them with a Python loop over the stacked layer axis
(JAX's ``lax.scan``). ``remat_wrap`` is JAX's: ``model.py`` wraps the
bodies JAX wraps, and the train step (``launch/steps.py``) differentiates
through them.

The layers of every family: dense and MoE transformer layers, MLA layers
(deepseek-v2), rwkv6 and Mamba-2 mixers, and the encoder-decoder's
cross-attention. A decode layer writes the new token's entries into the
cache tensors it is given, in place, and returns them.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .attention import attention, decode_attention
from .common import (act_fn, apply_norm, apply_rope, decode_positions,
                     write_at)
from .mamba2 import mamba2_mixer
from .mla import mla_attention_train, mla_decode_step
from .moe import moe_ffn
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
    positions = decode_positions(cur_len, b, x.device)
    q, k, v = qkv_project(cfg, p, x, positions)
    write_at(kcache, 2, cur_len, k)
    write_at(vcache, 2, cur_len, v)
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
    h = _norm(cfg, p, "ln1", x)
    attn, kv = self_attention_full(cfg, p, h, positions, window,
                                   causal=causal)
    if cfg.post_norms:
        attn = apply_norm(cfg, attn, p.get("post_ln1"))
    x = x + attn
    h = _norm(cfg, p, "ln2", x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "moe":
        out, aux = moe_ffn(cfg, p, h)
    else:
        out = mlp(cfg, p, h)
    if cfg.post_norms:
        out = apply_norm(cfg, out, p.get("post_ln2"))
    return x + out, kv, aux


def dense_layer_decode(cfg, p, x, kcache, vcache, cur_len: int, window,
                       ffn: str = "mlp"):
    h = _norm(cfg, p, "ln1", x)
    attn, kcache, vcache = self_attention_decode(
        cfg, p, h, kcache, vcache, cur_len, window)
    if cfg.post_norms:
        attn = apply_norm(cfg, attn, p.get("post_ln1"))
    x = x + attn
    h = _norm(cfg, p, "ln2", x)
    out = moe_ffn(cfg, p, h)[0] if ffn == "moe" else mlp(cfg, p, h)
    if cfg.post_norms:
        out = apply_norm(cfg, out, p.get("post_ln2"))
    return x + out, kcache, vcache


def mla_layer_full(cfg, p, x, positions, ffn: str, collect: bool = False):
    """MLA attention then an MLP or MoE FFN. Returns (x, (ckv, krope) or
    None, aux)."""
    h = _norm(cfg, p, "ln1", x)
    if collect:
        attn, cache = mla_attention_train(cfg, p, h, positions,
                                          return_cache=True)
    else:
        attn, cache = mla_attention_train(cfg, p, h, positions), None
    x = x + attn
    h = _norm(cfg, p, "ln2", x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "moe":
        out, aux = moe_ffn(cfg, p, h)
    else:
        out = mlp(cfg, p, h)
    return x + out, cache, aux


def mla_layer_decode(cfg, p, x, ckv_cache, krope_cache, cur_len: int,
                     ffn: str):
    h = _norm(cfg, p, "ln1", x)
    attn, ckv_cache, krope_cache = mla_decode_step(
        cfg, p, h, ckv_cache, krope_cache, cur_len + 1)
    x = x + attn
    h = _norm(cfg, p, "ln2", x)
    out = moe_ffn(cfg, p, h)[0] if ffn == "moe" else mlp(cfg, p, h)
    return x + out, ckv_cache, krope_cache


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


def mamba_layer_full(cfg, p, x, state, chunk=64):
    """state: (B,H,P,N) f32 initial state. Returns (x, (state, conv_cache))
    for the streaming handoff (prefill->decode)."""
    h = _norm(cfg, p, "ln1", x)
    out, state, conv_cache = mamba2_mixer(cfg, p, h, state, None,
                                          chunk=chunk)
    return x + out, (state, conv_cache)


def mamba_layer_decode(cfg, p, x, cache):
    state, conv_cache = cache
    h = _norm(cfg, p, "ln1", x)
    out, state, conv_cache = mamba2_mixer(cfg, p, h, state, conv_cache,
                                          decode=True)
    return x + out, (state, conv_cache)


def cross_attention_full(cfg, p, x, memory):
    """Decoder cross-attention over the encoder memory, non-causal, Sq =
    decoder length and Skv = encoder length. Returns (out, (xk, xv))."""
    b, s, d = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    h = apply_norm(cfg, x, p.get("xln"))
    q = torch.einsum("bsd,de->bse", h, p["xwq"]).reshape(
        b, s, hq, hd).transpose(1, 2)
    k = torch.einsum("bsd,de->bse", memory, p["xwk"]).reshape(
        b, memory.shape[1], hkv, hd).transpose(1, 2)
    v = torch.einsum("bsd,de->bse", memory, p["xwv"]).reshape(
        b, memory.shape[1], hkv, hd).transpose(1, 2)
    o = attention(cfg, q, k, v, causal=False)
    b2, hh, s2, hd2 = o.shape
    o = o.transpose(1, 2).reshape(b2, s2, hh * hd2)
    return torch.einsum("bse,ed->bsd", o, p["xwo"]), (k, v)


def cross_attention_decode(cfg, p, x, xk, xv):
    """Cross-attention with the memory's precomputed K/V (all of it
    visible)."""
    b, s, d = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    h = apply_norm(cfg, x, p.get("xln"))
    q = torch.einsum("bsd,de->bse", h, p["xwq"]).reshape(
        b, s, hq, hd).transpose(1, 2)
    o = decode_attention(q, xk, xv, xk.shape[2])
    o = o.transpose(1, 2).reshape(b, s, hq * hd)
    return torch.einsum("bse,ed->bsd", o, p["xwo"])


# ---------------------------------------------------------------- wrappers
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: keep the outputs of the
    matrix products without batch dims (``mm``, ``addmm``, and the ``bmm``
    of batch 1 that ``einsum`` makes of one), recompute the rest."""
    if op in _MATMULS or (op == torch.ops.aten.bmm.default
                          and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _records_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_records_grad(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_records_grad(v) for v in tree)
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def remat_wrap(cfg, fn):
    """``fn`` under ``cfg.remat``: ``"none"`` as it is; ``"block"`` keeps
    only its inputs for the backward and reruns it there
    (``torch.utils.checkpoint``, non-reentrant); ``"dots"`` keeps the
    outputs of its matrix products without batch dims as well. Remat
    changes memory, never values. A call that autograd does not record
    (no argument requires grad, or grad mode off: serving) runs ``fn``
    directly."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("block", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    extra = {}
    if cfg.remat == "dots":
        extra["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    @functools.wraps(fn)
    def wrapped(*args):
        if not (torch.is_grad_enabled() and _records_grad(args)):
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **extra)
    return wrapped
