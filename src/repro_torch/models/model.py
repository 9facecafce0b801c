"""Top-level LM: embedding -> layer loops -> norm -> (chunked) loss, plus
the serving entry points (prefill / single-token decode with caches): the
counterpart of ``repro/models/model.py`` for the dense and ssm families.

Public entry points (cfg first, as in JAX; no ``jit``: PyTorch runs
eagerly, and a Python loop over the stacked layer axis takes the place of
``lax.scan``):

  train_loss(cfg, params, batch)                   -> scalar loss (forward)
  forward_full(cfg, params, batch, collect=False)  -> (hidden, labels,
                                                      caches, aux)
  prefill(cfg, params, batch, max_len)             -> (last_logits, cache)
  decode_step(cfg, params, cache, tokens, cur_len) -> (logits, cache)

Batch schema (labels use -1 for masked positions):
  dense/ssm:     {tokens (B,S) int, labels (B,S) int}
  vlm frontend:  + {vision_embeds (B,T_img,1024)}; tokens are text-only

On the card, ``forward_full`` and ``prefill`` launch the flash-attention
kernel once per attention layer (dense) or the WKV kernel once per layer
(ssm); ``decode_step`` launches neither (plain ``decode_attention`` /
``wkv_decode``). ``decode_step`` writes the new token's entries into the
cache tensors it is given, in place, and returns them.

The moe, hybrid and encdec families wait for their modules (ROADMAP
Queue 1 item 6) and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from . import blocks as B
from .common import apply_norm, dtype_scalar, softcap
from .params import PORTED_FAMILIES, _unported

AUX_WEIGHT = 0.01


def _largest_divisor(n: int, target: int) -> int:
    c = min(target, n)
    while n % c:
        c -= 1
    return c


def _check_family(cfg) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise _unported(cfg)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked (sub)tree: a view of every leaf."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ------------------------------------------------------------ embeddings
def embed(cfg, params, tokens):
    x = params["embed"][tokens.long()]
    if cfg.embed_scale:
        x = x * dtype_scalar(cfg.d_model ** 0.5, x.dtype)
    return x


def build_inputs(cfg, params, batch):
    """Returns (x (B,S,d), labels (B,S), positions (B,S)). The vision
    frontend is a stub, as in JAX: precomputed patch embeddings projected
    by ``mm_proj`` and put before the text."""
    tokens = batch["tokens"]
    x = embed(cfg, params, tokens)
    labels = batch.get("labels")
    if cfg.frontend == "vision":
        vis = torch.einsum("bte,ed->btd", batch["vision_embeds"].float(),
                           params["mm_proj"].float()).to(x.dtype)
        x = torch.cat([vis, x], dim=1)
        if labels is not None:
            pad = torch.full(vis.shape[:2], -1, dtype=labels.dtype,
                             device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    return x, labels, positions


# ------------------------------------------------------- layer loops
def _window_for(cfg, which: str) -> Optional[int]:
    if cfg.layer_pattern == "local_global":
        return cfg.sliding_window if which == "local" else None
    return cfg.sliding_window


def _n_stacked(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def run_dense_full(cfg, params_blocks, x, positions, *, ffn="mlp",
                   collect=False, causal=True):
    """Loop over the stacked dense layers (gemma2: (local, global) pairs).
    Returns (x, (k, v) stacked as JAX's scan stacks them or None, aux)."""
    paired = cfg.layer_pattern == "local_global"
    ks, vs = [], []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(_n_stacked(params_blocks)):
        p_l = _layer(params_blocks, i)
        if paired:
            x, kv_l, aux_l = B.dense_layer_full(
                cfg, p_l["local"], x, positions,
                _window_for(cfg, "local"), ffn=ffn, causal=causal)
            x, kv_g, aux_g = B.dense_layer_full(
                cfg, p_l["global"], x, positions,
                _window_for(cfg, "global"), ffn=ffn, causal=causal)
            if collect:
                ks.append(torch.stack([kv_l[0], kv_g[0]]))
                vs.append(torch.stack([kv_l[1], kv_g[1]]))
            aux = aux + aux_l + aux_g
        else:
            x, kv, aux_i = B.dense_layer_full(
                cfg, p_l, x, positions, _window_for(cfg, "global"),
                ffn=ffn, causal=causal)
            if collect:
                ks.append(kv[0])
                vs.append(kv[1])
            aux = aux + aux_i
    kvs = (torch.stack(ks), torch.stack(vs)) if collect else None
    return x, kvs, aux


def run_dense_decode(cfg, params_blocks, x, kcache, vcache, cur_len: int,
                     ffn="mlp"):
    """One token through every dense layer; writes the caches in place."""
    paired = cfg.layer_pattern == "local_global"
    for i in range(_n_stacked(params_blocks)):
        p_l = _layer(params_blocks, i)
        if paired:
            x, _, _ = B.dense_layer_decode(
                cfg, p_l["local"], x, kcache[i, 0], vcache[i, 0], cur_len,
                _window_for(cfg, "local"), ffn=ffn)
            x, _, _ = B.dense_layer_decode(
                cfg, p_l["global"], x, kcache[i, 1], vcache[i, 1], cur_len,
                _window_for(cfg, "global"), ffn=ffn)
        else:
            x, _, _ = B.dense_layer_decode(
                cfg, p_l, x, kcache[i], vcache[i], cur_len,
                _window_for(cfg, "global"), ffn=ffn)
    return x, kcache, vcache


def run_ssm_full(cfg, params_blocks, x, chunk=16):
    """Every rwkv layer from a zero state. Returns (x, (att_xprev
    (L,B,d), att_state (L,B,H,dk,dk) f32, cmix_xprev (L,B,d)))."""
    b = x.shape[0]
    h = cfg.n_heads
    dk = cfg.d_model // h
    caches = []
    for i in range(_n_stacked(params_blocks)):
        state0 = torch.zeros((b, h, dk, dk), dtype=torch.float32,
                             device=x.device)
        x, cache = B.rwkv_layer_full(cfg, _layer(params_blocks, i), x,
                                     state0, chunk=chunk)
        caches.append(cache)
    return x, tuple(torch.stack(c) for c in zip(*caches))


def run_ssm_decode(cfg, params_blocks, x, cache):
    """One token through every rwkv layer; writes the three stacked cache
    tensors in place and returns them."""
    att_xprev, att_state, cmix_xprev = cache
    for i in range(_n_stacked(params_blocks)):
        x, (ax, st, cx) = B.rwkv_layer_decode(
            cfg, _layer(params_blocks, i), x,
            (att_xprev[i], att_state[i], cmix_xprev[i]))
        att_xprev[i] = ax
        att_state[i] = st
        cmix_xprev[i] = cx
    return x, cache


# --------------------------------------------------------------- full fwd
def forward_full(cfg, params, batch, collect=False):
    """Returns (hidden (B,S,d), labels, caches, aux)."""
    _check_family(cfg)
    x, labels, positions = build_inputs(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "dense":
        x, caches, aux = run_dense_full(cfg, params["blocks"], x, positions,
                                        ffn="mlp", collect=collect)
    else:
        x = apply_norm(cfg, x, params.get("ln0"))
        x, caches = run_ssm_full(cfg, params["blocks"], x)
    x = apply_norm(cfg, x, params.get("final_norm"))
    return x, labels, caches, aux


# ------------------------------------------------------------------- loss
def unembed_chunk(cfg, params, h):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.einsum("btd,dv->btv", h.float(), w.float())
    return softcap(logits, cfg.logit_softcap)


def loss_from_hidden(cfg, params, hidden, labels):
    """Chunked next-token CE: prediction at position t scores labels[t+1].
    labels == -1 are ignored. Never materializes (B,S,V)."""
    b, s, d = hidden.shape
    h = hidden[:, :-1]
    y = labels[:, 1:]
    sl = s - 1
    c = _largest_divisor(sl, cfg.loss_chunk)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, sl, c):
        hc, yc = h[:, i:i + c], y[:, i:i + c]
        logits = unembed_chunk(cfg, params, hc).float()
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1,
                              yc.clamp(min=0).long()[..., None])[..., 0]
        mask = (yc >= 0).float()
        total = total + torch.sum((lse - picked) * mask)
        count = count + torch.sum(mask)
    return total / torch.clamp(count, min=1.0)


def train_loss(cfg, params, batch):
    """The training loss, forward only (no backward is ported)."""
    hidden, labels, _, aux = forward_full(cfg, params, batch, collect=False)
    return loss_from_hidden(cfg, params, hidden, labels) + AUX_WEIGHT * aux


# ------------------------------------------------------------- serving
def _kv_cache_from(kvs, max_len: int):
    """Stacked per-layer (k, v) of shape (L..., B, Hkv, S, hd) -> zero-padded
    cache buffers of length max_len."""
    def pad(t):
        out = torch.zeros((*t.shape[:-2], max_len, t.shape[-1]),
                          dtype=t.dtype, device=t.device)
        out[..., :t.shape[-2], :] = t
        return out
    k, v = kvs
    return pad(k), pad(v)


def init_decode_cache(cfg, batch_size: int, max_len: int, enc_len: int = 0,
                      device=None) -> Any:
    """Zero caches (``enc_len`` is JAX's encdec argument; unused here).
    ``device`` defaults to the CUDA card."""
    from ..device import resolve_device
    _check_family(cfg)
    dev = resolve_device(device)
    dt = cfg.param_dtype
    b, L = batch_size, cfg.n_layers
    hkv, hd = cfg.n_kv_heads, cfg.d_head
    if cfg.family == "dense":
        if cfg.layer_pattern == "local_global":
            shape = (L // 2, 2, b, hkv, max_len, hd)
        else:
            shape = (L, b, hkv, max_len, hd)
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev)}
    h = cfg.n_heads
    dk = cfg.d_model // h
    return (torch.zeros((L, b, cfg.d_model), dtype=dt, device=dev),
            torch.zeros((L, b, h, dk, dk), dtype=torch.float32, device=dev),
            torch.zeros((L, b, cfg.d_model), dtype=dt, device=dev))


def prefill(cfg, params, batch, max_len: int):
    """Run the full prompt, return (last_logits (B,V) f32, cache)."""
    hidden, _, caches, _ = forward_full(cfg, params, batch, collect=True)
    logits = unembed_chunk(cfg, params, hidden[:, -1:])[:, 0]
    if cfg.family == "dense":
        k, v = _kv_cache_from(caches, max_len)
        return logits, {"k": k, "v": v}
    return logits, caches


def decode_step(cfg, params, cache, tokens, cur_len: int):
    """tokens: (B,) new token ids; cur_len: number of tokens already in the
    cache. Returns (logits (B,V) f32, cache), the cache updated in place."""
    _check_family(cfg)
    cur_len = int(cur_len)
    x = embed(cfg, params, tokens[:, None])
    if cfg.family == "dense":
        x, kc, vc = run_dense_decode(cfg, params["blocks"], x, cache["k"],
                                     cache["v"], cur_len)
        cache = {"k": kc, "v": vc}
    else:
        x = apply_norm(cfg, x, params.get("ln0"))
        x, cache = run_ssm_decode(cfg, params["blocks"], x, cache)
    x = apply_norm(cfg, x, params.get("final_norm"))
    logits = unembed_chunk(cfg, params, x)[:, 0]
    return logits, cache
