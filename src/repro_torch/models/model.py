"""Top-level LM: embedding -> layer loops -> norm -> (chunked) loss, plus
the serving entry points (prefill / single-token decode with caches): the
counterpart of ``repro/models/model.py`` for every family.

Public entry points (cfg first, as in JAX; no ``jit``: PyTorch runs
eagerly, and a Python loop over the stacked layer axis takes the place of
``lax.scan``):

  train_loss(cfg, params, batch)                   -> scalar loss
  forward_full(cfg, params, batch, collect=False)  -> (hidden, labels,
                                                      caches, aux)
  prefill(cfg, params, batch, max_len)             -> (last_logits, cache)
  decode_step(cfg, params, cache, tokens, cur_len) -> (logits, cache)

Batch schema (labels use -1 for masked positions):
  dense/moe/ssm/hybrid: {tokens (B,S) int, labels (B,S) int}
  vlm frontend:  + {vision_embeds (B,T_img,1024)}; tokens are text-only
  encdec:        {frames (B,S_enc,d), dec_tokens (B,S_dec), labels}

Cache trees, shapes and dtypes are JAX's: dense and moe {"k", "v"}; MLA
{"dense_ckv", "dense_krope", "ckv", "krope"}; ssm a tuple of three; hybrid
{"mamba": (state f32, conv), "k", "v", "tail"} (``tail`` None without tail
layers); encdec {"k", "v", "xk", "xv"}.

On the card, ``forward_full`` and ``prefill`` launch the flash-attention
kernel once per attention call (each dense, moe and MLA layer; zamba2's
shared block once a period; seamless's encoder, decoder and
cross-attention layers) or the WKV kernel once per layer (ssm);
``decode_step`` launches neither (plain ``decode_attention``, the absorbed
MLA decode, ``ssd_decode`` and ``wkv_decode``). ``decode_step`` writes the
new token's entries into the cache tensors it is given, in place, and
returns them.

``train_loss`` is differentiable for every family (``launch/steps.py``'s
``make_train_step`` takes its gradients): the layer bodies JAX wraps in
``remat_wrap`` are wrapped here too (``cfg.remat``), and on the card the
kernels' autograd ``Function``s carry the gradient through attention and
the WKV scan (``kernels/*/ops.py``).
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import torch

from .. import obs
from . import blocks as B
from .common import apply_norm, dtype_scalar, softcap

AUX_WEIGHT = 0.01


def _largest_divisor(n: int, target: int) -> int:
    c = min(target, n)
    while n % c:
        c -= 1
    return c


def _layers(tree) -> list:
    """The layers of a stacked (sub)tree, each a tree of views: one
    ``unbind`` a leaf, whose backward is one ``stack`` of the layers'
    gradients (indexing layer by layer would add a full-size gradient of
    the stacked leaf per layer)."""
    if isinstance(tree, dict):
        keys = list(tree)
        return [dict(zip(keys, vals))
                for vals in zip(*(_layers(tree[k]) for k in keys))]
    return list(tree.unbind(0))


# ------------------------------------------------------------ embeddings
def embed(cfg, params, tokens):
    with obs.span("model.embed"):
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


def run_dense_full(cfg, params_blocks, x, positions, *, ffn="mlp",
                   collect=False, causal=True):
    """Loop over the stacked dense layers (gemma2: (local, global) pairs).
    Returns (x, (k, v) stacked as JAX's scan stacks them or None, aux)."""
    paired = cfg.layer_pattern == "local_global"

    def body(x, p_l):
        if paired:
            x, kv_l, aux_l = B.dense_layer_full(
                cfg, p_l["local"], x, positions,
                _window_for(cfg, "local"), ffn=ffn, causal=causal)
            x, kv_g, aux_g = B.dense_layer_full(
                cfg, p_l["global"], x, positions,
                _window_for(cfg, "global"), ffn=ffn, causal=causal)
            kv = (torch.stack([kv_l[0], kv_g[0]]),
                  torch.stack([kv_l[1], kv_g[1]])) if collect else None
            return x, kv, aux_l + aux_g
        x, kv, aux = B.dense_layer_full(
            cfg, p_l, x, positions, _window_for(cfg, "global"), ffn=ffn,
            causal=causal)
        return x, kv if collect else None, aux

    body = B.remat_wrap(cfg, body)
    ks, vs = [], []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p_l in _layers(params_blocks):
        with obs.span("layer"):
            x, kv, aux_i = body(x, p_l)
        if collect:
            ks.append(kv[0])
            vs.append(kv[1])
        aux = aux + aux_i
    kvs = None
    if collect:
        with obs.span("kv.collect"):
            kvs = (torch.stack(ks), torch.stack(vs))
    return x, kvs, aux


def run_dense_decode(cfg, params_blocks, x, kcache, vcache, cur_len: int,
                     ffn="mlp"):
    """One token through every dense layer; writes the caches in place."""
    paired = cfg.layer_pattern == "local_global"
    for i, p_l in enumerate(_layers(params_blocks)):
        with obs.span("layer"):
            if paired:
                x, _, _ = B.dense_layer_decode(
                    cfg, p_l["local"], x, kcache[i, 0], vcache[i, 0],
                    cur_len, _window_for(cfg, "local"), ffn=ffn)
                x, _, _ = B.dense_layer_decode(
                    cfg, p_l["global"], x, kcache[i, 1], vcache[i, 1],
                    cur_len, _window_for(cfg, "global"), ffn=ffn)
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

    def body(x, p_l):
        state0 = torch.zeros((b, h, dk, dk), dtype=torch.float32,
                             device=x.device)
        return B.rwkv_layer_full(cfg, p_l, x, state0, chunk=chunk)

    body = B.remat_wrap(cfg, body)
    caches = []
    for p_l in _layers(params_blocks):
        with obs.span("layer"):
            x, cache = body(x, p_l)
        caches.append(cache)
    with obs.span("ssm.state_collect"):
        return x, tuple(torch.stack(c) for c in zip(*caches))


def run_ssm_decode(cfg, params_blocks, x, cache):
    """One token through every rwkv layer; writes the three stacked cache
    tensors in place and returns them."""
    att_xprev, att_state, cmix_xprev = cache
    for i, p_l in enumerate(_layers(params_blocks)):
        with obs.span("layer"):
            x, (ax, st, cx) = B.rwkv_layer_decode(
                cfg, p_l, x, (att_xprev[i], att_state[i], cmix_xprev[i]))
            att_xprev[i] = ax
            att_state[i] = st
            cmix_xprev[i] = cx
    return x, cache


def run_mla_full(cfg, params, x, positions, collect=False):
    """deepseek-v2: the dense first layers (``dense_blocks``), then the MoE
    layers. Returns (x, {"dense": (ckv, krope) stacked, "moe": ...}, aux);
    each entry None unless ``collect``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = {}
    for key, name, ffn in (("dense_blocks", "dense", "mlp"),
                           ("blocks", "moe", "moe")):
        if key not in params:
            continue
        body = B.remat_wrap(cfg, functools.partial(
            B.mla_layer_full, cfg, positions=positions, ffn=ffn,
            collect=collect))
        ckvs, krs = [], []
        for p_l in _layers(params[key]):
            x, cache, aux_i = body(p_l, x)
            aux = aux + aux_i
            if collect:
                ckvs.append(cache[0])
                krs.append(cache[1])
        caches[name] = (torch.stack(ckvs), torch.stack(krs)) \
            if collect else None
    return x, caches, aux


def run_mla_decode(cfg, params, x, cache, cur_len: int):
    """One token through every MLA layer; writes the latent caches in
    place."""
    for key, ffn, ckv, kr in (("dense_blocks", "mlp", "dense_ckv",
                               "dense_krope"),
                              ("blocks", "moe", "ckv", "krope")):
        if key not in params:
            continue
        for i, p_l in enumerate(_layers(params[key])):
            x, _, _ = B.mla_layer_decode(cfg, p_l, x, cache[ckv][i],
                                         cache[kr][i], cur_len, ffn=ffn)
    return x, cache


def _mamba_full(cfg, stacked, x):
    """Every mamba layer of a stacked segment, each from a zero state.
    Returns (x, (state (L,B,H,P,N) f32, conv (L,B,k-1,conv_dim)))."""
    b = x.shape[0]
    h, pd, n = cfg.n_heads, cfg.d_inner // cfg.n_heads, cfg.ssm_state

    def body(x, p_l):
        state0 = torch.zeros((b, h, pd, n), dtype=torch.float32,
                             device=x.device)
        return B.mamba_layer_full(cfg, p_l, x, state0)

    body = B.remat_wrap(cfg, body)
    states, convs = [], []
    for p_l in _layers(stacked):
        x, (st, cv) = body(x, p_l)
        states.append(st)
        convs.append(cv)
    return x, (torch.stack(states), torch.stack(convs))


def _mamba_decode(cfg, stacked, x, cache):
    """One token through a stacked segment of mamba layers; writes the
    (state, conv) cache tensors in place."""
    states, convs = cache
    for i, p_l in enumerate(_layers(stacked)):
        x, (st, cv) = B.mamba_layer_decode(cfg, p_l, x,
                                           (states[i], convs[i]))
        states[i] = st
        convs[i] = cv
    return x


def run_hybrid_full(cfg, params, x, positions, collect=False):
    """zamba2: periods of mamba layers, each followed by the one shared
    attention block; then a tail of mamba layers. Returns (x, (mcaches
    stacked (n_periods, period, ...), (k, v) stacked or None, tail caches
    or None))."""
    shared = params["shared_attn"]

    def period_body(x, p_period, shared):
        x, mc = _mamba_full(cfg, p_period, x)
        x, kv, _ = B.dense_layer_full(cfg, shared, x, positions, None)
        return x, mc, kv if collect else None

    period_body = B.remat_wrap(cfg, period_body)
    mcaches, ks, vs = [], [], []
    for p_period in _layers(params["blocks"]):
        x, mc, kv = period_body(x, p_period, shared)
        mcaches.append(mc)
        if collect:
            ks.append(kv[0])
            vs.append(kv[1])
    mcaches = tuple(torch.stack(c) for c in zip(*mcaches))
    kvs = (torch.stack(ks), torch.stack(vs)) if collect else None
    tcaches = None
    if "tail_blocks" in params:
        x, tcaches = _mamba_full(cfg, params["tail_blocks"], x)
    return x, (mcaches, kvs, tcaches)


def run_hybrid_decode(cfg, params, x, cache, cur_len: int):
    """One token through zamba2; writes every cache tensor in place."""
    shared = params["shared_attn"]
    states, convs = cache["mamba"]
    for i, p_period in enumerate(_layers(params["blocks"])):
        x = _mamba_decode(cfg, p_period, x, (states[i], convs[i]))
        x, _, _ = B.dense_layer_decode(cfg, shared, x, cache["k"][i],
                                       cache["v"][i], cur_len, None)
    if "tail_blocks" in params:
        x = _mamba_decode(cfg, params["tail_blocks"], x, cache["tail"])
    return x, cache


def run_encdec_full(cfg, params, frames, dec_x, dec_positions,
                    collect=False):
    """The encoder (non-causal) over ``frames``, then the decoder, each
    layer self-attention and cross-attention over the encoder's memory.
    Returns (x, memory, ((k, v), (xk, xv)) stacked or None)."""
    b, s_enc = frames.shape[:2]
    enc_positions = torch.arange(s_enc, device=frames.device).expand(
        b, s_enc)

    def enc_body(x, p_l):
        return B.dense_layer_full(cfg, p_l, x, enc_positions, None,
                                  causal=False)[0]

    def dec_body(x, p_l, memory):
        x, kv, _ = B.dense_layer_full(cfg, p_l, x, dec_positions, None)
        xo, xkv = B.cross_attention_full(cfg, p_l, x, memory)
        return x + xo, (*kv, *xkv) if collect else None

    enc_body = B.remat_wrap(cfg, enc_body)
    dec_body = B.remat_wrap(cfg, dec_body)
    x = frames
    for p_l in _layers(params["enc_blocks"]):
        x = enc_body(x, p_l)
    memory = apply_norm(cfg, x, params.get("enc_final_norm"))
    x = dec_x
    kv_caches = []
    for p_l in _layers(params["dec_blocks"]):
        x, kv = dec_body(x, p_l, memory)
        if collect:
            kv_caches.append(kv)
    caches = None
    if collect:
        k, v, xk, xv = (torch.stack(c) for c in zip(*kv_caches))
        caches = ((k, v), (xk, xv))
    return x, memory, caches


def run_encdec_decode(cfg, params, x, cache, cur_len: int):
    """One decoder token; reads ``xk`` / ``xv`` from the cache (never
    recomputes them) and writes ``k`` / ``v`` in place."""
    for i, p_l in enumerate(_layers(params["dec_blocks"])):
        x, _, _ = B.dense_layer_decode(cfg, p_l, x, cache["k"][i],
                                       cache["v"][i], cur_len, None)
        x = x + B.cross_attention_decode(cfg, p_l, x, cache["xk"][i],
                                         cache["xv"][i])
    return x, cache


# --------------------------------------------------------------- full fwd
def forward_full(cfg, params, batch, collect=False):
    """Returns (hidden (B,S,d), labels, caches, aux)."""
    if cfg.family == "encdec":
        dec_x = embed(cfg, params, batch["dec_tokens"])
        b, s = dec_x.shape[:2]
        dec_positions = torch.arange(s, device=dec_x.device).expand(b, s)
        x, memory, caches = run_encdec_full(
            cfg, params, batch["frames"].to(cfg.param_dtype), dec_x,
            dec_positions, collect=collect)
        x = apply_norm(cfg, x, params.get("final_norm"))
        return x, batch.get("labels"), (caches, memory), \
            torch.zeros((), dtype=torch.float32, device=x.device)

    x, labels, positions = build_inputs(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "dense":
        x, caches, aux = run_dense_full(cfg, params["blocks"], x, positions,
                                        ffn="mlp", collect=collect)
    elif cfg.family == "moe" and cfg.mla:
        x, caches, aux = run_mla_full(cfg, params, x, positions,
                                      collect=collect)
    elif cfg.family == "moe":
        x, caches, aux = run_dense_full(cfg, params["blocks"], x, positions,
                                        ffn="moe", collect=collect)
    elif cfg.family == "ssm":
        x = apply_norm(cfg, x, params.get("ln0"))
        x, caches = run_ssm_full(cfg, params["blocks"], x)
    elif cfg.family == "hybrid":
        x, caches = run_hybrid_full(cfg, params, x, positions,
                                    collect=collect)
    else:
        raise ValueError(cfg.family)
    x = apply_norm(cfg, x, params.get("final_norm"))
    return x, labels, caches, aux


# ------------------------------------------------------------------- loss
def _unembed_weight(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _unembed(cfg, h, wf):
    """Logits in float32 from the float32 copy ``wf`` of the (d, V) weight:
    the products of JAX's bf16 x bf16 einsum with a float32 result."""
    logits = torch.einsum("btd,dv->btv", h.float(), wf)
    return softcap(logits, cfg.logit_softcap)


def unembed_chunk(cfg, params, h):
    return _unembed(cfg, h, _unembed_weight(cfg, params).float())


def loss_from_hidden(cfg, params, hidden, labels):
    """Chunked next-token CE: prediction at position t scores labels[t+1].
    labels == -1 are ignored. Never materializes (B,S,V). The unembedding
    weight is cast to float32 once a call and that one copy serves every
    chunk (autograd saves it once, not once a chunk)."""
    b, s, d = hidden.shape
    wf = _unembed_weight(cfg, params).float()
    h = hidden[:, :-1]
    y = labels[:, 1:]
    sl = s - 1
    c = _largest_divisor(sl, cfg.loss_chunk)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, sl, c):
        hc, yc = h[:, i:i + c], y[:, i:i + c]
        logits = _unembed(cfg, hc, wf)
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1,
                              yc.clamp(min=0).long()[..., None])[..., 0]
        mask = (yc >= 0).float()
        total = total + torch.sum((lse - picked) * mask)
        count = count + torch.sum(mask)
    return total / torch.clamp(count, min=1.0)


def train_loss(cfg, params, batch):
    """The training loss: next-token CE plus ``AUX_WEIGHT`` times the MoE
    load-balance loss. Differentiable; ``launch/steps.py`` takes its
    gradients."""
    hidden, labels, _, aux = forward_full(cfg, params, batch, collect=False)
    return loss_from_hidden(cfg, params, hidden, labels) + AUX_WEIGHT * aux


# ------------------------------------------------------------- serving
def _kv_cache_from(kvs, max_len: int):
    """Stacked per-layer (k, v) of shape (L..., B, Hkv, S, hd) (or MLA's
    (L, B, S, r) latents) -> buffers zero-padded on axis -2 to max_len."""
    def pad(t):
        out = torch.zeros((*t.shape[:-2], max_len, t.shape[-1]),
                          dtype=t.dtype, device=t.device)
        out[..., :t.shape[-2], :] = t
        return out
    k, v = kvs
    return pad(k), pad(v)


def init_decode_cache(cfg, batch_size: int, max_len: int, enc_len: int = 0,
                      device=None) -> Any:
    """Zero caches (``enc_len``: the encoder memory's length, encdec only).
    ``device`` defaults to the CUDA card."""
    from ..device import resolve_device
    dev = resolve_device(device)
    dt = cfg.param_dtype
    b, L = batch_size, cfg.n_layers
    hkv, hd = cfg.n_kv_heads, cfg.d_head

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if cfg.family == "dense" or (cfg.family == "moe" and not cfg.mla):
        if cfg.layer_pattern == "local_global":
            shape = (L // 2, 2, b, hkv, max_len, hd)
        else:
            shape = (L, b, hkv, max_len, hd)
        return {"k": zeros(shape), "v": zeros(shape)}
    if cfg.family == "moe":
        nd, nm = cfg.first_k_dense, L - cfg.first_k_dense
        r, rope = cfg.kv_lora_rank, cfg.qk_rope_dim
        return {"dense_ckv": zeros((nd, b, max_len, r)),
                "dense_krope": zeros((nd, b, max_len, rope)),
                "ckv": zeros((nm, b, max_len, r)),
                "krope": zeros((nm, b, max_len, rope))}
    if cfg.family == "ssm":
        h = cfg.n_heads
        dk = cfg.d_model // h
        return (zeros((L, b, cfg.d_model)),
                zeros((L, b, h, dk, dk), torch.float32),
                zeros((L, b, cfg.d_model)))
    if cfg.family == "hybrid":
        period = cfg.attn_every
        np_ = L // period
        tail = L - np_ * period
        h, pd, n = cfg.n_heads, cfg.d_inner // cfg.n_heads, cfg.ssm_state
        convdim = cfg.d_inner + 2 * n
        k1 = cfg.conv_kernel - 1
        return {
            "mamba": (zeros((np_, period, b, h, pd, n), torch.float32),
                      zeros((np_, period, b, k1, convdim))),
            "k": zeros((np_, b, hkv, max_len, hd)),
            "v": zeros((np_, b, hkv, max_len, hd)),
            "tail": (zeros((tail, b, h, pd, n), torch.float32),
                     zeros((tail, b, k1, convdim))) if tail else None,
        }
    if cfg.family == "encdec":
        Ld = cfg.dec_layers
        return {"k": zeros((Ld, b, hkv, max_len, hd)),
                "v": zeros((Ld, b, hkv, max_len, hd)),
                "xk": zeros((Ld, b, hkv, enc_len, hd)),
                "xv": zeros((Ld, b, hkv, enc_len, hd))}
    raise ValueError(cfg.family)


def prefill(cfg, params, batch, max_len: int):
    """Run the full prompt, return (last_logits (B,V) f32, cache)."""
    with obs.span("model.prefill"):
        return _prefill(cfg, params, batch, max_len)


def _prefill(cfg, params, batch, max_len: int):
    hidden, _, caches, _ = forward_full(cfg, params, batch, collect=True)
    with obs.span("model.head"):
        logits = unembed_chunk(cfg, params, hidden[:, -1:])[:, 0]
    if cfg.family == "dense" or (cfg.family == "moe" and not cfg.mla):
        with obs.span("kv.collect"):
            k, v = _kv_cache_from(caches, max_len)
        return logits, {"k": k, "v": v}
    if cfg.family == "ssm":
        return logits, caches
    if cfg.family == "hybrid":
        mcaches, kvs, tcaches = caches
        k, v = _kv_cache_from(kvs, max_len)
        return logits, {"mamba": mcaches, "k": k, "v": v, "tail": tcaches}
    if cfg.family == "encdec":
        (kv, xkv), _memory = caches
        k, v = _kv_cache_from(kv, max_len)
        return logits, {"k": k, "v": v, "xk": xkv[0], "xv": xkv[1]}
    ckv, krope = _kv_cache_from(caches["moe"], max_len)
    out = {"ckv": ckv, "krope": krope}
    if "dense" in caches:
        out["dense_ckv"], out["dense_krope"] = _kv_cache_from(
            caches["dense"], max_len)
    return logits, out


def decode_step(cfg, params, cache, tokens, cur_len: int):
    """tokens: (B,) new token ids; cur_len: number of tokens already in the
    cache (an int, or a 0-d integer tensor, which is read on the device
    only: a meta trace runs). Returns (logits (B,V) f32, cache), the cache
    updated in place."""
    if not isinstance(cur_len, torch.Tensor):
        cur_len = int(cur_len)
    with obs.span("model.decode_step"):
        return _decode_step(cfg, params, cache, tokens, cur_len)


def _decode_step(cfg, params, cache, tokens, cur_len):
    x = embed(cfg, params, tokens[:, None])
    if cfg.family == "encdec":
        x, cache = run_encdec_decode(cfg, params, x, cache, cur_len)
    elif cfg.family == "dense" or (cfg.family == "moe" and not cfg.mla):
        x, kc, vc = run_dense_decode(
            cfg, params["blocks"], x, cache["k"], cache["v"], cur_len,
            ffn="moe" if cfg.family == "moe" else "mlp")
        cache = {"k": kc, "v": vc}
    elif cfg.family == "moe":
        x, cache = run_mla_decode(cfg, params, x, cache, cur_len)
    elif cfg.family == "ssm":
        x = apply_norm(cfg, x, params.get("ln0"))
        x, cache = run_ssm_decode(cfg, params["blocks"], x, cache)
    elif cfg.family == "hybrid":
        x, cache = run_hybrid_decode(cfg, params, x, cache, cur_len)
    else:
        raise ValueError(cfg.family)
    with obs.span("model.head"):
        x = apply_norm(cfg, x, params.get("final_norm"))
        logits = unembed_chunk(cfg, params, x)[:, 0]
    return logits, cache
