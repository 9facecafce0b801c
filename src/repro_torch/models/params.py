"""Parameter trees (+ counting): the counterpart of
``repro/models/params.py``.

The tree stays what JAX's is: nested dicts of tensors whose layer leaves
are stacked on axis 0 (``blocks``: (L, ...); gemma2's ``local`` /
``global`` pairs: (L/2, ...)). It is not an ``nn.Module``: the model's
layer loop slices the stacked leaves directly, and a tree that matches
JAX's key for key is what the weight bridge (``params_from_numpy``), the
parity tests, the optimizer (``optim/adamw.py``, whose weight decay
follows JAX's ``ndim >= 2`` rule on these stacked leaves) and the
checkpoint (``checkpoint/ckpt.py``, leaves in JAX's order) walk. Training
marks the leaves with :func:`trainable` and takes gradients with
``torch.autograd.grad`` over them (``launch/steps.py``).

``init_params`` draws on the generator's device with the same
distributions as JAX (truncated normal at +-2 times 1/sqrt(fan_in) for
weights, normal x 0.02 for the embedding, ``u`` normal x 0.3 in float32,
``decay_base`` = -0.6 in float32). The numbers differ from JAX's: the
bridge carries JAX's own parameters across where a test needs equal
weights. Each stacked leaf is allocated once and filled layer by layer,
so the peak is the model plus one layer; zamba2's (period, layer) stack is
filled the same way, one layer at a time.

Every family: dense, moe (olmoe; deepseek-v2's MLA with a dense first
layer of d_ff 12288 under ``dense_blocks``), ssm (rwkv6), hybrid (zamba2:
``blocks`` stacked (n_periods, period, ...), ``tail_blocks`` and one
unstacked ``shared_attn`` block) and encdec (seamless: ``enc_blocks``,
``dec_blocks``, ``enc_final_norm``).
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..tree import tree_leaves
from .common import dense_init, embed_init, normal_init
from .config import ModelConfig


def _const(shape, value, dtype, device) -> torch.Tensor:
    return torch.full(shape, value, dtype=dtype, device=device)


def _maybe_norm(cfg, d: int, device):
    """Norm weight or None for non-parametric LN (olmo)."""
    if cfg.norm == "nonparam":
        return None
    if cfg.name.startswith("gemma"):
        return _const((d,), 0.0, cfg.param_dtype, device)   # (1+w) form
    return _const((d,), 1.0, cfg.param_dtype, device)


# ------------------------------------------------------------ per-layer init
def init_attn_layer(cfg, gen: torch.Generator) -> Dict[str, Any]:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt, dev = cfg.param_dtype, gen.device
    p = {
        "wq": dense_init(gen, (d, hq * hd), dt),
        "wk": dense_init(gen, (d, hkv * hd), dt),
        "wv": dense_init(gen, (d, hkv * hd), dt),
        "wo": dense_init(gen, (hq * hd, d), dt),
    }
    if cfg.qkv_bias:
        p["bq"] = _const((hq * hd,), 0.0, dt, dev)
        p["bk"] = _const((hkv * hd,), 0.0, dt, dev)
        p["bv"] = _const((hkv * hd,), 0.0, dt, dev)
    n = _maybe_norm(cfg, d, dev)
    if n is not None:
        p["ln1"] = n
    if cfg.post_norms:
        pn = _maybe_norm(cfg, d, dev)
        if pn is not None:
            p["post_ln1"] = pn
    return p


def init_mla_layer(cfg, gen: torch.Generator) -> Dict[str, Any]:
    d, h = cfg.d_model, cfg.n_heads
    dt, dev = cfg.param_dtype, gen.device
    dqk = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "q_a": dense_init(gen, (d, cfg.q_lora_rank), dt),
        "q_norm": _const((cfg.q_lora_rank,), 1.0, dt, dev),
        "q_b": dense_init(gen, (cfg.q_lora_rank, h * dqk), dt),
        "kv_a": dense_init(gen, (d, cfg.kv_lora_rank + cfg.qk_rope_dim), dt),
        "kv_norm": _const((cfg.kv_lora_rank,), 1.0, dt, dev),
        "kv_b": dense_init(
            gen, (cfg.kv_lora_rank, h * (cfg.qk_nope_dim + cfg.v_head_dim)),
            dt),
        "o": dense_init(gen, (h * cfg.v_head_dim, d), dt),
        "ln1": _const((d,), 1.0, dt, dev),
    }


def init_mlp_layer(cfg, gen: torch.Generator,
                   d_ff: Optional[int] = None) -> Dict[str, Any]:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    dt, dev = cfg.param_dtype, gen.device
    p = {
        "wg": dense_init(gen, (d, ff), dt),
        "wu": dense_init(gen, (d, ff), dt),
        "wd": dense_init(gen, (ff, d), dt),
    }
    n = _maybe_norm(cfg, d, dev)
    if n is not None:
        p["ln2"] = n
    if cfg.post_norms:
        pn = _maybe_norm(cfg, d, dev)
        if pn is not None:
            p["post_ln2"] = pn
    return p


def init_moe_layer(cfg, gen: torch.Generator) -> Dict[str, Any]:
    """The router in float32; expert weights (E, fan_in, fan_out) with
    their fan-in on axis -2."""
    d, e, fe = cfg.d_model, cfg.n_experts, cfg.d_expert
    dt, dev = cfg.param_dtype, gen.device
    p = {
        "router": dense_init(gen, (d, e), torch.float32),
        "wg": dense_init(gen, (e, d, fe), dt, in_axis=-2),
        "wu": dense_init(gen, (e, d, fe), dt, in_axis=-2),
        "wd": dense_init(gen, (e, fe, d), dt, in_axis=-2),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * fe
        p["sg"] = dense_init(gen, (d, fs), dt)
        p["su"] = dense_init(gen, (d, fs), dt)
        p["sd"] = dense_init(gen, (fs, d), dt)
    n = _maybe_norm(cfg, d, dev)
    if n is not None:
        p["ln2"] = n
    return p


def init_rwkv_layer(cfg, gen: torch.Generator) -> Dict[str, Any]:
    d, h = cfg.d_model, cfg.n_heads
    dk = d // h
    dt, dev = cfg.param_dtype, gen.device
    lora = 64
    f32 = torch.float32
    p = {
        "ln1": _const((d,), 1.0, dt, dev),
        "ln2": _const((d,), 1.0, dt, dev),
        # JAX draws a (d, 5*lora) mix_A first and replaces it with this one
        "mix_A": dense_init(gen, (d, lora), dt),
        "decay_A": dense_init(gen, (d, lora), dt),
        "decay_B": dense_init(gen, (lora, d), dt),
        "decay_base": _const((d,), 0.0, f32, dev) - 0.6,
        "u": normal_init(gen, (h, dk), f32, 0.3),
        "wr": dense_init(gen, (d, d), dt),
        "wk": dense_init(gen, (d, d), dt),
        "wv": dense_init(gen, (d, d), dt),
        "wg": dense_init(gen, (d, d), dt),
        "wo": dense_init(gen, (d, d), dt),
        "ln_x": _const((d,), 1.0, dt, dev),
        "cmix_k": _const((d,), 0.5, dt, dev),
        "cmix_r": _const((d,), 0.5, dt, dev),
        "ck": dense_init(gen, (d, cfg.d_ff), dt),
        "cv": dense_init(gen, (cfg.d_ff, d), dt),
        "cr": dense_init(gen, (d, d), dt),
    }
    for nm in ("r", "k", "v", "g", "w"):
        p[f"mix_{nm}"] = _const((d,), 0.5, dt, dev)
        p[f"mix_B_{nm}"] = dense_init(gen, (lora, d), dt)
    return p


def init_mamba_layer(cfg, gen: torch.Generator) -> Dict[str, Any]:
    """``conv_w`` with its fan-in (the kernel taps) on axis 0; ``dt_bias``,
    ``a_log`` and ``D`` in float32."""
    d, h, di, n = cfg.d_model, cfg.n_heads, cfg.d_inner, cfg.ssm_state
    dt, dev = cfg.param_dtype, gen.device
    f32 = torch.float32
    return {
        "ln1": _const((d,), 1.0, dt, dev),
        "in_zx": dense_init(gen, (d, 2 * di), dt),
        "in_bcdt": dense_init(gen, (d, 2 * n + h), dt),
        "conv_w": dense_init(gen, (cfg.conv_kernel, di + 2 * n), dt,
                             in_axis=0),
        "dt_bias": _const((h,), 0.0, f32, dev),
        "a_log": _const((h,), 0.0, f32, dev),
        "D": _const((h,), 1.0, f32, dev),
        "out_norm": _const((di,), 1.0, dt, dev),
        "out_proj": dense_init(gen, (di, d), dt),
    }


def init_cross_attn_layer(cfg, gen: torch.Generator) -> Dict[str, Any]:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt, dev = cfg.param_dtype, gen.device
    return {
        "xwq": dense_init(gen, (d, hq * hd), dt),
        "xwk": dense_init(gen, (d, hkv * hd), dt),
        "xwv": dense_init(gen, (d, hkv * hd), dt),
        "xwo": dense_init(gen, (hq * hd, d), dt),
        "xln": _const((d,), 1.0, dt, dev),
    }


def _stack_layers(n: Union[int, Tuple[int, ...]], make: Callable[[], Any]):
    """Stack per-layer trees from ``make()`` along new leading axes: ``n``
    layers, or an (n_periods, period, ...) grid of them, filled in row-major
    order. Each stacked leaf is allocated once and each layer is copied in
    as it is made, so only one layer exists beside the stack."""
    lead = (n,) if isinstance(n, int) else tuple(n)

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return torch.empty((*lead, *t.shape), dtype=t.dtype, device=t.device)

    def put(dst, src, i):
        if isinstance(src, dict):
            for k, v in src.items():
                put(dst[k], v, i)
        else:
            dst[i].copy_(src)

    if min(lead) < 1:
        raise ValueError(f"a model needs at least one layer to stack, got "
                         f"{n}")
    cells = itertools.product(*(range(m) for m in lead))
    first = make()
    stacked = alloc(first)
    put(stacked, first, next(cells))
    del first
    for i in cells:
        put(stacked, make(), i)
    return stacked


# -------------------------------------------------------------- full models
class _NoDraws:
    """What the initialisers take for a generator on the meta device, which
    has none: they make each leaf's shape there and draw nothing."""
    device = torch.device("meta")


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device=None) -> Dict[str, Any]:
    """The parameter tree of ``cfg``, drawn from ``generator`` on its
    device; ``device``, when given, must be that device's kind. With no
    generator, ``device`` must be ``"meta"``: the tree's shapes and dtypes
    (the counterpart of ``jax.eval_shape`` of JAX's ``init_params``), with
    no memory allocated, at any config's full size."""
    if generator is None:
        if device is None or torch.device(device).type != "meta":
            raise ValueError(f"init_params draws from a generator; only the "
                             f"meta device takes none (device={device!r})")
        generator = _NoDraws()
    elif device is not None and torch.device(device).type \
            != generator.device.type:
        raise ValueError(f"device={device!r} but the generator is on "
                         f"{generator.device}")
    gen, dt, dev = generator, cfg.param_dtype, generator.device
    params: Dict[str, Any] = {
        "embed": embed_init(gen, (cfg.vocab, cfg.d_model), dt),
    }
    fn = _maybe_norm(cfg, cfg.d_model, dev)
    if fn is not None:
        params["final_norm"] = fn
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab), dt)
    if cfg.frontend == "vision":
        params["mm_proj"] = dense_init(gen, (1024, cfg.d_model), dt)

    def dense_block():
        return {**init_attn_layer(cfg, gen), **init_mlp_layer(cfg, gen)}

    def mamba_block():
        return init_mamba_layer(cfg, gen)

    if cfg.family == "dense":
        if cfg.layer_pattern == "local_global":
            params["blocks"] = _stack_layers(
                cfg.n_layers // 2,
                lambda: {"local": dense_block(), "global": dense_block()})
        else:
            params["blocks"] = _stack_layers(cfg.n_layers, dense_block)
    elif cfg.family == "moe" and cfg.mla:
        if cfg.first_k_dense:
            # HF deepseek-v2: the dense first layer has d_ff 12288
            params["dense_blocks"] = _stack_layers(
                cfg.first_k_dense,
                lambda: {**init_mla_layer(cfg, gen),
                         **init_mlp_layer(cfg, gen, d_ff=12288)})
        params["blocks"] = _stack_layers(
            cfg.n_layers - cfg.first_k_dense,
            lambda: {**init_mla_layer(cfg, gen), **init_moe_layer(cfg, gen)})
    elif cfg.family == "moe":
        params["blocks"] = _stack_layers(
            cfg.n_layers,
            lambda: {**init_attn_layer(cfg, gen), **init_moe_layer(cfg, gen)})
    elif cfg.family == "ssm":
        params["blocks"] = _stack_layers(
            cfg.n_layers, lambda: init_rwkv_layer(cfg, gen))
        params["ln0"] = _const((cfg.d_model,), 1.0, dt, dev)
    elif cfg.family == "hybrid":
        period = cfg.attn_every
        n_periods = cfg.n_layers // period
        tail = cfg.n_layers - n_periods * period
        params["blocks"] = _stack_layers((n_periods, period), mamba_block)
        if tail:
            params["tail_blocks"] = _stack_layers(tail, mamba_block)
        params["shared_attn"] = dense_block()
    elif cfg.family == "encdec":
        params["enc_blocks"] = _stack_layers(cfg.enc_layers, dense_block)
        params["dec_blocks"] = _stack_layers(
            cfg.dec_layers,
            lambda: {**init_attn_layer(cfg, gen),
                     **init_cross_attn_layer(cfg, gen),
                     **init_mlp_layer(cfg, gen)})
        params["enc_final_norm"] = _const((cfg.d_model,), 1.0, dt, dev)
    else:
        raise ValueError(cfg.family)
    return params


def params_from_numpy(tree, cfg: ModelConfig, device=None) -> Dict[str, Any]:
    """The weight bridge: JAX's ``init_params`` output, as numpy arrays (or
    anything ``np.asarray`` takes), as the port's tree on ``device``
    (default: the CUDA card). Every leaf keeps its dtype. A bfloat16 leaf
    arrives as an ``ml_dtypes`` array, which ``torch`` does not take; it
    goes through float32, which holds every bfloat16 value exactly."""
    from ..device import resolve_device
    dev = resolve_device(device)

    def conv(a):
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        arr = np.asarray(a)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.astype(np.float32)).to(
                device=dev, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(arr)).to(dev)   # a writable copy

    params = conv(tree)
    want = (cfg.vocab, cfg.d_model)
    if tuple(params["embed"].shape) != want:
        raise ValueError(f"embed is {tuple(params['embed'].shape)}, "
                         f"{cfg.name} needs {want}")
    return params


def trainable(params):
    """Mark every floating leaf of ``params`` as requiring grad (in place)
    and return the tree, unchanged in structure: JAX's, key for key, with
    the layer leaves stacked."""
    for leaf in tree_leaves(params):
        if leaf.is_floating_point():
            leaf.requires_grad_(True)
    return params


# ----------------------------------------------------------------- counting
def count_params(tree) -> int:
    return sum(int(math.prod(l.shape)) for l in tree_leaves(tree))


def count_params_config(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic parameter count (no allocation).

    active_only: MoE layers count top_k routed + shared experts only
    (for MODEL_FLOPS = 6 * N_active * D).
    """
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    attn = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
    if cfg.qkv_bias:
        attn += hq * hd + 2 * hkv * hd
    mlp = 3 * d * cfg.d_ff
    if cfg.mla:
        dqk = cfg.qk_nope_dim + cfg.qk_rope_dim
        attn = (d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads * dqk
                + d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
                + cfg.kv_lora_rank * cfg.n_heads
                * (cfg.qk_nope_dim + cfg.v_head_dim)
                + cfg.n_heads * cfg.v_head_dim * d)
    if cfg.family in ("dense",):
        body = cfg.n_layers * (attn + mlp)
    elif cfg.family == "moe":
        n_routed = cfg.top_k if active_only else cfg.n_experts
        moe = (d * cfg.n_experts
               + n_routed * 3 * d * cfg.d_expert
               + cfg.n_shared_experts * 3 * d * cfg.d_expert)
        n_moe = cfg.n_layers - cfg.first_k_dense
        dense_ff = 12288 if cfg.mla else cfg.d_ff
        body = (n_moe * (attn + moe)
                + cfg.first_k_dense * (attn + 3 * d * dense_ff))
    elif cfg.family == "ssm":
        lora = 64
        tm = (5 * d * lora + lora * 5 * d + d * lora + lora * d
              + 5 * d * d + 2 * d)
        cm = 2 * d * cfg.d_ff + d * d
        body = cfg.n_layers * (tm + cm)
    elif cfg.family == "hybrid":
        di, n, h = cfg.d_inner, cfg.ssm_state, cfg.n_heads
        zxbcdt = 2 * di + 2 * n + h
        mamba = (d * zxbcdt + cfg.conv_kernel * (di + 2 * n)
                 + di * d + di)
        body = cfg.n_layers * mamba + (attn + mlp)   # one shared attn block
    elif cfg.family == "encdec":
        xattn = 2 * (d * hq * hd) + 2 * (d * hkv * hd)
        body = (cfg.enc_layers * (attn + mlp)
                + cfg.dec_layers * (attn + xattn + mlp))
    else:
        raise ValueError(cfg.family)
    emb = cfg.vocab * d
    if not cfg.tie_embeddings:
        emb *= 2
    return int(body + emb)
