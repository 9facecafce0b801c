"""Shared numerical building blocks (norms, RoPE, activations, init): the
counterpart of ``repro/models/common.py``.

Every dtype cast the JAX code makes is made in the same place: the norms,
``apply_rope`` and ``softcap`` compute in float32 and cast back to the
input's dtype. Initialisers draw from an explicit ``torch.Generator`` on
its device (``jax.random`` keys have no counterpart; the distributions are
the same, the numbers are not); on the meta device, which has no
generator, they make the shape and draw nothing. ``with_sharding`` and
``shard_seq`` (sharding constraints inside JAX's jitted model) have no
counterpart on one device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# ------------------------------------------------------------------ norms
def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
             eps: float = 1e-6, plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in fp32 (weight=None -> non-parametric, olmo-style)."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    if weight is not None:
        w = weight.float()
        xf = xf * (1.0 + w if plus_one else w)
    return xf.to(dt)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], eps: float = 1e-5
               ) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        xf = xf * weight.float()
    if bias is not None:
        xf = xf + bias.float()
    return xf.to(dt)


def apply_norm(cfg, x: torch.Tensor, w) -> torch.Tensor:
    if cfg.norm == "rms":
        plus_one = cfg.name.startswith("gemma")
        return rms_norm(x, w, plus_one=plus_one)
    if cfg.norm == "nonparam":
        return layer_norm(x, None, None)
    return layer_norm(x, w, None)


# ---------------------------------------------------------- decode position
def decode_positions(pos, b: int, device) -> torch.Tensor:
    """(b, 1) int64 positions all ``pos``: an int, or a 0-d integer tensor
    read on the device (no host read, so a meta trace of a decode step
    runs)."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device, torch.int64).reshape(1, 1).expand(b, 1)
    return torch.full((b, 1), pos, device=device)


def write_at(cache: torch.Tensor, dim: int, pos, new: torch.Tensor) -> None:
    """``cache``'s index ``pos`` along ``dim`` = ``new`` (its extent 1
    there), in place; ``pos`` an int or a 0-d integer tensor, as in
    :func:`decode_positions`."""
    if isinstance(pos, torch.Tensor):
        cache.index_copy_(dim, pos.to(cache.device, torch.int64).reshape(1),
                          new.to(cache.dtype))
    else:
        cache.narrow(dim, pos, 1).copy_(new)


# ------------------------------------------------------------------- rope
def rope_freqs(d: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, D) with D even; positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                     # (D/2,)
    angles = positions.float()[..., None] * freqs              # (..., S, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- activations
# JAX evaluates these in the input's dtype one primitive at a time (a
# bfloat16 sigmoid is exp, add and divide, each rounded to bfloat16), and
# its Python constants are rounded to that dtype first. The port does the
# same: every step of a bfloat16 activation is rounded where JAX rounds it.
def dtype_scalar(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype`` (as JAX's weakly typed constants are),
    as a Python float, so that it costs no device transfer."""
    return float(torch.tensor(c, dtype=dtype))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: 1 / (1 + exp(-x)), each step in x's dtype."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x) in x's dtype."""
    return x * sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)``, step by step in x's dtype."""
    c1 = dtype_scalar(0.044715, x.dtype)
    c2 = dtype_scalar(math.sqrt(2.0 / math.pi), x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c2 * (x + c1 * (x * x * x))))
    return x * cdf


def _relu2(x):
    return torch.square(F.relu(x))


def act_fn(name: str):
    if name == "silu":
        return silu
    if name == "gelu":
        return gelu_tanh
    if name == "relu2":
        return _relu2
    raise ValueError(name)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# -------------------------------------------------------------------- init
def dense_init(generator: torch.Generator, shape, dtype,
               in_axis: int = -2) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun-style): a standard normal cut at
    +-2, times 1/sqrt(fan_in), drawn in float32 on the generator's device
    and cast to ``dtype``."""
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    std = 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * std).to(dtype)


def normal_init(generator: torch.Generator, shape, dtype,
                std: float) -> torch.Tensor:
    """A normal draw in float32 times ``std``, cast to ``dtype``."""
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * std).to(dtype)


def embed_init(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    return normal_init(generator, shape, dtype, 0.02)
