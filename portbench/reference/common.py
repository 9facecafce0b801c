"""Pieces every plain reference shares: float32 products with TF32 off,
the float8 control's rounding, RMSNorm and RoPE. Nothing of the program.
"""

from __future__ import annotations

import torch

F32 = torch.float32
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def full_float32() -> None:
    """Float32 products in float32: TF32 would round their inputs to 10
    bits of mantissa."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (its largest magnitude to 448), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(FP8).to(F32) * scale


def linear(x: torch.Tensor, w: torch.Tensor, precision: str = "float32"
           ) -> torch.Tensor:
    """x (..., n) @ w (n, m) in float32; ``"fp8"`` rounds x by rows and w by
    columns to float8 first."""
    w = w.to(F32)
    if precision == "fp8":
        x, w = fp8(x, -1), fp8(w, 0)
    elif precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    return torch.matmul(x, w)


def rms_norm(x: torch.Tensor, w, eps: float) -> torch.Tensor:
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return x if w is None else x * w.to(F32)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on x (B, H, L, D), the halves of D as the pairs."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=F32,
                                       device=x.device) / d)
    ang = pos.to(F32)[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
