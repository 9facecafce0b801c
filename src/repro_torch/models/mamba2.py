"""Mamba-2 (SSD) mixer (arXiv:2405.21060), used by zamba2's backbone: the
counterpart of ``repro/models/mamba2.py``.

Scalar-per-head decay SSD recurrence, per head of size P with state N:

    h_t = a_t * h_{t-1} + dt_t * x_t B_t^T        h in R^{P x N}
    y_t = h_t C_t + D * x_t

with a_t = exp(-exp(a_log) * dt_t) in (0,1). Prefill uses the chunked
parallel form in float32 (JAX's ``lax.scan`` over chunks is a Python loop
here); decode is the O(1) recurrence. A depthwise causal conv (kernel 4)
precedes the SSM on x/B/C as in Mamba. JAX computes all of it outside any
Pallas kernel, and so does the port: plain PyTorch on either device.
"""

from __future__ import annotations

from typing import Optional

import torch

from .common import silu


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def ssd_chunked(x, dt, a_log, B, C, D, state, chunk: int = 64):
    """Chunked SSD scan.

    x: (b,s,h,p); dt: (b,s,h); a_log: (h,); B, C: (b,s,n); state: (b,h,p,n)
    float32; s a multiple of min(chunk, s). Returns (y in x's dtype,
    state_out float32)."""
    b, s, h, p = x.shape
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"ssd_chunked: sequence {s} is not a multiple of "
                         f"the chunk {c}")
    xf = x.float()
    dtf = dt.float()
    la = -torch.exp(a_log.float())                          # (h,) < 0
    dla = dtf * la[None, None, :]                           # (b,s,h)
    Bf, Cf = B.float(), C.float()
    tri = torch.tril(torch.ones((c, c), dtype=torch.float32,
                                device=x.device))           # incl. diag
    S = state.float()
    ys = []
    for i in range(0, s, c):
        xc, dtc, dlc = xf[:, i:i + c], dtf[:, i:i + c], dla[:, i:i + c]
        Bc, Cc = Bf[:, i:i + c], Cf[:, i:i + c]
        L = torch.cumsum(dlc, dim=1)                        # (b,c,h) incl.
        # inter-chunk: the state decayed by every decay up to and with t
        y = torch.einsum("bcn,bhpn,bch->bchp", Cc, S, torch.exp(L))
        # intra-chunk: pairwise decay e^{L_t - L_s} for s <= t. The mask is
        # applied inside the exp: for t < s the difference is positive and
        # would overflow float32 before a mask could zero it (inf*0 = NaN).
        diff = L[:, :, None, :] - L[:, None, :, :]          # (b,t,s,h)
        diff = torch.where(tri[None, :, :, None] > 0, diff, -torch.inf)
        att = torch.einsum("btn,bsn,btsh->bths", Cc, Bc, torch.exp(diff))
        y = y + torch.einsum("bths,bsh,bshp->bthp", att, dtc, xc)
        # state update
        Ltot = L[:, -1:, :]                                 # (b,1,h)
        carry_decay = torch.exp(Ltot - L)                   # (b,c,h)
        S = S * torch.exp(Ltot)[:, 0, :, None, None] + torch.einsum(
            "bsh,bshp,bsn->bhpn", dtc * carry_decay, xc, Bc)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    y = y + D.float()[None, None, :, None] * xf
    return y.to(x.dtype), S


def ssd_decode(x, dt, a_log, B, C, D, state):
    """One-token recurrence. x: (b,h,p); dt: (b,h); B, C: (b,n); state
    (b,h,p,n) float32. Returns (y in x's dtype, state)."""
    xf = x.float()
    dtf = dt.float()
    a = torch.exp(dtf * (-torch.exp(a_log.float()))[None, :])
    state = state * a[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dtf, xf, B.float())
    y = torch.einsum("bhpn,bn->bhp", state, C.float())
    y = y + D.float()[None, :, None] * xf
    return y.to(x.dtype), state


def causal_conv(x, w, cache: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d. x: (b,s,d); w: (k,d).

    With ``cache`` ((b,k-1,d)) it convolves as a stream (decode) and
    returns the updated cache: the last k-1 inputs."""
    k = w.shape[0]
    if cache is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
        xp = torch.cat([pad, x], dim=1)
    else:
        xp = torch.cat([cache.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i][None, None] for i in range(k))
    new_cache = xp[:, -(k - 1):] if k > 1 else None
    return silu(out), new_cache


def mamba2_mixer(cfg, p, x, state, conv_cache, *, decode: bool = False,
                 chunk: int = 64):
    """Full Mamba-2 block mixer.

    x: (b,s,d); state: (b,h,p,n) float32; conv_cache: (b,k-1,conv_dim)
    (None on a full sequence). Returns (out, state, conv_cache)."""
    b, s, d = x.shape
    h = cfg.n_heads
    di = cfg.d_inner
    pdim = di // h
    n = cfg.ssm_state
    # the (z, x) and the (B, C, dt) projections, as JAX splits them
    zx = torch.einsum("bsd,de->bse", x, p["in_zx"])
    z, xin = zx[..., :di], zx[..., di:]
    bcdt = torch.einsum("bsd,de->bse", x, p["in_bcdt"])
    Bc, Cc, dt = bcdt[..., :n], bcdt[..., n:2 * n], bcdt[..., 2 * n:]
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    conv_out, conv_cache = causal_conv(conv_in, p["conv_w"], conv_cache)
    xin = conv_out[..., :di]
    Bc = conv_out[..., di:di + n]
    Cc = conv_out[..., di + n:]
    dt = _softplus(dt + p["dt_bias"][None, None])           # (b,s,h) f32
    xh = xin.reshape(b, s, h, pdim)
    if decode:
        y, state = ssd_decode(xh[:, 0], dt[:, 0], p["a_log"], Bc[:, 0],
                              Cc[:, 0], p["D"], state)
        y = y[:, None]
    else:
        y, state = ssd_chunked(xh, dt, p["a_log"], Bc, Cc, p["D"], state,
                               chunk=chunk)
    y = y.reshape(b, s, di)
    # gated RMSNorm (mamba2 style), float32, eps 1e-6
    yf = y.float() * silu(z.float())
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + 1e-6) * p["out_norm"].float()
    out = torch.einsum("bse,ed->bsd", yf.to(x.dtype), p["out_proj"])
    return out, state, conv_cache
