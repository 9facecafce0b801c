"""RWKV-6 "Finch" time-mix and channel-mix (arXiv:2404.05892): the
counterpart of ``repro/models/rwkv6.py``.

Recurrence per head (r,k in R^dk, v in R^dv, data-dependent decay
w_t in (0,1)^dk, bonus u in R^dk):

    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

``wkv_chunked`` (prefill) computes the chunked parallel form in float32
with chunk size <= 16: on a CUDA tensor through the WKV kernel
(``kernels/rwkv6/csrc/wkv.cu``), on a CPU tensor through its plain
version. ``wkv_decode`` is the plain O(1)-per-token recurrence.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import obs
from ..kernels.rwkv6 import ops as wkv_ops
from .common import sigmoid, silu


def _lora_mix(x, xprev, mix, A, B):
    """RWKV6 data-dependent token-shift interpolation (ddlerp)."""
    delta = xprev - x
    base = x + delta * mix
    boost = torch.tanh(torch.einsum("bsd,dr->bsr", base, A))
    return x + delta * (mix + torch.einsum("bsr,rd->bsd", boost, B))


def _decay(base_w, xw):
    """log-decay: logw = -exp(w0 + xw), guaranteed < 0.

    Clamped to [-4.25, -1e-6]: the chunked form factorizes the pairwise
    decay e^{L_t - L_s} into e^{L_t} * e^{-L_s}, so each factor must stay
    inside fp32 range: |logw|*chunk <= 4.25*16 = 68 < log(3.4e38)~88.
    A decay of e^-4.25 ~ 0.014 zeroes the state in one step anyway, so the
    clamp is semantically negligible (and identical in the decode path).
    """
    return torch.clamp(-torch.exp(base_w + xw), -4.25, -1e-6)


def wkv_chunked(r, k, v, logw, u, state, chunk: int = 16):
    """Chunked WKV scan.

    r,k,logw: (B,H,S,dk); v: (B,H,S,dv); u: (H,dk);
    state: (B,H,dk,dv) fp32. Returns (o (B,H,S,dv), state_out).
    """
    with obs.span("rwkv.wkv"):
        return wkv_ops.wkv_with_state(r, k, v, logw, u, state.float(),
                                      chunk=chunk)


def wkv_decode(r, k, v, logw, u, state):
    """One-token recurrence. r,k,logw:(B,H,dk); v:(B,H,dv);
    state (B,H,dk,dv) fp32 -> (o (B,H,dv), state)."""
    with obs.span("rwkv.wkv"):
        rf, kf, vf = (t.float() for t in (r, k, v))
        w = torch.exp(logw.float())
        kv = kf[..., :, None] * vf[..., None, :]              # (B,H,dk,dv)
        o = torch.einsum("bhk,bhkv->bhv",
                         rf, state + u.float()[None, :, :, None] * kv)
        state = state * w[..., :, None] + kv
        return o.to(r.dtype), state


def time_mix(cfg, p, x, xprev, state, *, decode: bool = False,
             chunk: int = 16):
    """RWKV6 attention replacement.

    x: (B,S,d) (S=1 when decode); xprev: (B,d) last token of prev step;
    state: (B,H,dk,dv) fp32. Returns (out, new_xprev, new_state).
    """
    with obs.span("rwkv.time_mix"):
        b, s, d = x.shape
        h = cfg.n_heads
        dk = d // h
        shifted = torch.cat([xprev[:, None], x[:, :-1]], dim=1)

        def mixed(name):
            return _lora_mix(x, shifted, p[f"mix_{name}"],
                             p["mix_A"], p[f"mix_B_{name}"])

        r = torch.einsum("bsd,de->bse", mixed("r"), p["wr"])
        k = torch.einsum("bsd,de->bse", mixed("k"), p["wk"])
        v = torch.einsum("bsd,de->bse", mixed("v"), p["wv"])
        g = silu(torch.einsum("bsd,de->bse", mixed("g"), p["wg"]))
        xw = torch.einsum("bsd,dr->bsr", mixed("w"), p["decay_A"])
        xw = torch.einsum("bsr,rd->bsd", torch.tanh(xw), p["decay_B"])
        logw = _decay(p["decay_base"][None, None], xw)            # (B,S,d)

        def heads(t):
            return t.reshape(b, s, h, dk).transpose(1, 2)

        rh, kh, vh, lwh = heads(r), heads(k), heads(v), heads(logw)
        if decode:
            o, state = wkv_decode(rh[:, :, 0], kh[:, :, 0], vh[:, :, 0],
                                  lwh[:, :, 0], p["u"], state)
            o = o[:, :, None, :]
        else:
            o, state = wkv_chunked(rh, kh, vh, lwh, p["u"], state, chunk=chunk)
        o = o.transpose(1, 2).reshape(b, s, d)
        # per-head group norm then output gate
        o = o.reshape(b, s, h, dk)
        mu = torch.mean(o, dim=-1, keepdim=True)
        var = torch.var(o.float(), dim=-1, keepdim=True, correction=0)
        o = ((o - mu) * torch.rsqrt(var + 64e-5)).to(x.dtype)
        o = o.reshape(b, s, d) * p["ln_x"][None, None]
        out = torch.einsum("bsd,de->bse", o * g, p["wo"])
        return out.to(x.dtype), x[:, -1], state


def channel_mix(cfg, p, x, xprev):
    """RWKV6 FFN: token-shift + squared-relu MLP with receptance gate."""
    with obs.span("rwkv.channel_mix"):
        shifted = torch.cat([xprev[:, None], x[:, :-1]], dim=1)
        delta = shifted - x
        xk = x + delta * p["cmix_k"]
        xr = x + delta * p["cmix_r"]
        kk = torch.einsum("bsd,df->bsf", xk, p["ck"])
        kk = torch.square(F.relu(kk))
        vv = torch.einsum("bsf,fd->bsd", kk, p["cv"])
        rr = sigmoid(torch.einsum("bsd,de->bse", xr, p["cr"]))
        return (rr * vv).to(x.dtype), x[:, -1]
