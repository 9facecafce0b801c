"""Plain PyTorch versions of the WKV kernel (the counterpart of
``repro/kernels/rwkv6/ref.py``): the chunked form the model computes
(``repro/models/rwkv6.py::wkv_chunked``) and the token-by-token
recurrence that both chunked forms must match.

Shapes: r, k, logw (B, H, S, dk); v (B, H, S, dv); u (H, dk); state
(B, H, dk, dv) float32. All arithmetic is float32; ``o`` comes back in
r's dtype.
"""

from __future__ import annotations

import torch


def inclusive_scan(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive prefix sums of ``x`` along ``dim`` in a fixed order on any
    device: ceil(log2 n) shifted adds (Hillis-Steele), each an elementwise
    add in ``x``'s dtype. torch's float ``cumsum`` has no deterministic CUDA
    implementation, and a product with a ones mask would follow the TF32
    setting; these adds are exact in float32 and the same on every run."""
    n = x.shape[dim]
    shift = 1
    while shift < n:
        pad = x.new_zeros(x.shape[:dim] + (shift,) + x.shape[dim + 1:])
        x = x + torch.cat([pad, x.narrow(dim, 0, n - shift)], dim=dim)
        shift *= 2
    return x


def wkv_chunked_ref(r, k, v, logw, u, state, chunk: int = 16):
    """Chunked WKV scan from ``state``. Returns (o (B,H,S,dv), final state
    (B,H,dk,dv) float32). S must be a multiple of min(chunk, S)."""
    b, h, s, dk = r.shape
    dv = v.shape[-1]
    c = min(chunk, s)
    if c < 1 or s % c:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {c}")
    n = s // c
    rf, kf, lw = (t.float().reshape(b, h, n, c, dk) for t in (r, k, logw))
    vf = v.float().reshape(b, h, n, c, dv)
    uf = u.float()
    tri = torch.tril(torch.ones((c, c), dtype=torch.float32,
                                device=r.device), diagonal=-1)
    Lx_all = inclusive_scan(lw, dim=3)     # in-chunk prefix sums, all chunks
    S = state.float()
    outs = []
    for i in range(n):
        rc, kc, vc, lwc = rf[:, :, i], kf[:, :, i], vf[:, :, i], lw[:, :, i]
        Lx = Lx_all[:, :, i]                                   # inclusive
        Lex = Lx - lwc                                         # exclusive
        r_dec = rc * torch.exp(Lex)                            # r_t e^{L_t}
        k_inc = kc * torch.exp(-Lx)                    # k_s e^{-L_{s+1}}
        o = torch.einsum("bhck,bhkv->bhcv", r_dec, S)          # inter-chunk
        att = torch.einsum("bhck,bhsk->bhcs", r_dec, k_inc) * tri
        o = o + torch.einsum("bhcs,bhsv->bhcv", att, vc)       # intra-chunk
        bonus = torch.sum(rc * uf[None, :, None, :] * kc, dim=-1,
                          keepdim=True)                        # current token
        o = o + bonus * vc
        Ltot = Lx[:, :, -1:, :]                                # (B,H,1,dk)
        S = S * torch.exp(Ltot[:, :, 0, :, None]) + torch.einsum(
            "bhsk,bhsv->bhkv", kc * torch.exp(Ltot - Lx), vc)
        outs.append(o)
    o = torch.stack(outs, dim=2).reshape(b, h, s, dv)
    return o.to(r.dtype), S


def wkv_ref(r, k, v, logw, u):
    """Chunked reference with zero initial state."""
    b, h, _, dk = r.shape
    state = torch.zeros((b, h, dk, v.shape[-1]), dtype=torch.float32,
                        device=r.device)
    return wkv_chunked_ref(r, k, v, logw, u, state)[0]


def wkv_sequential(r, k, v, logw, u):
    """Token-by-token recurrence (slow, exact)."""
    b, h, s, dk = r.shape
    dv = v.shape[-1]
    rf, kf, vf, lw = (t.float() for t in (r, k, v, logw))
    uf = u.float()
    state = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(s):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, :, t],
                                 state + uf[None, :, :, None] * kv))
        state = state * torch.exp(lw[:, :, t])[..., None] + kv
    return torch.stack(outs, dim=2).to(r.dtype)
