"""Public wrappers for the WKV kernel (the counterpart of
``repro/kernels/rwkv6/ops.py``).

``impl="kernel"`` (JAX's ``"pallas"``) launches the CUDA kernel, ``"ref"``
runs the plain PyTorch version. ``device=`` takes the place of JAX's
``interpret=``: inputs that are numpy arrays go to that device (default:
the CUDA card). For tensors on the CPU every impl runs the plain version;
on a CUDA tensor ``"kernel"`` launches the kernel or raises. Tensors keep
their strides: the kernel's wrapper reads them as they are (a copy only
where the last dimension is not contiguous).

Gradients: as for flash attention (``kernels/flash_attention/ops.py``),
a recorded call on CUDA tensors goes through :class:`WkvFunction`, whose
forward launches the kernel and whose backward recomputes ``o`` and the
final state through the plain chunked version; gradients reach r, k, v,
logw, u and the initial state, from cotangents on either output. An
unrecorded call launches the kernel directly.
"""

from __future__ import annotations

import torch

from ...device import on_device
from .ref import wkv_chunked_ref
from .rwkv6 import wkv_cuda

IMPLS = ("kernel", "ref")


def recompute_grads(r, k, v, logw, u, state, do, dstate, needs, *,
                    chunk: int = 16):
    """Gradients of the plain chunked version at (r, k, v, logw, u, state)
    (``state`` None: zero) against the cotangents ``do`` and ``dstate`` (None:
    that output takes none), recomputed under autograd; None where
    ``needs`` is false."""
    ins = [None if t is None else t.detach().requires_grad_(n)
           for t, n in zip((r, k, v, logw, u, state), needs)]
    if ins[5] is None:
        ins[5] = torch.zeros((*r.shape[:2], r.shape[-1], v.shape[-1]),
                             dtype=torch.float32, device=r.device)
    pairs = [(o, g) for o, g in zip((0, 1), (do, dstate)) if g is not None]
    wrt = [t for t in ins if t.requires_grad]
    if not pairs or not wrt:
        return [None] * 6
    with torch.enable_grad():
        outs = wkv_chunked_ref(*ins, chunk=chunk)
        got = iter(torch.autograd.grad(
            [outs[i] for i, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True, materialize_grads=True))
    return [next(got) if n else None for n in needs]


class WkvFunction(torch.autograd.Function):
    """``forward(r, k, v, logw, u, state, chunk=chunk)`` as the forward (the
    CUDA kernel; the tests pass the plain version on the CPU), the plain
    chunked version's recomputed gradients as the backward. It saves the
    six inputs (``state`` may be None: a zero state)."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state, forward, chunk):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, logw, u, state)
        return forward(r, k, v, logw, u, state, chunk=chunk)

    @staticmethod
    def backward(ctx, do, dstate):
        grads = recompute_grads(*ctx.saved_tensors, do, dstate,
                                ctx.needs_input_grad[:6], chunk=ctx.chunk)
        return (*grads, None, None)


def wkv_with_state(r, k, v, logw, u, state=None, *, chunk: int = 16,
                   impl: str = "kernel", device=None):
    """RWKV-6 WKV scan from ``state`` (None: zero): r, k, logw (B,H,S,dk);
    v (B,H,S,dv); u (H,dk). Returns (o (B,H,S,dv) in r's dtype, final
    state (B,H,dk,dv) float32)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    arrays = (r, k, v, logw, u) + (() if state is None else (state,))
    arrays = on_device(device, arrays, (None,) * len(arrays),
                       contiguous=False)
    r, k, v, logw, u = arrays[:5]
    state = arrays[5] if len(arrays) > 5 else None
    # a meta tensor (the dry run's trace) computes nothing: the plain
    # version gives its shape and FLOPs; a CUDA tensor still reaches the
    # kernel or raises
    if impl == "ref" or r.device.type in ("cpu", "meta"):
        if state is None:
            state = torch.zeros((*r.shape[:2], r.shape[-1], v.shape[-1]),
                                dtype=torch.float32, device=r.device)
        return wkv_chunked_ref(r, k, v, logw, u, state, chunk=chunk)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (r, k, v, logw, u, state)):
        return WkvFunction.apply(r, k, v, logw, u, state, wkv_cuda, chunk)
    return wkv_cuda(r, k, v, logw, u, state, chunk=chunk)


def wkv(r, k, v, logw, u, *, chunk: int = 16, impl: str = "kernel",
        device=None) -> torch.Tensor:
    """RWKV-6 WKV scan from a zero state; returns o (B,H,S,dv)."""
    return wkv_with_state(r, k, v, logw, u, chunk=chunk, impl=impl,
                          device=device)[0]
