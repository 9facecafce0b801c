"""Public wrapper for the flash-attention kernel (the counterpart of
``repro/kernels/flash_attention/ops.py``).

``impl="kernel"`` (JAX's ``"pallas"``) launches the CUDA kernel,
``"ref"`` runs the plain PyTorch version. ``device=`` takes the place of
JAX's ``interpret=``: inputs that are numpy arrays go to that device
(default: the CUDA card). For tensors on the CPU every impl runs the plain
version; on a CUDA tensor ``"kernel"`` launches the kernel or raises.
``bq`` and ``bk`` stay in the signature for parity with JAX: the kernel
picks its own tiles, and the result does not depend on them. ``q0`` places
query i at position q0 + i (the model's ``attention`` takes it); tensors
keep their strides, which the kernel reads as they are.

Gradients: the kernel computes no backward (nor does the Pallas kernel it
replaces; JAX trains through XLA's autodiff of plain attention). When
autograd records the call (grad mode on and q, k or v requiring grad), a
CUDA input goes through :class:`FlashAttentionFunction`: its forward
launches the kernel exactly as an unrecorded call does, and its backward
recomputes the output through the plain version and returns that
recompute's gradients, the gradients of JAX's own training path. An
unrecorded call launches the kernel directly, as serving does.
"""

from __future__ import annotations

import torch

from ...device import on_device
from .flash_attention import flash_attention_cuda
from .ref import flash_attention_ref

IMPLS = ("kernel", "ref")
#: elements of the plain version's float32 scores (B x Hq x Sq x Skv) that
#: one backward recompute may hold (4 GiB; autograd keeps about four
#: tensors of that size alive); larger inputs are recomputed a few batch
#: rows at a time, rows being independent
RECOMPUTE_MAX_SCORES = 2 ** 30


def recompute_grads(q, k, v, do, needs, **kw):
    """Gradients of the plain version at (q, k, v) against the cotangent
    ``do`` (None where ``needs`` is false), recomputed under autograd in
    chunks of batch rows that hold at most ``RECOMPUTE_MAX_SCORES``
    scores."""
    b, hq, sq, _ = q.shape
    rows = max(1, RECOMPUTE_MAX_SCORES // max(1, hq * sq * k.shape[2]))
    parts = []
    for i in range(0, b, rows):
        ins = [t[i:i + rows].detach().requires_grad_(n)
               for t, n in zip((q, k, v), needs)]
        with torch.enable_grad():
            o = flash_attention_ref(*ins, **kw)
            wrt = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(o, wrt, do[i:i + rows]))
        parts.append([next(got) if n else None for n in needs])
    if len(parts) == 1:
        return parts[0]
    return [torch.cat(g) if n else None for n, g in zip(needs, zip(*parts))]


class FlashAttentionFunction(torch.autograd.Function):
    """``forward(q, k, v, **kw)`` as the forward (the CUDA kernel; the
    tests pass the plain version on the CPU), the plain version's
    recomputed gradients as the backward. It saves q, k, v and every
    keyword; the output is not saved."""

    @staticmethod
    def forward(ctx, q, k, v, forward, causal, window, cap, kv_len, q0):
        ctx.kw = dict(causal=causal, window=window, cap=cap, kv_len=kv_len,
                      q0=q0)
        ctx.save_for_backward(q, k, v)
        return forward(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        grads = recompute_grads(q, k, v, do, ctx.needs_input_grad[:3],
                                **ctx.kw)
        return (*grads,) + (None,) * 6


def differentiable(q, k, v, forward=flash_attention_cuda, *, causal=True,
                   window=None, cap=None, kv_len=None, q0: int = 0):
    """``forward`` under :class:`FlashAttentionFunction`."""
    return FlashAttentionFunction.apply(q, k, v, forward, causal, window,
                                        cap, kv_len, q0)


def flash_attention(q, k, v, *, causal=True, window=None, cap=None,
                    bq=128, bk=128, kv_len=None, q0: int = 0,
                    impl: str = "kernel", device=None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if bq < 1 or bk < 1:
        raise ValueError(f"block sizes must be positive: bq={bq} bk={bk}")
    q, k, v = on_device(device, (q, k, v), (None,) * 3, contiguous=False)
    # a meta tensor (the dry run's trace) computes nothing: the plain
    # version gives its shape, FLOPs and collectives; a CUDA tensor still
    # reaches the kernel or raises
    if impl == "ref" or q.device.type in ("cpu", "meta"):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   cap=cap, kv_len=kv_len, q0=q0)
    kw = dict(causal=causal, window=window, cap=cap, kv_len=kv_len, q0=q0)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return differentiable(q, k, v, **kw)
    return flash_attention_cuda(q, k, v, **kw)
