"""Public wrappers for the WKV kernel (the counterpart of
``repro/kernels/rwkv6/ops.py``).

``impl="kernel"`` (JAX's ``"pallas"``) launches the CUDA kernel, ``"ref"``
runs the plain PyTorch version. ``device=`` takes the place of JAX's
``interpret=``: inputs that are numpy arrays go to that device (default:
the CUDA card). For tensors on the CPU every impl runs the plain version;
on a CUDA tensor ``"kernel"`` launches the kernel or raises. Tensors keep
their strides: the kernel's wrapper reads them as they are or copies them
for the route that needs contiguous inputs.
"""

from __future__ import annotations

import torch

from ...device import on_device
from .ref import wkv_chunked_ref
from .rwkv6 import wkv_cuda

IMPLS = ("kernel", "ref")


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
    if impl == "ref" or r.device.type == "cpu":
        if state is None:
            state = torch.zeros((*r.shape[:2], r.shape[-1], v.shape[-1]),
                                dtype=torch.float32, device=r.device)
        return wkv_chunked_ref(r, k, v, logw, u, state, chunk=chunk)
    return wkv_cuda(r, k, v, logw, u, state, chunk=chunk)


def wkv(r, k, v, logw, u, *, chunk: int = 16, impl: str = "kernel",
        device=None) -> torch.Tensor:
    """RWKV-6 WKV scan from a zero state; returns o (B,H,S,dv)."""
    return wkv_with_state(r, k, v, logw, u, chunk=chunk, impl=impl,
                          device=device)[0]
