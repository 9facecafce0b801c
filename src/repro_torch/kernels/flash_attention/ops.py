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
"""

from __future__ import annotations

import torch

from ...device import on_device
from .flash_attention import flash_attention_cuda
from .ref import flash_attention_ref

IMPLS = ("kernel", "ref")


def flash_attention(q, k, v, *, causal=True, window=None, cap=None,
                    bq=128, bk=128, kv_len=None, q0: int = 0,
                    impl: str = "kernel", device=None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if bq < 1 or bk < 1:
        raise ValueError(f"block sizes must be positive: bq={bq} bk={bk}")
    q, k, v = on_device(device, (q, k, v), (None,) * 3, contiguous=False)
    if impl == "ref" or q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   cap=cap, kv_len=kv_len, q0=q0)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                cap=cap, kv_len=kv_len, q0=q0)
