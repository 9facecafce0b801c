"""Python wrapper of the CUDA flash-attention kernel in
``csrc/flash_attention.cu`` (the Hopper counterpart of
``repro/kernels/flash_attention/flash_attention.py``).

The wrapper takes CUDA tensors only and checks device, dtype and shape.
q, k and v may be strided views (the model passes its head-transposed
projections without a copy) as long as their last dimension is
contiguous. It allocates the (B, Hq, Sq, D) output with ``torch.empty``
and launches on the current stream without synchronising. The kernel
picks its own tiles. The library is built on first use (see
``kernels/_build.py``).

Two routes, each its own C entry point, so that the launch counter shows
which one ran; :func:`flash_route` picks one from the dtype, and nothing
falls back from one to the other:

- ``flash_attention_mma``: bfloat16 at any D <= 256, QK^T and P.V on the
  tensor cores (``wgmma`` from TMA-fed shared memory, float32
  accumulators; a view TMA cannot describe is copied by the kernel's own
  loads);
- ``flash_attention``: float32 at any D <= 256, on the CUDA cores (full
  float32 FMAs, no TF32).
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from .. import _build

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# q, k, v, o, 9 strides, batch, hq, hkv, sq, skv, d, dtype, causal,
# has_window, window, has_cap, cap, has_kv_len, kv_len, q0, scale, stream
_ARGS = (_P,) * 4 + (_L,) * 9 + (_I,) * 11 + (_F,) + (_I,) * 3 + (_F, _P)
ROUTES = ("flash_attention_mma", "flash_attention")
_SIGNATURES = {route: _ARGS for route in ROUTES}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
#: BQ = BK of both routes, at every head dim: a row whose visited keys are
#: all masked averages the keys of the tiles it visits
MMA_TILE = 64
_INT_MAX = 2 ** 31 - 1
#: launches by call shape, (route, b, hq, hkv, sq, skv, d, causal), counted
#: beside ``_build.launches`` once the launch was accepted; callers clear it
#: before the run whose calls they read
launches_by_shape: collections.Counter = collections.Counter()


def flash_route(dtype: torch.dtype, d: int) -> str:
    """The C entry point for inputs of ``dtype``: the tensor-core route for
    bfloat16, the CUDA-core one for float32 (multiplied in full float32,
    never TF32). Both take every head dim ``d`` up to ``MAX_HEAD_DIM``, so
    ``d`` does not change the route."""
    if dtype == torch.bfloat16:
        return "flash_attention_mma"
    return "flash_attention"


def _opt(x):
    return (0, 0) if x is None else (1, x)


def flash_attention_cuda(q, k, v, *, causal=True, window=None, cap=None,
                         kv_len=None, q0: int = 0) -> torch.Tensor:
    """Blockwise GQA attention on the card: q (B, Hq, Sq, D), k/v
    (B, Hkv, Skv, D), one dtype (float32 or bfloat16) on one CUDA device;
    query i sits at position q0 + i. Returns (B, Hq, Sq, D) in q's dtype,
    through the route :func:`flash_route` picks."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (the plain "
                             f"version in ref.py runs on the CPU)")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d, got {tuple(t.shape)}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, skv, d) or v.shape != k.shape:
        raise ValueError(f"k/v must be (B, Hkv, Skv, D) matching q "
                         f"{tuple(q.shape)}: k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside [1, {MAX_HEAD_DIM}]")
    if max(sq, skv, abs(q0)) > _INT_MAX // 2:
        raise ValueError("sequence too long for 32-bit positions")
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if skv == 0:
        raise ValueError("flash_attention: no keys to attend to")
    route = flash_route(q.dtype, d)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    lib = _build.library("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.launch(
            lib, route, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], b, hq, hkv, sq, skv, d, DTYPES[q.dtype],
            int(bool(causal)), *_opt(window), *_opt(cap), *_opt(kv_len),
            q0, 1.0 / math.sqrt(d), stream)
    launches_by_shape[(route, b, hq, hkv, sq, skv, d, bool(causal))] += 1
    return out
