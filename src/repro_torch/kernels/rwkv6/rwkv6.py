"""Python wrapper of the CUDA WKV kernel in ``csrc/wkv.cu`` (the Hopper
counterpart of ``repro/kernels/rwkv6/rwkv6.py``).

The wrapper takes CUDA tensors only, checks device, dtype and shape,
allocates ``o`` and the final state with ``torch.empty``, and launches on
the current stream without synchronising. The library is built on first
use (see ``kernels/_build.py``).

One design, one CTA of three warpgroups a head (``csrc/wkv.cu``), in two
instantiations, each its own C entry point, so that the launch counter
shows which one ran; :func:`wkv_route` picks one from the shape, and
nothing falls back from one to the other:

- ``wkv_split``: dk = dv = 64 with chunk 16 (rwkv6-7b's heads), every
  shape known when compiled;
- ``wkv``: every other shape (dk, dv <= 64, chunk <= 16, e.g. rwkv6-7b's
  prompts shorter than 16 tokens), masked: each head on the same 64 x 64
  tile in steps of 16 rows, padded with zeros.

Both read r, k, v and logw through their strides (the last dimension
contiguous), so the model's head-transposed views go in without copies.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # each: r, k, v, logw, u, state_in, o, state_out, the element strides
    # of b, h and s of r, k, v and logw, B, H, S, dk, dv, C, dtype, wdtype,
    # stream
    "wkv": (_P,) * 8 + (_L,) * 12 + (_I,) * 8 + (_P,),
    "wkv_split": (_P,) * 8 + (_L,) * 12 + (_I,) * 8 + (_P,),
}
ROUTES = tuple(_SIGNATURES)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 16      # e^{+-4.25 * 16} is the float32 range the scan needs
MAX_HEAD_DIM = 64
SPLIT_SHAPE = (64, 64, 16)  # (dk, dv, chunk) of the split route


def wkv_route(dk: int, dv: int, chunk: int) -> str:
    """The C entry point for heads of ``dk`` x ``dv`` scanned in chunks of
    ``chunk`` tokens (``min(chunk, S)``, as the scan uses it)."""
    return "wkv_split" if (dk, dv, chunk) == SPLIT_SHAPE else "wkv"


def wkv_cuda(r, k, v, logw, u, state=None, *, chunk: int = 16):
    """WKV scan on the card from ``state`` (None: zero). r, k, logw
    (B, H, S, dk); v (B, H, S, dv); u (H, dk); state (B, H, dk, dv) float32.
    r, k and v share a dtype (float32 or bfloat16); logw is float32 or
    bfloat16. Returns (o (B, H, S, dv) in r's dtype, final state float32).
    S must be a multiple of min(chunk, S), with that chunk <= 16. The
    inputs may be strided views. Runs the route :func:`wkv_route` picks."""
    named = {"r": r, "k": k, "v": v, "logw": logw, "u": u}
    if state is not None:
        named["state"] = state
    for name, t in named.items():
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (the plain "
                             f"version in ref.py runs on the CPU)")
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
    for name in ("k", "v"):
        if named[name].dtype != r.dtype:
            raise TypeError(f"{name} is {named[name].dtype}, r is {r.dtype}")
    if r.dtype not in DTYPES or logw.dtype not in DTYPES:
        raise TypeError(f"wkv takes float32 or bfloat16 r/k/v and logw, got "
                        f"{r.dtype} and {logw.dtype}")
    if r.dim() != 4:
        raise ValueError(f"r must be (B, H, S, dk), got {tuple(r.shape)}")
    b, h, s, dk = r.shape
    dv = v.shape[-1]
    if k.shape != r.shape or logw.shape != r.shape \
            or v.shape != (b, h, s, dv) or u.shape != (h, dk):
        raise ValueError(f"shapes: r {tuple(r.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} logw {tuple(logw.shape)} "
                         f"u {tuple(u.shape)}")
    if state is not None and (state.shape != (b, h, dk, dv)
                              or state.dtype != torch.float32):
        raise ValueError(f"state must be float32 (B, H, dk, dv) = "
                         f"{(b, h, dk, dv)}, got {state.dtype} "
                         f"{tuple(state.shape)}")
    if not (1 <= dk <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"dk={dk}, dv={dv}: the kernel takes 1..64")
    c = min(chunk, s)
    if c < 1 or s % c:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {c}")
    if c > MAX_CHUNK:
        raise ValueError(f"chunk {c} > {MAX_CHUNK}: the factorised decay "
                         f"leaves float32 range")
    o = torch.empty((b, h, s, dv), dtype=r.dtype, device=r.device)
    state_out = torch.empty((b, h, dk, dv), dtype=torch.float32,
                            device=r.device)
    if b * h == 0:
        return o, state_out
    route = wkv_route(dk, dv, c)
    u = u.float().contiguous()
    state_in = None if state is None else state.contiguous()
    r, k, v, logw = (t if t.stride(-1) == 1 else t.contiguous()
                     for t in (r, k, v, logw))
    shape = (*(st for t in (r, k, v, logw) for st in t.stride()[:3]),
             b, h, s, dk, dv, c)
    lib = _build.library("wkv", _SIGNATURES)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        _build.launch(lib, route, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                      logw.data_ptr(), u.data_ptr(),
                      None if state_in is None else state_in.data_ptr(),
                      o.data_ptr(), state_out.data_ptr(), *shape,
                      DTYPES[r.dtype], DTYPES[logw.dtype], stream)
    return o, state_out
