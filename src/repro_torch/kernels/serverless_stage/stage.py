"""Python wrapper of the CUDA chunk-gather kernel in
``csrc/serverless_stage.cu`` (the Hopper counterpart of
``repro/kernels/serverless_stage/stage.py``).

The wrapper takes its source as a CUDA tensor only, checks device, dtype,
shape and contiguity, allocates its output with ``torch.empty``, and
launches on the current stream without synchronising. The library is built
on first use (see ``kernels/_build.py``). The plain version lives in
``ref.py``; the ops take it for CPU tensors, never for CUDA ones.

Two routes, each its own C entry point, so that the launch counter shows
which one ran; :func:`gather_route` picks one from where the routing lies
and how long it is, and nothing falls back from one to the other:

- ``chunk_gather_byval``: ``src_row`` and ``valid`` lie on the host (numpy
  arrays or CPU tensors) and NOUT <= :data:`BYVAL_CAP`. They go into the
  launch's parameters, with no copy to the card (the counterpart of the TPU
  kernel's scalar prefetch);
- ``chunk_gather``: the routing is on the card, or longer. From the host it
  is copied over in one copy.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build

CHUNK = 128                     # int32 elements per staged chunk (512 B)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # src, src_row, valid, out, nout, nsrc, chunk, stream; the routing on
    # the card
    "chunk_gather": (_P, _P, _P, _P, _L, _L, _I, _P),
    # the same, the routing in host memory
    "chunk_gather_byval": (_P, _P, _P, _P, _L, _L, _I, _P),
}
#: the C entry points, by-value route first
ROUTES = ("chunk_gather_byval", "chunk_gather")
#: most chunks the by-value route takes: src_row and valid, 8 bytes a chunk,
#: in CUDA 12.1's 32,764 bytes of kernel parameters. Every chain gather
#: fits: 16 payloads x 128 chunks (64 KiB)
BYVAL_CAP = 2048
#: output chunks per block of the kernel (one per warp)
_WARPS = 8
_MAX_GRID_X = 2 ** 31 - 1


def gather_route(on_host: bool, nout: int) -> str:
    """The C entry point for NOUT chunks whose routing lies on the host
    (``on_host``) or on the card."""
    return ROUTES[0] if on_host and nout <= BYVAL_CAP else ROUTES[1]


def _host_routing(named: dict) -> dict:
    """numpy arrays or CPU tensors -> contiguous int32 numpy arrays."""
    out = {}
    for name, a in named.items():
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        if a.dtype != np.int32:
            raise TypeError(f"{name} must be int32, got {a.dtype}")
        out[name] = np.ascontiguousarray(a)
    return out


def chunk_gather_cuda(src, src_row, valid, *, chunk: int = CHUNK):
    """Gather ``len(src_row)`` chunks out of ``src`` on the card.

    src (NSRC, chunk) int32, a CUDA tensor; src_row (NOUT,) and valid
    (NOUT,) int32, both CUDA tensors on src's device or both on the host
    (numpy arrays or CPU tensors) -> (NOUT, chunk) int32 with out[j] =
    src[r(j)] and lanes >= valid[j] zeroed (see ``ref.chunk_gather_ref``
    for how an out-of-range id resolves). NOUT == 0 returns an empty
    output without a launch; NSRC == 0 with NOUT > 0 raises ``ValueError``.
    Runs the route :func:`gather_route` picks.
    """
    routing = {"src_row": src_row, "valid": valid}
    on_host = [not isinstance(a, torch.Tensor) or a.device.type == "cpu"
               for a in routing.values()]
    named = {"src": src}
    if all(on_host):
        routing = _host_routing(routing)
    elif any(on_host):
        raise ValueError("src_row and valid must lie both on the card or "
                         "both on the host")
    else:
        named.update(routing)
    for name, t in named.items():
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (the plain "
                             f"version in ref.py runs on the CPU)")
        if t.device != src.device:
            raise ValueError(f"{name} is on {t.device}, src on {src.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if chunk < 1 or src.dim() != 2 or src.shape[1] != chunk:
        raise ValueError(f"src must be (NSRC, {chunk}), got "
                         f"{tuple(src.shape)}")
    src_row, valid = routing.values()
    nout = src_row.shape[0] if src_row.ndim == 1 else -1
    if nout < 0 or tuple(valid.shape) != (nout,):
        raise ValueError("src_row and valid must be (NOUT,)")
    out = torch.empty((nout, chunk), dtype=torch.int32, device=src.device)
    if nout == 0:
        return out
    if src.shape[0] == 0:
        raise ValueError("chunk_gather: src has no rows to gather from")
    if -(-nout // _WARPS) > _MAX_GRID_X:
        raise ValueError(f"{nout} chunks need more than {_MAX_GRID_X} "
                         f"blocks")
    route = gather_route(all(on_host), nout)
    if route == "chunk_gather_byval":
        ptrs = (src_row.ctypes.data, valid.ctypes.data)
    else:
        if all(on_host):                  # one copy for both tables
            both = torch.from_numpy(np.stack([src_row, valid])).to(
                src.device)
            src_row, valid = both
        ptrs = (src_row.data_ptr(), valid.data_ptr())
    lib = _build.library("serverless_stage", _SIGNATURES)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        _build.launch(lib, route, src.data_ptr(), *ptrs, out.data_ptr(),
                      nout, src.shape[0], chunk, stream)
    return out
