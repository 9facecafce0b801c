"""Python wrapper of the CUDA chunk-gather kernel in
``csrc/serverless_stage.cu`` (the Hopper counterpart of
``repro/kernels/serverless_stage/stage.py``).

The wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates its output with ``torch.empty``, and launches on the
current stream without synchronising. The library is built on first use
(see ``kernels/_build.py``). The plain version lives in ``ref.py``; the ops
take it for CPU tensors, never for CUDA ones.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

CHUNK = 128                     # int32 elements per staged chunk (512 B)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # src, src_row, valid, out, nout, nsrc, chunk, stream
    "chunk_gather": (_P, _P, _P, _P, _L, _L, _I, _P),
}
#: output chunks per block of the kernel (one per warp)
_WARPS = 8
_MAX_GRID_X = 2 ** 31 - 1


def chunk_gather_cuda(src, src_row, valid, *, chunk: int = CHUNK):
    """Gather ``len(src_row)`` chunks out of ``src`` on the card.

    src (NSRC, chunk) int32, src_row (NOUT,) int32, valid (NOUT,) int32,
    all CUDA tensors on one device -> (NOUT, chunk) int32 with out[j] =
    src[r(j)] and lanes >= valid[j] zeroed (see ``ref.chunk_gather_ref``
    for how an out-of-range id resolves). NOUT == 0 returns an empty
    output without a launch; NSRC == 0 with NOUT > 0 raises ``ValueError``.
    """
    named = {"src": src, "src_row": src_row, "valid": valid}
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
    nout = src_row.shape[0] if src_row.dim() == 1 else -1
    if nout < 0 or valid.shape != (nout,):
        raise ValueError("src_row and valid must be (NOUT,)")
    out = torch.empty((nout, chunk), dtype=torch.int32, device=src.device)
    if nout == 0:
        return out
    if src.shape[0] == 0:
        raise ValueError("chunk_gather: src has no rows to gather from")
    if -(-nout // _WARPS) > _MAX_GRID_X:
        raise ValueError(f"{nout} chunks need more than {_MAX_GRID_X} "
                         f"blocks")
    lib = _build.library("serverless_stage", _SIGNATURES)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        _build.launch(lib, "chunk_gather", src.data_ptr(),
                      src_row.data_ptr(), valid.data_ptr(), out.data_ptr(),
                      nout, src.shape[0], chunk, stream)
    return out
