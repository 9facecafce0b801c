"""Python wrappers of the three CUDA lookup kernels in ``csrc/race_lookup.cu``
(the Hopper counterparts of ``repro/kernels/race_lookup/race_lookup.py``).

Each wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty``, and launches on the
current stream without synchronising. The library is built on first use
(see ``kernels/_build.py``). The plain versions live in ``ref.py``; the ops
take them for CPU tensors, never for CUDA ones.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # fp, val, queries, bidx, out, found, nq, nb, nslot, row_bytes, qblock,
    # stream
    "race_lookup_tiled": (_P, _P, _P, _P, _P, _P, _L, _L, _I, _L, _I, _P),
    # fp, val, queries, bidx, out, found, nq, nb, nslot, row_bytes, stream
    "race_lookup_scalar": (_P, _P, _P, _P, _P, _P, _L, _L, _I, _L, _P),
    # fp, val, queries, bidx, shard_idx, out, found, nq, ns, nb, nslot,
    # row_bytes, qblock, stream
    "race_lookup_sharded": (_P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _I, _L,
                            _I, _P),
}
#: most blocks a grid's x dimension takes
_MAX_GRID_X = 2 ** 31 - 1
#: queries per block of the tiled and sharded kernels: one per warp of the
#: block's 8. The JAX kernels' 64 (an MXU-sized tile) would make each warp
#: run 8 dependent lookups in a row, which measured slower on the H100
#: (PERF.md).
QBLOCK = 8


def _lib():
    return _build.library("race_lookup", _SIGNATURES)


def _check(fp, val, queries, bucket_idx, shard_idx=None, *, sharded=False):
    """Validate the inputs; returns (nq, ns, nb, nslot, vdim)."""
    named = {"fp_table": fp, "val_table": val, "queries": queries,
             "bucket_idx": bucket_idx}
    if sharded:
        named["shard_idx"] = shard_idx
    for name, t in named.items():
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (the plain "
                             f"version in ref.py runs on the CPU)")
        if t.device != fp.device:
            raise ValueError(f"{name} is on {t.device}, fp_table on "
                             f"{fp.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "val_table" and t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    lead = 1 if sharded else 0
    if fp.dim() != 2 + lead or val.dim() != 3 + lead \
            or val.shape[:-1] != fp.shape:
        raise ValueError(f"table shapes fp {tuple(fp.shape)} / val "
                         f"{tuple(val.shape)} do not match")
    ns = fp.shape[0] if sharded else 1
    nb, nslot = fp.shape[-2:]
    if min(ns, nb, nslot) < 1:
        raise ValueError("tables need at least one shard, bucket and slot")
    nq = queries.shape[0] if queries.dim() == 1 else -1
    if nq < 0 or bucket_idx.shape != (nq, 2) \
            or (sharded and shard_idx.shape != (nq,)):
        raise ValueError("queries must be (NQ,), bucket_idx (NQ, 2) and "
                         "shard_idx (NQ,)")
    return nq, ns, nb, nslot, val.shape[-1]


def _check_grid(nq: int, qblock: int) -> None:
    if qblock < 1:
        raise ValueError("qblock must be >= 1")
    if -(-nq // qblock) > _MAX_GRID_X:
        raise ValueError(f"{nq} queries need more than {_MAX_GRID_X} blocks "
                         f"of {qblock}")


def _outputs(val, nq, vdim):
    return (torch.empty((nq, vdim), dtype=val.dtype, device=val.device),
            torch.empty((nq,), dtype=torch.int32, device=val.device))


def _launch(symbol, device, *args):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _build.launch(_lib(), symbol, *args, stream)


def race_lookup_tiled(fp_table, val_table, queries, bucket_idx,
                      qblock: int = QBLOCK):
    """Tiled kernel: ``qblock`` queries per block of 8 warps, each warp
    taking every 8th query of the block. fp_table (NB, NSLOT) int32,
    val_table (NB, NSLOT, VDIM) any dtype, queries (NQ,) int32, bucket_idx
    (NQ, 2) int32 -> (values (NQ, VDIM), found (NQ,) int32)."""
    nq, _, nb, nslot, vdim = _check(fp_table, val_table, queries, bucket_idx)
    _check_grid(nq, qblock)
    values, found = _outputs(val_table, nq, vdim)
    if nq:
        _launch("race_lookup_tiled", fp_table.device, fp_table.data_ptr(),
                val_table.data_ptr(), queries.data_ptr(),
                bucket_idx.data_ptr(), values.data_ptr(), found.data_ptr(),
                nq, nb, nslot, vdim * val_table.element_size(), qblock)
    return values, found


def race_lookup_scalar(fp_table, val_table, queries, bucket_idx):
    """Scalar kernel: one block of one warp per query. Same contract as
    :func:`race_lookup_tiled`."""
    nq, _, nb, nslot, vdim = _check(fp_table, val_table, queries, bucket_idx)
    _check_grid(nq, 1)
    values, found = _outputs(val_table, nq, vdim)
    if nq:
        _launch("race_lookup_scalar", fp_table.device, fp_table.data_ptr(),
                val_table.data_ptr(), queries.data_ptr(),
                bucket_idx.data_ptr(), values.data_ptr(), found.data_ptr(),
                nq, nb, nslot, vdim * val_table.element_size())
    return values, found


def race_lookup_sharded(fp_tables, val_tables, queries, bucket_idx,
                        shard_idx, qblock: int = QBLOCK):
    """Sharded kernel over stacked tables: fp_tables (NS, NB, NSLOT) int32,
    val_tables (NS, NB, NSLOT, VDIM), shard_idx (NQ,) int32 with ids in
    [0, NS) (the kernel clamps; ``ops.race_lookup_sharded`` rejects ids
    outside that range). Results come out in input order."""
    nq, ns, nb, nslot, vdim = _check(fp_tables, val_tables, queries,
                                     bucket_idx, shard_idx, sharded=True)
    _check_grid(nq, qblock)
    values, found = _outputs(val_tables, nq, vdim)
    if nq:
        _launch("race_lookup_sharded", fp_tables.device,
                fp_tables.data_ptr(), val_tables.data_ptr(),
                queries.data_ptr(), bucket_idx.data_ptr(),
                shard_idx.data_ptr(), values.data_ptr(), found.data_ptr(),
                nq, ns, nb, nslot, vdim * val_tables.element_size(), qblock)
    return values, found
