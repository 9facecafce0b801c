"""Python wrappers of the three CUDA lookup kernels in ``csrc/race_lookup.cu``
(the Hopper counterparts of ``repro/kernels/race_lookup/race_lookup.py``).

Each wrapper takes its tables as CUDA tensors only, checks device, dtype,
shape and contiguity, allocates its outputs with ``torch.empty``, and
launches on the current stream without synchronising. The library is built
on first use (see ``kernels/_build.py``). The plain versions live in
``ref.py``; the ops take them for CPU tensors, never for CUDA ones.

The sharded kernel has two routes, each its own C entry point, so that the
launch counter shows which one ran; :func:`sharded_route` picks one from
where the routing lies and how long it is, and nothing falls back from one
to the other:

- ``race_lookup_sharded_byval``: the routing lies on the host (numpy or a
  CPU tensor) and NQ <= :data:`BYVAL_CAP`. Each query's (fingerprint, b0,
  b1, shard) goes into the launch's parameters, with no copy to the card;
- ``race_lookup_sharded``: the routing is on the card, or longer. It is
  packed into one (NQ, 4) int32 array (:func:`pack_routing`) and, from the
  host, copied to the card at once.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # fp, val, queries, bidx, out, found, nq, nb, nslot, row_bytes, qblock,
    # stream
    "race_lookup_tiled": (_P, _P, _P, _P, _P, _P, _L, _L, _I, _L, _I, _P),
    # fp, val, queries, bidx, out, found, nq, nb, nslot, row_bytes, stream
    "race_lookup_scalar": (_P, _P, _P, _P, _P, _P, _L, _L, _I, _L, _P),
    # fp, val, routing (NQ, 4), out, found, nq, ns, nb, nslot, row_bytes,
    # qblock, stream; the routing on the card
    "race_lookup_sharded": (_P, _P, _P, _P, _P, _L, _L, _L, _I, _L, _I, _P),
    # the same, the routing in host memory
    "race_lookup_sharded_byval": (_P, _P, _P, _P, _P, _L, _L, _L, _I, _L, _I,
                                  _P),
}
#: the sharded kernel's C entry points
SHARDED_ROUTES = ("race_lookup_sharded_byval", "race_lookup_sharded")
#: most queries the by-value route takes: 16 bytes a query in CUDA 12.1's
#: 32,764 bytes of kernel parameters
BYVAL_CAP = 2032
#: most blocks a grid's x dimension takes
_MAX_GRID_X = 2 ** 31 - 1
#: queries per block of the tiled and sharded kernels: one per warp of the
#: tiled kernel's 8; one per half warp of the sharded kernel's 4 at NSLOT <=
#: 8, else two in turn on each warp. The JAX kernels' 64 (an MXU-sized
#: tile) would make each warp run 8 dependent lookups in a row, which
#: measured slower on the H100 (PERF.md).
QBLOCK = 8


def _lib():
    return _build.library("race_lookup", _SIGNATURES)


def _check_tables(named: dict, fp) -> None:
    """CUDA, on fp's device, contiguous; int32 but for the value table."""
    for name, t in named.items():
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (the plain "
                             f"version in ref.py runs on the CPU)")
        if t.device != fp.device:
            raise ValueError(f"{name} is on {t.device}, fp_table on "
                             f"{fp.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if not name.startswith("val_table") and t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")


def _check_shapes(fp, val, sharded: bool):
    """Returns (ns, nb, nslot, vdim)."""
    lead = 1 if sharded else 0
    if fp.dim() != 2 + lead or val.dim() != 3 + lead \
            or val.shape[:-1] != fp.shape:
        raise ValueError(f"table shapes fp {tuple(fp.shape)} / val "
                         f"{tuple(val.shape)} do not match")
    ns = fp.shape[0] if sharded else 1
    nb, nslot = fp.shape[-2:]
    if min(ns, nb, nslot) < 1:
        raise ValueError("tables need at least one shard, bucket and slot")
    return ns, nb, nslot, val.shape[-1]


def _check_routing(queries, bucket_idx, shard_idx=None) -> int:
    """Returns NQ."""
    nq = queries.shape[0] if queries.ndim == 1 else -1
    if nq < 0 or tuple(bucket_idx.shape) != (nq, 2) \
            or (shard_idx is not None and tuple(shard_idx.shape) != (nq,)):
        raise ValueError("queries must be (NQ,), bucket_idx (NQ, 2) and "
                         "shard_idx (NQ,)")
    return nq


def _check(fp, val, queries, bucket_idx):
    """Validate an unsharded lookup; returns (nq, nb, nslot, vdim)."""
    _check_tables({"fp_table": fp, "val_table": val, "queries": queries,
                   "bucket_idx": bucket_idx}, fp)
    _, nb, nslot, vdim = _check_shapes(fp, val, sharded=False)
    return _check_routing(queries, bucket_idx), nb, nslot, vdim


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
    nq, nb, nslot, vdim = _check(fp_table, val_table, queries, bucket_idx)
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
    nq, nb, nslot, vdim = _check(fp_table, val_table, queries, bucket_idx)
    _check_grid(nq, 1)
    values, found = _outputs(val_table, nq, vdim)
    if nq:
        _launch("race_lookup_scalar", fp_table.device, fp_table.data_ptr(),
                val_table.data_ptr(), queries.data_ptr(),
                bucket_idx.data_ptr(), values.data_ptr(), found.data_ptr(),
                nq, nb, nslot, vdim * val_table.element_size())
    return values, found


def sharded_route(on_host: bool, nq: int) -> str:
    """The sharded kernel's C entry point for NQ queries whose routing lies
    on the host (``on_host``) or on the card."""
    return SHARDED_ROUTES[0] if on_host and nq <= BYVAL_CAP \
        else SHARDED_ROUTES[1]


def _on_host(a) -> bool:
    return not isinstance(a, torch.Tensor) or a.device.type == "cpu"


def pack_routing(queries, bucket_idx, shard_idx) -> np.ndarray:
    """Host routing as the sharded kernel reads it: (NQ, 4) int32 rows of
    (fingerprint, b0, b1, shard). Takes numpy arrays or CPU tensors, which
    must be int32."""
    named = {"queries": queries, "bucket_idx": bucket_idx,
             "shard_idx": shard_idx}
    arrays = {}
    for name, a in named.items():
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        if a.dtype != np.int32:
            raise TypeError(f"{name} must be int32, got {a.dtype}")
        arrays[name] = a
    nq = _check_routing(*arrays.values())
    routing = np.empty((nq, 4), np.int32)
    routing[:, 0] = arrays["queries"]
    routing[:, 1:3] = arrays["bucket_idx"]
    routing[:, 3] = arrays["shard_idx"]
    return routing


def race_lookup_sharded(fp_tables, val_tables, queries, bucket_idx,
                        shard_idx, qblock: int = QBLOCK):
    """Sharded kernel over stacked tables: fp_tables (NS, NB, NSLOT) int32,
    val_tables (NS, NB, NSLOT, VDIM), queries (NQ,), bucket_idx (NQ, 2) and
    shard_idx (NQ,) int32 with ids in [0, NS) (the kernel clamps;
    ``ops.race_lookup_sharded`` rejects ids outside that range). The three
    routing arrays lie on the card (CUDA tensors) or on the host (numpy
    arrays or CPU tensors); :func:`sharded_route` picks the route. Results
    come out in input order."""
    on_host = [_on_host(a) for a in (queries, bucket_idx, shard_idx)]
    if all(on_host):
        routing = pack_routing(queries, bucket_idx, shard_idx)
    elif not any(on_host):
        _check_tables({"fp_tables": fp_tables, "queries": queries,
                       "bucket_idx": bucket_idx, "shard_idx": shard_idx},
                      fp_tables)
        _check_routing(queries, bucket_idx, shard_idx)
        routing = torch.cat([queries[:, None], bucket_idx,
                             shard_idx[:, None]], dim=1)
    else:
        raise ValueError("queries, bucket_idx and shard_idx must lie all on "
                         "the card or all on the host")
    return race_lookup_sharded_packed(fp_tables, val_tables, routing,
                                      qblock=qblock)


def race_lookup_sharded_packed(fp_tables, val_tables, routing,
                               qblock: int = QBLOCK):
    """:func:`race_lookup_sharded` on routing already packed as
    :func:`pack_routing` packs it: an (NQ, 4) int32 numpy array or CPU
    tensor (host routing), or a CUDA tensor."""
    _check_tables({"fp_tables": fp_tables, "val_tables": val_tables},
                  fp_tables)
    ns, nb, nslot, vdim = _check_shapes(fp_tables, val_tables, sharded=True)
    on_host = _on_host(routing)
    if on_host:
        routing = np.ascontiguousarray(
            routing.numpy() if isinstance(routing, torch.Tensor) else routing)
        if routing.dtype != np.int32:
            raise TypeError(f"routing must be int32, got {routing.dtype}")
    else:
        _check_tables({"routing": routing}, fp_tables)
    if routing.ndim != 2 or routing.shape[1] != 4:
        raise ValueError(f"routing must be (NQ, 4), got "
                         f"{tuple(routing.shape)}")
    nq = routing.shape[0]
    _check_grid(nq, qblock)
    values, found = _outputs(val_tables, nq, vdim)
    if not nq:
        return values, found
    route = sharded_route(on_host, nq)
    if route == "race_lookup_sharded_byval":
        ptr = routing.ctypes.data
    else:
        if on_host:
            routing = torch.from_numpy(routing).to(fp_tables.device)
        elif routing.data_ptr() % 16:     # one 16-byte load a query
            routing = routing.clone()
        ptr = routing.data_ptr()
    _launch(route, fp_tables.device, fp_tables.data_ptr(),
            val_tables.data_ptr(), ptr, values.data_ptr(), found.data_ptr(),
            nq, ns, nb, nslot, vdim * val_tables.element_size(), qblock)
    return values, found
