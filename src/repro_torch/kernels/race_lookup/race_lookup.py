"""Python wrappers of the three CUDA lookup kernels in ``csrc/race_lookup.cu``
(the Hopper counterparts of ``repro/kernels/race_lookup/race_lookup.py``).

Each wrapper takes its tables as CUDA tensors only, checks device, dtype,
shape and contiguity, allocates its outputs with ``torch.empty``, and
launches on the current stream without synchronising. The library is built
on first use (see ``kernels/_build.py``). The plain versions live in
``ref.py``; the ops take them for CPU tensors, never for CUDA ones.

Every kernel reads its queries as one (NQ, 4) int32 routing array, a row
of (fingerprint, b0, b1, w) a query (:func:`pack_routing`): ``w`` is the
shard for the sharded kernel, 0 for the tiled one (the sharded kernel at
one shard) and the output row for the scalar one. Each kernel has two
routes, each its own C entry point, so that the launch counter shows which
one ran; :func:`route` picks one from where the routing lies and how long
it is, and nothing falls back from one to the other:

- ``<kernel>_byval``: the routing lies on the host (numpy or a CPU tensor)
  and NQ <= :data:`BYVAL_CAP`. It goes into the launch's parameters, with
  no copy to the card;
- ``<kernel>``: the routing is on the card, or longer. From the host it is
  copied to the card at once.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# fp, val, routing (NQ, 4), out, found, nq, nb, nslot, row_bytes, qblock,
# stream
_TILED = (_P, _P, _P, _P, _P, _L, _L, _I, _L, _I, _P)
# fp, val, routing, out, found, nq, nout (out's rows), nb, nslot, row_bytes,
# stream
_SCALAR = (_P, _P, _P, _P, _P, _L, _L, _L, _I, _L, _P)
# fp, val, routing, out, found, nq, ns, nb, nslot, row_bytes, qblock, stream
_SHARDED = (_P, _P, _P, _P, _P, _L, _L, _L, _I, _L, _I, _P)
#: each kernel's two C entry points: (routing by value, routing on the card)
ROUTES = {"tiled": ("race_lookup_tiled_byval", "race_lookup_tiled"),
          "scalar": ("race_lookup_scalar_byval", "race_lookup_scalar"),
          "sharded": ("race_lookup_sharded_byval", "race_lookup_sharded")}
_SIGNATURES = {symbol: sig for kernel, sig in (
    ("tiled", _TILED), ("scalar", _SCALAR), ("sharded", _SHARDED))
    for symbol in ROUTES[kernel]}
#: most queries a by-value route takes: 16 bytes a query in CUDA 12.1's
#: 32,764 bytes of kernel parameters
BYVAL_CAP = 2032
#: most blocks a grid's x dimension takes
_MAX_GRID_X = 2 ** 31 - 1
#: queries per block of the tiled and sharded kernels: one per half warp
#: of the block's 4 at NSLOT <= 8, else two in turn on each warp. The JAX
#: kernels' 64 (an MXU-sized tile) would make each warp run 8 dependent
#: lookups in a row, which measured slower on the H100 (PERF.md).
QBLOCK = 8


def _lib():
    return _build.library("race_lookup", _SIGNATURES)


def route(kernel: str, on_host: bool, nq: int) -> str:
    """The C entry point of ``kernel`` ("tiled", "scalar" or "sharded") for
    NQ queries whose routing lies on the host (``on_host``) or on the
    card."""
    byval, device = ROUTES[kernel]
    return byval if on_host and nq <= BYVAL_CAP else device


def _check_tables(named: dict, fp) -> None:
    """CUDA, on fp's device, contiguous; int32 but for the value table and
    the values (names starting with "val")."""
    for name, t in named.items():
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (the plain "
                             f"version in ref.py runs on the CPU)")
        if t.device != fp.device:
            raise ValueError(f"{name} is on {t.device}, fp_table on "
                             f"{fp.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if not name.startswith("val") and t.dtype != torch.int32:
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


def _check_routing(queries, bucket_idx, w=None) -> int:
    """Returns NQ."""
    nq = queries.shape[0] if queries.ndim == 1 else -1
    if nq < 0 or tuple(bucket_idx.shape) != (nq, 2) \
            or (w is not None and tuple(w.shape) != (nq,)):
        raise ValueError("queries must be (NQ,), bucket_idx (NQ, 2) and "
                         "shard_idx or rows (NQ,)")
    return nq


def _check_grid(nq: int, qblock: int) -> None:
    if qblock < 1:
        raise ValueError("qblock must be >= 1")
    if -(-nq // qblock) > _MAX_GRID_X:
        raise ValueError(f"{nq} queries need more than {_MAX_GRID_X} blocks "
                         f"of {qblock}")


def _outputs(val, nq, vdim):
    return (torch.empty((nq, vdim), dtype=val.dtype, device=val.device),
            torch.empty((nq,), dtype=torch.int32, device=val.device))


def _on_host(a) -> bool:
    return not isinstance(a, torch.Tensor) or a.device.type == "cpu"


def _host_int32(a, name: str) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    if a.dtype != np.int32:
        raise TypeError(f"{name} must be int32, got {a.dtype}")
    return a


def pack_routing(queries, bucket_idx, w=None) -> np.ndarray:
    """Host routing as the kernels read it: (NQ, 4) int32 rows of
    (fingerprint, b0, b1, w), ``w`` the shard ids (sharded kernel) or the
    output rows (scalar kernel); ``None`` packs 0 (the tiled kernel's one
    shard). Takes numpy arrays or CPU tensors, which must be int32."""
    named = {"queries": queries, "bucket_idx": bucket_idx}
    if w is not None:
        named["w"] = w
    arrays = [_host_int32(a, name) for name, a in named.items()]
    nq = _check_routing(*arrays)
    routing = np.zeros((nq, 4), np.int32)
    routing[:, 0] = arrays[0]
    routing[:, 1:3] = arrays[1]
    if w is not None:
        routing[:, 3] = arrays[2]
    return routing


def split_by_shard(queries, bucket_idx, shard_idx) -> list:
    """Host routing of a sharded batch, split for per-shard scalar calls as
    the JAX ``"pallas_scalar"`` impl splits it: ``[(shard, routing)]`` by
    ascending shard, ``routing`` the shard's queries in input order packed
    with each query's row of the batch's output as ``w``. Takes numpy
    arrays or CPU tensors, which must be int32."""
    shards = _host_int32(shard_idx, "shard_idx")
    routing = pack_routing(queries, bucket_idx,
                           np.arange(len(shards), dtype=np.int32))
    return [(sid, routing[shards == sid])
            for sid in np.unique(shards).tolist()]


def _routing(fp, queries, bucket_idx, w=None, rows=False):
    """The routing of a lookup, packed where it lies: host routing as a
    numpy array, card routing as a CUDA tensor. ``rows``: ``w`` is each
    query's own index (the scalar kernel's output rows)."""
    named = {"queries": queries, "bucket_idx": bucket_idx}
    if w is not None:
        named["shard_idx"] = w
    on_host = [_on_host(a) for a in named.values()]
    if all(on_host):
        if rows:
            w = np.arange(len(queries), dtype=np.int32)
        return pack_routing(queries, bucket_idx, w)
    if any(on_host):
        raise ValueError("the routing arrays must lie all on the card or all "
                         "on the host")
    _check_tables(named, fp)
    nq = _check_routing(queries, bucket_idx, w)
    if w is None:
        w = (torch.arange if rows else torch.zeros)(
            nq, dtype=torch.int32, device=fp.device)
    return torch.cat([queries[:, None], bucket_idx, w[:, None]], dim=1)


def race_lookup_packed(kernel: str, fp_table, val_table, routing,
                       qblock: int = QBLOCK, out=None):
    """Launch ``kernel`` ("tiled", "scalar" or "sharded") on routing packed
    as :func:`pack_routing` packs it: an (NQ, 4) int32 numpy array or CPU
    tensor (host routing), or a CUDA tensor. The sharded kernel takes
    stacked (NS, NB, NSLOT[, VDIM]) tables, the others one (NB, NSLOT[,
    VDIM]) table. ``out`` = (values, found) to write into, for the scalar
    kernel, whose host routing must name rows in [0, len(values)) (the
    kernel skips rows outside it); else (NQ, VDIM) and (NQ,) outputs are
    allocated. Returns (values, found)."""
    sharded = kernel == "sharded"
    _check_tables({"fp_table": fp_table, "val_table": val_table}, fp_table)
    ns, nb, nslot, vdim = _check_shapes(fp_table, val_table, sharded)
    on_host = _on_host(routing)
    if on_host:
        routing = np.ascontiguousarray(_host_int32(routing, "routing"))
    else:
        _check_tables({"routing": routing}, fp_table)
    if routing.ndim != 2 or routing.shape[1] != 4:
        raise ValueError(f"routing must be (NQ, 4), got "
                         f"{tuple(routing.shape)}")
    nq = routing.shape[0]
    _check_grid(nq, 1 if kernel == "scalar" else qblock)
    if out is None:
        out = _outputs(val_table, nq, vdim)
    elif kernel != "scalar":
        raise ValueError("only the scalar kernel writes into given outputs")
    values, found = out
    if kernel == "scalar":
        _check_tables({"values": values, "found": found}, fp_table)
        if values.dtype != val_table.dtype \
                or tuple(values.shape) != (len(found), vdim) \
                or found.dim() != 1:
            raise ValueError(f"outputs {tuple(values.shape)} "
                             f"{values.dtype} / {tuple(found.shape)} do not "
                             f"fit the value table")
        if on_host and nq and not (0 <= routing[:, 3].min()
                                   and routing[:, 3].max() < len(found)):
            raise IndexError(f"output rows outside [0, {len(found)})")
    if not nq:
        return values, found
    symbol = route(kernel, on_host, nq)
    if symbol == ROUTES[kernel][0]:
        ptr = routing.ctypes.data
    else:
        if on_host:
            routing = torch.from_numpy(routing).to(fp_table.device)
        elif routing.data_ptr() % 16:     # one 16-byte load a query
            routing = routing.clone()
        ptr = routing.data_ptr()
    row_bytes = vdim * val_table.element_size()
    dims = {"tiled": (nq, nb, nslot, row_bytes, qblock),
            "scalar": (nq, len(found), nb, nslot, row_bytes),
            "sharded": (nq, ns, nb, nslot, row_bytes, qblock)}[kernel]
    with torch.cuda.device(fp_table.device):
        stream = torch.cuda.current_stream(fp_table.device).cuda_stream
        _build.launch(_lib(), symbol, fp_table.data_ptr(),
                      val_table.data_ptr(), ptr, values.data_ptr(),
                      found.data_ptr(), *dims, stream)
    return values, found


def _lookup(kernel, fp_table, val_table, queries, bucket_idx, w=None,
            qblock=QBLOCK):
    _check_tables({"fp_table": fp_table, "val_table": val_table}, fp_table)
    routing = _routing(fp_table, queries, bucket_idx, w,
                       rows=kernel == "scalar")
    return race_lookup_packed(kernel, fp_table, val_table, routing,
                              qblock=qblock)


def race_lookup_tiled(fp_table, val_table, queries, bucket_idx,
                      qblock: int = QBLOCK):
    """Tiled kernel: ``qblock`` queries per block of 4 warps. fp_table (NB,
    NSLOT) int32, val_table (NB, NSLOT, VDIM) any dtype, queries (NQ,) and
    bucket_idx (NQ, 2) int32 on the card (CUDA tensors) or on the host
    (numpy arrays or CPU tensors; :func:`route` picks the route) -> (values
    (NQ, VDIM), found (NQ,) int32)."""
    return _lookup("tiled", fp_table, val_table, queries, bucket_idx,
                   qblock=qblock)


def race_lookup_scalar(fp_table, val_table, queries, bucket_idx):
    """Scalar kernel: one block of one warp per query. Same contract as
    :func:`race_lookup_tiled`."""
    return _lookup("scalar", fp_table, val_table, queries, bucket_idx)


def race_lookup_sharded(fp_tables, val_tables, queries, bucket_idx,
                        shard_idx, qblock: int = QBLOCK):
    """Sharded kernel over stacked tables: fp_tables (NS, NB, NSLOT) int32,
    val_tables (NS, NB, NSLOT, VDIM), queries (NQ,), bucket_idx (NQ, 2) and
    shard_idx (NQ,) int32 with ids in [0, NS) (the kernel clamps;
    ``ops.race_lookup_sharded`` rejects ids outside that range), on the
    card or on the host as for :func:`race_lookup_tiled`. Results come out
    in input order."""
    return _lookup("sharded", fp_tables, val_tables, queries, bucket_idx,
                   shard_idx, qblock=qblock)
