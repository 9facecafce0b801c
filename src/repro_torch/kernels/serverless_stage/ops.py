"""Host-side routing planners and public wrappers for payload staging
(counterparts of ``repro/kernels/serverless_stage/ops.py``).

The serverless chain calls :func:`stage_pack` on the sender (K ragged
payloads -> one contiguous slab, so a hop rides ceil(K/slab) doorbells
instead of K) and :func:`stage_unpack` on the receiver (slab -> (K, Lmax)
padded payload matrix). Both run the SAME chunk-gather kernel with
different routing tables; the tables are a pure function of ``lengths``,
which travels in the message header, so sender and receiver plan
identically with no extra round trip.

``impl`` maps onto the JAX package's names: ``"kernel"`` (JAX
``"pallas"``) launches the CUDA kernel, ``"ref"`` runs the plain PyTorch
version. ``device=`` takes the place of JAX's ``interpret=``: it names the
device the gather runs on (default: the CUDA card). For tensors on the CPU
every impl runs the plain version: that is the only place it stands in for
the kernel. On a CUDA tensor ``"kernel"`` launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...device import on_device
from .ref import chunk_gather_ref
from .stage import CHUNK, chunk_gather_cuda

IMPLS = ("kernel", "ref")


def n_chunks(lengths: np.ndarray, chunk: int = CHUNK) -> np.ndarray:
    """ceil(len/chunk) per payload (a zero-length payload takes 0 chunks)."""
    lengths = np.asarray(lengths, np.int64)
    return -(-lengths // chunk)


def slab_offsets(lengths: np.ndarray,
                 chunk: int = CHUNK) -> Tuple[np.ndarray, int]:
    """(start_chunk per payload, total slab chunks) for the chunk-aligned
    slab layout. Deterministic in ``lengths`` — both hop endpoints call
    this with the header's length vector and agree on the layout."""
    nc = n_chunks(lengths, chunk)
    starts = np.zeros(len(nc), np.int64)
    if len(nc):
        starts[1:] = np.cumsum(nc)[:-1]
    return starts.astype(np.int32), int(nc.sum())


def pack_plan(lengths: np.ndarray, lmax: int,
              chunk: int = CHUNK) -> Tuple[np.ndarray, np.ndarray]:
    """Routing tables for pack: slab chunk j <- payload chunk src_row[j]
    of the (K, cmax) chunk-matrix view of the payload buffer."""
    lengths = np.asarray(lengths, np.int64)
    cmax = max(1, -(-int(lmax) // chunk))
    nc = n_chunks(lengths, chunk)
    src_row, valid = [], []
    for i, (n, total) in enumerate(zip(nc, lengths)):
        for c in range(int(n)):
            src_row.append(i * cmax + c)
            valid.append(int(min(chunk, total - c * chunk)))
    return (np.asarray(src_row, np.int32),
            np.asarray(valid, np.int32))


def unpack_plan(lengths: np.ndarray, lmax: int,
                chunk: int = CHUNK) -> Tuple[np.ndarray, np.ndarray]:
    """Routing tables for unpack: payload chunk j (row-major over the
    (K, cmax) chunk matrix) <- slab chunk src_row[j]; chunks beyond a
    payload's length have valid == 0 (the kernel zeros them)."""
    lengths = np.asarray(lengths, np.int64)
    cmax = max(1, -(-int(lmax) // chunk))
    starts, _ = slab_offsets(lengths, chunk)
    nc = n_chunks(lengths, chunk)
    src_row = np.zeros(len(lengths) * cmax, np.int32)
    valid = np.zeros(len(lengths) * cmax, np.int32)
    for i, (n, total) in enumerate(zip(nc, lengths)):
        for c in range(int(n)):
            src_row[i * cmax + c] = starts[i] + c
            valid[i * cmax + c] = int(min(chunk, total - c * chunk))
    return src_row, valid


def chunk_gather(src, src_row, valid, impl: str = "kernel",
                 chunk: int = CHUNK, device=None) -> torch.Tensor:
    """out[j] = src[src_row[j]] with lanes >= valid[j] zeroed.

    src (NSRC, chunk), src_row (NOUT,), valid (NOUT,): tensors on one
    device, or numpy arrays (moved to that device, or to ``device=``,
    which defaults to the CUDA card); all become int32, as JAX's default
    32-bit mode makes them. Returns a (NOUT, chunk) int32 tensor on that
    device. When the kernel runs, routing given as numpy arrays stays on
    the host, where the kernel's wrapper picks its route
    (``stage.gather_route``: by value up to ``BYVAL_CAP`` chunks).
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if not any(isinstance(a, torch.Tensor) for a in (src_row, valid)):
        (src,) = on_device(device, (src,), (torch.int32,))
        if impl == "kernel" and src.device.type == "cuda":
            return chunk_gather_cuda(
                src, np.ascontiguousarray(src_row, np.int32),
                np.ascontiguousarray(valid, np.int32), chunk=chunk)
    src, src_row, valid = on_device(device, (src, src_row, valid),
                                    (torch.int32,) * 3)
    if impl == "ref" or src.device.type == "cpu":
        return chunk_gather_ref(src, src_row, valid, chunk=chunk)
    return chunk_gather_cuda(src, src_row, valid, chunk=chunk)


def stage_pack(payloads: np.ndarray, lengths: np.ndarray, *,
               chunk: int = CHUNK, impl: str = "kernel",
               device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Pack K ragged payloads into one contiguous slab.

    payloads: (K, Lmax) int32 (rows padded arbitrarily past their length);
    lengths: (K,) element counts. Returns (slab (NCHUNK*chunk,) int32,
    start_chunk (K,) int32) as numpy arrays; the gather runs on ``device``.
    """
    payloads = np.ascontiguousarray(payloads, np.int32)
    k, lmax = payloads.shape if payloads.ndim == 2 else (0, chunk)
    starts, total_chunks = slab_offsets(lengths, chunk)
    if total_chunks == 0:
        return np.zeros(0, np.int32), starts
    cmax = max(1, -(-int(lmax) // chunk))
    pad = cmax * chunk - lmax
    if pad:
        payloads = np.pad(payloads, ((0, 0), (0, pad)))
    src = payloads.reshape(k * cmax, chunk)
    src_row, valid = pack_plan(lengths, lmax, chunk)
    slab = chunk_gather(src, src_row, valid, impl=impl, chunk=chunk,
                        device=device)
    return slab.cpu().numpy().reshape(-1), starts


def stage_unpack(slab: np.ndarray, lengths: np.ndarray, lmax: int, *,
                 chunk: int = CHUNK, impl: str = "kernel",
                 device=None) -> np.ndarray:
    """Inverse of :func:`stage_pack`: slab -> (K, Lmax) int32 numpy matrix
    with each row's tail (beyond its length) zeroed."""
    lengths = np.asarray(lengths)
    k = len(lengths)
    if k == 0:
        return np.zeros((0, max(int(lmax), 0)), np.int32)
    cmax = max(1, -(-int(lmax) // chunk))
    _, total_chunks = slab_offsets(lengths, chunk)
    slab = np.ascontiguousarray(slab, np.int32).reshape(-1)
    if len(slab) < total_chunks * chunk:
        raise ValueError(f"slab too small: {len(slab)} < "
                         f"{total_chunks * chunk}")
    src = slab[:total_chunks * chunk].reshape(total_chunks, chunk) \
        if total_chunks else np.zeros((1, chunk), np.int32)
    src_row, valid = unpack_plan(lengths, lmax, chunk)
    out = chunk_gather(src, src_row, valid, impl=impl, chunk=chunk,
                       device=device)
    return out.cpu().numpy().reshape(k, cmax * chunk)[:, :lmax]
