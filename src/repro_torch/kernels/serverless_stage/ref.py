"""Plain PyTorch version of the payload-staging chunk gather, and the dense
numpy pack oracle (counterparts of ``repro/kernels/serverless_stage/ref.py``).

The plain version is what the kernel is held against, on the card and in
the CPU tests, and what the ops run for tensors on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def chunk_gather_ref(src, src_row, valid, *, chunk: int = 128):
    """Same contract as the kernel: out[j] is src[r(j)] with lanes >=
    valid[j] zeroed.

    src (NSRC, chunk) int32, src_row (NOUT,) int32, valid (NOUT,) int32 ->
    (NOUT, chunk) int32. r(j) resolves an id the way the JAX kernel does in
    interpret mode and the JAX oracle does (they agree): a negative id
    wraps once (+ NSRC), then it is clamped to [0, NSRC-1]. NSRC == 0 with
    NOUT > 0 raises ``ValueError``, as both JAX versions raise.
    """
    nout = src_row.shape[0]
    if nout == 0:
        return torch.zeros((0, chunk), dtype=torch.int32, device=src.device)
    nsrc = src.shape[0]
    if nsrc == 0:
        raise ValueError("chunk_gather: src has no rows to gather from")
    rows = src_row.long()
    rows = torch.where(rows < 0, rows + nsrc, rows).clamp(0, nsrc - 1)
    lane = torch.arange(chunk, device=src.device)
    keep = lane[None, :] < valid[:, None]
    return torch.where(keep, src[rows], torch.zeros_like(src[:1]))


def pack_ref(payloads: np.ndarray, lengths: np.ndarray,
             *, chunk: int = 128) -> np.ndarray:
    """Dense-numpy oracle of the full pack. Slab layout is chunk-aligned:
    payload i occupies ceil(lengths[i]/chunk) consecutive slab chunks
    (tail chunk zero-padded), in key order."""
    rows = []
    for i, n in enumerate(np.asarray(lengths)):
        n = int(n)
        n_chunks = -(-n // chunk)
        row = np.zeros(n_chunks * chunk, np.int32)
        row[:n] = np.asarray(payloads[i, :n], np.int32)
        rows.append(row.reshape(-1, chunk))
    if not rows:
        return np.zeros((0, chunk), np.int32)
    return np.concatenate(rows, axis=0)
