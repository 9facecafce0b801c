"""Plain PyTorch versions of the RACE-hash lookup, and ``make_table`` in
numpy (counterparts of ``repro/kernels/race_lookup/ref.py``).

The plain versions are what the kernels are held against, on the card and
in the CPU tests, and what the ops run for tensors on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def race_lookup_ref(fp_table, val_table, queries, bucket_idx):
    """Same contract as the lookup kernels: first matching slot wins, bucket
    1's slots order before bucket 2's, fingerprint 0 is an empty slot.

    fp_table (NB, NSLOT) int32, val_table (NB, NSLOT, VDIM), queries (NQ,)
    int32, bucket_idx (NQ, 2) int32 -> (values (NQ, VDIM) in val_table's
    dtype, found (NQ,) int32). Zeros on a miss.

    Bucket ids are clamped to [0, NB-1] like the tiled kernel's
    ``mode="clip"`` (the JAX oracle wraps negative ids instead). The row is
    selected by indexing, not by a one-hot product, so a non-finite value
    in a candidate slot that did not hit cannot reach the result (in JAX's
    product it turns the row into NaN).
    """
    nb, nslot = fp_table.shape
    b = bucket_idx.long().clamp(0, nb - 1)                     # (NQ, 2)
    fps = fp_table[b].reshape(len(b), 2 * nslot)               # (NQ, 2*NSLOT)
    rows = val_table.reshape(nb * nslot, val_table.shape[-1])
    return _select(fps, rows, b * nslot, queries, nslot)


def race_lookup_sharded_ref(fp_tables, val_tables, queries, bucket_idx,
                            shard_idx):
    """Plain version of the sharded lookup: stacked tables (NS, NB, NSLOT[,
    VDIM]), ``shard_idx`` (NQ,) int32 the owning shard of each query (in
    [0, NS); clamped like the bucket ids). Results in input order."""
    ns, nb, nslot = fp_tables.shape
    s = shard_idx.long().clamp(0, ns - 1)[:, None]
    b = s * nb + bucket_idx.long().clamp(0, nb - 1)            # global buckets
    fps = fp_tables.reshape(ns * nb, nslot)[b].reshape(len(b), 2 * nslot)
    rows = val_tables.reshape(ns * nb * nslot, val_tables.shape[-1])
    return _select(fps, rows, b * nslot, queries, nslot)


def race_lookup_routed_ref(fp_table, val_table, routing, values, found):
    """Plain version of the scalar kernel on packed routing: ``routing``
    (NQ, 4) int32 rows of (fingerprint, b0, b1, output row), numpy or a
    tensor; each query's result goes to its row of ``values`` (N, VDIM) and
    ``found`` (N,), in place."""
    r = torch.as_tensor(routing, device=fp_table.device)
    rows = r[:, 3].long()
    values[rows], found[rows] = race_lookup_ref(fp_table, val_table, r[:, 0],
                                                r[:, 1:3])


def _select(fps, rows, first_row, queries, nslot):
    """First hit per query among its 2*NSLOT candidates -> its value row.
    ``first_row`` (NQ, 2) is the flat row of each candidate bucket's slot 0."""
    hit = (fps == queries[:, None]) & (fps != 0)
    found = hit.any(dim=1)
    # argmax over int keeps the first index among equal maxima
    first = hit.to(torch.int32).argmax(dim=1)
    in_b2 = first >= nslot
    row = torch.where(in_b2, first_row[:, 1], first_row[:, 0]) \
        + first - in_b2 * nslot
    values = rows[row]
    values = torch.where(found[:, None], values, torch.zeros_like(values))
    return values, found.to(torch.int32)


def make_table(n_buckets: int, nslot: int, vdim: int, keys, values,
               seed: int = 7):
    """Build (fp_table, val_table, bucket_idx_fn) from int32 keys/values.

    Two-choice hashing like RACE: each key has two candidate buckets; the
    less-loaded one receives it (host-side build; device-side lookup).
    Its ``h2`` adds ``seed``, which ``kvs.race._h2`` does not: the two stay
    as they are in the reference.
    """
    fp_table = np.zeros((n_buckets, nslot), np.int32)
    val_table = np.zeros((n_buckets, nslot, vdim), np.float32)

    def h1(k):
        return (k * 2654435761 + seed) % n_buckets

    def h2(k):
        return (k * 40503 + 0x9E3779B9 + seed) % n_buckets

    def fingerprint(k):
        fp = (k * 2246822519 + 1) & 0x7FFFFFFF
        return fp if fp != 0 else 1

    loads = np.zeros(n_buckets, np.int32)
    for k, v in zip(keys, values):
        b1, b2 = int(h1(k)), int(h2(k))
        b = b1 if loads[b1] <= loads[b2] else b2
        if loads[b] >= nslot:
            b = b2 if b == b1 else b1
            if loads[b] >= nslot:
                raise RuntimeError("bucket overflow; grow table")
        fp_table[b, loads[b]] = fingerprint(k)
        val_table[b, loads[b]] = v
        loads[b] += 1

    def query_prep(qkeys):
        qk = np.asarray(qkeys)
        bidx = np.stack([h1(qk), h2(qk)], axis=1).astype(np.int32)
        fps = ((qk * 2246822519 + 1) & 0x7FFFFFFF).astype(np.int32)
        fps = np.where(fps == 0, 1, fps)
        return fps, bidx

    return fp_table, val_table, query_prep
