"""Public wrappers of the RACE-lookup kernels (counterparts of
``repro/kernels/race_lookup/ops.py``).

``impl`` maps onto the JAX package's names:

  ==========  ==================  ===================================
  port        JAX                 what runs
  ==========  ==================  ===================================
  "kernel"    "pallas"            tiled kernel (default)
  "tiled"     "pallas_tiled"      tiled kernel
  "scalar"    "pallas_scalar"     scalar kernel
  "ref"       "ref"               plain PyTorch version (``ref.py``)
  ==========  ==================  ===================================

The JAX ``"pallas"`` impl switches to the scalar kernel above
``TILED_VMEM_BUDGET_BYTES``, because its tiled kernel pins the whole table
in the TPU's VMEM. Both Hopper kernels read the table straight from HBM and
have no such bound, so ``"kernel"`` takes the tiled kernel at every table
size and the budget has no counterpart here.

Inputs are tensors on one device, or numpy arrays (moved to that device,
or to ``device=``, which defaults to the CUDA card). Integer inputs become
int32, as JAX's default 32-bit mode makes them; values keep their dtype.
One exception: routing given as numpy arrays (queries, bucket ids, shard
ids) stays on the host when a kernel runs, and the kernel's wrapper takes
it from there (``race_lookup.route``: by value up to ``BYVAL_CAP`` queries,
else packed into one copy to the card).
For tensors on the CPU every impl runs the plain version: that is the only
place it stands in for a kernel. On a CUDA tensor a kernel impl launches
its kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import on_device
from . import race_lookup as kern
from .race_lookup import QBLOCK
from .ref import race_lookup_ref, race_lookup_routed_ref, \
    race_lookup_sharded_ref

IMPLS = ("kernel", "tiled", "scalar", "ref")
SHARDED_IMPLS = ("kernel", "scalar", "ref")


def _on_device(device, values, *ints):
    """(values, *int32 tensors) on one device (see ``device.on_device``)."""
    return on_device(device, (values, *ints),
                     (None,) + (torch.int32,) * len(ints))


def _place(device, val, fp, routing, keep_on_host: bool):
    """Tables on one device (that of any tensor among the inputs, else
    ``device``) and the routing arrays as int32: numpy on the host when
    all are numpy and ``keep_on_host(device of the tables)``, else tensors
    beside the tables."""
    if any(isinstance(a, torch.Tensor) for a in routing):
        return _on_device(device, val, fp, *routing)
    val, fp = _on_device(device, val, fp)
    if keep_on_host(fp.device):
        return [val, fp, *(np.ascontiguousarray(a, np.int32)
                           for a in routing)]
    return [val, fp, *on_device(fp.device, routing,
                                (torch.int32,) * len(routing))]


def race_lookup(fp_table, val_table, queries, bucket_idx,
                impl: str = "kernel", qblock: int = QBLOCK, device=None):
    """Batched two-choice hash lookup.

    fp_table (NB, NSLOT) int32, val_table (NB, NSLOT, VDIM), queries (NQ,)
    int32 fingerprints, bucket_idx (NQ, 2) int32 -> (values (NQ, VDIM),
    found (NQ,) int32). ``qblock`` is the tiled kernel's queries per block
    (the JAX default of 64 is an MXU-sized tile; see ``QBLOCK``).
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    kernel = impl != "ref"
    val_table, fp_table, queries, bucket_idx = _place(
        device, val_table, fp_table, (queries, bucket_idx),
        lambda dev: kernel and dev.type == "cuda")
    if not kernel or fp_table.device.type == "cpu":
        return race_lookup_ref(fp_table, val_table, queries, bucket_idx)
    if impl == "scalar":
        return kern.race_lookup_scalar(fp_table, val_table, queries,
                                       bucket_idx)
    return kern.race_lookup_tiled(fp_table, val_table, queries, bucket_idx,
                                  qblock=qblock)


def _check_shards(shard_idx, ns: int) -> None:
    """Shard ids outside [0, NS) raise ``IndexError``, as the JAX path does.
    For a device tensor this reads two numbers back (one synchronisation)."""
    if isinstance(shard_idx, torch.Tensor):
        if shard_idx.numel() == 0:
            return
        lo, hi = (int(x) for x in torch.aminmax(shard_idx))
    else:
        s = np.asarray(shard_idx)
        if s.size == 0:
            return
        lo, hi = int(s.min()), int(s.max())
    if lo < 0 or hi >= ns:
        raise IndexError(f"shard id outside [0, {ns}): min {lo}, max {hi}")


def _scalar_by_shard(fp_tables, val_tables, queries, bucket_idx, shard_idx):
    """The JAX ``"pallas_scalar"`` impl: one scalar call a shard with
    queries, on that shard's tables, each writing its queries' rows of one
    shared output (every row is written once). The routing is split on the
    host; routing on the card is read back once for that."""
    routing = (queries, bucket_idx, shard_idx)
    if isinstance(queries, torch.Tensor):
        packed = torch.cat([queries[:, None], bucket_idx,
                            shard_idx[:, None]], dim=1).cpu().numpy()
        routing = (packed[:, 0], packed[:, 1:3], packed[:, 3])
    values, found = (
        torch.empty((len(queries), val_tables.shape[-1]),
                    dtype=val_tables.dtype, device=val_tables.device),
        torch.empty(len(queries), dtype=torch.int32,
                    device=val_tables.device))
    plain = fp_tables.device.type == "cpu"
    for sid, part in kern.split_by_shard(*routing):
        if plain:
            race_lookup_routed_ref(fp_tables[sid], val_tables[sid], part,
                                   values, found)
        else:
            kern.race_lookup_packed("scalar", fp_tables[sid],
                                    val_tables[sid], part,
                                    out=(values, found))
    return values, found


def race_lookup_sharded(fp_tables, val_tables, queries, bucket_idx,
                        shard_idx, impl: str = "kernel", qblock: int = QBLOCK,
                        device=None):
    """Batched lookup over a SHARDED table set (the dkv shard map).

    fp_tables (NS, NB, NSLOT) int32, val_tables (NS, NB, NSLOT, VDIM),
    queries (NQ,) int32 fingerprints, bucket_idx (NQ, 2) int32 intra-shard
    rows, shard_idx (NQ,) int32 -> (values (NQ, VDIM), found (NQ,) int32)
    in input order.

    ``impl``:
      * ``"kernel"`` — the sharded kernel: each query reads its own shard
        id, results go straight to input order (no host sort or scatter);
        numpy routing stays on the host, where the kernel's wrapper picks
        its route (``race_lookup.route``),
      * ``"scalar"`` — per-shard calls into the scalar kernel, as the JAX
        ``"pallas_scalar"`` impl does: the routing is split by shard on the
        host and each call writes its queries' rows of the output (on the
        CPU, each call runs the plain version),
      * ``"ref"`` — the plain version.
    """
    if impl not in SHARDED_IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of "
                         f"{SHARDED_IMPLS}")
    _check_shards(shard_idx, len(fp_tables))
    val_tables, fp_tables, queries, bucket_idx, shard_idx = _place(
        device, val_tables, fp_tables, (queries, bucket_idx, shard_idx),
        lambda dev: impl == "scalar" or impl == "kernel" and dev.type == "cuda")
    if impl == "scalar":
        return _scalar_by_shard(fp_tables, val_tables, queries, bucket_idx,
                                shard_idx)
    if impl == "ref" or fp_tables.device.type == "cpu":
        return race_lookup_sharded_ref(fp_tables, val_tables, queries,
                                       bucket_idx, shard_idx)
    return kern.race_lookup_sharded(fp_tables, val_tables, queries,
                                    bucket_idx, shard_idx, qblock=qblock)
