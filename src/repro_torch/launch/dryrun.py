"""Multi-pod dry run: trace every (arch x shape x mesh) cell on the meta
device (the counterpart of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \
        --shape train_4k --mesh single --out results/gemma2.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The reference lowers and compiles each cell with XLA on 512 host devices.
The port runs the cell's step once, eagerly, on meta-device stand-ins of
its inputs (``launch.steps.input_specs``: shapes and dtypes, no memory),
inside one process standing for every rank of the production mesh
(``launch.mesh.make_production_mesh``: 16 x 16 or 2 x 16 x 16 on the
``"fake"`` process group, started for the cell and destroyed after it).
Nothing is computed and nothing is allocated. Per cell it records:

* ``memory``: argument and output bytes a rank, exact: every leaf's shape
  with each dimension that its sharding spec (``distributed.shardings``)
  splits divided by the product of the sizes of its mesh dimensions,
  rounded up. No compiler plans the port's buffers, so there is no
  temporary-bytes figure (``temp_bytes`` is None).
* ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode`` over
  the traced step, divided by the number of ranks. The port computes the
  global step on one rank (no tensor parallelism), so this is no XLA
  figure.
* ``collectives``: the c10d collectives the step issues on the fake group,
  each with its bytes and its group's size, seen by a dispatch mode
  (:class:`CollectiveLog`; ``CommDebugMode`` counts them but records
  neither), and their link bytes by ``hlo_stats.link_bytes``'s ring
  factors.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, List

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import all_archs, get_config, skip_shapes
from ..distributed.shardings import (P, _dp_or_none, _mesh_sizes,
                                     batch_specs, cache_specs,
                                     opt_state_specs, param_specs)
from ..models.config import SHAPES_BY_NAME
from ..tree import tree_leaves
from .hlo_stats import _COLLECTIVES, link_bytes
from .mesh import make_production_mesh, set_mesh
from .steps import (input_specs, make_decode_step, make_prefill_step,
                    make_train_step)

FLOPS_SOURCE = "FlopCounterMode, global step / ranks"
COLLECTIVES_SOURCE = ("c10d ops on the fake process group, seen by a "
                      "TorchDispatchMode; link bytes by hlo_stats.link_bytes")
MEMORY_SOURCE = "leaf shapes and the sharding specs on the mesh, exact"

#: c10d op (overload packet name) -> the HLO collective it stands for
_C10D_TO_HLO = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute",
}


def depth_variants(cfg):
    """Two shallow UNROLLED variants (a, b) and the multiplier such that
    exact_cost = F_a + mult * (F_b - F_a).

    Layers are identical within a segment, so cost is affine in depth: two
    unrolled points recover it exactly (the reference's rule, kept so that
    the two packages extrapolate from the same depths)."""
    r = dataclasses.replace
    if cfg.family == "hybrid":
        per = cfg.attn_every
        tail = cfg.n_layers % per
        a, b = per + tail, 2 * per + tail
        mult = (cfg.n_layers - a) / per
        return (r(cfg, n_layers=a, scan_layers=False),
                r(cfg, n_layers=b, scan_layers=False), mult)
    if cfg.family == "encdec":
        return (r(cfg, enc_layers=1, dec_layers=1, n_layers=2,
                  scan_layers=False),
                r(cfg, enc_layers=2, dec_layers=2, n_layers=4,
                  scan_layers=False),
                cfg.enc_layers - 1)
    if cfg.layer_pattern == "local_global":
        return (r(cfg, n_layers=2, scan_layers=False),
                r(cfg, n_layers=4, scan_layers=False),
                (cfg.n_layers - 2) / 2)
    if cfg.mla and cfg.first_k_dense:
        a = cfg.first_k_dense + 1
        return (r(cfg, n_layers=a, scan_layers=False),
                r(cfg, n_layers=a + 1, scan_layers=False),
                cfg.n_layers - a)
    return (r(cfg, n_layers=1, scan_layers=False),
            r(cfg, n_layers=2, scan_layers=False),
            cfg.n_layers - 1)


# ------------------------------------------------------------- collectives
def _process_group(args):
    for a in args:
        if isinstance(a, torch.ScriptObject) and \
                a._type().name().endswith("ProcessGroup"):
            return torch._C._distributed_c10d.ProcessGroup.unbox(a)
    return None


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0


class CollectiveLog(TorchDispatchMode):
    """Every c10d collective dispatched inside the block: (c10d op, result
    bytes, group size) in ``ops``. The result is the op's first argument
    (the tensors it writes: in place for an all-reduce, the gathered or
    scattered outputs otherwise)."""

    def __init__(self):
        super().__init__()
        self.ops: List[tuple] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "c10d":
            pg = _process_group(args)
            self.ops.append((func._overloadpacket.__name__,
                             _nbytes(args[0]) if args else 0,
                             pg.size() if pg is not None else 0))
        return func(*args, **(kwargs or {}))

    def stats(self) -> Dict:
        """Counts, result bytes and link bytes a rank by HLO collective
        name (ops with none, such as a broadcast, under ``other``)."""
        counts = {c: 0 for c in _COLLECTIVES}
        result = {c: 0 for c in _COLLECTIVES}
        other: Dict[str, int] = {}
        link = 0.0
        groups = set()
        for name, nbytes, k in self.ops:
            op = _C10D_TO_HLO.get(name)
            if op is None:
                other[name] = other.get(name, 0) + 1
                continue
            counts[op] += 1
            result[op] += nbytes
            link += link_bytes(op, nbytes, k)
            groups.add(k)
        return {"counts": counts, "result_bytes": result,
                "link_bytes_per_device": link,
                "group_sizes": sorted(groups), "other": other,
                "source": COLLECTIVES_SOURCE}


# ------------------------------------------------------------------ memory
def _leaf_bytes(t: torch.Tensor, spec, sizes: Dict[str, int]) -> int:
    shape = list(t.shape)
    for i, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        div = math.prod(sizes[n] for n in names if n is not None)
        shape[i] = -(-shape[i] // div)
    return math.prod(shape) * t.element_size()


def sharded_bytes(tree, specs, mesh) -> int:
    """Bytes a rank of ``tree`` laid out by the spec tree ``specs`` on
    ``mesh``."""
    leaves, spec_leaves = tree_leaves(tree), tree_leaves(specs)
    if len(leaves) != len(spec_leaves):
        raise ValueError(f"{len(leaves)} leaves, {len(spec_leaves)} specs")
    sizes = _mesh_sizes(mesh)
    return sum(_leaf_bytes(t, s, sizes) for t, s in zip(leaves, spec_leaves))


def input_shardings(cfg, kind: str, args, mesh, global_batch: int):
    """The spec trees of a cell's arguments on ``mesh``: the reference's
    ``in_shardings``."""
    pspecs = param_specs(cfg, args[0], mesh)
    if kind == "train":
        return (pspecs, opt_state_specs(cfg, args[1], pspecs),
                batch_specs(cfg, mesh, "train"))
    if kind == "prefill":
        return pspecs, batch_specs(cfg, mesh, "prefill")
    return (pspecs, cache_specs(cfg, mesh, args[1], global_batch),
            P(_dp_or_none(mesh, global_batch)), P())


def output_shardings(cfg, kind: str, in_sh, outs, mesh, global_batch: int):
    """The spec trees of a cell's outputs ``outs``: the reference's
    ``out_shardings``."""
    if kind == "train":
        return P(), in_sh[0], in_sh[1]
    if kind == "prefill":
        return P(), cache_specs(cfg, mesh, outs[1], global_batch)
    return P(_dp_or_none(mesh, global_batch), None), in_sh[1]


def argument_bytes(cfg, shape_name: str, mesh) -> int:
    """A rank's argument bytes of the cell, from the input specs alone
    (nothing traced)."""
    spec = input_specs(cfg, shape_name)
    return sharded_bytes(spec["args"], input_shardings(
        cfg, spec["kind"], spec["args"], mesh,
        SHAPES_BY_NAME[shape_name].global_batch), mesh)


# ------------------------------------------------------------------ cells
@contextlib.contextmanager
def production_mesh(multi_pod: bool):
    """The production mesh on a fake group started for the block (or the
    default group there is, if of the mesh's size), destroyed after it if
    it was started here."""
    started = not dist.is_initialized()
    try:
        yield make_production_mesh(multi_pod=multi_pod)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _analyze(cfg, shape_name: str, multi_pod: bool) -> Dict:
    """Trace one configuration on the meta device; its record."""
    shape = SHAPES_BY_NAME[shape_name]
    spec = input_specs(cfg, shape_name)
    kind, args = spec["kind"], spec["args"]
    with production_mesh(multi_pod) as mesh, set_mesh(mesh):
        if kind == "train":
            fn = make_train_step(cfg, mesh=mesh)
        elif kind == "prefill":
            fn = make_prefill_step(cfg, max_len=shape.seq_len)
        else:
            fn = make_decode_step(cfg)
        flops, log = FlopCounterMode(display=False), CollectiveLog()
        t0 = time.perf_counter()
        with flops, log:
            outs = fn(*args)
        trace_s = time.perf_counter() - t0
        in_sh = input_shardings(cfg, kind, args, mesh, shape.global_batch)
        out_sh = output_shardings(cfg, kind, in_sh, outs, mesh,
                                  shape.global_batch)
        ranks = mesh.size()
        memory = {"argument_bytes": sharded_bytes(args, in_sh, mesh),
                  "output_bytes": sharded_bytes(outs, out_sh, mesh),
                  "temp_bytes": None,
                  "temp_bytes_note": "no compiler plans the port's "
                                     "buffers: not known",
                  "source": MEMORY_SOURCE}
    return {"kind": kind, "trace_s": trace_s, "ranks": ranks,
            "memory": memory,
            "flops_per_device": flops.get_total_flops() / ranks,
            "flops_source": FLOPS_SOURCE,
            "collectives": log.stats()}


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               overrides: dict = None, exact: bool = True) -> Dict:
    """One cell: the full-depth trace (it runs, and its memory) plus, on
    the single-pod mesh, two shallow unrolled traces that extrapolate the
    FLOPs and the collective traffic a rank to full depth."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    out = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16", "status": "ok"}
    out.update(_analyze(cfg, shape_name, multi_pod))

    if exact and not multi_pod:
        cfg_a, cfg_b, mult = depth_variants(cfg)
        ra = _analyze(cfg_a, shape_name, multi_pod)
        rb = _analyze(cfg_b, shape_name, multi_pod)

        def extrap(fa, fb):
            return fa + mult * (fb - fa)

        ca, cb = ra["collectives"], rb["collectives"]
        out["exact"] = {
            "flops_per_device": extrap(ra["flops_per_device"],
                                       rb["flops_per_device"]),
            "link_bytes_per_device": extrap(
                ca["link_bytes_per_device"], cb["link_bytes_per_device"]),
            "coll_counts": {
                k: extrap(ca["counts"][k], cb["counts"][k])
                for k in ca["counts"]},
            "depth_points": [cfg_a.n_layers, cfg_b.n_layers],
            "mult": mult,
            "trace_s": ra["trace_s"] + rb["trace_s"],
        }
    return out


def run_cell(arch, shape_name, multi_pod, overrides=None, exact=True):
    try:
        return lower_cell(arch, shape_name, multi_pod, overrides,
                          exact=exact)
    except Exception as e:                                   # noqa: BLE001
        return {"arch": arch, "shape": shape_name,
                "mesh": "2x16x16" if multi_pod else "16x16",
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--override", default=None,
                    help="JSON dict of ModelConfig overrides (perf knobs)")
    ap.add_argument("--no-exact", action="store_true",
                    help="skip the exact-cost depth-variant traces")
    args = ap.parse_args(argv)

    overrides = json.loads(args.override) if args.override else None
    archs = all_archs() if args.all or not args.arch else [args.arch]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = []
    for arch in archs:
        skips = skip_shapes(arch)
        shapes = ([args.shape] if args.shape
                  else list(SHAPES_BY_NAME.keys()))
        for shape_name in shapes:
            if shape_name in skips:
                results.append({"arch": arch, "shape": shape_name,
                                "status": "skip",
                                "reason": skips[shape_name]})
                print(f"SKIP {arch} {shape_name}: {skips[shape_name]}")
                continue
            for mp in meshes:
                r = run_cell(arch, shape_name, mp, overrides,
                             exact=not args.no_exact)
                results.append(r)
                tag = "OK  " if r["status"] == "ok" else "FAIL"
                extra = (f"trace={r.get('trace_s')}s "
                         f"flops/dev={r.get('flops_per_device', 0):.3g}"
                         if r["status"] == "ok"
                         else r.get("error", ""))
                print(f"{tag} {arch} {shape_name} "
                      f"{'512' if mp else '256'}ranks {extra}", flush=True)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    n_fail = sum(1 for r in results if r["status"] == "error")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
