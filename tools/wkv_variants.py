#!/usr/bin/env python3
"""Time builds of the port's WKV source against each other on one CUDA
card, in turns, through each build's ``wkv_split`` (the 64 x 64, chunk-16
route): rwkv6-7b's prefill shape (B, 64, 512, 64) at B = 1, 2 and 4 with
bf16 r/k/v head-transposed views and float32 logw, the same at B = 4 in
float32, and rwkv6-7b's training microbatch (2, 64, 1,024, 64) from a
non-zero state.

Each variant is ``NAME:PATH``, a copy of ``wkv.cu`` (an earlier commit's,
from ``git show``, or one edited by hand), built with the port's ``nvcc``
flags. Every call is held against ``wkv_chunked_ref`` (o at 2e-2 in bf16,
5e-4 / 1e-3 in float32; the final state at 5e-4 / 1e-3) before it is
timed; times are CUDA events over launches queued behind a spin kernel
(``chip_smoke.device_ms``), taken in turns (A B ... B A) so that the
variants see the same card. Prints each shape's bound (bytes at 3.35 TB/s
and operations, the products as split TF32 on the tensor cores and the rest
at 67 TFLOP/s, and which one binds), each build's
ptxas registers, stack and spills for every ``wkv_split_kernel`` instance
(``chip_smoke.ptxas_report`` on the build log's text) and the CTAs an SM
of each instance (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), and
writes everything to ``--out``.

    F=src/repro_torch/kernels/rwkv6/csrc/wkv.cu
    V=_archive/variants && mkdir -p $V
    git show <commit>:$F > $V/parent.cu
    python3 tools/wkv_variants.py --out _archive/wv \\
        parent:$V/parent.cu new:$F
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rwkv6 import rwkv6  # noqa: E402
from repro_torch.kernels.rwkv6.ref import wkv_chunked_ref  # noqa: E402

#: rwkv6-7b's heads: the shapes are chip_smoke's ``WKV_SPLIT_SHAPES``
H, D, CHUNK = 64, 64, 16
#: the four instances of the split kernel, by (dtype, wdtype) code
INSTANCES = {(0, 0): "float, float", (1, 0): "__nv_bfloat16, float",
             (1, 1): "__nv_bfloat16, __nv_bfloat16",
             (0, 1): "float, __nv_bfloat16"}
#: appended to each copy: the CTAs an SM of one split-kernel instance
OCCUPANCY = """
extern "C" int ctas_per_sm(int dtype, int wdtype) {
  int n = -1;
  auto occ = [&](auto kernel, int bytes) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, kernel, kSplitThreads, bytes) != cudaSuccess)
      n = -1;
  };
%s
  return n;
}
"""


def _bytes_of(src: str, types: str) -> str:
    """The dynamic shared memory a copy launches an instance with: its
    ``split_smem_bytes`` where it has one, else ``sizeof(SplitSmem)``."""
    if "split_smem_bytes" in src:
        return f"split_smem_bytes<{types}>()"
    return f"static_cast<int>(sizeof(SplitSmem<{types}>))"


def build(name, path, out_dir):
    """Compile one variant; return (library, ptxas log)."""
    src = Path(path).read_text()
    cases = "\n".join(
        f"  if (dtype == {dt} && wdtype == {wt}) "
        f"occ(wkv_split_kernel<{types}>, {_bytes_of(src, types)});"
        for (dt, wt), types in INSTANCES.items())
    marker = "}  // namespace\n"
    src = src.replace(marker, marker + OCCUPANCY % cases, 1)
    lib, log = _build.build_copy(name, src, out_dir)
    lib.wkv_split.argtypes = list(rwkv6._SIGNATURES["wkv_split"])
    lib.wkv_split.restype = ctypes.c_int
    lib.ctas_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib, log


def call(lib, r, k, v, logw, u, state):
    """One launch of a copy's ``wkv_split``; returns (o, final state)."""
    b, h, s, _ = r.shape
    o = torch.empty((b, h, s, D), dtype=r.dtype, device=r.device)
    st = torch.empty((b, h, D, D), dtype=torch.float32, device=r.device)
    err = lib.wkv_split(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), None if state is None else state.data_ptr(),
        o.data_ptr(), st.data_ptr(),
        *(x for t in (r, k, v, logw) for x in t.stride()[:3]),
        b, h, s, D, D, CHUNK, rwkv6.DTYPES[r.dtype],
        rwkv6.DTYPES[logw.dtype], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"wkv_split: CUDA error {err}")
    return o, st


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+", help="NAME:PATH")
    ap.add_argument("--out", type=Path,
                    default=_build.BUILD_DIR / "wkv_variants")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wkv_variants: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    args.out.mkdir(parents=True, exist_ok=True)
    specs = [spec.split(":", 1) for spec in args.variants]
    with ThreadPoolExecutor(len(specs)) as pool:
        built = list(pool.map(lambda sp: build(*sp, args.out), specs))
    card = cs.card_line()
    print(card)
    report = dict(card=card, variants={}, shapes=[])
    libs = {}
    for (name, path), (lib, log) in zip(specs, built):
        libs[name] = lib
        rep = dict(source=path,
                   ptxas=cs.ptxas_report(log, ("wkv_split_kernel",)),
                   ctas_per_sm={types: lib.ctas_per_sm(*codes)
                                for codes, types in INSTANCES.items()})
        report["variants"][name] = rep
        print(f"{name} ({path}): CTAs an SM {rep['ctas_per_sm']}")
        for fn, r in rep["ptxas"].items():
            print(f"  ptxas {fn}: {r}")
    gen = torch.Generator(device=dev).manual_seed(3)
    for label, b, s, dtype, with_state in cs.WKV_SPLIT_SHAPES:
        h = H
        r, k, v, logw, u = cs._wkv_views(gen, dev, b, h, s, D, dtype)
        state = (torch.randn((b, h, D, D), generator=gen, device=dev) * 0.5
                 if with_state else None)
        zero = torch.zeros((b, h, D, D), device=dev)
        want_o, want_st = wkv_chunked_ref(r, k, v, logw, u,
                                          zero if state is None else state)
        otol = (2e-2, 2e-2) if dtype == "bfloat16" else (5e-4, 1e-3)
        runs = {}
        for name, lib in libs.items():
            o, st = call(lib, r, k, v, logw, u, state)
            torch.cuda.synchronize(dev)
            err = max(cs._within(o, want_o, *otol, f"{label} {name} o"),
                      cs._within(st, want_st, 5e-4, 1e-3,
                                 f"{label} {name} state"))
            runs[name] = dict(max_abs_err=err, ms=[])
        for name in list(libs) + list(libs)[::-1]:
            runs[name]["ms"].append(cs.device_ms(
                lambda: call(libs[name], r, k, v, logw, u, state),
                args.reps, dev))
        bound = cs._wkv_split_bounds(r, k, v, logw, u, state, want_o,
                                     want_st)
        report["shapes"].append(dict(label=label, shape=[b, h, s, D],
                                     dtype=dtype, state=with_state,
                                     **bound, by_variant=runs))
        print(f"{label}: r/k/v ({b}, {h}, {s}, {D}) {dtype} views, logw "
              f"float32{', from a non-zero state' if with_state else ''}; "
              f"bound {bound['bound_ms']:.6f} ms ({bound['bound_by']}: "
              f"{bound['bytes']} B take {bound['bytes_ms']:.6f} ms; "
              f"{bound['flops']} FLOP take {bound['ops_ms']:.6f} ms with the "
              f"products as split TF32, {bound['fp32_ops_ms']:.6f} ms all on "
              f"the CUDA cores)")
        for name, run in runs.items():
            best = min(run["ms"])
            print(f"  {name}: {run['ms']} ms, max abs err "
                  f"{run['max_abs_err']:.3e}, {best / bound['bytes_ms']:.2f}"
                  f" x the bytes bound")
        del r, k, v, logw, u, state, want_o, want_st
    (args.out / "report.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
