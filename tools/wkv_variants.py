#!/usr/bin/env python3
"""Time builds of the port's WKV source against each other on one CUDA
card, in turns, through each build's two entry points. ``wkv_split`` (the
64 x 64, chunk-16 route) at chip_smoke's ``WKV_SPLIT_SHAPES``: rwkv6-7b's
prefill shape (B, 64, 512, 64) at B = 1, 2 and 4 with bf16 r/k/v
head-transposed views and float32 logw, the same at B = 4 in float32, and
rwkv6-7b's training microbatch (2, 64, 1,024, 64) from a non-zero state.
``wkv`` (every other shape) at chip_smoke's ``WKV_SHAPES``: rwkv6-7b's
heads over prompts of 8, 1 and 13 tokens and over 512 tokens in chunks of
8. A build whose ``wkv`` takes strides (this design's) is timed on the
views and on their contiguous copies; one whose ``wkv`` takes contiguous
inputs only (the one-CTA-a-head scalar kernel this design replaced) on
the copies, so that kernel meets kernel on the same bytes.

Each variant is ``NAME:PATH``, a copy of ``wkv.cu`` (an earlier commit's,
from ``git show``, or one edited by hand), built with the port's ``nvcc``
flags. Every call is held against ``wkv_chunked_ref`` (o at 2e-2 in bf16,
5e-4 / 1e-3 in float32; the final state at 5e-4 / 1e-3) before it is
timed; times are CUDA events over launches queued behind a spin kernel
(``chip_smoke.device_ms``), taken in turns (A B ... B A) so that the
variants see the same card. Prints each shape's bound (bytes at 3.35 TB/s
and operations, the products as split TF32 on the tensor cores and the rest
at 67 TFLOP/s, and which one binds), each build's
ptxas registers, stack and spills for every ``wkv_split_kernel`` and
``wkv_kernel`` instance (``chip_smoke.ptxas_report`` on the build log's
text) and the CTAs an SM of each split instance
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), and writes everything
to ``--out``.

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
import re
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
    lib.ctas_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.strided = takes_strides(src)
    lib.wkv.argtypes = list(rwkv6._SIGNATURES["wkv"] if lib.strided
                            else (ctypes.c_void_p,) * 8 + (ctypes.c_int64,)
                            + (ctypes.c_int,) * 7 + (ctypes.c_void_p,))
    lib.wkv_split.restype = lib.wkv.restype = ctypes.c_int
    return lib, log


def takes_strides(src: str) -> bool:
    """Whether a copy's ``wkv`` entry point reads its inputs through their
    strides (this design's arguments, those of ``wkv_split``) or takes
    contiguous inputs and B * H (the scalar kernel's)."""
    m = re.search(r"\bint wkv\((.*?)\)\s*\{", src, re.S)
    return m is not None and "int64_t bh," not in m[1]


def call(lib, r, k, v, logw, u, state, entry="wkv_split", chunk=CHUNK):
    """One launch of a copy's ``entry``; returns (o, final state)."""
    b, h, s, dk = r.shape
    dv = v.shape[-1]
    o = torch.empty((b, h, s, dv), dtype=r.dtype, device=r.device)
    st = torch.empty((b, h, dk, dv), dtype=torch.float32, device=r.device)
    c = min(chunk, s)
    if entry == "wkv_split" or lib.strided:
        shape = (*(x for t in (r, k, v, logw) for x in t.stride()[:3]),
                 b, h, s, dk, dv, c)
    else:
        assert all(t.is_contiguous() for t in (r, k, v, logw))
        shape = (b * h, h, s, dk, dv, c)
    err = getattr(lib, entry)(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), None if state is None else state.data_ptr(),
        o.data_ptr(), st.data_ptr(), *shape, rwkv6.DTYPES[r.dtype],
        rwkv6.DTYPES[logw.dtype], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{entry}: CUDA error {err}")
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
        rep = dict(source=path, wkv_takes_strides=lib.strided,
                   ptxas=cs.ptxas_report(log, ("wkv_split_kernel",
                                               "wkv_kernel")),
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
    for label, b, s, chunk, dtype in cs.WKV_SHAPES:
        report["shapes"].append(time_wkv(libs, gen, dev, label, b, s,
                                         chunk, dtype, args.reps))
    (args.out / "report.json").write_text(json.dumps(report, indent=1))
    return 0


def time_wkv(libs, gen, dev, label, b, s, chunk, dtype, reps) -> dict:
    """Each copy's ``wkv`` at one shape of rwkv6-7b's heads, in turns:
    held against ``wkv_chunked_ref`` first, then timed on the contiguous
    copies of the model's views (every copy) and on the views themselves
    (the copies whose ``wkv`` takes strides)."""
    views = cs._wkv_views(gen, dev, b, H, s, D, dtype)
    r, k, v, logw, u = views
    contig = [t.contiguous() for t in (r, k, v, logw)] + [u]
    zero = torch.zeros((b, H, D, D), device=dev)
    want_o, want_st = wkv_chunked_ref(r, k, v, logw, u, zero, chunk=chunk)
    runs, timed = {}, []
    for name, lib in libs.items():
        err = 0.0
        for ins, how in ((contig, "contiguous"), (views, "views")):
            if how == "views" and not lib.strided:
                continue
            o, st = call(lib, *ins, None, "wkv", chunk)
            torch.cuda.synchronize(dev)
            err = max(err, cs._within(o, want_o, 2e-2, 2e-2,
                                      f"wkv {label} {name} {how} o"),
                      cs._within(st, want_st, 5e-4, 1e-3,
                                 f"wkv {label} {name} {how} state"))
            timed.append((name, how, ins))
        runs[name] = dict(max_abs_err=err, ms={})
    for name, how, ins in timed + timed[::-1]:
        runs[name]["ms"].setdefault(how, []).append(cs.device_ms(
            lambda: call(libs[name], *ins, None, "wkv", chunk), reps, dev))
    c = min(chunk, s)
    o, st = call(libs[next(iter(libs))], *contig, None, "wkv", chunk)
    bound = cs._wkv_split_bounds(r, k, v, logw, u, None, o, st, c)
    print(f"wkv {label}: r/k/v ({b}, {H}, {s}, {D}) {dtype} views, logw "
          f"float32, chunk {c}; bound {bound['bound_ms']:.6f} ms "
          f"({bound['bound_by']}: {bound['bytes']} B take "
          f"{bound['bytes_ms']:.6f} ms; {bound['flops']} FLOP take "
          f"{bound['ops_ms']:.6f} ms with the products as split TF32)")
    for name, run in runs.items():
        print(f"  {name}: " + "; ".join(
            f"{how} {ms} ms ({min(ms) / bound['bound_ms']:.2f} x the bound)"
            for how, ms in run["ms"].items())
            + f"; max abs err {run['max_abs_err']:.3e}")
    return dict(label=label, entry="wkv", shape=[b, H, s, D], chunk=c,
                dtype=dtype, **bound, by_variant=runs)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
