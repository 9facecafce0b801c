#!/usr/bin/env python3
"""Time builds of the port's flash-attention source against each other on
one CUDA card, in turns. In bf16 (the default) at every shape of
``chip_smoke.FLASH_MODEL_SHAPES`` (the bf16 prefills, gemma2's D = 256 and
qwen2's train shape) and at three more (deepseek-v2's MLA at batch 1, a D
= 160 head, phi3's D = 96); with ``--dtype
float32`` at every float32 shape of ``chip_smoke.py``'s consistency phase
(``chip_smoke.FLASH_F32_SHAPES``: qwen2, olmoe, deepseek-v2's MLA, zamba2
and seamless, batch 1, S = 512-576).

Each variant is ``NAME:PATH``, a copy of ``flash_attention.cu`` (an
earlier commit's, from ``git show``, or one edited by hand), built with
the port's ``nvcc`` flags. A bf16 call goes to the variant's
``flash_attention_mma``; where that entry refuses the head dim, as an
earlier source's does above D = 128, to its ``flash_attention``. A
float32 call goes to the variant's ``flash_attention``. The line of each
shape names the entry that ran.
Every call is held against ``flash_attention_ref`` (at 2e-2 in bf16, 2e-5
in float32; v's zero columns must give exactly zero output columns)
before it is timed; times are CUDA events over launches queued behind a
spin kernel (``chip_smoke.device_ms``), taken in turns (A B ... B A) so
that the variants see the same card. Prints each build's ptxas registers
and spills (``chip_smoke.ptxas_report`` on the build log's text) and the
CTAs an SM of every instance of the route the dtype takes
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), and writes
everything to ``--out``.

    F=src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu
    V=chiprun_out/variants && mkdir -p $V
    git show <commit>:$F > $V/parent.cu
    # one CTA an SM at every DP: MmaRegs' ctas set to 1
    sed 's/ctas = DP <= 64 ? 2 : 1;/ctas = 1;/' $F > $V/one_cta.cu
    python3 tools/flash_variants.py --out $V \\
        parent:$V/parent.cu one_cta:$V/one_cta.cu new:$F
    # the float32 route: the parent's CUDA-core kernel against this one
    python3 tools/flash_variants.py --dtype float32 --out $V \\
        parent:$V/parent.cu new:$F
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention as fa)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref)

#: (label, b, hq, hkv, sq, skv, d, causal, columns of v that are not zero)
SHAPES = {
    "bfloat16": tuple((f"{arch} {what}", *shape)
                      for arch, what, *shape in cs.FLASH_MODEL_SHAPES) + (
        ("MLA, batch 1", 1, 128, 128, 512, 512, 192, True, 128),
        ("D 160", 4, 32, 8, 512, 512, 160, True, None),
        ("phi3-mini", 4, 32, 32, 512, 512, 96, True, None),
    ),
    "float32": tuple((f"{arch} {what}", *shape)
                     for arch, what, *shape, _ in cs.FLASH_F32_SHAPES),
}
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
PEAK = {"bfloat16": cs.BF16_FLOP_PER_S, "float32": cs.FP32_FLOP_PER_S}
#: appended to each copy: the CTAs an SM of one instance of a route (0 the
#: tensor-core one, 1 the CUDA-core one), -1 where the copy has none
OCCUPANCY = """
extern "C" int ctas_per_sm(int route, int dp) {
  int n = -1;
  auto occ = [&](auto kernel, size_t bytes, int threads) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, kernel, threads, bytes) != cudaSuccess)
      n = -1;
  };
  if (route == 0) {
    switch (dp) {
%s
    }
  } else {
    switch (dp) {
%s
    }
  }
  return n;
}
"""
INVALID_VALUE = 1  # cudaErrorInvalidValue: the entry refuses the shape


def _instances(src):
    """The compiled instances of each route in a copy, by DP, as the
    ``case`` lines of ``OCCUPANCY``: each with the launch's shared memory
    and threads. A copy without ``launch_mma<DP>`` or
    ``launch_f32<DP>`` reports -1 CTAs an SM for that route."""
    mma = {int(m): f"occ(flash_mma_kernel<{m}>, MmaTile<{m}>::bytes, "
                   f"kMmaThreads);"
           for m in re.findall(r"launch_mma<(\d+)>\(", src)}
    f32 = {int(m): f"occ(flash_kernel<{m}>, F32Tile<{m}>::bytes, "
                   f"kF32Threads);"
           for m in re.findall(r"launch_f32<(\d+)>\(", src)}
    return mma, f32


def build(name, path, out_dir):
    """Compile one variant; return (library, ptxas log, instances)."""
    src = Path(path).read_text()
    routes = _instances(src)
    cases = ["\n".join(f"    case {dp}: {line} break;"
                        for dp, line in sorted(r.items())) for r in routes]
    marker = "}  // namespace\n"
    src = src.replace(marker, marker + OCCUPANCY % tuple(cases), 1)
    lib, log = _build.build_copy(name, src, out_dir)
    for symbol in fa.ROUTES:
        getattr(lib, symbol).argtypes = list(fa._ARGS)
        getattr(lib, symbol).restype = ctypes.c_int
    lib.ctas_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib, log, routes


def call(lib, entry, q, k, v, causal):
    """One launch of ``entry``; None where the tensor-core entry refuses
    the shape."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], b, hq, hkv, sq,
        skv, d, fa.DTYPES[q.dtype], int(causal), 0, 0, 0, 0.0, 0, 0,
        0, 1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
    if err == INVALID_VALUE and entry == "flash_attention_mma":
        return None
    if err:
        raise RuntimeError(f"{entry}: CUDA error {err}")
    return o


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+", help="NAME:PATH")
    ap.add_argument("--out", type=Path,
                    default=_build.BUILD_DIR / "variants")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dtype", choices=sorted(SHAPES), default="bfloat16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    args.out.mkdir(parents=True, exist_ok=True)
    specs = [spec.split(":", 1) for spec in args.variants]
    with ThreadPoolExecutor(len(specs)) as pool:
        built = list(pool.map(lambda s: build(*s, args.out), specs))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    report = dict(card=card, dtype=args.dtype, variants={}, shapes=[])
    libs = {}
    route = 0 if args.dtype == "bfloat16" else 1
    for (name, path), (lib, log, routes) in zip(specs, built):
        libs[name] = lib
        rep = dict(source=path, ptxas=cs.ptxas_report(
            log, ("flash_mma_kernel", "flash_kernel")), ctas_per_sm={
            dp: lib.ctas_per_sm(route, dp) for dp in sorted(routes[route])})
        report["variants"][name] = rep
        print(f"{name} ({path}): CTAs an SM by DP {rep['ctas_per_sm']}")
        for fn, r in rep["ptxas"].items():
            print(f"  ptxas {fn}: {r}")
    gen = torch.Generator(device=dev).manual_seed(3)
    tol = TOL[args.dtype]
    for label, b, hq, hkv, sq, skv, d, causal, v_cols in SHAPES[args.dtype]:
        q, k, v = cs._flash_inputs(gen, dev, b, hq, hkv, sq, skv, d,
                                   args.dtype, 1.5)
        if v_cols:
            v[..., v_cols:] = 0
        want = flash_attention_ref(q, k, v, causal=causal)
        runs = {}
        for name, lib in libs.items():
            entry = fa.flash_route(q.dtype, d)
            got = call(lib, entry, q, k, v, causal)
            if got is None:
                entry = "flash_attention"
                got = call(lib, entry, q, k, v, causal)
            torch.cuda.synchronize(dev)
            err = cs._within(got, want, tol, tol, f"{label} {name}")
            cs.check(not v_cols or not got[..., v_cols:].any(),
                     f"{label} {name}: output columns {v_cols}.. of zero "
                     f"v columns are not exactly 0")
            runs[name] = dict(entry=entry, max_abs_err=err, ms=[])
        for name in list(libs) + list(libs)[::-1]:
            entry = runs[name]["entry"]
            runs[name]["ms"].append(cs.device_ms(
                lambda: call(libs[name], entry, q, k, v, causal),
                args.reps, dev))
        sdpa = cs.device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), args.reps, dev)
        bound = cs._bound(*cs._flash_work(q, k, v, causal), PEAK[args.dtype])
        bound.update(cs._useful_bound(q, k, v, causal, v_cols,
                                      PEAK[args.dtype]))
        report["shapes"].append(dict(label=label,
                                     shape=[b, hq, hkv, sq, skv, d],
                                     causal=causal, sdpa_ms=sdpa, **bound,
                                     by_variant=runs))
        print(f"{label}: q ({b}, {hq}, {sq}, {d}) {args.dtype}, k/v ({b}, "
              f"{hkv}, {skv}, {d}), {'causal' if causal else 'non-causal'}; "
              f"bound {bound['bound_ms']:.6f} ms ({bound['bound_by']}"
              + (f"; {bound['useful_bound_ms']:.6f} ms without v's zero pad"
                 if v_cols else "") + f"); SDPA {sdpa:.6f} ms")
        for name, r in runs.items():
            print(f"  {name}: {r['entry']} {r['ms']} ms, max abs err "
                  f"{r['max_abs_err']:.3e}, "
                  f"{bound['flops'] / min(r['ms']) / 1e9:.1f} TFLOP/s"
                  + (f" ({bound['useful_flops'] / min(r['ms']) / 1e9:.1f} "
                     f"without the pad)" if v_cols else ""))
        del q, k, v, want
    (args.out / "report.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
