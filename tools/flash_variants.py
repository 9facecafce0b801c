#!/usr/bin/env python3
"""Time builds of the port's flash-attention source against each other on
one CUDA card, in turns, at the wide-head shapes of the bf16 models
(deepseek-v2's MLA at D = 192, gemma2 at D = 256, a D = 160 head) and at
three narrow ones (qwen2, olmoe, phi3).

Each variant is ``NAME:PATH``, a copy of ``flash_attention.cu`` (an
earlier commit's, from ``git show``, or one edited by hand), built with
the port's ``nvcc`` flags. A bf16 call goes to the variant's
``flash_attention_mma``; where that entry refuses the head dim, as an
earlier source's does above D = 128, to its ``flash_attention``. The line
of each shape names the entry that ran.
Every call is held against ``flash_attention_ref`` at 2e-2 (and v's zero
columns must give exactly zero output columns) before it is timed; times
are CUDA events over
launches queued behind a spin kernel (``chip_smoke.device_ms``), taken in
turns (A B ... B A) so that the variants see the same card. Prints each
build's ptxas registers and spills and the CTAs an SM of every
tensor-core instance (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
and writes everything to ``--out``.

    F=src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu
    V=chiprun_out/variants && mkdir -p $V
    git show <commit>:$F > $V/parent.cu
    # two V stages at every DP: MmaTile's SV set to false
    sed 's/smem_ctas(5 \\* tile) < 2 .*;/false;/' $F > $V/two_v.cu
    python3 tools/flash_variants.py --out $V \\
        parent:$V/parent.cu two_v:$V/two_v.cu one_v:$F
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

#: (label, b, hq, hkv, s, d, causal, columns of v that are not zero)
SHAPES = (
    ("deepseek-v2 MLA", 4, 128, 128, 512, 192, True, 128),
    ("gemma2-2b", 4, 8, 4, 512, 256, True, None),
    ("MLA, batch 1", 1, 128, 128, 512, 192, True, 128),
    ("D 160", 4, 32, 8, 512, 160, True, None),
    ("qwen2-0.5b", 8, 14, 2, 512, 64, True, None),
    ("olmoe-1b-7b", 4, 16, 16, 512, 128, True, None),
    ("phi3-mini", 4, 32, 32, 512, 96, True, None),
)
#: appended to each copy: the CTAs an SM of one tensor-core instance
OCCUPANCY = """
extern "C" int mma_ctas_per_sm(int dp) {
  int n = -1;
  auto occ = [&](auto kernel, size_t bytes) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, kernel, kMmaThreads, bytes) != cudaSuccess)
      n = -1;
  };
  switch (dp) {
%s
  }
  return n;
}
"""
INVALID_VALUE = 1  # cudaErrorInvalidValue: the entry refuses the shape


def build(name, path, out_dir):
    """Compile one variant; return (library, ptxas log, tensor-core DPs)."""
    src = Path(path).read_text()
    dps = sorted({int(m) for m in re.findall(r"launch_mma<(\d+)>\(", src)})
    cases = "\n".join(f"    case {dp}: occ(flash_mma_kernel<{dp}>, "
                      f"MmaTile<{dp}>::bytes); break;" for dp in dps)
    marker = "}  // namespace\n"
    src = src.replace(marker, marker + OCCUPANCY % cases, 1)
    cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
    cu.write_text(src)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    (out_dir / f"{name}.log").write_text(log)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{log}")
    lib = ctypes.CDLL(str(so))
    for symbol in fa.ROUTES:
        getattr(lib, symbol).argtypes = list(fa._ARGS)
        getattr(lib, symbol).restype = ctypes.c_int
    lib.mma_ctas_per_sm.argtypes = [ctypes.c_int]
    return lib, log, dps


def call(lib, entry, q, k, v, causal):
    """One bf16 launch of ``entry``; None where it refuses the shape."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], b, hq, hkv, sq,
        skv, d, fa.DTYPES[torch.bfloat16], int(causal), 0, 0, 0, 0.0, 0, 0,
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
    report = dict(card=card, variants={}, shapes=[])
    libs = {}
    for (name, path), (lib, log, dps) in zip(specs, built):
        libs[name] = lib
        rep = dict(source=path, ptxas=cs.ptxas_report(
            log, ("flash_mma_kernel", "flash_kernel")), ctas_per_sm={
            dp: lib.mma_ctas_per_sm(dp) for dp in dps})
        report["variants"][name] = rep
        print(f"{name} ({path}): CTAs an SM by DP {rep['ctas_per_sm']}")
        for fn, r in rep["ptxas"].items():
            print(f"  ptxas {fn}: {r}")
    gen = torch.Generator(device=dev).manual_seed(3)
    for label, b, hq, hkv, s, d, causal, v_cols in SHAPES:
        q, k, v = cs._flash_inputs(gen, dev, b, hq, hkv, s, s, d,
                                   "bfloat16", 1.5)
        if v_cols:
            v[..., v_cols:] = 0
        want = flash_attention_ref(q, k, v, causal=causal)
        runs = {}
        for name, lib in libs.items():
            entry = "flash_attention_mma"
            got = call(lib, entry, q, k, v, causal)
            if got is None:
                entry = "flash_attention"
                got = call(lib, entry, q, k, v, causal)
            torch.cuda.synchronize(dev)
            err = cs._within(got, want, 2e-2, 2e-2, f"{label} {name}")
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
        bound = cs._bound(*cs._flash_work(q, k, v, causal),
                          cs.BF16_FLOP_PER_S)
        report["shapes"].append(dict(label=label, shape=[b, hq, hkv, s, d],
                                     causal=causal, sdpa_ms=sdpa, **bound,
                                     by_variant=runs))
        print(f"{label}: q ({b}, {hq}, {s}, {d}) bf16, k/v ({b}, {hkv}, "
              f"{s}, {d}), {'causal' if causal else 'non-causal'}; bound "
              f"{bound['bound_ms']:.6f} ms ({bound['bound_by']}); SDPA "
              f"{sdpa:.6f} ms")
        for name, r in runs.items():
            print(f"  {name}: {r['entry']} {r['ms']} ms, max abs err "
                  f"{r['max_abs_err']:.3e}, "
                  f"{bound['flops'] / min(r['ms']) / 1e9:.1f} TFLOP/s")
        del q, k, v, want
    (args.out / "report.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
