"""The port's benchmark: one cell of ``BENCHMARK.json`` on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout: it imports the port from ``src/`` and
builds its kernels into the port's own build directory there. It prints
the window's kernel launches and the card on earlier lines, and as its
last line of standard output one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number with its limit,
which also close standard error.

It exits with 2 and prints no result without a CUDA card, or with fewer
cards than the cell asks for, and with 3 when JAX, flax or the JAX
package has been imported by the time the result would be printed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Modules loaded whose top-level name is JAX's, flax's or the JAX
    package's (whole names: ``repro_torch`` is the port)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip() or f"not read ({out.stderr.strip()})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import spec
    cell = spec.cell(args.workload)
    chips = cell["workload"]["chips"]

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 2
    from portbench.bench import run_cell
    device = torch.device("cuda", 0)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                   T_START)

    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    print(json.dumps({"launches": res["launches"], "rounds": res["rounds"],
                      "window_s": res["window_s"], "check_s": res["check_s"],
                      "card": power_limit()}))
    if "traced_launches" in res:
        print(json.dumps({"traced_launches": res["traced_launches"]}))
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": dev}
    if args.trace:
        dev.update(busy_s=res["busy_s"], window_s=res["traced_s"])
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
