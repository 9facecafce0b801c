#!/usr/bin/env python3
"""How often the port's decode step replays its CUDA graph, round by round,
in one run of one cell of ``BENCHMARK.json`` on the CUDA card.

    python3 tools/decode_graphs.py --workload rwkv6-7b.code16 \\
        --seed 2901 --seconds 51 --trace 1 --out <dir>

Runs the benchmark's own run (``portbench/bench.py``'s ``run_cell``: the
set-up, the warm-up, the window, with ``--trace 1`` the traced cycle, the
check) with its prefill step wrapped to read
``repro_torch.launch.steps.decode_calls`` at each round's start. Each
round's decode calls by path (``captured``, ``replayed``, ``eager``) are
the counter's change between two such readings: the first round is the
warm-up's, then the window's rounds, then the traced cycle's. Writes the
rounds and the run's result to ``<out>/<cell>.json`` and prints a summary
line: the window's calls by path, its captures per cycle of the mix, and
the run's metrics. Without a card it refuses to run.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench import bench, spec, traffic  # noqa: E402
from repro_torch.launch import steps  # noqa: E402


def counted(cell: dict, seed: int, seconds: float, traced: bool, device,
            t_start: float) -> dict:
    """The run's result with ``decode_calls``: one dict a round, the
    warm-up's first."""
    marks = []

    def wrap(pair):
        prefill, decode = pair

        def marked(params, batch):
            marks.append(dict(steps.decode_calls))
            return prefill(params, batch)
        return marked, decode

    steps.decode_calls.clear()
    res = bench.run_cell(cell, seed, seconds, traced, device, t_start,
                         wrap=wrap)
    marks.append(dict(steps.decode_calls))
    rounds = []
    for a, b in zip(marks, marks[1:]):
        d = collections.Counter(b)
        d.subtract(a)
        rounds.append({k: v for k, v in d.items() if v})
    res["decode_calls"] = rounds
    return res


def summary(res: dict, cell: dict) -> dict:
    """The window's decode calls by path and its captures per cycle."""
    window = res["decode_calls"][1:1 + res["rounds"]]
    total = collections.Counter()
    for r in window:
        total.update(r)
    cycles = res["rounds"] / traffic.cycle(cell["traffic"])
    return {"window_calls": dict(total),
            "replayed_share": total["replayed"] / max(sum(total.values()), 1),
            "captures_per_cycle": total["captured"] / cycles,
            "warm_up": res["decode_calls"][0],
            "traced_cycle": dict(sum(
                (collections.Counter(r)
                 for r in res["decode_calls"][1 + res["rounds"]:]),
                collections.Counter())),
            "metrics": res["metrics"], "correct": res["correct"],
            "memory_peak_bytes": res["memory_peak_bytes"],
            "rounds": res["rounds"], "window_s": res["window_s"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_graphs: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    res = counted(cell, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda", 0), T_START)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / f"{args.workload}.json", "w") as f:
        json.dump(res, f, indent=1, default=str)
    line = dict(cell=args.workload, seed=args.seed, trace=args.trace,
                **summary(res, cell))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
