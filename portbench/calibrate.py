"""The readings a cell's correctness limits are set from and held against,
on the card, at the cell's own size and through the benchmark's own run
(``bench.run_cell``: set-up, warm-up, a window of ``--seconds``, the check
of its sample): for each seed, what the program reads (each number of the
cell's limits, and every other candidate), and

- with ``--control fp8``, the control's verdict under the cell's limits:
  the reference in float8 put in the program's place at the same
  positions. It has to come out not correct;
- with ``--faults <names>`` (``faults.py``; ``none`` is the program as it
  is), the program with each fault in turn planted under the timed path,
  on every seed. The control is read on the program as it is only.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 0] [--control fp8] [--faults none,token_altered] \\
        [--out f]

``--seconds 0`` runs one cycle of the mix as the window. One line of JSON
a run on standard output (and appended to ``--out``). The benchmark's own
runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--control", default=None)
    ap.add_argument("--faults", default="none")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from portbench import bench, faults, spec
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    planted = args.faults.split(",")
    for name in planted:
        if name != "none" and name not in faults.FAULTS:
            raise SystemExit(f"calibrate: no fault {name!r}")
    device = torch.device("cuda", 0)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    runs = [(f, int(x)) for f in planted for x in args.seeds.split(",")]
    for fault, seed in runs:
        # each run's program runs as in a fresh process: the check turned
        # TF32 off for the reference
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
        sound = fault == "none"
        t0 = time.perf_counter()
        res = bench.run_cell(cell, seed, args.seconds, False, device, t0,
                             wrap=None if sound else faults.FAULTS[fault],
                             control=args.control if sound else None)
        line = dict(workload=args.workload, seed=seed, fault=fault,
                    correct=res["correct"], checks=res["checks"],
                    read=res["read"], rounds=res["rounds"],
                    check_s=res["check_s"],
                    run_s=time.perf_counter() - t0,
                    card=torch.cuda.get_device_name(device))
        if "control" in res:
            line["control"] = res["control"]
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        del res
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
