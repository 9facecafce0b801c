"""Where the benchmark finds each piece of a cell, by the names that
``BENCHMARK.json`` gives:

- ``configs/<config>.json``: a model configuration;
- ``traffic/<traffic>.json``: a traffic mix;
- ``checks/<cell>.json``: the limits of the cell's correctness check;
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``reference/<family>.py``: the plain float32 reference of a family;
- ``counts/<family>.py``: the useful FLOPs of a family's prefill.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(BENCHMARK)


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(cell: str) -> dict:
    return load_json(HERE / "checks" / f"{cell}.json")


def _module(folder: str, name: str):
    """The module in ``<folder>/<name>.py``, loaded from its path, so that a
    name may hold dots."""
    path = HERE / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{folder}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    return _module("metrics", name).read


def reference(family: str):
    return _module("reference", family)


def counts(family: str):
    return _module("counts", family)


def cell(name: str, bench: dict = None) -> dict:
    """Everything one cell needs: its entry in ``workloads``, its
    configuration, traffic and limits, and the metrics it reports with
    ``--trace 0`` (``end_to_end``) and ``--trace 1`` (``per_layer``)."""
    bench = benchmark() if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return dict(workload=w, config=config(w["config"]),
                traffic=traffic(w["traffic"]), limits=limits(name),
                end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]))
