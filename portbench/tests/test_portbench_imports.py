"""A run loads nothing of JAX, flax or the JAX package (``repro``; whole
top-level names, so the port ``repro_torch`` passes); the references and
the counts import nothing of the program; without a card the command
prints no result."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT),
                                         str(HERE)])
    return env


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax_and_no_jax_package():
    code = (
        "import json, sys, time\n"
        "t = time.perf_counter()\n"
        "import portbench.run as run\n"
        "from portbench import bench, spec\n"
        "from portbench_cases import CONFIGS, small_cell\n"
        "for name in CONFIGS:\n"
        "    c = small_cell(name)\n"
        "    bench.run_cell(c, 2 ** 33 + 5, 0.0, True, 'cpu', t)\n"
        "    for m in c['per_layer']:\n"
        "        spec.metric_reader(m['name'])\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    assert json.loads(_run(code)) == []


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield "." * node.level + (node.module or "")


@pytest.mark.parametrize("folder", ["reference", "counts"])
def test_references_and_counts_import_nothing_of_the_program(folder):
    files = sorted((BENCH / folder).glob("*.py"))
    assert len(files) >= 3
    allowed = ("torch", "math", "__future__", ".")
    for f in files:
        for name in _imports(f):
            assert name.startswith(allowed), f"{f.name} imports {name}"
    mods = ", ".join(f"portbench.{folder}.{f.stem}" for f in files)
    code = (f"import json, sys, importlib\n"
            f"for m in '{mods}'.split(', '):\n"
            f"    importlib.import_module(m)\n"
            f"print(json.dumps(sorted(m for m in sys.modules if "
            f"m.split('.')[0] in ('repro_torch', 'repro', 'jax'))))\n")
    assert json.loads(_run(code)) == []


def test_the_command_prints_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the command would run the cell")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "olmoe-1b-7b.code32", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=300)
    assert out.returncode == 2
    assert "correct" not in out.stdout
    assert "CUDA card" in out.stderr
