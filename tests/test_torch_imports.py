"""The port stands alone: it imports neither ``jax`` nor anything of the
JAX package ``repro``, and its entry points default to the CUDA card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import resolve_device
from repro_torch.kvs import DeviceRaceTable, ShardedDeviceRaceTable

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert len(files) >= 8
    return files + [ROOT / "chip_smoke.py"]


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = ("import sys\n"
            "import repro_torch, repro_torch.kvs\n"
            "import repro_torch.kernels.race_lookup.ops\n"
            "import repro_torch.kernels.race_lookup.race_lookup\n"
            "import repro_torch.core, repro_torch.serverless\n"
            "import repro_torch.dkv, repro_torch.serverless.gateway\n"
            "import repro_torch.serverless.traces\n"
            "from repro_torch.kvs import RaceClient, RaceKVStore, ShardClient\n"
            "import repro_torch.kernels.serverless_stage.ops\n"
            "import repro_torch.kernels.flash_attention.ops\n"
            "import repro_torch.kernels.rwkv6.ops\n"
            "import repro_torch.models, repro_torch.configs\n"
            "import repro_torch.models.moe, repro_torch.models.mla\n"
            "import repro_torch.models.mamba2\n"
            "import repro_torch.elastic, repro_torch.launch.steps\n"
            "import repro_torch.launch.serve, repro_torch.launch.train\n"
            "import repro_torch.optim, repro_torch.data, repro_torch.tree\n"
            "import repro_torch.checkpoint, repro_torch.distributed\n"
            "import repro_torch.distributed.compression\n"
            "import repro_torch.distributed.shardings\n"
            "import repro_torch.launch.mesh\n"
            "import repro_torch.distributed.pipeline\n"
            "import repro_torch.launch.hlo_stats\n"
            "import repro_torch.launch.dryrun\n"
            "from repro_torch.distributed import pipeline_apply\n"
            "from repro_torch.elastic import ElasticTrainer\n"
            "from repro_torch.launch.steps import input_specs\n"
            "import warnings\n"
            "with warnings.catch_warnings():\n"
            "    warnings.simplefilter('ignore', DeprecationWarning)\n"
            "    import repro_torch.core.legacy\n"
            "from repro_torch.configs import all_archs, get_config\n"
            "[get_config(a) for a in all_archs()]\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_sources_import_no_jax_and_no_repro(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"


@pytest.mark.parametrize("make", [
    lambda: DeviceRaceTable(n_buckets=8, nslot=2, vdim=4),
    lambda: ShardedDeviceRaceTable(n_shards=2, n_buckets=8, nslot=2, vdim=4),
], ids=["table", "sharded"])
def test_tables_default_to_the_card(make):
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


@pytest.mark.parametrize("entry", ["data", "train"])
def test_training_entry_points_default_to_the_card(entry):
    from repro_torch.data import to_device
    from repro_torch.launch.train import run
    call = {"data": lambda: to_device({"tokens": [[1, 2]]})["tokens"],
            "train": lambda: run("qwen2_0_5b", True, 1, 2, 8, None)}[entry]
    if torch.cuda.is_available():
        out = call()
        assert out.device.type == "cuda" if entry == "data" else len(out) == 1
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda:0")
