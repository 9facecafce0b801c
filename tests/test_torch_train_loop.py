"""The port's training loop on the CPU (the ports of
``tests/test_integration.py``'s training tests): the loss falls, and a run
cut at step 10 and resumed from its checkpoint ends bit for bit where an
uncut run ends. Also ``chip_smoke.py``'s train phase, rehearsed at smoke
size."""

import dataclasses
import importlib.util
import os
from pathlib import Path

import pytest
import torch

from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.launch.train import run
from repro_torch.models import init_params
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parent.parent


def test_training_loss_decreases():
    losses = run("qwen2_0_5b", smoke=True, steps=30, batch=8, seq=128,
                 ckpt_dir=None, lr=3e-3, device="cpu")
    assert len(losses) == 30
    assert losses[-1] < losses[0] - 0.2


def test_crash_resume_bit_exact(tmp_path):
    """Train 20 straight vs train 10 + restart + 10: identical params and
    optimizer state."""
    d1, d2 = str(tmp_path / "straight"), str(tmp_path / "resumed")
    kw = dict(smoke=True, batch=4, seq=64, ckpt_every=10, device="cpu")
    straight = run("olmo_1b", steps=20, ckpt_dir=d1, **kw)
    first = run("olmo_1b", steps=10, ckpt_dir=d2, **kw)
    # "crash": a new call; the run resumes from step 10
    second = run("olmo_1b", steps=20, ckpt_dir=d2, **kw)
    assert straight == first + second

    cfg = get_smoke_config("olmo_1b")
    params = init_params(cfg, torch.Generator().manual_seed(1))
    template = (params, adamw_init(params))
    s1, t1, _ = restore_checkpoint(d1, template)
    s2, t2, _ = restore_checkpoint(d2, template)
    assert s1 == s2 == 20 and int(t1[1].step) == 20
    for a, b in zip(tree_leaves(t1), tree_leaves(t2)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("arch,size", [
    ("qwen2_0_5b", dict(batch=4, seq=64, steps=8, resume_at=4,
                        descent=True)),
    ("rwkv6_7b", dict(batch=4, seq=32, steps=4, resume_at=2,
                      grad_accum=2))])
def test_chip_smoke_train_phase_rehearsed_on_cpu(arch, size, tmp_path):
    """``chip_smoke.py``'s train phase at smoke size on the CPU (no kernel
    launches there: the plain versions run), with each model's checkpoint,
    restore and resume, and rwkv6's two microbatches."""
    cs = _chip_smoke()
    accum = size.pop("grad_accum", None)

    def config(a):
        cfg = get_smoke_config(a)
        return dataclasses.replace(cfg, grad_accum=accum) if accum else cfg

    r = cs.train_model("cpu", arch=arch, route="unused", seed=0,
                       ckpt_dir=str(tmp_path), config=config, **size)
    assert len(r["losses"]) == size["steps"]
    assert r["launches_a_step"] == {} and r["step_ms"] > 0
    assert r["reduced"] == [f"global batch 256 -> {size['batch']}"]
    assert r["grad_accum"] == (accum or 1)
    if "resume_at" in size:
        at = size["resume_at"]
        assert r["resume"]["bit_for_bit"] and r["resume"]["equal"]
        assert r["resume"]["resumed_losses"] == r["losses"][at:]
        assert os.path.isdir(tmp_path / f"step_{at:08d}")


def test_train_launches_follow_remat_and_accumulation():
    cs = _chip_smoke()
    qwen2 = cs.get_config("qwen2_0_5b")
    rwkv6 = dataclasses.replace(cs.get_config("rwkv6_7b"), n_layers=4)
    assert cs.train_launches(qwen2) == 48
    assert cs.train_launches(rwkv6) == 16
    assert cs.train_launches(dataclasses.replace(qwen2, remat="none")) == 24
