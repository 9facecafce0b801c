"""The train step's data-parallel mean over every data-parallel mesh
dimension, on four gloo ranks.

The reference shards the batch over ``dp_axes(mesh)``, which on a
multi-pod mesh is ("pod", "data"), so JAX's step takes one mean over the
ranks of both. Four ranks, spawned once for the module, build two
("pod", "data", "model") meshes: 2 x 2 x 1 (one group of four ranks) and
2 x 1 x 2 (two groups of two, the ranks that share a "model" coordinate).
On each, every rank steps ``make_train_step(cfg, mesh=mesh)`` on its block
of one seeded global batch (8 x 64 tokens of qwen2's smoke config in
float32), the block its pod x data coordinate names, and then takes the
one-rank step (no mesh) on the whole batch from the same initial state.
The loss and every updated parameter must equal the one-rank step's within
``tests/test_torch_elastic_trainer.py``'s tolerances: a mean over "data"
alone would average within each pod, and each pod would step on its own
half of the batch.

The rendezvous is a file in ``tmp_path``; the process group has a 60 s
timeout, and the spawned ranks a deadline, after which they are killed and
the test fails.
"""

import dataclasses
import datetime
import json
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import get_smoke_config
from repro_torch.launch.steps import dp_group, make_train_step
from repro_torch.models import init_params
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_leaves

WORLD = 4
AXES = ("pod", "data", "model")
MESHES = {"2x2x1": (2, 2, 1), "2x1x2": (2, 1, 2)}
GLOBAL_BATCH = 8
LR = 1e-3
#: seconds the spawned ranks may take in all
DEADLINE_S = 240
#: as in test_torch_elastic_trainer.py: the loss relative, each parameter
#: absolute (float32; the mean sums in another order)
LOSS_RTOL = 1e-6
PARAM_ATOL = 1e-6


def _cfg():
    return dataclasses.replace(get_smoke_config("qwen2_0_5b"),
                               dtype="float32")


def _batch(cfg):
    toks = np.random.RandomState(1).randint(
        0, cfg.vocab, (GLOBAL_BATCH, 64)).astype(np.int32)
    return {"tokens": toks, "labels": toks}


def _state(cfg):
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return p, adamw_init(p)


def _rank(rank, world, init, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        cfg = _cfg()
        batch = _batch(cfg)
        whole = {k: torch.from_numpy(v) for k, v in batch.items()}
        params, opt = _state(cfg)
        want, want_params, _ = make_train_step(cfg, lr=LR)(params, opt,
                                                            whole)
        seen = {}
        for name, shape in MESHES.items():
            mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                              mesh_dim_names=AXES)
            pod, data, _ = mesh.get_coordinate()
            n_dp = shape[0] * shape[1]
            i, b = pod * shape[1] + data, GLOBAL_BATCH // n_dp
            block = {k: torch.from_numpy(v[i * b:(i + 1) * b])
                     for k, v in batch.items()}
            params, opt = _state(cfg)
            loss, params, _ = make_train_step(cfg, lr=LR, mesh=mesh)(
                params, opt, block)
            seen[name] = dict(
                block=i, group=dist.get_world_size(dp_group(mesh)),
                loss=float(loss), want_loss=float(want),
                param_err=max(float((a - w).abs().max()) for a, w in zip(
                    tree_leaves(params), tree_leaves(want_params))))
        (out / f"rank{rank}.json").write_text(json.dumps(seen))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def multipod_run(tmp_path_factory):
    """Each of the ``WORLD`` spawned ranks' record, by rank."""
    out = tmp_path_factory.mktemp("multipod_step")
    ctx = mp.spawn(_rank, args=(WORLD, f"file://{out}/rendezvous", out),
                   nprocs=WORLD, join=False)
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                pytest.fail(f"the {WORLD} ranks did not finish within "
                            f"{DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(WORLD)]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_multipod_step_equals_the_one_rank_step(multipod_run, mesh):
    shape = MESHES[mesh]
    n_dp = shape[0] * shape[1]
    assert sorted(r[mesh]["block"] for r in multipod_run) == sorted(
        i // shape[2] for i in range(WORLD))
    for rank, seen in enumerate(multipod_run):
        row = seen[mesh]
        assert abs(row["loss"] - row["want_loss"]) \
            <= LOSS_RTOL * abs(row["want_loss"]), (rank, row)
        assert row["param_err"] <= PARAM_ATOL, (rank, row)
        assert row["group"] == n_dp, (rank, row)
