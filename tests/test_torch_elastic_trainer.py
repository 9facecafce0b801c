"""The port's ``ElasticTrainer`` on the CPU: gloo ranks stand in for the
reference's eight host devices (``tests/test_integration.py::
test_elastic_trainer_multi_device_subprocess``).

Eight ranks, spawned once for the module, each run the same scenario
(every rank makes the same calls, as the trainer requires): the ladder
(2, 4, 8) built by ``prewarm``, then ``scale_to`` 2, 4 and 8 (generic pool
hits, no build) and 1 (off the ladder: cold, one build), a train step
after each on a seeded global batch of 8 x 64 tokens of qwen2's smoke
config in float32, then a few more ``scale_to(4)`` hits. Rank 0 also
takes, from a copy of the state before each step, the one-rank step
(``make_train_step`` with no mesh) on the whole batch, and writes what it
saw. The checks the reference lacks: the
n-rank step's loss and updated parameters equal the one-rank step's within
float32 tolerance, and the trainer's one-rank step equals the JAX
package's ``ElasticTrainer`` step on the same weights.

Every rendezvous is a file in ``tmp_path``; every process group has a
60 s timeout, and the spawned ranks a deadline, after which they are
killed and the test fails.
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

from repro_torch.configs import get_smoke_config
from repro_torch.elastic import ElasticTrainer
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_leaves, tree_map

WORLD = 8
LADDER = (2, 4, 8)
SCALES = (2, 4, 8, 1)
#: n = 4 hits after the scenario, for the least time of a hit
REHITS = 4
LR = 1e-3
#: seconds the spawned ranks may take in all
DEADLINE_S = 300
#: the n-rank step against the one-rank step: the loss relative, each
#: parameter absolute (float32; the averaging sums in another order)
LOSS_RTOL = 1e-6
PARAM_ATOL = 1e-6


def _cfg():
    return dataclasses.replace(get_smoke_config("qwen2_0_5b"),
                               dtype="float32")


def _batch(cfg, seed):
    toks = np.random.RandomState(seed).randint(0, cfg.vocab, (8, 64)) \
        .astype(np.int32)
    return {"tokens": toks, "labels": toks}


def _make_step(cfg):
    """The reference test's ``make_step``: ``make_train_step`` on the
    mesh it is given, so that the step averages over that mesh."""
    def make_step(mesh):
        inner = make_train_step(cfg, lr=LR, mesh=mesh)

        def step(state, batch):
            params, opt = state
            loss, params, opt = inner(params, opt, batch)
            return loss, (params, opt)
        return step
    return make_step


def _detached(state):
    return tree_map(lambda t: t.detach().clone(), state)


def _ladder_rank(rank, world, init, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        cfg = _cfg()

        def init_state():
            p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
            return (p, adamw_init(p))

        tr = ElasticTrainer(cfg, _make_step(cfg), init_state, ladder=LADDER,
                            example_batch=_batch(cfg, 0), device="cpu")
        tr.prewarm()
        seen = dict(prewarm_builds=tr.n_builds, compile_s={
            str(n): tr.pool._entries[("ladder", n)].compile_s
            for n in LADDER}, steps=[])
        single = make_train_step(cfg, lr=LR)
        for i, n in enumerate(SCALES, 1):
            ev = tr.scale_to(n)
            builds = tr.n_builds
            batch = _batch(cfg, i)
            before = _detached(tr.state) if rank == 0 else None
            loss = tr.train_step(batch)
            row = dict(ev, builds=builds,
                       loss=None if loss is None else float(loss))
            if rank == 0:
                params, opt = before
                want, params, _ = single(params, opt, {
                    k: torch.from_numpy(v) for k, v in batch.items()})
                got = tree_leaves(tr.state[0])
                row.update(want_loss=float(want), param_err=max(
                    float((a.detach() - b.detach()).abs().max())
                    for a, b in zip(got, tree_leaves(params))),
                    param_bits_equal=all(
                        torch.equal(a.detach(), b.detach())
                        for a, b in zip(got, tree_leaves(params))))
            seen["steps"].append(row)
        # more n = 4 hits, with no step between them: a hit's least time
        # is its cost, which a descheduled rank can only add to
        seen["rehits4"] = [tr.scale_to(4) for _ in range(REHITS)]
        seen["rehit_builds"] = tr.n_builds
        (out / f"rank{rank}.json").write_text(json.dumps(seen))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ladder_run(tmp_path_factory):
    """Run the scenario on ``WORLD`` spawned gloo ranks; each rank's
    record, by rank."""
    out = tmp_path_factory.mktemp("elastic_ladder")
    ctx = mp.spawn(_ladder_rank, args=(WORLD, f"file://{out}/rendezvous",
                                       out), nprocs=WORLD, join=False)
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


def test_ladder_counts_are_generic_hits_with_no_build(ladder_run):
    root = ladder_run[0]
    assert root["prewarm_builds"] == len(LADDER)
    assert all(s > 0 for s in root["compile_s"].values())
    for row in root["steps"][:3]:
        assert row["kind"] == "generic", row
        assert row["builds"] == len(LADDER), row
    assert [(r["from"], r["to"]) for r in root["steps"]] == [
        (0, 2), (2, 4), (4, 8), (8, 1)]
    assert [ev["kind"] for ev in root["rehits4"]] == ["generic"] * REHITS
    assert root["rehit_builds"] == len(LADDER) + 1


def test_off_ladder_count_is_cold_with_one_build(ladder_run):
    root = ladder_run[0]
    hit4, cold = root["steps"][1], root["steps"][3]
    assert cold["kind"] == "cold" and cold["to"] == 1
    assert cold["builds"] == len(LADDER) + 1
    # the build (a mesh and a warm-up train step) dominates the hit (a
    # broadcast of the state over four ranks). A rank descheduled beside
    # other processes can stretch any one hit, so the cold event is held
    # against the least of the n = 4 hits' times
    hits4 = [hit4["control_s"]] + [ev["control_s"] for ev in
                                   root["rehits4"]]
    print(f"control_s: cold {cold['control_s']:.6f}, n = 4 hits {hits4}")
    assert cold["control_s"] > min(hits4), (cold, hits4)


def test_every_rank_sees_the_same_events_and_the_mesh_ranks_the_loss(
        ladder_run):
    for rank, seen in enumerate(ladder_run):
        assert seen["prewarm_builds"] == len(LADDER)
        for n, row, root in zip(SCALES, seen["steps"],
                                ladder_run[0]["steps"]):
            assert (row["kind"], row["builds"]) == (root["kind"],
                                                    root["builds"])
            if rank < n:
                assert row["loss"] == root["loss"], (rank, n)
            else:
                assert row["loss"] is None, (rank, n)


@pytest.mark.parametrize("n", SCALES)
def test_n_rank_step_equals_the_one_rank_step(ladder_run, n):
    row = ladder_run[0]["steps"][SCALES.index(n)]
    assert abs(row["loss"] - row["want_loss"]) \
        <= LOSS_RTOL * abs(row["want_loss"]), row
    assert row["param_err"] <= PARAM_ATOL, row
    if n == 1:
        # one rank averages nothing: the plain step, bit for bit
        assert row["loss"] == row["want_loss"] and row["param_bits_equal"]


def test_one_rank_trainer_matches_jax_elastic_trainer():
    """The CPU trainer at n = 1 (a process group of this process alone)
    and the reference's ``ElasticTrainer`` on one host device, from JAX's
    own smoke weights (float32, bridged) through ``make_train_step`` at lr
    1e-3: two steps on two batches, each loss within the train tests'
    1e-4 relative."""
    import jax
    from repro.configs import get_smoke_config as jget_smoke_config
    from repro.elastic import ElasticTrainer as JaxElasticTrainer
    from repro.launch.steps import make_train_step as jmake_train_step
    from repro.models import init_params as jinit_params
    from repro.optim import adamw_init as jadamw_init
    from repro_torch.models import params_from_numpy

    over = dict(dtype="float32", scan_layers=False, remat="none")
    jcfg = dataclasses.replace(jget_smoke_config("qwen2_0_5b"), **over)
    cfg = dataclasses.replace(get_smoke_config("qwen2_0_5b"),
                              **{k: v for k, v in over.items()
                                 if k != "scan_layers"})
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))

    def jmake_step(mesh):
        inner = jmake_train_step(jcfg, lr=LR)

        def step(state, batch):
            params, opt = state
            loss, params, opt = inner(params, opt, batch)
            return loss, (params, opt)
        return step

    def init_state():
        p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                              device="cpu")
        return (p, adamw_init(p))

    batches = [_batch(cfg, 1), _batch(cfg, 2)]
    jtr = JaxElasticTrainer(jcfg, jmake_step, lambda: (jp, jadamw_init(jp)),
                            example_batch=batches[0])
    assert jtr.scale_to(1)["kind"] == "cold"
    want = [float(jtr.train_step(b)) for b in batches]
    assert not dist.is_initialized()
    try:
        tr = ElasticTrainer(cfg, _make_step(cfg), init_state,
                            example_batch=batches[0], device="cpu")
        ev = tr.scale_to(1)
        assert ev["kind"] == "cold" and tr.n_builds == 1
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        got = [float(tr.train_step(b)) for b in batches]
    finally:
        dist.destroy_process_group()
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-4 * abs(w), (got, want)


def test_chip_smoke_elastic_phase_rehearsed_on_cpu():
    """``chip_smoke.py``'s elastic phase at smoke size on the CPU (one rank,
    no kernel launches: the plain versions run): its gates pass, the
    process group it started is gone, the ladder trainer's hit skips the
    build the cold trainer pays, and a second ``scale_to(1)`` is a hit
    (generic, or the specialized entry of the cold build) in both."""
    from test_torch_train_loop import _chip_smoke
    assert not dist.is_initialized()
    r = _chip_smoke().elastic_phase("cpu", arch="qwen2_0_5b", batch=2,
                                    seq=32, steps=2, seed=0,
                                    config=get_smoke_config)
    assert not dist.is_initialized()
    assert r["hit"]["event"]["kind"] == "generic"
    assert r["cold"]["event"]["kind"] == "cold"
    assert (r["hit"]["prewarm_builds"], r["hit"]["scale_builds"],
            r["cold"]["prewarm_builds"], r["cold"]["scale_builds"]) == \
        (1, 0, 0, 1)
    assert (r["hit"]["again"]["kind"], r["hit"]["again_builds"],
            r["cold"]["again"]["kind"], r["cold"]["again_builds"]) == \
        ("generic", 0, "specialized", 0)
    assert r["hit"]["losses"] == r["cold"]["losses"] == r["losses"]
    assert len(r["losses"]) == 2 and r["launches"] == {}
    assert list(r["hit"]["compile_s"]) == ["('ladder', 1)"]
