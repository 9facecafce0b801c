"""The port's GPipe pipeline (``repro_torch.distributed.pipeline``) against
the JAX package's and against the sequential stack, on the CPU:
``tests/test_pipeline.py``'s case (S = 4 stages, M = 8 microbatches of
MB = 2, D = 16, ``relu(h @ w)``, seed 0, float32) and one with M = 2 < S,
where the idle stages must write nothing.

The port runs on four gloo ranks, spawned once for the module (1 thread a
rank, a ``file://`` rendezvous in ``tmp_path``, a 60 s group timeout and a
deadline): each rank, stage s, passes its slice ``w[s]`` and takes
``torch.autograd.grad`` of ``sum(out ** 2)`` on its own copy of the
replicated output, for its slice and for ``x``. JAX runs
``repro.distributed.pipeline.pipeline_apply`` and ``jax.grad`` of the same
loss in a subprocess with four host devices, as ``tests/test_pipeline.py``
does. The forward must agree at 1e-5 and each stage's gradient slice at
rtol = atol = 2e-4, the reference's tolerances, against both.
"""

import datetime
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.distributed import pipeline_apply, split_microbatches

S, MB, D = 4, 2, 16
MICRO = (8, 2)
WORLD = S
#: seconds the spawned ranks, and the JAX subprocess, may take
DEADLINE_S = 240
FWD_ATOL = 1e-5
GRAD_TOL = 2e-4
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def _inputs(m):
    """``tests/test_pipeline.py``'s draw: params (S, D, D), x (m * MB, D)."""
    rng = np.random.RandomState(0)
    params = rng.randn(S, D, D).astype(np.float32) * 0.3
    x = rng.randn(m * MB, D).astype(np.float32)
    return params, x


def stage_fn(w, h):
    return torch.relu(h @ w)


JAX_CODE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys; sys.path.insert(0, %r)
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.distributed.pipeline import pipeline_apply, split_microbatches

S, MB, D = 4, 2, 16
out = {}
for m in %r:
    rng = np.random.RandomState(0)
    params = jnp.asarray(rng.randn(S, D, D).astype(np.float32) * 0.3)
    x = jnp.asarray(rng.randn(m * MB, D).astype(np.float32))
    mesh = Mesh(np.array(jax.devices()).reshape(S), ("stage",))
    micro = split_microbatches(x, m)

    def stage_fn(w, h):
        return jax.nn.relu(h @ w)

    def loss(p):
        return jnp.sum(pipeline_apply(stage_fn, p, micro, mesh,
                                      axis="stage") ** 2)

    out[f"micro{m}"] = np.asarray(micro)
    out[f"out{m}"] = np.asarray(pipeline_apply(stage_fn, params, micro,
                                               mesh, axis="stage"))
    out[f"grad{m}"] = np.asarray(jax.grad(loss)(params))
np.savez(sys.argv[1], **out)
print("JAX_PIPELINE_OK")
""" % (SRC, MICRO)


def _rank(rank, world, init, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = DeviceMesh("cpu", torch.arange(world),
                          mesh_dim_names=("stage",))
        stage = mesh.get_local_rank("stage")
        seen = {"stage": stage}
        for m in MICRO:
            params, x = _inputs(m)
            micro = split_microbatches(torch.from_numpy(x), m)
            w = torch.from_numpy(params[stage]).requires_grad_()
            with torch.no_grad():
                plain = pipeline_apply(stage_fn, w, micro, mesh)
            xg = micro.clone().requires_grad_()
            got = pipeline_apply(stage_fn, w, xg, mesh)
            gw, gx = torch.autograd.grad((got ** 2).sum(), (w, xg))
            seen[str(m)] = dict(out=got.detach().tolist(),
                                plain=plain.tolist(), grad=gw.tolist(),
                                xgrad=gx.tolist())
        (out / f"rank{rank}.json").write_text(json.dumps(seen))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each spawned rank's record, by rank."""
    out = tmp_path_factory.mktemp("pipeline")
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
    rows = [json.loads((out / f"rank{r}.json").read_text())
            for r in range(WORLD)]
    return [{k: ({f: np.asarray(v, np.float32) for f, v in row.items()}
                 if isinstance(row, dict) else row)
             for k, row in seen.items()} for seen in rows]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's forward and gradients, by key, from a subprocess with four
    host devices."""
    path = tmp_path_factory.mktemp("pipeline_jax") / "jax.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", JAX_CODE, str(path)],
                         env=env, capture_output=True, text=True,
                         timeout=DEADLINE_S)
    assert "JAX_PIPELINE_OK" in out.stdout, out.stdout + out.stderr
    with np.load(path) as f:
        return dict(f)


def _sequential(m):
    """The stack run stage after stage on the whole batch: the output
    (m, MB, D), each stage's gradient of ``sum(out ** 2)``, and x's."""
    params, x = _inputs(m)
    w = torch.from_numpy(params).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    h = xt
    for s in range(S):
        h = stage_fn(w[s], h)
    gw, gx = torch.autograd.grad((h ** 2).sum(), (w, xt))
    return (h.detach().reshape(m, MB, D).numpy(), gw.numpy(),
            gx.reshape(m, MB, D).numpy())


@pytest.mark.parametrize("m", MICRO)
def test_forward_matches_jax_and_the_sequential_stack(ranks, jax_run, m):
    want, _, _ = _sequential(m)
    np.testing.assert_allclose(jax_run[f"out{m}"], want, atol=FWD_ATOL)
    for row in ranks:
        got = row[str(m)]
        assert got["out"].shape == (m, MB, D)
        np.testing.assert_allclose(got["out"], jax_run[f"out{m}"],
                                   atol=FWD_ATOL)
        np.testing.assert_allclose(got["out"], want, atol=FWD_ATOL)
        # without autograd the same schedule, the same numbers
        np.testing.assert_array_equal(got["plain"], got["out"])


@pytest.mark.parametrize("m", MICRO)
def test_each_stage_gradient_matches_jax_and_the_sequential_stack(
        ranks, jax_run, m):
    _, want, want_x = _sequential(m)
    for row in ranks:
        s, got = row["stage"], row[str(m)]
        np.testing.assert_allclose(got["grad"], jax_run[f"grad{m}"][s],
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
        np.testing.assert_allclose(got["grad"], want[s], rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
        # x's gradient, from stage 0, on every stage
        np.testing.assert_allclose(got["xgrad"], want_x, rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
    assert sorted(row["stage"] for row in ranks) == list(range(S))


@pytest.mark.parametrize("m", MICRO)
def test_split_microbatches_matches_jax(jax_run, m):
    _, x = _inputs(m)
    got = split_microbatches(torch.from_numpy(x), m)
    np.testing.assert_array_equal(got.numpy(), jax_run[f"micro{m}"])


def test_split_microbatches_refuses_a_batch_that_does_not_divide():
    with pytest.raises(AssertionError):
        split_microbatches(torch.zeros(6, D), 4)


def test_a_one_rank_stage_mesh_runs_microbatch_by_microbatch():
    """S = 1 on a gloo group of this process alone: the outputs equal the
    stage run on each microbatch bit for bit, and the gradient that of the
    whole batch within float32 rounding."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("stage",))
        params, x = _inputs(4)
        w = torch.from_numpy(params[0]).requires_grad_()
        micro = split_microbatches(torch.from_numpy(x), 4)
        got = pipeline_apply(stage_fn, w, micro, mesh)
        want = torch.stack([stage_fn(w, mb) for mb in micro])
        assert torch.equal(got, want)
        g, = torch.autograd.grad((got ** 2).sum(), w)
        gw, = torch.autograd.grad((stage_fn(w, torch.from_numpy(x)) ** 2)
                                  .sum(), w)
        torch.testing.assert_close(g, gw, rtol=1e-6, atol=1e-6)
    finally:
        dist.destroy_process_group()


def test_chip_smoke_pipeline_phase_rehearsed_on_cpu():
    """``chip_smoke.py``'s pipeline phase at smoke size on the CPU (a
    one-rank gloo stage mesh; no kernel launches: the plain versions run):
    its gates pass and the process group it started is gone."""
    from repro_torch.configs import get_smoke_config
    from test_torch_train_loop import _chip_smoke
    assert not dist.is_initialized()
    r = _chip_smoke().pipeline_phase("cpu", arch="qwen2_0_5b", n_micro=2,
                                     seq=32, seed=0,
                                     config=get_smoke_config)
    assert not dist.is_initialized()
    assert r["launches"] == {} and r["n_micro"] == 2
    assert r["grad_err"] <= r["grad_tol"]
    assert len(r["pipeline_wall_ms"]) == len(r["whole_wall_ms"]) == 2
