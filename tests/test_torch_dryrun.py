"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

``depth_variants`` mirrors ``tests/test_race_and_shardings.py::
test_depth_variant_math`` and equals the JAX package's for all ten
architectures. A rank's argument bytes equal, exactly, a computation made
here with numpy from the JAX package's own spec functions and input
structures (``jax.eval_shape``; nothing is allocated): every arch at
``train_4k`` on 16 x 16, and at each decode shape on 2 x 16 x 16. Then a
traced cell (qwen2-0.5b ``train_4k`` at depth variant a) on both meshes,
with the repaired train step's all-reduce over the data-parallel group,
and the CLI.

The port's production meshes are ``DeviceMesh``es on the fake process
group in this process; every test leaves no process group behind, so no
later test in this worker finds one. JAX's spec functions read only a
mesh's axis names and shape, so they get a stand-in with those.
"""

import dataclasses
import functools
import importlib
import json
import math
import os
import types

import jax
import numpy as np
import pytest
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.distributed import shardings as js
from repro.launch import steps as jsteps
from repro.models.config import SHAPES_BY_NAME as JSHAPES
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import params_struct
from repro_torch.tree import tree_leaves

ARCHS = tconfigs.all_archs()
MESH_SHAPES = {False: (("data", "model"), (16, 16)),
               True: (("pod", "data", "model"), (2, 16, 16))}


def _jax_dryrun():
    """The reference's dry-run module. Importing it sets ``XLA_FLAGS`` to
    512 host devices for a JAX not yet started; the variable is put back
    at once, before any JAX backend starts, so no later test here sees
    it."""
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


@pytest.fixture(autouse=True)
def no_process_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def test_depth_variant_math():
    """``tests/test_race_and_shardings.py::test_depth_variant_math`` on the
    port."""
    for arch, expect_depths in [
        ("qwen2_0_5b", (1, 2)), ("gemma2_2b", (2, 4)),
        ("deepseek_v2_236b", (2, 3)), ("zamba2_1_2b", (8, 14)),
        ("seamless_m4t_medium", (2, 4)),
    ]:
        cfg = tconfigs.get_config(arch)
        a, b, mult = dryrun.depth_variants(cfg)
        assert (a.n_layers, b.n_layers) == expect_depths
        # extrapolation recovers full depth: a + mult*(b-a) == n_layers
        assert a.n_layers + mult * (b.n_layers - a.n_layers) == \
            cfg.n_layers
        assert not a.scan_layers and not b.scan_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_depth_variants_equal_jax(arch):
    ja, jb, jmult = _jax_dryrun().depth_variants(jconfigs.get_config(arch))
    a, b, mult = dryrun.depth_variants(tconfigs.get_config(arch))
    assert mult == jmult
    for got, want in ((a, ja), (b, jb)):
        for field in ("n_layers", "enc_layers", "dec_layers", "scan_layers"):
            assert getattr(got, field) == getattr(want, field), field


# ------------------------------------------------------- argument bytes
@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jsteps.params_struct(jconfigs.get_config(arch))


def _jax_argument_bytes(arch, shape_name, multi_pod):
    """A rank's argument bytes of the cell by JAX's structures and specs:
    each sharded dimension divided by the product of its mesh axes' sizes,
    rounded up (numpy)."""
    cfg = jconfigs.get_config(arch)
    shape = JSHAPES[shape_name]
    names, sizes = MESH_SHAPES[multi_pod]
    mesh = types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(sizes))
    p = _jax_params(arch)
    pspecs = js.param_specs(cfg, p, mesh)
    if shape.kind == "train":
        opt = jsteps.opt_struct(cfg, p)
        args = (p, opt, jsteps.batch_struct(cfg, shape, with_labels=True))
        specs = (pspecs, js.opt_state_specs(cfg, opt, pspecs),
                 js.batch_specs(cfg, mesh, "train"))
    else:
        assert shape.kind == "decode"
        cache = jsteps.cache_struct(cfg, shape)
        dp = js._dp_or_none(mesh, shape.global_batch)
        args = (p, cache, jax.ShapeDtypeStruct((shape.global_batch,),
                                               np.int32),
                jax.ShapeDtypeStruct((), np.int32))
        specs = (pspecs, js.cache_specs(cfg, mesh, cache,
                                        shape.global_batch), JP(dp), JP())
    leaves = jax.tree_util.tree_leaves(args)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(spec_leaves)
    size = dict(zip(names, sizes))
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        dims = np.array(leaf.shape, dtype=np.int64)
        for i, entry in enumerate(spec):
            axes = entry if isinstance(entry, tuple) else (entry,)
            div = np.prod([size[a] for a in axes if a is not None],
                          dtype=np.int64)
            dims[i] = -(-dims[i] // div)
        total += int(np.prod(dims, dtype=np.int64)) \
            * np.dtype(leaf.dtype).itemsize
    return total


def _cells():
    out = [(a, "train_4k", False) for a in ARCHS]
    for a in ARCHS:
        skips = tconfigs.skip_shapes(a)
        out += [(a, s.name, True) for s in JSHAPES.values()
                if s.kind == "decode" and s.name not in skips]
    return out


@pytest.mark.parametrize("arch,shape_name,multi_pod", _cells())
def test_argument_bytes_equal_jax_specs(arch, shape_name, multi_pod):
    want = _jax_argument_bytes(arch, shape_name, multi_pod)
    cfg = tconfigs.get_config(arch)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        got = dryrun.argument_bytes(cfg, shape_name, mesh)
    finally:
        dist.destroy_process_group()
    assert got == want


def test_the_cells_cover_every_arch_and_a_decode_shape_each():
    cells = _cells()
    assert {a for a, s, mp in cells if s == "train_4k" and not mp} == \
        set(ARCHS)
    assert {a for a, s, mp in cells if mp} == set(ARCHS)


# ------------------------------------------------------------ decode steps
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "gemma2_2b",
                                  "deepseek_v2_236b", "zamba2_1_2b",
                                  "seamless_m4t_medium"])
def test_decode_step_takes_cur_len_as_a_tensor(arch):
    """A decode step with ``cur_len`` as a 0-d tensor (read on the device
    only, which a meta trace needs) computes what the int gives, bit for
    bit, on the CPU: logits and every cache leaf, after two steps."""
    import torch
    from repro_torch.models import decode_step, init_decode_cache, \
        init_params
    cfg = tconfigs.get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 2),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    got = []
    for as_tensor in (False, True):
        cache = init_decode_cache(cfg, 2, 16, enc_len=8, device="cpu")
        for i, cur in enumerate((3, 4)):
            pos = torch.tensor(cur, dtype=torch.int32) if as_tensor else cur
            logits, cache = decode_step(cfg, params, cache, toks[:, i], pos)
        got.append([logits] + tree_leaves(cache))
    assert len(got[0]) == len(got[1])
    assert all(torch.equal(a, b) for a, b in zip(*got))


# ------------------------------------------------------------- traced cells
VARIANT_A = {"n_layers": 1, "scan_layers": False}


def _grad_buffer_bytes(cfg):
    """The train step's one float32 all-reduce: the loss and every
    parameter."""
    return 4 * (1 + sum(math.prod(t.shape)
                        for t in tree_leaves(params_struct(cfg))))


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_lower_cell_traces_qwen2_variant_a(multi_pod):
    r = dryrun.lower_cell("qwen2_0_5b", "train_4k", multi_pod,
                          overrides=VARIANT_A)
    assert r["status"] == "ok" and r["kind"] == "train"
    assert r["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert r["ranks"] == (512 if multi_pod else 256)
    assert r["flops_per_device"] > 0
    assert r["flops_source"] == dryrun.FLOPS_SOURCE
    assert r["memory"]["temp_bytes"] is None
    cfg = dataclasses.replace(tconfigs.get_config("qwen2_0_5b"),
                              **VARIANT_A)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        want_args = dryrun.argument_bytes(cfg, "train_4k", mesh)
    finally:
        dist.destroy_process_group()
    assert r["memory"]["argument_bytes"] == want_args
    # the outputs: the loss, the parameters and the optimizer state, laid
    # out as the arguments but for the batch
    assert 0 < r["memory"]["output_bytes"] < want_args
    # one all-reduce of the flat float32 buffer, over the data-parallel
    # group: "data" (16 ranks), or pod x data (32) on two pods
    k = 32 if multi_pod else 16
    col = r["collectives"]
    n = _grad_buffer_bytes(cfg)
    assert col["counts"]["all-reduce"] == 1
    assert sum(col["counts"].values()) == 1 and col["other"] == {}
    assert col["group_sizes"] == [k]
    assert col["result_bytes"]["all-reduce"] == n
    assert col["link_bytes_per_device"] == 2.0 * n * (k - 1) / k
    if multi_pod:
        assert "exact" not in r
    else:
        ex = r["exact"]
        assert ex["depth_points"] == [1, 2] and ex["mult"] == 0
        assert ex["flops_per_device"] == r["flops_per_device"]


def test_run_cell_turns_an_exception_into_an_error_record():
    r = dryrun.run_cell("qwen2_0_5b", "train_4k", False,
                        overrides={"no_such_field": 1})
    assert r["status"] == "error" and r["error"].startswith("TypeError")
    assert r["mesh"] == "16x16" and "trace" in r


def test_main_writes_one_record_and_exits_0(tmp_path):
    out = tmp_path / "qwen2.json"
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "qwen2_0_5b", "--shape", "train_4k",
                     "--no-exact", "--out", str(out)])
    assert exc.value.code == 0
    rows = json.loads(out.read_text())
    assert len(rows) == 1
    assert rows[0]["status"] == "ok" and rows[0]["mesh"] == "16x16"
    assert rows[0]["flops_per_device"] > 0 and "exact" not in rows[0]
    assert rows[0]["collectives"]["group_sizes"] == [16]


def test_chip_smoke_dryrun_phase_rehearsed_on_cpu():
    """``chip_smoke.py``'s dry-run phase in this process at depth variant a
    (its child runs the same two functions at full depth): the qwen2 cells
    on both meshes pass its gates."""
    from test_torch_train_loop import _chip_smoke
    cs = _chip_smoke()
    cells = [c for c in cs.DRYRUN_CELLS if c["arch"] == "qwen2_0_5b"]
    rows = cs.dryrun_report(cs.dryrun_rows(cells, overrides=VARIANT_A),
                            "no card (CPU rehearsal)")
    assert [r["mesh"] for r in rows] == ["16x16", "2x16x16"]
    assert [r["collectives"]["group_sizes"] for r in rows] == [[16], [32]]
    assert "exact" in rows[0] and "exact" not in rows[1]
