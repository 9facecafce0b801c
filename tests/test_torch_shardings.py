"""The port's sharding plans and meshes against the JAX package's on the
CPU, at every config's full size.

The port's parameter, optimizer and cache trees are built on the meta
device (``launch.steps.params_struct`` / ``opt_struct`` /
``cache_struct``), JAX's through ``jax.eval_shape``; nothing is allocated.
Every spec tree must equal JAX's exactly (the port's ``P`` is a tuple and
compares entry for entry with ``PartitionSpec``): ``param_specs`` (with
and without a mesh), ``opt_state_specs``, ``batch_specs`` for "train" and
"prefill", ``kv_shard_mode`` and ``cache_specs`` at ``decode_32k``, on the
16 x 16 and 2 x 16 x 16 production meshes and on a 1 x 1 host mesh. The
port's production meshes are ``DeviceMesh``es on the fake backend in this
process; JAX's spec functions read only a mesh's axis names and shape, so
its side gets a stand-in with those. Then the cases of
``tests/test_race_and_shardings.py``, on the port, and ``to_placements``.
"""

import functools
import types

import jax
import numpy as np
import pytest
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from repro import configs as jconfigs
from repro.distributed import shardings as js
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models.config import DECODE_32K as JDECODE_32K
from repro_torch import configs as tconfigs
from repro_torch.distributed import (P, batch_specs, cache_specs,
                                     kv_shard_mode, opt_state_specs,
                                     param_specs, to_placements)
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models.config import DECODE_32K
from repro_torch.tree import tree_leaves, tree_map

ARCHS = tconfigs.all_archs()
MESHES = ("production", "multi_pod", "host")


@pytest.fixture(params=MESHES)
def meshes(request):
    """(the port's DeviceMesh, what JAX's spec functions get), the port's
    process group destroyed after the test."""
    assert not dist.is_initialized()
    try:
        if request.param == "host":
            yield tmesh.make_host_mesh(device="cpu"), jmesh.make_host_mesh()
        else:
            multi = request.param == "multi_pod"
            mesh = tmesh.make_production_mesh(multi_pod=multi)
            yield mesh, types.SimpleNamespace(
                axis_names=mesh.mesh_dim_names,
                devices=np.empty(tuple(mesh.shape)))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jsteps.params_struct(jconfigs.get_config(arch))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return tsteps.params_struct(tconfigs.get_config(arch))


def _plain(port_specs):
    """A port spec tree as plain Python: every ``P`` a tuple (checked to
    be a ``P``), the containers kept."""
    def leaf(s):
        assert isinstance(s, P), s
        return tuple(s)
    return tree_map(leaf, port_specs)


def _jax_plain(jax_specs):
    return jax.tree_util.tree_map(tuple, jax_specs,
                                  is_leaf=lambda x: isinstance(x, JP))


def _assert_same_specs(port_specs, jax_specs):
    assert _plain(port_specs) == _jax_plain(jax_specs)
    got = tree_leaves(port_specs)
    want = jax.tree_util.tree_leaves(jax_specs,
                                     is_leaf=lambda x: isinstance(x, JP))
    assert len(got) == len(want) and all(a == b for a, b in zip(got, want))


# ----------------------------------------------------------------- meshes
def test_production_meshes():
    for multi, shape, axes in ((False, (16, 16), ("data", "model")),
                               (True, (2, 16, 16),
                                ("pod", "data", "model"))):
        try:
            mesh = tmesh.make_production_mesh(multi_pod=multi)
            assert isinstance(mesh, DeviceMesh)
            assert tuple(mesh.shape) == shape
            assert mesh.mesh_dim_names == axes
            assert dist.get_backend() == "fake"
            assert mesh.mesh.flatten().tolist() == list(range(len(
                mesh.mesh.flatten())))
        finally:
            dist.destroy_process_group()


def test_production_mesh_refuses_a_group_of_another_size():
    tmesh.make_host_mesh(device="cpu")
    try:
        with pytest.raises(ValueError, match="needs 256 ranks"):
            tmesh.make_production_mesh()
        with pytest.raises(ValueError, match="model = 2"):
            tmesh.make_host_mesh(model=2)
    finally:
        dist.destroy_process_group()


def test_set_mesh_makes_a_mesh_current_inside_the_block():
    a, b = object(), object()
    assert tmesh.current_mesh() is None
    with tmesh.set_mesh(a) as got:
        assert got is a and tmesh.current_mesh() is a
        with tmesh.set_mesh(b):
            assert tmesh.current_mesh() is b
        assert tmesh.current_mesh() is a
    assert tmesh.current_mesh() is None


# ------------------------------------------------------- specs against JAX
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_jax_without_a_mesh(arch):
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    specs = param_specs(cfg, _port_params(arch))
    jspecs = js.param_specs(jcfg, _jax_params(arch))
    _assert_same_specs(specs, jspecs)
    opt = opt_state_specs(cfg, tsteps.opt_struct(cfg, _port_params(arch)),
                          specs)
    jopt = js.opt_state_specs(jcfg, None, jspecs)
    _assert_same_specs(opt, jopt)


def test_specs_equal_jax_on_each_mesh(meshes):
    mesh, jm = meshes
    for arch in ARCHS:
        cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
        _assert_same_specs(param_specs(cfg, _port_params(arch), mesh),
                           js.param_specs(jcfg, _jax_params(arch), jm))
        for kind in ("train", "prefill"):
            _assert_same_specs(batch_specs(cfg, mesh, kind),
                               js.batch_specs(jcfg, jm, kind))
        assert kv_shard_mode(cfg, mesh) == js.kv_shard_mode(jcfg, jm), arch
        cs = tsteps.cache_struct(cfg, DECODE_32K)
        jcs = jsteps.cache_struct(jcfg, JDECODE_32K)
        _assert_same_specs(
            cache_specs(cfg, mesh, cs, DECODE_32K.global_batch),
            js.cache_specs(jcfg, jm, jcs, JDECODE_32K.global_batch))


# ------------------------------- the reference's cases, on the port's plans
def test_param_specs_cover_all_archs():
    for arch in ARCHS:
        ps = _port_params(arch)
        specs = param_specs(tconfigs.get_config(arch), ps)
        leaves, flat = tree_leaves(ps), tree_leaves(specs)
        assert len(leaves) == len(flat)
        for leaf, spec in zip(leaves, flat):
            assert isinstance(spec, P)
            assert leaf.device.type == "meta"
            assert len(spec) <= leaf.ndim, (arch, spec, leaf.shape)
            # every model-sharded dim must divide by 16
            for i, ax in enumerate(spec):
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    if a == "model":
                        assert leaf.shape[i] % 16 == 0, (arch, spec)


def test_uneven_vocab_falls_back_to_dmodel_sharding():
    arch = "seamless_m4t_medium"                      # vocab 256206
    specs = param_specs(tconfigs.get_config(arch), _port_params(arch))
    assert specs["embed"] == P(None, "model")


def test_fsdp_adds_data_axis():
    arch = "deepseek_v2_236b"
    specs = param_specs(tconfigs.get_config(arch), _port_params(arch))
    n_data = sum(1 for s in tree_leaves(specs) for ax in s if ax == "data")
    assert n_data > 10                 # the big matrices picked up "data"


def test_cache_specs_structures(meshes):
    mesh, _ = meshes
    for arch in ARCHS:
        cfg = tconfigs.get_config(arch)
        cs = tsteps.cache_struct(cfg, DECODE_32K)
        specs = cache_specs(cfg, mesh, cs, DECODE_32K.global_batch)
        # the same tree structure (None leaves allowed on both sides), and
        # each spec no longer than its leaf's rank
        for leaf, spec in zip(tree_leaves(cs), tree_leaves(specs)):
            assert leaf.device.type == "meta" and len(spec) <= leaf.ndim
        tree_map(lambda a, b: None, cs, specs)


# --------------------------------------------------------------- placements
def test_to_placements(meshes):
    mesh, _ = meshes
    names = mesh.mesh_dim_names
    rep = [Replicate()] * len(names)
    assert to_placements(P(), mesh) == rep
    assert to_placements(P(None, None), mesh) == rep
    want = [Shard(1) if n == "model" else Replicate() for n in names]
    assert to_placements(P(None, "model"), mesh) == want
    dp = tuple(n for n in names if n != "model")
    spec = P(dp if len(dp) > 1 else dp[0], None, "model")
    assert to_placements(spec, mesh) == [
        Shard(2) if n == "model" else Shard(0) for n in names]
    with pytest.raises(ValueError, match="twice"):
        to_placements(P("data", "data"), mesh)
    with pytest.raises(ValueError, match="twice"):
        to_placements(P(("data", "model"), "model"), mesh)
    with pytest.raises(ValueError, match="'expert'"):
        to_placements(P("expert"), mesh)
    if "pod" not in names:
        with pytest.raises(ValueError, match="'pod'"):
            to_placements(P(("pod", "data")), mesh)
