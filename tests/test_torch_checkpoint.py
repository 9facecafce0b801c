"""The port's checkpoints against ``repro.checkpoint``: the same format, so
a checkpoint written by either package restores into the other's template,
bf16 leaves and an ``AdamWState`` included, byte for byte. Also the
reference's own checkpoint tests (``tests/test_substrates.py``), ported:
uncommitted directories are ignored, a shape mismatch raises, and the
manager saves asynchronously and keeps the last k."""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.optim import AdamWState as JAdamWState
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.optim import AdamWState
from repro_torch.tree import tree_leaves


def _numpy_tree(seed):
    rng = np.random.RandomState(seed)
    return {
        "blocks": {"wq": rng.randn(2, 4, 6).astype(np.float32),
                   "ln": rng.randn(2, 4).astype(ml_dtypes.bfloat16)},
        "embed": rng.randn(9, 4).astype(ml_dtypes.bfloat16),
        "ids": rng.randint(-5, 5, (3,)).astype(np.int32),
        "pair": (rng.randn(2).astype(np.float32), None,
                 rng.randn(1, 1).astype(np.float32)),
    }


def _port(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _trees(seed):
    """The same (params, AdamWState) as a JAX tree and as a port tree."""
    params = _numpy_tree(seed)
    rng = np.random.RandomState(seed + 1)
    moments = [jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32), params)
        for _ in range(2)]
    jtree = (jax.tree_util.tree_map(jnp.asarray, params),
             JAdamWState(jnp.asarray(7, jnp.int32),
                         *(jax.tree_util.tree_map(jnp.asarray, m)
                           for m in moments)))
    ttree = (jax.tree_util.tree_map(_port, params),
             AdamWState(torch.tensor(7, dtype=torch.int32),
                        *(jax.tree_util.tree_map(_port, m)
                          for m in moments)))
    return jtree, ttree


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return x.numpy(), str(x.numpy().dtype)
    a = np.asarray(x)
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def _assert_same_bits(got, want):
    got, want = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        (ga, gd), (wa, wd) = _bits(g), _bits(w)
        assert gd == wd and ga.shape == wa.shape
        np.testing.assert_array_equal(ga, wa)


def test_leaf_order_is_jax_order():
    jtree, ttree = _trees(0)
    _assert_same_bits(ttree, jtree)


def test_port_save_restores_into_a_jax_template(tmp_path):
    jtree, ttree = _trees(1)
    save_checkpoint(str(tmp_path), 5, ttree, {"note": "port"})
    template, _ = _trees(2)
    step, restored, meta = jrestore(str(tmp_path), template)
    assert step == 5 and meta == {"note": "port"}
    assert isinstance(restored[1], JAdamWState)
    _assert_same_bits(ttree, restored)


def test_jax_save_restores_into_a_port_template(tmp_path):
    jtree, ttree = _trees(3)
    jsave(str(tmp_path), 9, jtree, {"note": "jax"})
    _, template = _trees(4)
    step, restored, meta = restore_checkpoint(str(tmp_path), template)
    assert step == 9 and meta == {"note": "jax"}
    assert isinstance(restored[1], AdamWState)
    assert restored[0]["embed"].dtype == torch.bfloat16
    assert restored[1].step.dtype == torch.int32
    _assert_same_bits(restored, jtree)


def test_both_packages_write_the_same_arrays_and_manifest(tmp_path):
    jtree, ttree = _trees(5)
    jsave(str(tmp_path / "jax"), 1, jtree)
    save_checkpoint(str(tmp_path / "port"), 1, ttree)
    man = {}
    for who in ("jax", "port"):
        d = tmp_path / who / "step_00000001"
        assert (d / "COMMITTED").read_text() == "ok"
        man[who] = json.loads((d / "MANIFEST.json").read_text())
        man[who].pop("time")
        man[who]["arrays"] = dict(np.load(d / "arrays.npz"))
    arrays = man["jax"].pop("arrays"), man["port"].pop("arrays")
    assert man["jax"] == man["port"]
    assert arrays[0].keys() == arrays[1].keys()
    for k in arrays[0]:
        assert arrays[0][k].dtype == arrays[1][k].dtype
        np.testing.assert_array_equal(arrays[0][k], arrays[1][k])


def test_roundtrip_keeps_values_dtypes_and_devices(tmp_path):
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.ones(2, dtype=torch.bfloat16)},
            "t": (torch.zeros(1), torch.full((2, 2), 7.0))}
    save_checkpoint(str(tmp_path), 42, tree, {"note": "hi"})
    assert latest_step(str(tmp_path)) == 42
    step, restored, meta = restore_checkpoint(str(tmp_path), tree)
    assert step == 42 and meta["note"] == "hi"
    assert isinstance(restored["t"], tuple)
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


def test_uncommitted_step_is_ignored(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2)})
    broken = tmp_path / "step_00000002"
    broken.mkdir()
    (broken / "arrays.npz").write_bytes(b"garbage")
    (tmp_path / "step_00000003.tmp").mkdir()
    assert latest_step(str(tmp_path)) == 1
    assert restore_checkpoint(str(tmp_path), {"w": torch.ones(2)})[0] == 1


def test_shape_or_leaf_count_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), {"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(str(tmp_path), {"w": torch.zeros(2),
                                           "x": torch.zeros(2)})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), {"w": torch.zeros(2)})


def test_manager_async_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.zeros(4)}
    for s in (1, 2, 3, 4):
        mgr.save_async(s, {"w": tree["w"] + s})
    mgr.wait()
    steps = sorted(int(n[5:]) for n in os.listdir(tmp_path)
                   if n.startswith("step_"))
    assert steps == [3, 4]
    step, restored, _ = mgr.restore_latest(tree)
    assert step == 4 and torch.equal(restored["w"], torch.full((4,), 4.0))


def test_manager_snapshots_before_returning(tmp_path):
    """``save_async`` copies the leaves on the caller's thread: an in-place
    update right after it (``adamw_update`` updates in place) does not
    reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    w = torch.zeros(1000)
    mgr.save_async(1, {"w": w})
    w.add_(1.0)
    mgr.wait()
    assert not torch.any(restore_checkpoint(str(tmp_path),
                                            {"w": w})[1]["w"])
    assert mgr.restore_latest({"w": w})[0] == 1


def test_manager_reraises_the_writers_error(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    (tmp_path / "step_00000001.tmp").write_text("a file, not a directory")
    mgr.save_async(1, {"w": torch.zeros(1)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                              # the error is raised once
