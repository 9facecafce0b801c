"""The port's int8 gradient compression against
``repro.distributed.compression``: ``quantize_int8``, ``ef_compress`` and
``compressed_grad_tree`` are equal bit for bit on the same numpy inputs;
``compressed_all_reduce`` over a 2-rank gloo group equals the reference's
``compressed_psum`` formula on the same two shards."""

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

from repro.distributed import compression as jc
from repro_torch.distributed import compression as tc
from repro_torch.tree import tree_leaves


def _x(seed, n=1000, scale=3.0):
    return (np.random.RandomState(seed).randn(n) * scale).astype(np.float32)


@pytest.mark.parametrize("x", [
    _x(0), _x(1, 17, 1e-3), np.zeros(8, np.float32),
    np.array([0.5, -0.5, 1.5, 2.5, -127.0, 127.0], np.float32),  # ties
    _x(2, 64, 1e6)], ids=["randn", "tiny", "zeros", "ties", "huge"])
def test_quantize_and_dequantize_equal_jax(x):
    q, scale = tc.quantize_int8(torch.from_numpy(x))
    jq, jscale = jc.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert scale.item() == float(jscale)
    np.testing.assert_array_equal(tc.dequantize_int8(q, scale).numpy(),
                                  np.asarray(jc.dequantize_int8(jq, jscale)))
    err = np.abs(tc.dequantize_int8(q, scale).numpy() - x)
    assert err.max() <= scale.item() * 0.5 + 1e-6


def test_ef_compress_equals_jax_over_steps():
    ef, jef = torch.zeros(256), jnp.zeros((256,), jnp.float32)
    for step in range(5):
        g = _x(10 + step, 256)
        q, scale, ef = tc.ef_compress(torch.from_numpy(g), ef)
        jq, jscale, jef = jc.ef_compress(jnp.asarray(g), jef)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert scale.item() == float(jscale)
        np.testing.assert_array_equal(ef.numpy(), np.asarray(jef))


def test_compressed_grad_tree_equals_jax():
    grads = {"w": _x(3, 48).reshape(6, 8), "b": (_x(4, 5), None)}
    bf16 = torch.from_numpy(_x(5, 16)).bfloat16()
    tgrads = {"w": torch.from_numpy(grads["w"]),
              "b": (torch.from_numpy(grads["b"][0]), None), "h": bf16}
    jgrads = {"w": jnp.asarray(grads["w"]),
              "b": (jnp.asarray(grads["b"][0]), None),
              "h": jnp.asarray(bf16.float().numpy()).astype(jnp.bfloat16)}
    ef, jef = tc.ef_init(tgrads), jc.ef_init(jgrads)
    for _ in range(3):
        out, ef = tc.compressed_grad_tree(tgrads, ef)
        jout, jef = jc.compressed_grad_tree(jgrads, jef)
    got, want = tree_leaves(out), jax.tree_util.tree_leaves(jout)
    assert out["b"][1] is None and out["h"].dtype == torch.bfloat16
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    for e, w in zip(tree_leaves(ef), jax.tree_util.tree_leaves(jef)):
        np.testing.assert_array_equal(e.numpy(), np.asarray(w))


def test_error_feedback_preserves_mean_gradient():
    """The port of ``tests/test_substrates.py::
    test_error_feedback_preserves_mean_gradient``."""
    rng = np.random.RandomState(1)
    true = rng.randn(64).astype(np.float32)
    ef = {"g": torch.zeros(64)}
    acc = np.zeros(64, np.float64)
    acc_true = np.zeros(64, np.float64)
    for _ in range(200):
        g = {"g": torch.from_numpy(
            true + 0.1 * rng.randn(64).astype(np.float32))}
        comp, ef = tc.compressed_grad_tree(g, ef)
        acc += comp["g"].double().numpy()
        acc_true += g["g"].double().numpy()
    assert np.abs(acc - acc_true).max() / np.abs(acc_true).max() < 0.02


def _rank(rank, world, init, shards, efs, out_dir):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        mean, ef = tc.compressed_all_reduce(torch.from_numpy(shards[rank]),
                                            torch.from_numpy(efs[rank]))
        np.savez(f"{out_dir}/rank{rank}.npz", mean=mean.numpy(),
                 ef=ef.numpy())
    finally:
        dist.destroy_process_group()


def test_compressed_all_reduce_equals_jax_formula(tmp_path):
    shards = [_x(20, 96), _x(21, 96, 0.5)]
    efs = [_x(22, 96, 0.01), _x(23, 96, 0.01)]
    mp.spawn(_rank, args=(2, f"file://{tmp_path}/rendezvous", shards, efs,
                          str(tmp_path)), nprocs=2, join=True)
    # the reference's compressed_psum, its psums written out over 2 shards
    qs, scales, new_efs = zip(*(jc.ef_compress(jnp.asarray(g),
                                               jnp.asarray(e))
                                for g, e in zip(shards, efs)))
    qsum = sum(q.astype(jnp.int32) for q in qs)
    ssum = scales[0] + scales[1]
    k = jnp.ones((), jnp.float32) + jnp.ones((), jnp.float32)
    mean = np.asarray(qsum.astype(jnp.float32) * (ssum / k) / k)
    for rank in range(2):
        got = np.load(tmp_path / f"rank{rank}.npz")
        np.testing.assert_array_equal(got["mean"], mean)
        np.testing.assert_array_equal(got["ef"], np.asarray(new_efs[rank]))
