"""The port's AdamW, clipping and cosine schedule against ``repro.optim``
on the same numpy inputs, at 1e-6 relative (float32 arithmetic in the same
order; XLA's and PyTorch's ``pow``, ``sqrt`` and sums may round their last
bit differently)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import optim as jopt
from repro_torch import optim as topt
from repro_torch.tree import tree_leaves

RTOL = 1e-6


def _tree(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return {"blocks": {"w": rng.randn(3, 8, 5).astype(dtype),
                       "b": rng.randn(3, 5).astype(dtype)},
            "embed": rng.randn(11, 8).astype(dtype),
            "scale": rng.randn(8).astype(dtype)}


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), tree)


def _close(got, want, rtol=RTOL):
    got = [np.asarray(g.float()) for g in tree_leaves(got)]
    want = [np.asarray(w, np.float32) for w in jax.tree_util.tree_leaves(want)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * np.abs(w).max())


@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_update_matches_jax_over_three_steps(schedule):
    params, jp = _t(_tree(0)), _j(_tree(0))
    state, jstate = topt.adamw_init(params), jopt.adamw_init(jp)
    kw = dict(lr=3e-3)
    jkw = dict(kw)
    if schedule:
        kw["schedule"] = topt.cosine_schedule(3e-3, warmup=2, total=6)
        jkw["schedule"] = jopt.cosine_schedule(3e-3, warmup=2, total=6)
    for step in range(3):
        grads = _tree(10 + step)
        params, state = topt.adamw_update(params, _t(grads), state, **kw)
        jp, jstate = jopt.adamw_update(jp, _j(grads), jstate, **jkw)
        _close(params, jp)
        _close(state.mu, jstate.mu)
        _close(state.nu, jstate.nu)
        assert int(state.step) == int(jstate.step) == step + 1
        assert state.step.dtype == torch.int32


def test_adamw_decays_stacked_vectors_as_jax_does():
    """Weight decay on every leaf with ndim >= 2: the stacked (L, n) bias
    decays, the (n,) scale does not (zero gradients isolate the decay)."""
    params = _t(_tree(1))
    zeros = jax.tree_util.tree_map(np.zeros_like, _tree(1))
    before = _t(_tree(1))
    params, _ = topt.adamw_update(params, _t(zeros), topt.adamw_init(params),
                                  lr=0.5, weight_decay=0.1)
    assert not torch.equal(params["blocks"]["b"], before["blocks"]["b"])
    assert torch.equal(params["scale"], before["scale"])


def test_adamw_bf16_params_match_jax():
    import ml_dtypes
    tree = jax.tree_util.tree_map(lambda a: a.astype(ml_dtypes.bfloat16),
                                  _tree(2))
    jp = _j(tree)
    params = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16(), tree)
    state, jstate = topt.adamw_init(params), jopt.adamw_init(jp)
    for step in range(3):
        grads = _tree(20 + step)
        params, state = topt.adamw_update(params, _t(grads), state, lr=1e-2)
        jp, jstate = jopt.adamw_update(jp, _j(grads), jstate, lr=1e-2)
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(params))
    # equal bit for bit on this CPU; the bound allows one bf16 ulp, where a
    # last-bit difference of the float32 update rounds to the other side
    _close(params, jp, rtol=2 ** -8)
    _close(state.nu, jstate.nu)


def test_adamw_converges_quadratic():
    """The port of ``tests/test_substrates.py::test_adamw_converges_quadratic``."""
    params = {"w": torch.tensor([5.0, -3.0]), "b": torch.tensor([2.0])}
    opt = topt.adamw_init(params)
    for _ in range(300):
        grads = {k: 2 * v for k, v in params.items()}
        params, opt = topt.adamw_update(params, grads, opt, lr=5e-2,
                                        weight_decay=0.0)
    assert float(sum(torch.sum(v ** 2) for v in params.values())) < 1e-2


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    grads = _tree(3)
    got, norm = topt.clip_by_global_norm(_t(grads), max_norm)
    want, jnorm = jopt.clip_by_global_norm(_j(grads), max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=RTOL)
    _close(got, want)
    assert norm.dtype == torch.float32


def test_cosine_schedule_matches_jax():
    sched = topt.cosine_schedule(1e-3, warmup=10, total=100)
    jsched = jopt.cosine_schedule(1e-3, warmup=10, total=100)
    for step in (0, 5, 10, 55, 100, 120):
        got = sched(torch.tensor(step, dtype=torch.int32))
        want = jsched(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                                   atol=1e-12)
    assert abs(float(sched(torch.tensor(10))) - 1e-3) < 1e-9
