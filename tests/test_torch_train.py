"""The port's training gradients against JAX's on the CPU, at smoke size.

JAX's own ``init_params`` output crosses to the port through
``params_from_numpy``; the same seeded batch goes to both. JAX runs op by
op (no ``jit``, ``scan_layers=False``, ``remat="none"``) in float32, as
the model tests run it, and ``jax.value_and_grad`` of its ``train_loss``
is held against ``torch.autograd.grad`` of the port's.

Gradients are compared leaf by leaf, not the params after a step: at step
1 Adam's update is ``lr * sign(g)``, so a gradient element near 0 whose
sign differs moves by 2 lr. The bound is ``max|g_port - g_jax| <= TOL *
max|g_jax|`` per leaf with ``TOL`` = 1e-4, the float32 tolerance of the
model tests; the largest seen is 2.2e-6 (rwkv6).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro import models as jm
from repro.launch import steps as jsteps
from repro.optim import adamw_init as jadamw_init
from repro_torch import configs as tconfigs
from repro_torch import models as tm
from repro_torch.launch import steps as tsteps
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_leaves

TOL = 1e-4


def _bridged(arch, **over):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               dtype="float32", scan_layers=False,
                               remat="none", **over)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                               dtype="float32", remat="none", **over)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                              device="cpu")
    return jcfg, tcfg, jp, tp


def _batch(cfg, b, s, seed=3):
    """A seeded batch of the config's family: tokens and labels (after the
    vision stub's random embeddings for llava), or the encoder-decoder's
    32 float32 frames and ``s`` decoder tokens."""
    rng = np.random.RandomState(seed)
    if cfg.family == "encdec":
        frames = rng.randn(b, 32, cfg.d_model).astype(np.float32)
        toks = rng.randint(0, cfg.vocab, (b, s)).astype(np.int32)
        return {"frames": frames, "dec_tokens": toks, "labels": toks}
    n_img = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    toks = rng.randint(0, cfg.vocab, (b, s - n_img)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if n_img:
        batch["vision_embeds"] = rng.randn(b, n_img, 1024).astype(np.float32)
    return batch


def _assert_leafwise(got, want, what):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.double().numpy()
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, i)
        err = np.abs(g - w).max()
        assert err <= TOL * np.abs(w).max(), \
            f"{what} leaf {i}: max|diff| {err} > {TOL} x {np.abs(w).max()}"


@pytest.mark.parametrize("arch", tconfigs.all_archs())
def test_train_loss_and_gradients_match_jax(arch):
    """Every config, float32 (``_bridged``)."""
    jcfg, tcfg, jp, tp = _bridged(arch)
    batch = _batch(jcfg, 2, 32)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.train_loss(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}))(jp)
    leaves = tree_leaves(tm.trainable(tp))
    loss = tm.train_loss(tcfg, tp, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(jloss)) <= TOL * abs(float(jloss))
    _assert_leafwise(grads, jax.tree_util.tree_leaves(jgrads), arch)


def test_train_step_with_grad_accum_matches_jax(monkeypatch):
    """``grad_accum = 2``: the loss and the clipped, accumulated float32
    gradients that reach ``adamw_update``, in both packages (each
    package's ``adamw_update`` is wrapped to record what it is given)."""
    jcfg, tcfg, jp, tp = _bridged("qwen2_0_5b", grad_accum=2)
    batch = _batch(jcfg, 4, 32, seed=5)
    seen = {}

    def spy(name, fn):
        def wrapped(params, grads, state, **kw):
            seen[name] = grads
            return fn(params, grads, state, **kw)
        return wrapped

    monkeypatch.setattr(jsteps, "adamw_update",
                        spy("jax", jsteps.adamw_update))
    monkeypatch.setattr(tsteps, "adamw_update",
                        spy("port", tsteps.adamw_update))
    jloss, _, _ = jsteps.make_train_step(jcfg)(
        jp, jadamw_init(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _, state = tsteps.make_train_step(tcfg)(
        tp, adamw_init(tp), {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    assert int(state.step) == 1 and loss.dtype == torch.float32
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    got = tree_leaves(seen["port"])
    assert all(g.dtype == torch.float32 for g in got)
    _assert_leafwise(got, jax.tree_util.tree_leaves(seen["jax"]),
                     "accumulated grads")
