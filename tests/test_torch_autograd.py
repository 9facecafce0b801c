"""Gradients through the port's own machinery on the CPU (no JAX): the
kernels' autograd ``Function``s, remat, and ``train_loss`` of every arch.

``FlashAttentionFunction`` and ``WkvFunction`` take the forward they wrap
as an argument; on the card it is the CUDA kernel. Here the plain version
is injected in its place, so the backward's wiring (every keyword and
every input reaching the recompute, cotangents on both WKV outputs) is
held exactly against the plain version's own autograd gradients.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch import models as tm
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6.ref import wkv_chunked_ref
from repro_torch.tree import tree_leaves


def _rand(gen, shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(dtype)


def _grads(fn, ins, cots):
    """(outputs, gradients of ``ins``) of ``fn`` under the cotangents."""
    ins = [t.detach().requires_grad_() for t in ins]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, cots)
    return [o.detach() for o in outs], [t.grad for t in ins]


FLASH_KW = [dict(causal=True), dict(causal=False),
            dict(causal=True, window=5), dict(causal=True, cap=2.0),
            dict(causal=False, kv_len=11), dict(causal=True, q0=7),
            dict(causal=True, window=4, cap=3.0, kv_len=20, q0=3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", FLASH_KW, ids=lambda kw: "-".join(kw))
def test_flash_function_gradients_equal_the_plain_version(kw, dtype):
    gen = torch.Generator().manual_seed(0)
    b, hq, hkv, sq, skv, d = 2, 6, 2, 12, 24, 16
    q = _rand(gen, (b, sq, hq, d), dtype).transpose(1, 2)    # strided view
    k = _rand(gen, (b, hkv, skv, d), dtype)
    v = _rand(gen, (b, hkv, skv, d), dtype)
    do = _rand(gen, (b, hq, sq, d), dtype)

    def plain(q, k, v):
        return flash_attention_ref(q, k, v, **kw)

    def through_function(q, k, v):
        return flash_ops.differentiable(q, k, v, flash_attention_ref, **kw)

    want_o, want = _grads(plain, (q, k, v), (do,))
    got_o, got = _grads(through_function, (q, k, v), (do,))
    assert torch.equal(got_o[0], want_o[0])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_flash_function_recomputes_in_batch_chunks(monkeypatch):
    """Above ``RECOMPUTE_MAX_SCORES`` the recompute goes a few batch rows at
    a time; rows are independent, so the gradients are the plain version's
    (float32 rounding of the reordered products aside: 1e-6)."""
    gen = torch.Generator().manual_seed(1)
    q, k, v = (_rand(gen, (5, 4, 16, 8)) for _ in range(3))
    do = _rand(gen, (5, 4, 16, 8))
    monkeypatch.setattr(flash_ops, "RECOMPUTE_MAX_SCORES", 2 * 4 * 16 * 16)
    _, want = _grads(lambda *a: flash_attention_ref(*a, causal=True),
                     (q, k, v), (do,))
    _, got = _grads(lambda *a: flash_ops.differentiable(
        *a, flash_attention_ref, causal=True), (q, k, v), (do,))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_flash_function_passes_only_needed_gradients():
    gen = torch.Generator().manual_seed(2)
    q, k, v = (_rand(gen, (1, 2, 8, 4)) for _ in range(3))
    k.requires_grad_()
    o = flash_ops.differentiable(q, k, v, flash_attention_ref)
    o.sum().backward()
    assert k.grad is not None and q.grad is None and v.grad is None


@pytest.mark.parametrize("outputs", ["o", "state", "both"])
@pytest.mark.parametrize("dtype,chunk", [(torch.float32, 16),
                                         (torch.float32, 4),
                                         (torch.bfloat16, 16)])
def test_wkv_function_gradients_equal_the_plain_version(outputs, dtype,
                                                        chunk):
    gen = torch.Generator().manual_seed(3)
    b, h, s, dk, dv = 2, 3, 32, 8, 8
    r, k, v = (_rand(gen, (b, h, s, dk), dtype) for _ in range(3))
    logw = -torch.exp(_rand(gen, (b, h, s, dk), scale=0.5)) - 0.01
    u = _rand(gen, (h, dk), scale=0.3)
    state = _rand(gen, (b, h, dk, dv))
    do = _rand(gen, (b, h, s, dv), dtype)
    dstate = _rand(gen, (b, h, dk, dv))
    cots = {"o": (do, None), "state": (None, dstate),
            "both": (do, dstate)}[outputs]

    def pick(outs):
        return tuple(o for o, c in zip(outs, cots) if c is not None)

    def plain(*a):
        return pick(wkv_chunked_ref(*a, chunk=chunk))

    def through_function(*a):
        return pick(wkv_ops.WkvFunction.apply(*a, wkv_chunked_ref, chunk))

    ins = (r, k, v, logw, u, state)
    live = tuple(c for c in cots if c is not None)
    want_o, want = _grads(plain, ins, live)
    got_o, got = _grads(through_function, ins, live)
    for g, w in zip(got_o, want_o):
        assert torch.equal(g, w)
    for name, g, w in zip("r k v logw u state".split(), got, want):
        if w is None:
            assert g is None or not torch.any(g), name
        else:
            assert g is not None and torch.equal(g, w), name


def test_wkv_function_without_initial_state():
    gen = torch.Generator().manual_seed(4)
    r, k, v = (_rand(gen, (1, 2, 16, 4)) for _ in range(3))
    logw = -torch.exp(_rand(gen, (1, 2, 16, 4)))
    u = _rand(gen, (2, 4))
    zero = torch.zeros((1, 2, 4, 4))
    ins = (r, k, v, logw, u)
    do = _rand(gen, (1, 2, 16, 4))
    _, want = _grads(
        lambda *a: wkv_chunked_ref(*a, zero, chunk=16)[0], ins, (do,))

    def forward(*a, chunk):      # the kernel's wrapper takes state=None
        return wkv_chunked_ref(*a[:5], zero, chunk=chunk)

    _, got = _grads(
        lambda *a: wkv_ops.WkvFunction.apply(*a, None, forward, 16)[0],
        ins, (do,))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_unrecorded_calls_take_no_function():
    """Serving's calls (nothing requires grad) and every CPU call go
    straight to their route: no autograd node is made."""
    gen = torch.Generator().manual_seed(5)
    q = _rand(gen, (1, 2, 8, 4))
    assert flash_ops.flash_attention(q, q, q).grad_fn is None
    qg = q.clone().requires_grad_()
    out = flash_ops.flash_attention(qg, q, q)
    assert type(out.grad_fn).__name__ != "FlashAttentionFunctionBackward"


# ------------------------------------------------------------------ models
def _smoke(arch, **over):
    return dataclasses.replace(tconfigs.get_smoke_config(arch), **over)


def _batch(cfg, b=2, s=32, seed=3):
    rng = np.random.RandomState(seed)
    if cfg.family == "encdec":
        toks = rng.randint(0, cfg.vocab, (b, s)).astype(np.int32)
        return {"frames": torch.from_numpy(
                    rng.randn(b, 32, cfg.d_model).astype(np.float32)),
                "dec_tokens": torch.from_numpy(toks),
                "labels": torch.from_numpy(toks)}
    n_img = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    toks = torch.from_numpy(
        rng.randint(0, cfg.vocab, (b, s - n_img)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    if n_img:
        batch["vision_embeds"] = torch.from_numpy(
            rng.randn(b, n_img, 1024).astype(np.float32))
    return batch


def _loss_and_grads(cfg, seed=0):
    params = tm.trainable(tm.init_params(
        cfg, torch.Generator().manual_seed(seed)))
    loss = tm.train_loss(cfg, params, _batch(cfg))
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(params))


@pytest.mark.parametrize("arch", tconfigs.all_archs())
def test_train_loss_differentiable_in_the_config_dtype(arch):
    """The port of ``tests/test_models.py::test_grads_finite_and_nonzero``:
    every floating leaf gets a finite gradient, and their total is > 0."""
    cfg = _smoke(arch)
    loss, grads = _loss_and_grads(cfg)
    assert torch.isfinite(loss) and 1.0 < float(loss) < 15.0
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)
    assert sum(float(g.float().abs().sum()) for g in grads) > 0.0


@pytest.mark.parametrize("arch", tconfigs.all_archs())
def test_remat_modes_give_the_same_gradients_bit_for_bit(arch,
                                                         monkeypatch):
    """``"none"``, ``"block"`` and ``"dots"`` give the same loss and
    gradients bit for bit; with remat on, the backward reruns the wrapped
    bodies: every kernel op (attention, the WKV scan) runs twice."""
    calls = []

    def counted(fn):
        def wrapped(*a, **kw):
            calls.append(1)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(flash_ops, "flash_attention",
                        counted(flash_ops.flash_attention))
    monkeypatch.setattr(wkv_ops, "wkv_with_state",
                        counted(wkv_ops.wkv_with_state))
    runs = {}
    for mode in ("none", "block", "dots"):
        calls.clear()
        runs[mode] = _loss_and_grads(_smoke(arch, remat=mode)), len(calls)
    (loss0, g0), n0 = runs["none"]
    for mode in ("block", "dots"):
        (loss, g), n = runs[mode]
        assert torch.equal(loss, loss0), mode
        assert all(torch.equal(a, b) for a, b in zip(g, g0)), mode
        assert n == 2 * n0 and n0 > 0, (mode, n, n0)
