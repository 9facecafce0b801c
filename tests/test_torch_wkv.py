"""The port's WKV scan against the JAX package on the CPU.

The same seeded numpy inputs go to JAX's Pallas kernel (in interpret mode,
as ``tests/test_kernels.py`` runs it), the model's chunked jnp form
``wkv_chunked`` and the sequential recurrence, and to the port's ops, which
on CPU tensors run the plain PyTorch chunked version. Tolerance is the
reference's own, atol 5e-4 / rtol 1e-3, for ``o`` and the final state.
The CUDA kernel is held against the same plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.rwkv6.ops import wkv as jax_wkv
from repro.kernels.rwkv6.ref import wkv_sequential as jax_sequential
from repro.models.rwkv6 import wkv_chunked as jax_chunked
from repro_torch.kernels.rwkv6.ops import wkv, wkv_with_state
from repro_torch.kernels.rwkv6.ref import (inclusive_scan, wkv_chunked_ref,
                                          wkv_ref, wkv_sequential)
from repro_torch.kernels.rwkv6.rwkv6 import ROUTES, wkv_route
from repro_torch.models.rwkv6 import wkv_chunked

TOL = dict(atol=5e-4, rtol=1e-3)


def _inputs(b, h, s, dk, dv, seed=7, strong=False):
    rng = np.random.RandomState(seed)
    if strong:
        r, k = (rng.randn(b, h, s, dk).astype(np.float32) for _ in range(2))
        v = rng.randn(b, h, s, dv).astype(np.float32)
        logw = np.full((b, h, s, dk), -4.25, np.float32)
        u = np.zeros((h, dk), np.float32)
    else:
        r = rng.randn(b, h, s, dk).astype(np.float32) * 0.4
        k = rng.randn(b, h, s, dk).astype(np.float32) * 0.4
        v = rng.randn(b, h, s, dv).astype(np.float32) * 0.4
        logw = np.clip(-np.exp(rng.randn(b, h, s, dk) * 0.3 - 0.6),
                       -4.25, -1e-6).astype(np.float32)
        u = (rng.randn(h, dk) * 0.3).astype(np.float32)
    return r, k, v, logw, u


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("b,h,s,dk,dv,chunk", [
    (2, 3, 128, 16, 16, 16), (1, 2, 64, 32, 32, 16),
    (1, 1, 256, 64, 64, 16), (2, 2, 96, 16, 32, 16),
])
def test_wkv_sweep_matches_jax(b, h, s, dk, dv, chunk):
    """The sweep of ``test_kernels.py::test_wkv_sweep``: o against the
    Pallas kernel, the sequential recurrence (JAX's and the port's), and
    o and the final state against the model's ``wkv_chunked``."""
    arrays = _inputs(b, h, s, dk, dv)
    o, state = wkv_with_state(*_t(arrays), chunk=chunk)
    assert o.shape == (b, h, s, dv) and state.shape == (b, h, dk, dv)
    assert state.dtype == torch.float32
    _close(o, jax_wkv(*arrays, chunk=chunk))
    _close(o, jax_sequential(*arrays))
    _close(o, wkv_sequential(*_t(arrays)))
    jo, jstate = jax_chunked(*arrays, jnp.zeros((b, h, dk, dv)), chunk=chunk)
    _close(o, jo)
    _close(state, jstate)
    assert torch.equal(wkv(*_t(arrays), chunk=chunk), o)


def test_strong_decay_stays_finite_and_exact():
    """Decays right at the clamp boundary (the factorised decay reaches
    e^{+-68})."""
    arrays = _inputs(1, 2, 64, 16, 16, seed=3, strong=True)
    o = wkv(*_t(arrays))
    assert torch.isfinite(o).all()
    _close(o, jax_sequential(*arrays))
    _close(o, jax_wkv(*arrays))
    _close(wkv_ref(*_t(arrays)), jax_sequential(*arrays))


@pytest.mark.parametrize("chunk", [16, 8, 4])
def test_nonzero_initial_state_matches_the_model(chunk):
    b, h, s, dk, dv = 2, 2, 48, 16, 32
    arrays = _inputs(b, h, s, dk, dv, seed=11)
    state0 = np.random.RandomState(12).randn(b, h, dk, dv).astype(np.float32)
    jo, jstate = jax_chunked(*arrays, jnp.asarray(state0), chunk=chunk)
    o, state = wkv_chunked(*_t(arrays), torch.from_numpy(state0),
                           chunk=chunk)
    _close(o, jo)
    _close(state, jstate)
    o2, state2 = wkv_with_state(*_t(arrays), torch.from_numpy(state0),
                                chunk=chunk, impl="ref")
    assert torch.equal(o, o2) and torch.equal(state, state2)


def test_model_dtypes_bf16_rkv_and_f32_logw():
    """On the model's path r/k/v are bfloat16 and logw float32."""
    r, k, v, logw, u = _inputs(2, 4, 64, 64, 64, seed=5)
    jr, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (r, k, v))
    tr, tk, tv = (torch.from_numpy(a).bfloat16() for a in (r, k, v))
    jo, jstate = jax_chunked(jr, jk, jv, logw, u, jnp.zeros((2, 4, 64, 64)))
    o, state = wkv_with_state(tr, tk, tv, torch.from_numpy(logw),
                              torch.from_numpy(u))
    assert o.dtype == torch.bfloat16 and state.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(), np.asarray(jo, np.float32),
                               atol=2e-2, rtol=2e-2)
    _close(state, jstate)


def test_short_sequence_and_errors():
    arrays = _inputs(1, 1, 8, 16, 16, seed=2)
    _close(wkv(*_t(arrays)), jax_sequential(*arrays))     # chunk min(16, 8)
    bad = _inputs(1, 1, 40, 16, 16, seed=2)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        wkv(*_t(bad))
    with pytest.raises(ValueError, match="unknown impl"):
        wkv(*_t(arrays), impl="pallas")


@pytest.mark.parametrize("b,h,s,dk,dv,parts,chunk", [
    (2, 2, 64, 64, 64, 2, 16), (1, 3, 48, 64, 64, 4, 16),
    (2, 2, 32, 16, 32, 2, 8),
])
def test_dv_split_premise_matches_jax(b, h, s, dk, dv, parts, chunk):
    """The split route's premise: the state's dv columns are independent.
    The port's plain chunked scan on dv-column slices of v and the state,
    concatenated, equals JAX's ``wkv_chunked`` on the whole."""
    arrays = _inputs(b, h, s, dk, dv, seed=13)
    state0 = np.random.RandomState(14).randn(b, h, dk, dv).astype(np.float32)
    jo, jstate = jax_chunked(*arrays, jnp.asarray(state0), chunk=chunk)
    r, k, v, logw, u = _t(arrays)
    s0 = torch.from_numpy(state0)
    cols = np.array_split(np.arange(dv), parts)
    outs = [wkv_chunked_ref(r, k, v[..., c], logw, u, s0[..., c],
                            chunk=chunk) for c in cols]
    _close(torch.cat([o for o, _ in outs], dim=-1), jo)
    _close(torch.cat([st for _, st in outs], dim=-1), jstate)


@pytest.mark.parametrize("state", [False, True])
def test_wkv_with_state_takes_strided_views(state):
    """The model hands the op head-transposed views of (B, S, H, d)
    projections; the op takes them as they are and returns what it returns
    for contiguous copies."""
    b, s, h, d = 2, 32, 3, 16
    rng = np.random.RandomState(15)
    r, k, v = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32)
                                * 0.4).transpose(1, 2) for _ in range(3))
    logw = torch.from_numpy(np.clip(-np.exp(rng.randn(b, s, h, d) * 0.3
                                            - 0.6), -4.25, -1e-6)
                            .astype(np.float32)).transpose(1, 2)
    u = torch.from_numpy((rng.randn(h, d) * 0.3).astype(np.float32))
    s0 = torch.from_numpy(rng.randn(b, h, d, d).astype(np.float32)) \
        if state else None
    assert not r.is_contiguous()
    o, st = wkv_with_state(r, k, v, logw, u, s0)
    o2, st2 = wkv_with_state(*(t.contiguous() for t in (r, k, v, logw)), u,
                             s0)
    assert torch.equal(o, o2) and torch.equal(st, st2)
    jo, jstate = jax_chunked(*(t.contiguous().numpy() for t in (r, k, v,
                                                               logw)),
                             u.numpy(), np.zeros((b, h, d, d), np.float32)
                             if s0 is None else s0.numpy())
    _close(o, jo)
    _close(st, jstate)


@pytest.mark.parametrize("dk,dv,chunk,route", [
    (64, 64, 16, "wkv_split"), (64, 64, 8, "wkv"), (32, 32, 16, "wkv"),
    (64, 32, 16, "wkv"), (16, 64, 16, "wkv"), (64, 64, 4, "wkv"),
])
def test_route_dispatch(dk, dv, chunk, route):
    """rwkv6-7b's heads (64 x 64, chunk 16) take the split route, every
    other shape the one-CTA-a-head kernel."""
    assert wkv_route(dk, dv, chunk) == route
    assert route in ROUTES


@pytest.mark.parametrize("shape,dim", [((5,), 0), ((3, 1, 4), 1),
                                       ((2, 13, 3), 1), ((2, 4, 16, 8), 2),
                                       ((2, 3, 64), 2)])
def test_inclusive_scan_is_the_prefix_sum(shape, dim):
    """The plain scans' prefix sums (shifted adds, any length, any axis)
    equal JAX's ``jnp.cumsum`` within float32 rounding, in the input's
    shape and dtype."""
    x = np.random.RandomState(len(shape) + dim).randn(*shape) \
        .astype(np.float32)
    got = inclusive_scan(torch.from_numpy(x), dim)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp.cumsum(x, dim)),
                               atol=1e-5, rtol=1e-5)
