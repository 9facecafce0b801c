"""The port's WKV scan against the JAX package on the CPU.

The same seeded numpy inputs go to JAX's Pallas kernel (in interpret mode,
as ``tests/test_kernels.py`` runs it), the model's chunked jnp form
``wkv_chunked`` and the sequential recurrence, and to the port's ops, which
on CPU tensors run the plain PyTorch chunked version. Tolerance is the
reference's own, atol 5e-4 / rtol 1e-3, for ``o`` and the final state.
The CUDA kernel is held against the same plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import importlib.util
from pathlib import Path

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


def _tf32(x):
    """``x`` with its low 13 bits cleared: the TF32 value the kernel hands
    the tensor cores."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _split(x):
    """x = hi + lo as two TF32 values, as ``split_tf32`` in ``wkv.cu``."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _passes(acc, a, b, a_exact=False, split=_split):
    """The split-TF32 product ``a b`` added one k-step of 8 at a time into
    three accumulators, one a pass: ``(hh, hl, lh) += (a_hi b_hi, a_hi b_lo,
    a_lo b_hi)``, in float32. ``a_exact``: a's low part is 0 (a bfloat16 v)
    and its pass is dropped. ``split`` splits an operand."""
    hh, hl, lh = acc
    (ah, al), (bh, bl) = split(a), split(b)
    for d in range(0, a.shape[-1], 8):
        sl = slice(d, d + 8)
        hl = hl + ah[..., sl] @ bl[..., sl, :]
        if not a_exact:
            lh = lh + al[..., sl] @ bh[..., sl, :]
        hh = hh + ah[..., sl] @ bh[..., sl, :]
    return hh, hl, lh


def _pad(x, c, width):
    """(b, h, s, d) float32 -> (b, h, s / c * 16, width): each chunk of c
    rows followed by 16 - c rows of zeros, each row's d columns by
    width - d zeros, as TMA or the plain loads fill the kernel's tile."""
    b, h, s, d = x.shape
    out = torch.zeros((b, h, s // c, 16, width))
    out[:, :, :, :c, :d] = x.float().reshape(b, h, s // c, c, d)
    return out.reshape(b, h, s // c * 16, width)


def _split_route_arithmetic(r, k, v, logw, u, state, v_exact=False,
                            split=_split, chunk=16):
    """The arithmetic of the WKV kernel in plain PyTorch, chunk by chunk in
    its order, at C = min(chunk, S): each head padded to the 64 x 64 tile
    and each chunk to 16 rows with zeros (``logw`` 0 in padded rows, so
    their decay is 1), as both instantiations run it (the split one's
    64 x 64 heads in chunks of 16 need no padding); then the log-decay
    summed down each column in base 2, one exp2 a factor, the scores as two
    halves of the columns (each hh + (hl + lh)) added, o as r_dec S and
    then att v in one accumulator a pass, the state scaled by e^{L_C} and
    then updated in place one k-step at a time; o's C rows and dv columns
    and the state's dk x dv corner kept. ``split`` splits each operand into
    its TF32 parts."""
    b, h, n, dk0 = r.shape
    dv0 = v.shape[-1]
    c0 = min(chunk, n)
    out_dtype = r.dtype
    r, k, logw = (_pad(x, c0, 64) for x in (r, k, logw))
    v = _pad(v, c0, 64)
    u = torch.zeros(h, 64).index_copy_(1, torch.arange(dk0), u.float())
    padded = torch.zeros(b, h, 64, 64)
    padded[:, :, :dk0, :dv0] = state.float()
    state = padded
    b, h, s, dk = r.shape
    dv = v.shape[-1]
    c = 16
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    lw = logw.float() * log2e
    rf, kf, vf = r.float(), k.float(), v.float()
    bonus_u = u.float()[None, :, None, :]
    tri = torch.tril(torch.ones(c, c, dtype=torch.bool), diagonal=-1)
    eye = torch.eye(c, dtype=torch.bool)
    S = state.float().clone()
    outs = []
    for t0 in range(0, s, c):
        rc, kc, vc, wc = (x[:, :, t0:t0 + c] for x in (rf, kf, vf, lw))
        run = torch.zeros_like(wc[:, :, 0])
        lx = []
        for t in range(c):
            run = run + wc[:, :, t]
            lx.append(run)
        lx = torch.stack(lx, dim=2)
        elc = torch.exp2(run)                                  # (b, h, dk)
        kinc = kc * torch.exp2(-lx)
        rdec = rc * torch.exp2(lx - wc)
        kfin = kinc * elc[:, :, None]
        bonus = (rc * bonus_u * kc).sum(-1)
        zero = torch.zeros(b, h, c, c)
        halves = []
        for cols in (slice(0, dk // 2), slice(dk // 2, dk)):
            hh, hl, lh = _passes((zero, zero, zero), rdec[..., cols],
                                 kinc[..., cols].transpose(-1, -2),
                                 split=split)
            halves.append(hh + (hl + lh))
        att = halves[0] + halves[1]
        att = torch.where(tri, att, torch.where(eye, bonus[..., None], 0.0))
        # o^T = S^T r_dec^T + v^T att^T: S^T and v^T are the A operands
        zero_o = torch.zeros(b, h, dv, c)
        acc = _passes((zero_o, zero_o, zero_o), S.transpose(-1, -2),
                      rdec.transpose(-1, -2), split=split)
        hh, hl, lh = _passes(acc, vc.transpose(-1, -2),
                             att.transpose(-1, -2), a_exact=v_exact,
                             split=split)
        outs.append((hh + (hl + lh)).transpose(-1, -2))
        # S^T = S^T e^{L_C} + v^T k_fin, accumulated into the state itself
        St = S.transpose(-1, -2) * elc[:, :, None, :]
        (vh, vl), (fh, fl) = split(vc.transpose(-1, -2)), split(kfin)
        for d in range(0, c, 8):
            sl = slice(d, d + 8)
            if not v_exact:
                St = St + vl[..., sl] @ fh[..., sl, :]
            St = St + vh[..., sl] @ fl[..., sl, :]
            St = St + vh[..., sl] @ fh[..., sl, :]
        S = St.transpose(-1, -2)
    o = torch.cat(outs, dim=2).reshape(b, h, n // c0, 16, dv)[:, :, :, :c0]
    return (o.reshape(b, h, n, dv)[..., :dv0].to(out_dtype),
            S[:, :, :dk0, :dv0].contiguous())


@pytest.mark.parametrize("b,h,s,dk,dv,strong,state", [
    (2, 3, 128, 16, 16, False, False), (1, 2, 64, 32, 32, False, False),
    (1, 1, 256, 64, 64, False, False), (2, 2, 96, 16, 32, False, False),
    (1, 2, 64, 64, 64, True, False), (1, 2, 256, 64, 64, False, True),
])
def test_split_route_arithmetic_matches_jax(b, h, s, dk, dv, strong, state):
    """``wkv_split``'s arithmetic (split TF32 products, its order of steps)
    rendered in plain PyTorch holds JAX's ``wkv_chunked`` (o and the final
    state) and, from a zero state, ``wkv_sequential`` at the reference
    tolerance: at the sweep's shapes, the -4.25 decay clamp at a 64 x 64
    head (e^{+-68} in the factors) and a 64 x 64 head from a non-zero
    state."""
    arrays = _inputs(b, h, s, dk, dv, seed=17, strong=strong)
    state0 = (np.random.RandomState(18).randn(b, h, dk, dv) if state
              else np.zeros((b, h, dk, dv))).astype(np.float32)
    o, st = _split_route_arithmetic(*_t(arrays), torch.from_numpy(state0))
    assert torch.isfinite(o).all() and torch.isfinite(st).all()
    jo, jstate = jax_chunked(*arrays, jnp.asarray(state0), chunk=16)
    _close(o, jo)
    _close(st, jstate)
    if not state:
        _close(o, jax_sequential(*arrays))
    # a bfloat16 v is exact in TF32: dropping its low pass changes nothing
    vb = torch.from_numpy(arrays[2]).bfloat16().float()
    r, k, _, logw, u = _t(arrays)
    s0 = torch.from_numpy(state0)
    full = _split_route_arithmetic(r, k, vb, logw, u, s0)
    dropped = _split_route_arithmetic(r, k, vb, logw, u, s0, v_exact=True)
    assert all(torch.equal(x, y) for x, y in zip(full, dropped))


@pytest.mark.parametrize("b,h,s,dk,dv,chunk,strong,state", [
    (4, 2, 8, 64, 64, 8, False, False),      # rwkv6-7b's 8-token prompt
    (2, 2, 1, 64, 64, 1, False, False),      # one token
    (1, 2, 13, 64, 64, 13, False, False),
    (1, 2, 64, 64, 64, 8, False, False),     # a caller's chunk of 8
    (2, 3, 128, 16, 16, 16, False, False),
    (2, 2, 96, 16, 32, 16, False, False),
    (1, 2, 48, 24, 40, 12, False, False),
    (1, 2, 64, 32, 32, 16, True, False),     # the -4.25 clamp
    (1, 2, 64, 64, 64, 8, False, True),      # from a non-zero state
])
def test_masked_route_arithmetic_matches_jax(b, h, s, dk, dv, chunk, strong,
                                             state):
    """The masked ``wkv`` route's arithmetic: each head padded to 64 x 64
    and each chunk of C = min(chunk, S) to 16 rows with zeros (``logw`` 0
    there), then ``wkv_split``'s split-TF32 steps, holds JAX's
    ``wkv_chunked`` at that chunk (o and the final state) and, from a zero
    state, ``wkv_sequential``, at the reference tolerance. The padding is
    exact: the chunk boundaries stay at multiples of C."""
    arrays = _inputs(b, h, s, dk, dv, seed=19, strong=strong)
    state0 = (np.random.RandomState(20).randn(b, h, dk, dv) if state
              else np.zeros((b, h, dk, dv))).astype(np.float32)
    o, st = _split_route_arithmetic(*_t(arrays), torch.from_numpy(state0),
                                    chunk=chunk)
    assert o.shape == (b, h, s, dv) and st.shape == (b, h, dk, dv)
    assert torch.isfinite(o).all() and torch.isfinite(st).all()
    jo, jstate = jax_chunked(*arrays, jnp.asarray(state0), chunk=chunk)
    _close(o, jo)
    _close(st, jstate)
    if not state:
        _close(o, jax_sequential(*arrays))


def test_one_tf32_pass_would_miss_the_tolerance():
    """Why every product of ``wkv_split`` splits its operands: the same
    arithmetic with one TF32 pass (the low parts dropped) misses the
    reference tolerance against JAX at the -4.25 decay clamp on a 64 x 64
    head, where the split passes hold it."""
    arrays = _inputs(1, 2, 64, 64, 64, seed=17, strong=True)
    zero = torch.zeros(1, 2, 64, 64)
    jo = np.asarray(jax_chunked(*arrays, jnp.zeros((1, 2, 64, 64)),
                                chunk=16)[0])
    limit = TOL["atol"] + TOL["rtol"] * np.abs(jo)
    split, _ = _split_route_arithmetic(*_t(arrays), zero)
    assert (np.abs(split.numpy() - jo) <= limit).all()
    single, _ = _split_route_arithmetic(
        *_t(arrays), zero, split=lambda x: (_tf32(x), torch.zeros_like(x)))
    assert (np.abs(single.numpy() - jo) > limit).any()


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


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


#: the four compiled instances of the split kernel, as nvcc names them, and
#: of the masked one (the ``wkv`` route)
SPLIT = ("_ZN33_GLOBAL__N__387ee8fb_6_wkv_cu_wkv16wkv_split_kernelI{}EEvNS_9"
         "SplitMapsENS_11SplitParamsEi")
MASKED = ("_ZN33_GLOBAL__N__387ee8fb_6_wkv_cu_wkv10wkv_kernelI{}EEvNS_9"
          "SplitMapsENS_11SplitParamsEi")
SPLIT_TYPES = ("ff", "13__nv_bfloat16f", "13__nv_bfloat16S1_",
               "f13__nv_bfloat16")


def _split_log(spill=(), registers=80, name=SPLIT):
    """An ``-Xptxas -v`` log of the split kernel's instances (or, with
    ``name=MASKED``, the masked kernel's), those of ``spill`` with 16 bytes
    spilled, each with ``registers``."""
    return "".join(f"""\
ptxas info    : Compiling entry function '{name.format(t)}' for 'sm_90a'
ptxas info    : Function properties for {name.format(t)}
    {16 * (t in spill)} bytes stack frame, {16 * (t in spill)} bytes spill stores, {16 * (t in spill)} bytes spill loads
ptxas info    : Used {registers} registers, used 2 barriers
""" for t in SPLIT_TYPES)


def test_ptxas_gate_holds_every_wkv_split_instance():
    """``chip_smoke.ptxas_gate`` holds each of the split kernel's four
    instances, read from a build log and named in
    ``PTXAS_GATED_INSTANCES``, to no stack, no spill and the 80 registers
    its setmaxnreg split redistributes, and fails when the log reports no
    such instance (the masked instances, gated the same way, clean)."""
    smoke = _smoke()
    clean = dict(stack_bytes=0, spill_store_bytes=0, spill_load_bytes=0,
                 registers=128, static_smem_bytes=0)
    others = {fn: dict(clean) for fn in (*smoke.PTXAS_GATED.values(),
                                         *smoke.PTXAS_GATED_INSTANCES)
              if fn not in smoke.WKV_SPLIT_INSTANCES}
    others.update(smoke.ptxas_report(_split_log(name=MASKED)))
    rep = smoke.ptxas_report(_split_log())
    assert set(rep) == {f"wkv_split_kernelI{t}" for t in SPLIT_TYPES}
    assert set(rep) == set(smoke.WKV_SPLIT_INSTANCES)
    assert set(rep) <= set(smoke.PTXAS_GATED_INSTANCES)
    assert smoke.WKV_SPLIT_REGISTERS == 80
    out = smoke.ptxas_gate({**others, **rep})
    assert set(out["wkv_split"]) == set(rep)
    spilled = smoke.ptxas_report(_split_log(spill=("13__nv_bfloat16f",)))
    with pytest.raises(smoke.PhaseError, match="stack or spills"):
        smoke.ptxas_gate({**others, **spilled})
    fewer = smoke.ptxas_report(_split_log(registers=72))
    with pytest.raises(smoke.PhaseError, match="72 registers"):
        smoke.ptxas_gate({**others, **fewer})
    del rep["wkv_split_kernelIff"]
    with pytest.raises(smoke.PhaseError,
                       match="no report of wkv_split_kernelIff"):
        smoke.ptxas_gate({**others, **rep})


def test_ptxas_gate_holds_every_masked_wkv_instance():
    """The masked instances (the ``wkv`` route, ``wkv_kernel``) are read
    from the log by their own name, apart from the split ones, and gated as
    those are: no stack, no spill, exactly 80 registers (the same
    setmaxnreg split), each present."""
    smoke = _smoke()
    clean = dict(stack_bytes=0, spill_store_bytes=0, spill_load_bytes=0,
                 registers=128, static_smem_bytes=0)
    others = {fn: dict(clean) for fn in (*smoke.PTXAS_GATED.values(),
                                         *smoke.PTXAS_GATED_INSTANCES)
              if fn not in smoke.WKV_SPLIT_INSTANCES}
    others.update(smoke.ptxas_report(_split_log()))
    rep = smoke.ptxas_report(_split_log(name=MASKED))
    assert set(rep) == {f"wkv_kernelI{t}" for t in SPLIT_TYPES} \
        == set(smoke.WKV_MASKED_INSTANCES)
    assert "wkv_kernel" in smoke.PTXAS_KERNELS
    out = smoke.ptxas_gate({**others, **rep})
    assert set(out["wkv"]) == set(rep)
    assert set(out["wkv_split"]) == set(smoke.WKV_SPLIT_INSTANCES)
    spilled = smoke.ptxas_report(_split_log(spill=("ff",), name=MASKED))
    with pytest.raises(smoke.PhaseError, match="stack or spills"):
        smoke.ptxas_gate({**others, **spilled})
    fewer = smoke.ptxas_report(_split_log(registers=72, name=MASKED))
    with pytest.raises(smoke.PhaseError, match="72 registers"):
        smoke.ptxas_gate({**others, **fewer})
    del rep["wkv_kernelI13__nv_bfloat16f"]
    with pytest.raises(smoke.PhaseError,
                       match="no report of wkv_kernelI13__nv_bfloat16f"):
        smoke.ptxas_gate({**others, **rep})


def test_wkv_bound_counts_the_useful_work_at_the_chunk():
    """``chip_smoke._wkv_split_bounds`` at the masked route's headline,
    rwkv6-7b's heads over an 8-token prompt in one chunk of 8: the bytes
    (5,783,552, mostly the 4 MiB final state) bind; the operations are the
    dk x dv x C work of that chunk, not the tile's 16 padded rows."""
    smoke = _smoke()
    b, h, s, d, c = 4, 64, 8, 64, 8
    meta = dict(device="meta")
    r, k, v = (torch.empty((b, h, s, d), dtype=torch.bfloat16, **meta)
               for _ in range(3))
    logw = torch.empty((b, h, s, d), **meta)
    u = torch.empty((h, d), **meta)
    st = torch.empty((b, h, d, d), **meta)
    got = smoke._wkv_split_bounds(r, k, v, logw, u, None, r, st, c)
    assert got["bytes"] == 5_783_552 and got["bound_by"] == "bytes"
    pairs = c * (c - 1) // 2
    assert got["product_flops"] == b * h * (4 * c * d * d
                                            + 2 * pairs * 2 * d)
    assert got["flops"] == smoke._wkv_work(r, k, v, logw, u, st, r, c)[1]
    assert got["bound_ms"] == pytest.approx(5_783_552 / 3.35e12 * 1e3)


def test_wkv_split_bound_takes_the_products_on_the_tensor_cores():
    """``chip_smoke._wkv_split_bounds`` at rwkv6-7b's prefill shape: the
    products at split TF32's 495 / 3 TFLOP/s and the rest at 67 TFLOP/s
    take less than the 104,873,984 bytes at 3.35 TB/s, so the bytes bind."""
    smoke = _smoke()
    b, h, s, d = 4, 64, 512, 64
    meta = dict(device="meta")
    r, k, v = (torch.empty((b, h, s, d), dtype=torch.bfloat16, **meta)
               for _ in range(3))
    logw = torch.empty((b, h, s, d), **meta)
    u = torch.empty((h, d), **meta)
    st = torch.empty((b, h, d, d), **meta)
    got = smoke._wkv_split_bounds(r, k, v, logw, u, None, r, st)
    assert got["bytes"] == 104_873_984 and got["flops"] == 2_533_359_616
    assert got["bound_by"] == "bytes"
    assert got["bound_ms"] == pytest.approx(104_873_984 / 3.35e12 * 1e3)
    assert got["ops_ms"] == pytest.approx(
        got["product_flops"] / (495e12 / 3) * 1e3)
    assert got["ops_ms"] < got["bytes_ms"] < got["fp32_ops_ms"]
    with_state = smoke._wkv_split_bounds(r, k, v, logw, u, st, r, st)
    assert with_state["bytes"] == got["bytes"] + st.numel() * 4

