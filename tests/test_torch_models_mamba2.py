"""The port's Mamba-2 mixer (``repro_torch/models/mamba2.py``) and zamba2
against the JAX package on the CPU.

Module level, on identical inputs: ``ssd_chunked`` (float32) against JAX's
and against the port's ``ssd_decode`` applied token by token, at 1e-4;
``causal_conv`` streaming (its cache) against the full sequence, exactly;
``causal_conv`` and ``mamba2_mixer`` in prefill and decode against JAX's at
1e-5 in float32 and 3e-2 in bfloat16.

Model level: zamba2's smoke config (periods of mamba layers with one shared
attention block, and a tail) through ``forward_full``, ``prefill`` and 8
``decode_step``s (see ``test_torch_models.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import mamba2 as jmamba
from repro.models import params as jparams
from repro.models.common import KeyGen
from repro_torch import configs as tconfigs
from repro_torch.models import mamba2 as tmamba
from test_torch_models import _close, check_forward_prefill_decode

ARCH = "zamba2_1_2b"
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _ssd_inputs(b, s, h, p, n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, s, h))).astype(np.float32)  # > 0
    a_log = (rng.randn(h) * 0.5).astype(np.float32)
    B = rng.randn(b, s, n).astype(np.float32)
    C = rng.randn(b, s, n).astype(np.float32)
    D = rng.randn(h).astype(np.float32)
    state = (rng.randn(b, h, p, n) * 0.3).astype(np.float32)
    return x, dt, a_log, B, C, D, state


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 4, 8, 16, 16),     # four chunks
    (1, 96, 2, 16, 8, 32),
    (2, 24, 3, 4, 4, 64),      # one chunk shorter than ``chunk``
])
def test_ssd_chunked_matches_jax_and_the_recurrence(b, s, h, p, n, chunk):
    ins = _ssd_inputs(b, s, h, p, n, seed=s)
    jy, jst = jmamba.ssd_chunked(*map(jnp.asarray, ins), chunk=chunk)
    t = [torch.from_numpy(a) for a in ins]
    y, st = tmamba.ssd_chunked(*t, chunk=chunk)
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    _close(y, jy, 1e-4, "y")
    _close(st, jst, 1e-4, "state")
    x, dt, a_log, B, C, D, state = t
    ys = []
    for i in range(s):
        yi, state = tmamba.ssd_decode(x[:, i], dt[:, i], a_log, B[:, i],
                                      C[:, i], D, state)
        ys.append(yi)
    _close(torch.stack(ys, 1), y.numpy(), 1e-4, "recurrence y")
    _close(state, st.numpy(), 1e-4, "recurrence state")


def test_ssd_chunked_needs_whole_chunks():
    ins = [torch.from_numpy(a) for a in _ssd_inputs(1, 72, 2, 4, 4)]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tmamba.ssd_chunked(*ins, chunk=64)


def test_ssd_chunked_stays_finite_under_strong_decay():
    """Large dt and decay: the pairwise decays above the diagonal would
    overflow float32 without the mask inside the exp."""
    x, dt, a_log, B, C, D, state = _ssd_inputs(1, 64, 2, 4, 4, seed=9)
    dt = dt * 60.0
    a_log = a_log + 2.0
    jy, _ = jmamba.ssd_chunked(*map(jnp.asarray, (x, dt, a_log, B, C, D,
                                                  state)))
    y, st = tmamba.ssd_chunked(*(torch.from_numpy(a) for a in (
        x, dt, a_log, B, C, D, state)))
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    _close(y, jy, 1e-4, "y")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_streaming_equals_full_and_jax(dtype):
    rng = np.random.RandomState(2)
    b, s, d, k = 2, 12, 10, 4
    dt = getattr(jnp, dtype)
    jx = jnp.asarray(rng.randn(b, s, d).astype(np.float32), dt)
    jw = jnp.asarray(rng.randn(k, d).astype(np.float32), dt)
    tdt = getattr(torch, dtype)
    tx, tw = (torch.from_numpy(np.asarray(a, np.float32)).to(tdt)
              for a in (jx, jw))
    jout, jcache = jmamba.causal_conv(jx, jw)
    out, cache = tmamba.causal_conv(tx, tw)
    _close(out, jout, TOL[dtype], "full")
    _close(cache, jcache, 0.0, "cache")
    # streaming: the first 5 tokens at once, then one token at a time
    part, c = tmamba.causal_conv(tx[:, :5], tw)
    outs = [part]
    for i in range(5, s):
        o, c = tmamba.causal_conv(tx[:, i:i + 1], tw, c)
        outs.append(o)
    assert torch.equal(torch.cat(outs, 1), out) and torch.equal(c, cache)
    jo, jc = jmamba.causal_conv(jx[:, 5:6], jw, jcache)
    o, c2 = tmamba.causal_conv(tx[:, 5:6], tw, cache)
    _close(o, jo, TOL[dtype], "one step after the sequence")
    _close(c2, jc, 0.0, "cache after one step")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_mixer_prefill_and_decode_match_jax(dtype):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype=dtype)
    jp = jparams.init_mamba_layer(jcfg, KeyGen(jax.random.PRNGKey(1)))
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(
        getattr(torch, str(v.dtype))) for k, v in jp.items()}
    b, s = 2, 32
    h, pd, n = jcfg.n_heads, jcfg.d_inner // jcfg.n_heads, jcfg.ssm_state
    x = np.random.RandomState(5).randn(b, s + 1, jcfg.d_model).astype(
        np.float32)
    jx = jnp.asarray(x, jcfg.param_dtype)
    tx = torch.from_numpy(np.asarray(jx, np.float32)).to(tcfg.param_dtype)
    st0 = np.zeros((b, h, pd, n), np.float32)
    jout, jst, jconv = jmamba.mamba2_mixer(jcfg, jp, jx[:, :s],
                                           jnp.asarray(st0), None, chunk=16)
    out, st, conv = tmamba.mamba2_mixer(tcfg, tp, tx[:, :s],
                                        torch.from_numpy(st0), None,
                                        chunk=16)
    assert out.dtype == tcfg.param_dtype and st.dtype == torch.float32
    assert conv.shape == (b, jcfg.conv_kernel - 1, jcfg.d_inner + 2 * n)
    _close(out, jout, TOL[dtype], "prefill out")
    _close(st, jst, TOL[dtype], "prefill state")
    _close(conv, jconv, TOL[dtype], "prefill conv cache")
    jout, jst, jconv = jmamba.mamba2_mixer(jcfg, jp, jx[:, s:], jst, jconv,
                                           decode=True)
    out, st, conv = tmamba.mamba2_mixer(tcfg, tp, tx[:, s:], st, conv,
                                        decode=True)
    _close(out, jout, TOL[dtype], "decode out")
    _close(st, jst, TOL[dtype], "decode state")
    _close(conv, jconv, TOL[dtype], "decode conv cache")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_decode_match_jax(dtype):
    check_forward_prefill_decode(ARCH, dtype)
