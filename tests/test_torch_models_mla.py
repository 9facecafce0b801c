"""The port's Multi-head Latent Attention (``repro_torch/models/mla.py``)
and deepseek-v2 against the JAX package on the CPU.

Module level, on identical inputs: ``mla_attention_train`` (the naive
expansion, v zero-padded to the q/k head dim for the shared attention) and
``mla_decode_step`` (the absorbed form, which writes the caches in place),
each against JAX's at 1e-5 in float32 and 3e-2 in bfloat16; and the
absorbed decode of a token against the naive form's row for it.

Model level: deepseek's smoke config (a dense first layer of d_ff 12,288,
then MoE layers) through ``forward_full``, ``prefill`` and 8
``decode_step``s (see ``test_torch_models.py``); in bfloat16 the routing
follows JAX's at near-ties (see ``test_torch_models_moe.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import mla as jmla
from repro.models import params as jparams
from repro.models.common import KeyGen
from repro_torch import configs as tconfigs
from repro_torch.models import mla as tmla
from test_torch_models import _close, check_forward_prefill_decode
from test_torch_models_moe import FollowJaxAtNearTies

ARCH = "deepseek_v2_236b"
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _layer(dtype, seed=0):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype=dtype)
    jp = jparams.init_mla_layer(jcfg, KeyGen(jax.random.PRNGKey(seed)))
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(tcfg.param_dtype)
          for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def _x(jcfg, tcfg, b, s, seed=1):
    x = np.random.RandomState(seed).randn(b, s, jcfg.d_model).astype(
        np.float32)
    jx = jnp.asarray(x, jcfg.param_dtype)
    return jx, torch.from_numpy(np.asarray(jx, np.float32)).to(
        tcfg.param_dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_attention_train_matches_jax(dtype):
    jcfg, tcfg, jp, tp = _layer(dtype)
    b, s = 2, 40
    jx, tx = _x(jcfg, tcfg, b, s)
    pos = np.broadcast_to(np.arange(s), (b, s))
    jout, (jckv, jkr) = jmla.mla_attention_train(
        jcfg, jp, jx, jnp.asarray(pos), impl="dense", return_cache=True)
    out, (ckv, kr) = tmla.mla_attention_train(
        tcfg, tp, tx, torch.from_numpy(pos.copy()), return_cache=True)
    assert out.dtype == tcfg.param_dtype and out.shape == (b, s,
                                                           jcfg.d_model)
    assert ckv.shape == (b, s, jcfg.kv_lora_rank)
    assert kr.shape == (b, s, jcfg.qk_rope_dim)
    for got, want, what in ((out, jout, "out"), (ckv, jckv, "ckv"),
                            (kr, jkr, "krope")):
        _close(got, want, TOL[dtype], what)
    q, k, v, _, _ = tmla.mla_project_qkv(tcfg, tp, tx,
                                         torch.from_numpy(pos.copy()))
    dqk = jcfg.qk_nope_dim + jcfg.qk_rope_dim
    assert q.shape == k.shape == (b, jcfg.n_heads, s, dqk)
    assert v.shape == (b, jcfg.n_heads, s, jcfg.v_head_dim)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_step_matches_jax_and_writes_in_place(dtype):
    jcfg, tcfg, jp, tp = _layer(dtype, seed=2)
    b, smax, cur_len = 2, 24, 11
    rng = np.random.RandomState(3)
    r, rope = jcfg.kv_lora_rank, jcfg.qk_rope_dim
    ckv = np.zeros((b, smax, r), np.float32)
    kr = np.zeros((b, smax, rope), np.float32)
    ckv[:, :cur_len - 1] = rng.randn(b, cur_len - 1, r)
    kr[:, :cur_len - 1] = rng.randn(b, cur_len - 1, rope)
    jckv, jkr = (jnp.asarray(a, jcfg.param_dtype) for a in (ckv, kr))
    tckv, tkr = (torch.from_numpy(np.asarray(a, np.float32)).to(
        tcfg.param_dtype) for a in (jckv, jkr))
    jx, tx = _x(jcfg, tcfg, b, 1, seed=4)
    jout, jckv2, jkr2 = jmla.mla_decode_step(jcfg, jp, jx, jckv, jkr,
                                            cur_len)
    out, ckv2, kr2 = tmla.mla_decode_step(tcfg, tp, tx, tckv, tkr, cur_len)
    assert ckv2 is tckv and kr2 is tkr                      # in place
    _close(out, jout, TOL[dtype], "decode out")
    _close(tckv, jckv2, TOL[dtype], "ckv cache")
    _close(tkr, jkr2, TOL[dtype], "krope cache")
    assert not tckv[:, cur_len:].any() and not tkr[:, cur_len:].any()


def test_absorbed_decode_equals_the_naive_rows():
    """In float32 the absorbed decode of each of the last 4 tokens, from
    the latents the naive form collects for the tokens before it, equals
    the naive form's row for that token (the reference's algorithmic
    equivalence)."""
    _, tcfg, _, tp = _layer("float32", seed=5)
    b, s = 2, 20
    tx = torch.from_numpy(np.random.RandomState(6).randn(
        b, s, tcfg.d_model).astype(np.float32))
    pos = torch.arange(s).expand(b, s)
    out, (ckv, kr) = tmla.mla_attention_train(tcfg, tp, tx, pos,
                                              return_cache=True)
    cache_ckv = torch.zeros((b, 32, tcfg.kv_lora_rank))
    cache_kr = torch.zeros((b, 32, tcfg.qk_rope_dim))
    cache_ckv[:, :s - 4] = ckv[:, :s - 4]
    cache_kr[:, :s - 4] = kr[:, :s - 4]
    for t in range(s - 4, s):
        got, _, _ = tmla.mla_decode_step(tcfg, tp, tx[:, t:t + 1],
                                         cache_ckv, cache_kr, t + 1)
        _close(got[:, 0], out[:, t].numpy(), 1e-5, f"token {t}")
    _close(cache_ckv[:, :s], ckv.numpy(), 1e-6, "collected latents")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_decode_match_jax(dtype, monkeypatch):
    """In bfloat16 the MLA attention upstream of the router rounds
    differently in the two packages: the router probabilities differed by
    at most 4.2e-3, 4.6e-3 and 5.3e-3 at 1, 2 and 8 CPU threads (about one
    bf16 ulp of the logits), and one choice of 20 calls flipped at 2
    threads (gap 1.0e-3)."""
    routing = FollowJaxAtNearTies(monkeypatch, tol=1e-2, max_flips=2) \
        if dtype == "bfloat16" else None
    check_forward_prefill_decode(ARCH, dtype)
    if routing is not None:
        routing.done()
