"""The port's encoder-decoder (seamless) against the JAX package on the
CPU.

Module level, on identical inputs: ``cross_attention_full`` (non-causal,
the decoder's queries against an encoder memory of another length) and
``cross_attention_decode`` (one query against the memory's cached K/V)
against JAX's at 1e-5 in float32 and 3e-2 in bfloat16, and the decode of a
query against the full form's row for it.

Model level: seamless's smoke config (``frames`` of the stubbed speech
frontend into the encoder, decoder tokens) through ``forward_full``,
``prefill`` and 8 ``decode_step``s (see ``test_torch_models.py``);
``decode_step`` reads ``xk`` / ``xv`` from the cache and never recomputes
them.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import blocks as jblocks
from repro.models import params as jparams
from repro.models.common import KeyGen
from repro_torch import configs as tconfigs
from repro_torch import models as tm
from repro_torch.models import blocks as tblocks
from test_torch_models import (_batch, _close, _t,
                               check_forward_prefill_decode)

ARCH = "seamless_m4t_medium"
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _cross_layer(dtype):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype=dtype)
    jp = jparams.init_cross_attn_layer(jcfg, KeyGen(jax.random.PRNGKey(2)))
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(tcfg.param_dtype)
          for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def _pair(jcfg, tcfg, shape, seed):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    ja = jnp.asarray(a, jcfg.param_dtype)
    return ja, torch.from_numpy(np.asarray(ja, np.float32)).to(
        tcfg.param_dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s_dec,s_enc", [(16, 40), (33, 7)])
def test_cross_attention_matches_jax(dtype, s_dec, s_enc):
    jcfg, tcfg, jp, tp = _cross_layer(dtype)
    b, d = 2, jcfg.d_model
    jx, tx = _pair(jcfg, tcfg, (b, s_dec, d), 1)
    jmem, tmem = _pair(jcfg, tcfg, (b, s_enc, d), 2)
    jout, (jxk, jxv) = jblocks.cross_attention_full(jcfg, jp, jx, jmem)
    out, (xk, xv) = tblocks.cross_attention_full(tcfg, tp, tx, tmem)
    assert out.dtype == tcfg.param_dtype and out.shape == (b, s_dec, d)
    assert xk.shape == (b, jcfg.n_kv_heads, s_enc, jcfg.d_head)
    for got, want, what in ((out, jout, "full"), (xk, jxk, "xk"),
                            (xv, jxv, "xv")):
        _close(got, want, TOL[dtype], what)
    jdec = jblocks.cross_attention_decode(jcfg, jp, jx[:, -1:], jxk, jxv)
    dec = tblocks.cross_attention_decode(tcfg, tp, tx[:, -1:], xk, xv)
    _close(dec, jdec, TOL[dtype], "decode")
    _close(dec[:, 0], out[:, -1].float().numpy(), TOL[dtype],
           "decode vs the full form's last row")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_decode_match_jax(dtype):
    check_forward_prefill_decode(ARCH, dtype)


def test_decode_reads_the_cached_memory():
    """Decode steps attend to the cached ``xk`` / ``xv``: scaling the
    cached memory changes the logits, the encoder's frames are not
    needed, and the decoder's own k / v grow by one position a step."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH),
                              dtype="float32")
    params = tm.init_params(cfg, torch.Generator("cpu").manual_seed(0),
                            "cpu")
    batch = _t(_batch(cfg, 2, 16))
    logits, cache = tm.prefill(cfg, params, batch, 24)
    assert cache["xk"].shape[3] == batch["frames"].shape[1]
    tok = torch.argmax(logits, -1)
    other = {k: v.clone() for k, v in cache.items()}
    other["xv"] *= 2.0
    a, cache = tm.decode_step(cfg, params, cache, tok, 16)
    b, _ = tm.decode_step(cfg, params, other, tok, 16)
    assert not torch.allclose(a, b)
    assert cache["k"][:, :, :, 16].abs().sum() > 0
    assert not cache["k"][:, :, :, 17:].any()
