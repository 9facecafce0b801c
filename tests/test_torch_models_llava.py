"""llava's text model and vision stub against the JAX package on the CPU,
at smoke size (see ``test_torch_models.py`` for the method)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_models import (_batch, _bridge, _configs, _j, _t,
                               check_forward_prefill_decode)

ARCH = "llava_next_mistral_7b"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_decode_match_jax(dtype):
    check_forward_prefill_decode(ARCH, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vision_stub_matches_jax(dtype):
    """llava's stub: ``build_inputs`` projects float32 patch embeddings by
    ``mm_proj`` in float32 and casts to the model dtype. XLA and PyTorch
    sum the 1,024-long dot products in different orders, so the float32
    results differ in the last bits, and in bfloat16 about one output in a
    thousand rounds to the neighbouring value (one ulp). Downstream, in
    bfloat16, such a flip can move a hidden state by a few ulps, which is
    why the bfloat16 parity test feeds one-hot patch embeddings
    (exact in any order) and the random ones go through
    test_bfloat16_random_vision_embeds_match_jax; here random ones are held
    to 1e-5 in float32 and to one ulp (or 1e-5) in bfloat16."""
    jcfg, tcfg = _configs(ARCH, dtype)
    jp, tp = _bridge(jcfg, tcfg)
    batch = _batch(jcfg, 2, 32)
    batch["labels"] = batch["tokens"]
    from repro.models.model import build_inputs as jax_build
    from repro_torch.models.model import build_inputs
    jx, jlabels, jpos = jax_build(jcfg, jp, _j(batch))
    x, labels, pos = build_inputs(tcfg, tp, _t(batch))
    assert x.dtype == tcfg.param_dtype and x.shape == jx.shape
    assert np.array_equal(labels.numpy(), np.asarray(jlabels))
    assert np.array_equal(pos.numpy(), np.asarray(jpos))
    want = np.asarray(jx, np.float32)
    got = x.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        _within_one_ulp(got, want)


def _within_one_ulp(got, want):
    """bfloat16 values (as float32 arrays) one ulp apart at most, or the
    float32 sums' own error where they cancel; few of them differ."""
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp + 1e-5).all()
    assert (got != want).mean() < 0.01


def test_bfloat16_random_vision_embeds_match_jax(monkeypatch):
    """The bfloat16 model path with random patch embeddings. Every time the
    port builds its inputs, its stub's output is held to JAX's on the same
    batch within one bfloat16 ulp; the text model then goes on from JAX's
    stub output, so that both models see the same inputs and are held to
    each other at the reference's 3e-2 through forward_full, prefill and
    decode (a one-ulp flip in the stub alone can move a hidden state by a
    few ulps downstream; see test_vision_stub_matches_jax)."""
    from repro.models.model import build_inputs as jax_build
    from repro_torch.models import model as tmodel
    jcfg, tcfg = _configs(ARCH, "bfloat16")
    jp, tp = _bridge(jcfg, tcfg)
    port_build = tmodel.build_inputs
    calls = []

    def build_inputs(cfg, params, batch):
        x, labels, pos = port_build(cfg, params, batch)
        jx = jax_build(jcfg, jp, {k: jnp.asarray(t.numpy())
                                  for k, t in batch.items()})[0]
        want = np.asarray(jx, np.float32)
        assert x.shape == want.shape and x.dtype == tcfg.param_dtype
        _within_one_ulp(x.float().numpy(), want)
        calls.append(x.shape)
        return torch.from_numpy(want).to(x.dtype), labels, pos

    monkeypatch.setattr(tmodel, "build_inputs", build_inputs)
    check_forward_prefill_decode(ARCH, "bfloat16", onehot_vision=False,
                                 bridged=(jcfg, tcfg, jp, tp))
    assert len(calls) == 2                       # forward_full and prefill
