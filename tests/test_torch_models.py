"""The port's models against the JAX package on the CPU, at smoke size.

Every arch in ``all_archs()``: JAX's own ``init_params`` output crosses to
the port through ``params_from_numpy``, the same seeded batch goes to both,
and ``forward_full``, ``prefill`` (its logits and cache) and 8
``decode_step``s must agree at 1e-4 in float32 and at the reference's 3e-2
in bfloat16. The text-only dense archs are checked here; llava, rwkv6 and
the moe, MLA, Mamba-2 hybrid and encoder-decoder families have files of
their own (``test_torch_models_*.py``), so that the parallel test workers
share the JAX compile time.

JAX runs op by op here (no ``jit``, ``scan_layers=False``): under ``jit``
XLA fuses elementwise chains and skips some of the bfloat16 roundings that
its eager primitives make, so jit and eager JAX differ from each other by
bfloat16 ulps. Op by op, the port makes JAX's roundings (see
``repro_torch/models/common.py``) and matches most archs bit for bit.

Also here: the port's own prefill->decode consistency (the port of
``tests/test_models.py::test_prefill_decode_consistency``),
``count_params_config`` for all ten configs, and the ``init_params`` tree
(keys, shapes, dtypes, and each leaf's mean and spread).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro import models as jm
from repro_torch import configs as tconfigs
from repro_torch import models as tm
from repro_torch.models.model import unembed_chunk

PORTED = jconfigs.all_archs()
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def test_every_arch_is_covered():
    assert sorted(PORTED) == sorted([
        "llava_next_mistral_7b", "phi3_mini_3_8b", "gemma2_2b", "qwen2_0_5b",
        "olmo_1b", "rwkv6_7b", "seamless_m4t_medium", "olmoe_1b_7b",
        "deepseek_v2_236b", "zamba2_1_2b"])
    assert tconfigs.all_archs() == jconfigs.all_archs()
    families = {tconfigs.get_smoke_config(a).family for a in PORTED}
    assert families == {"dense", "moe", "ssm", "hybrid", "encdec"}


def _configs(arch, dtype):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), dtype=dtype,
                               scan_layers=False, remat="none")
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch), dtype=dtype)
    return jcfg, tcfg


#: encoder frames of the encdec batches (the reference test's 32)
ENC_LEN = 32


def _batch(cfg, b, s, seed=3, onehot_vision=False):
    """Tokens (and, for the vision stub, patch embeddings; for encdec,
    ``ENC_LEN`` float32 frames and ``s`` decoder tokens) from a seed.
    ``onehot_vision``: each patch embedding is one scaled unit vector, so
    its float32 projection is exact whatever the summation order (see
    ``test_torch_models_llava.py``)."""
    rng = np.random.RandomState(seed)
    if cfg.family == "encdec":
        return {"frames": rng.randn(b, ENC_LEN, cfg.d_model)
                .astype(np.float32),
                "dec_tokens": rng.randint(0, cfg.vocab, (b, s))
                .astype(np.int32)}
    n_img = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    batch = {"tokens": rng.randint(0, cfg.vocab, (b, s - n_img))
             .astype(np.int32)}
    if n_img and onehot_vision:
        ve = np.zeros((b, n_img, 1024), np.float32)
        idx = rng.randint(0, 1024, (b, n_img))
        scale = 2.0 ** rng.randint(-2, 5, (b, n_img))
        np.put_along_axis(ve, idx[..., None], scale[..., None], axis=-1)
        batch["vision_embeds"] = ve
    elif n_img:
        batch["vision_embeds"] = rng.randn(b, n_img, 1024).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _bridge(jcfg, tcfg):
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                              device="cpu")
    return jp, tp


def _close(got, want, tol, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def _tokens_key(cfg):
    return "dec_tokens" if cfg.family == "encdec" else "tokens"


def _cache_leaves(cache):
    """The cache's tensors in ``jax.tree_util.tree_leaves`` order (dict keys
    sorted, tuples in order, None skipped)."""
    if cache is None:
        return []
    if isinstance(cache, dict):
        return [t for k in sorted(cache) for t in _cache_leaves(cache[k])]
    if isinstance(cache, (tuple, list)):
        return [t for c in cache for t in _cache_leaves(c)]
    return [cache]


def check_forward_prefill_decode(arch, dtype, onehot_vision=None,
                                 bridged=None):
    """forward_full hidden states, prefill logits and cache, and 8
    decode_step logits (and the cache after them) against JAX.
    ``onehot_vision`` (default: in bfloat16) picks one-hot patch embeddings
    for the vision stub; ``bridged`` gives (jcfg, tcfg, jax params, port
    params) made by the caller."""
    jcfg, tcfg = _configs(arch, dtype)
    tol = TOL[dtype]
    if bridged is None:
        jp, tp = _bridge(jcfg, tcfg)
    else:
        jcfg, tcfg, jp, tp = bridged
    if onehot_vision is None:
        onehot_vision = dtype == "bfloat16"
    b, s, cut, max_len = 2, 32, 16, 48
    full = _batch(jcfg, b, s, onehot_vision=onehot_vision)
    hidden, _, _, jaux = jm.forward_full(jcfg, jp, _j(full))
    got, _, _, aux = tm.forward_full(tcfg, tp, _t(full))
    assert got.dtype == tcfg.param_dtype
    _close(got, hidden, tol, f"{arch} forward_full")
    assert aux.dtype == torch.float32 and aux.shape == ()
    _close(aux, jaux, tol, f"{arch} forward_full aux")

    n_img = jcfg.n_frontend_tokens if jcfg.frontend == "vision" else 0
    key = _tokens_key(jcfg)
    pre = dict(full, **{key: full[key][:, :cut - n_img]})
    jl, jc = jm.prefill(jcfg, jp, _j(pre), max_len)
    tl, tc = tm.prefill(tcfg, tp, _t(pre), max_len)
    assert tl.dtype == torch.float32 and tl.shape == (b, tcfg.vocab)
    _close(tl, jl, tol, f"{arch} prefill logits")
    jleaves, tleaves = jax.tree_util.tree_leaves(jc), _cache_leaves(tc)
    assert [tuple(t.shape) for t in tleaves] == [l.shape for l in jleaves]
    assert [str(t.dtype).split(".")[1] for t in tleaves] == \
        [str(l.dtype) for l in jleaves]
    for jl_, tl_ in zip(jleaves, tleaves):
        _close(tl_, jl_, tol, f"{arch} prefill cache")

    rest = full[key][:, cut - n_img:cut - n_img + 8]
    cur = cut
    for t in range(rest.shape[1]):
        tok = rest[:, t]
        jl, jc = jm.decode_step(jcfg, jp, jc, jnp.asarray(tok), cur)
        tl, tc = tm.decode_step(tcfg, tp, tc, torch.from_numpy(tok), cur)
        _close(tl, jl, tol, f"{arch} decode step {t}")
        cur += 1
    jleaves, tleaves = jax.tree_util.tree_leaves(jc), _cache_leaves(tc)
    assert len(jleaves) == len(tleaves)
    for jl_, tl_ in zip(jleaves, tleaves):
        _close(tl_, jl_, tol, f"{arch} cache after decode")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "olmo_1b", "phi3_mini_3_8b",
                                  "gemma2_2b"])
def test_forward_prefill_decode_match_jax(arch, dtype):
    """The text-only dense archs (llava and rwkv6 have files of their own,
    ``test_torch_models_llava.py`` and ``test_torch_models_rwkv.py``, so
    that the parallel test workers share the JAX compile time)."""
    check_forward_prefill_decode(arch, dtype)


def consistency_config(arch, dtype):
    """The port's config of ``arch`` for the prefill->decode consistency,
    with the reference test's settings (``tests/test_models.py:89-99``): a
    no-drop capacity for MoE (capacity dropping depends on the batch's
    size by construction) and MLA in float32 (the absorbed decode
    reassociates the q/k products)."""
    _, cfg = _configs(arch, dtype)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=1000.0)
    if cfg.mla:
        cfg = dataclasses.replace(cfg, dtype="float32")
    return cfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", PORTED)
def test_prefill_decode_consistency(arch, dtype):
    """decode (tokens one by one) reproduces the teacher-forced logits of
    ``forward_full``: the port of ``tests/test_models.py:86``."""
    cfg = consistency_config(arch, dtype)
    gen = torch.Generator("cpu").manual_seed(0)
    params = tm.init_params(cfg, gen, "cpu")
    b, s, max_len = 1, 32, 64
    batch = _t(_batch(cfg, b, s))
    hidden = tm.forward_full(cfg, params, batch)[0]
    full_logits = unembed_chunk(cfg, params, hidden)
    cut = s // 2
    key = _tokens_key(cfg)
    pre = dict(batch, **{key: batch[key][:, :cut]})
    rest = batch[key][:, cut:]
    logits0, cache = tm.prefill(cfg, params, pre, max_len)
    n_img = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    pos0 = cut + n_img
    tol = TOL[dtype] if cfg.dtype == "bfloat16" else 1e-4
    _close(logits0, full_logits[:, pos0 - 1], tol, f"{arch} prefill")
    cur = pos0
    for t in range(rest.shape[1] - 1):
        logits, cache = tm.decode_step(cfg, params, cache, rest[:, t], cur)
        _close(logits, full_logits[:, pos0 + t], tol,
               f"{arch} mismatch at decode step {t}")
        cur += 1


@pytest.mark.parametrize("arch", jconfigs.all_archs())
def test_count_params_config_matches_jax(arch):
    for get in ("get_config", "get_smoke_config"):
        jcfg = getattr(jconfigs, get)(arch)
        tcfg = getattr(tconfigs, get)(arch)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        for active in (False, True):
            assert tm.count_params_config(tcfg, active_only=active) == \
                jm.count_params_config(jcfg, active_only=active)
        assert tconfigs.skip_shapes(arch) == jconfigs.skip_shapes(arch)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", PORTED)
def test_init_params_tree_matches_jax(arch):
    """Same keys, shapes and dtypes; constant leaves equal; random leaves
    with mean and spread within sampling error of JAX's draw (the numbers
    themselves differ: torch.Generator is not jax.random)."""
    cfg = tconfigs.get_smoke_config(arch)
    jflat = _flat(jm.init_params(jconfigs.get_smoke_config(arch),
                                 jax.random.PRNGKey(0)))
    tflat = _flat(tm.init_params(cfg, torch.Generator("cpu").manual_seed(0),
                                 "cpu"))
    assert sorted(tflat) == sorted(jflat)
    assert tm.count_params(tflat) == jm.count_params(jflat)
    for key, jleaf in jflat.items():
        t = tflat[key]
        assert tuple(t.shape) == jleaf.shape, key
        assert str(t.dtype).split(".")[1] == str(jleaf.dtype), key
        a = np.asarray(jleaf, np.float32).ravel()
        x = t.float().numpy().ravel()
        if a.std() == 0:
            assert np.array_equal(a, x), key
            continue
        n, sd = a.size, a.std()
        assert abs(x.mean() - a.mean()) <= 6 * sd * math.sqrt(2 / n), key
        assert abs(x.std() - sd) <= 6 * sd / math.sqrt(n) + 0.01 * sd, key
        assert np.abs(x).max() <= np.abs(a).max() * 1.6 + 1e-6, key


@pytest.mark.parametrize("arch", PORTED)
def test_decode_step_shapes_from_zero_caches(arch):
    """The port of ``tests/test_models.py::test_decode_step_shapes``:
    ``decode_step`` from ``init_decode_cache`` (encoder memory of 32) at
    cur_len 5 gives finite (2, vocab) logits and a cache of JAX's tree,
    shapes and dtypes, for every family."""
    jcfg, cfg = _configs(arch, "bfloat16")
    params = tm.init_params(cfg, torch.Generator("cpu").manual_seed(0),
                            "cpu")
    cache = tm.init_decode_cache(cfg, 2, 96, enc_len=32, device="cpu")
    want = jax.tree_util.tree_leaves(jax.eval_shape(
        lambda: jm.init_decode_cache(jcfg, 2, 96, enc_len=32)))
    leaves = _cache_leaves(cache)
    assert [(tuple(t.shape), str(t.dtype).split(".")[1]) for t in leaves] \
        == [(l.shape, str(l.dtype)) for l in want]
    logits, cache2 = tm.decode_step(cfg, params, cache,
                                    torch.zeros((2,), dtype=torch.int32), 5)
    assert logits.shape == (2, cfg.vocab) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
    assert [t.shape for t in _cache_leaves(cache2)] == \
        [t.shape for t in leaves]


def test_bridge_keeps_bf16_exact_and_train_loss_matches():
    jcfg, tcfg = _configs("qwen2_0_5b", "bfloat16")
    jp, tp = _bridge(jcfg, tcfg)
    w = np.asarray(jp["embed"])
    assert w.dtype.name == "bfloat16"
    assert np.array_equal(tp["embed"].float().numpy(), w.astype(np.float32))
    batch = _batch(jcfg, 2, 32)
    batch["labels"] = batch["tokens"]
    _close(tm.train_loss(tcfg, tp, _t(batch)),
           jm.train_loss(jcfg, jp, _j(batch)), 3e-2, "train_loss")


def test_reference_count_params_config_counts_rwkv_mix_a_five_times():
    """A fault of the reference, kept by the port (ROADMAP Queue 3):
    ``count_params_config`` counts RWKV-6's ``mix_A`` as (d, 5 * 64) per
    layer, but ``init_rwkv_layer`` replaces that draw with one shared
    (d, 64) matrix; the formula also leaves out the per-layer vectors but
    two. The gap is exactly that, in JAX and in the port."""
    jcfg = jconfigs.get_smoke_config("rwkv6_7b")
    L, d = jcfg.n_layers, jcfg.d_model
    jtree = _flat(jm.init_params(jcfg, jax.random.PRNGKey(0)))
    ttree = _flat(tm.init_params(tconfigs.get_smoke_config("rwkv6_7b"),
                                 torch.Generator("cpu").manual_seed(0),
                                 "cpu"))
    assert jtree["blocks/mix_A"].shape == (L, d, 64)
    small = sum(l.size for k, l in jtree.items()
                if (l.size // L <= d if k.startswith("blocks/")
                    else l.ndim == 1))
    gap = L * 4 * d * 64 + L * 2 * d - small
    assert jm.count_params_config(jcfg) - jm.count_params(jtree) == gap
    assert tm.count_params_config(tconfigs.get_smoke_config("rwkv6_7b")) \
        - tm.count_params(ttree) == gap
