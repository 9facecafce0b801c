"""The port's serving path against the JAX package on the CPU.

JAX's ``ServingWorker`` and the port's decode greedily from the same
parameters (JAX's float32 smoke-size ``init_params``, carried across by
``params_from_numpy``) and must give the same tokens; a second replica on
one ``ExecutablePool`` is a pool hit in both. Then the port's prefill and
decode steps (``make_prefill_step`` / ``make_decode_step``) against JAX's,
``serve.main`` on the CPU, and ``chip_smoke.py``'s serving phases
rehearsed on the CPU.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro import models as jm
from repro.elastic import ExecutablePool as JaxPool
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch import models as tm
from repro_torch.elastic import ExecutablePool
from repro_torch.launch import serve, steps

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ["qwen2_0_5b", "rwkv6_7b", "gemma2_2b", "olmoe_1b_7b",
         "deepseek_v2_236b", "zamba2_1_2b", "seamless_m4t_medium"]
#: chip_smoke's consistency lengths at smoke size: zamba2's prefill and
#: forward pass scan whole 64-token chunks (``ssd_chunked``)
REHEARSAL_LENGTHS = {"zamba2_1_2b": dict(s=128, cut=64)}


def _bridged(arch):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                               dtype="float32")
    jp = jm.init_params(jcfg, jax.random.PRNGKey(1))
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                              device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_worker_tokens_equal_jax_and_second_replica_hits(arch):
    jcfg, tcfg, jp, tp = _bridged(arch)
    slots, max_len, n = 4, 32, 8
    start = np.arange(slots, dtype=np.int32) * 7 % jcfg.vocab
    jpool, pool = JaxPool(), ExecutablePool()
    want = [jserve.ServingWorker(jcfg, jp, slots, max_len, pool=jpool)
            .decode_tokens(start, n) for _ in range(2)]
    workers = [serve.ServingWorker(tcfg, tp, slots, max_len, pool=pool)
               for _ in range(2)]
    got = [w.decode_tokens(start, n) for w in workers]
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == (slots, n)
        np.testing.assert_array_equal(g, np.asarray(w))
    assert (pool.stat_hits, pool.stat_misses) == (jpool.stat_hits,
                                                  jpool.stat_misses) == (1, 1)
    assert workers[0].decode_fn is workers[1].decode_fn
    assert all(w.bootstrap_s >= 0 for w in workers)
    assert workers[0].cur_len == 4 + n


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "rwkv6_7b"])
def test_prefill_then_decode_steps_match_jax(arch):
    jcfg, tcfg, jp, tp = _bridged(arch)
    rng = np.random.RandomState(2)
    tokens = rng.randint(0, jcfg.vocab, (2, 16)).astype(np.int32)
    jl, jc = jax.jit(jsteps.make_prefill_step(jcfg, 24))(
        jp, {"tokens": jnp.asarray(tokens)})
    tl, tc = steps.make_prefill_step(tcfg, 24)(
        tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    jstep = jax.jit(jsteps.make_decode_step(jcfg))
    tstep = steps.make_decode_step(tcfg)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for cur in range(16, 20):
        jl, jc = jstep(jp, jc, jnp.asarray(tok), jnp.asarray(cur))
        tl, tc = tstep(tp, tc, torch.from_numpy(tok), cur)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-1.2b",
                                  "seamless-m4t-medium"])
def test_serve_main_on_the_cpu(capsys, arch):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                "--steps", "2", "--slots", "2", "--max-len", "16"])
    out = capsys.readouterr().out
    assert "replica 0" in out and "(cold start)" in out
    assert "replica 1" in out and "(pool hit)" in out
    assert "pool stats: hits=1 misses=1" in out


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen2-0.5b", "--smoke", "--steps", "1"])


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_serving_phases_rehearsed_on_cpu(arch):
    """``chip_smoke.py``'s serving and consistency phases, at smoke size on
    the CPU (no kernel launches there: the plain versions run), each arch
    with the settings its phase gives it."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = tconfigs.get_smoke_config(arch)
    r = cs.serve_model("cpu", arch=arch, batch=2, prompt=32, max_len=64,
                       decode_steps=3, worker_steps=2, seed=0,
                       config=tconfigs.get_smoke_config)
    assert r["prefill_launches"] == {} and r["decode_launches"] == {}
    assert r["prefill_ms"] > 0 and r["decode_ms_per_step"] > 0
    assert r["prefill_profile"]["idle_share"] is None    # no device spans
    assert r["n_layers"] == cfg.n_layers and r["reduced"] is None
    lengths = REHEARSAL_LENGTHS.get(arch, dict(s=48, cut=32))
    c = cs.consistency("cpu", arch=arch, tol=1e-3, seed=1,
                       config=tconfigs.get_smoke_config, **lengths)
    assert c["max_abs_err"] < 1e-4
    if cfg.n_experts:
        assert c["routing"]["decisions"] > 0
    with pytest.raises(cs.PhaseError, match="out of tolerance"):
        cs._within(torch.ones(3), torch.zeros(3), 1e-3, 1e-3, "probe")


def test_chip_smoke_short_rwkv6_prompt_rehearsed_on_cpu():
    """``chip_smoke.py``'s short rwkv6 serve (prompts cut to 8 tokens
    through the same steps and parameters) and its short consistency case
    (an 8-token prefill, 16 tokens teacher-forced), at smoke size on the
    CPU, with the settings the phases give them."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    size = next(m for m in cs.SERVE_SIZE if m["arch"] == "rwkv6_7b")
    assert (size["short_prompt"], size["short_route"]) == (8, "wkv")
    r = cs.serve_model("cpu", arch="rwkv6_7b", batch=2, prompt=32,
                       max_len=64, decode_steps=2, worker_steps=2, seed=0,
                       short_prompt=size["short_prompt"],
                       short_route=size["short_route"],
                       config=tconfigs.get_smoke_config)
    short = r["short"]
    assert short["prompt"] == 8 and short["batch"] == 2
    assert short["prefill_launches"] == {} and short["decode_steps"] == 2
    assert short["prefill_ms"] > 0 and short["decode_ms_per_step"] > 0
    assert short["prefill_profile"]["before"] == []     # no device spans
    settings = dict(cs.CONSISTENCY_SHORT)
    assert settings.pop("arch") == "rwkv6_7b"
    assert (settings["s"], settings["cut"]) == (16, 8)
    c = cs.consistency("cpu", arch="rwkv6_7b", tol=1e-3, seed=1,
                       config=tconfigs.get_smoke_config, **settings)
    assert c["max_abs_err"] < 1e-4 and c["launches"] == {}


def test_chip_smoke_depth_cut_is_reported():
    """A serving phase at fewer layers than the config's (deepseek's on
    one card) runs the cut model and says so."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    r = cs.serve_model("cpu", arch="deepseek_v2_236b", batch=2, prompt=32,
                       max_len=48, decode_steps=2, worker_steps=1, seed=0,
                       n_layers=2, config=tconfigs.get_smoke_config)
    assert r["n_layers"] == 2
    assert r["reduced"] == "n_layers 3 -> 2"
    assert r["n_params"] < tm.count_params(tm.init_params(
        tconfigs.get_smoke_config("deepseek_v2_236b"),
        torch.Generator("cpu").manual_seed(0), "cpu"))
