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
ARCHS = ["qwen2_0_5b", "rwkv6_7b", "gemma2_2b"]


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


def test_serve_main_on_the_cpu(capsys):
    serve.main(["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
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


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "rwkv6_7b", "gemma2_2b"])
def test_chip_smoke_serving_phases_rehearsed_on_cpu(arch):
    """``chip_smoke.py``'s serving and consistency phases, at smoke size on
    the CPU (no kernel launches there: the plain versions run)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    r = cs.serve_model("cpu", arch=arch, batch=2, prompt=32, max_len=64,
                       decode_steps=3, worker_steps=2, seed=0,
                       config=tconfigs.get_smoke_config)
    assert r["prefill_launches"] == {} and r["decode_launches"] == {}
    assert r["prefill_ms"] > 0 and r["decode_ms_per_step"] > 0
    assert r["prefill_profile"]["idle_share"] is None    # no device spans
    c = cs.consistency("cpu", arch=arch, s=48, cut=32, tol=1e-3, seed=1,
                       config=tconfigs.get_smoke_config)
    assert c["max_abs_err"] < 1e-4
    with pytest.raises(cs.PhaseError, match="out of tolerance"):
        cs._within(torch.ones(3), torch.zeros(3), 1e-3, 1e-3, "probe")
