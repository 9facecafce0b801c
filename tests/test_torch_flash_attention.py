"""The port's flash attention against the JAX package on the CPU.

The same seeded numpy inputs go to JAX's Pallas kernel (in interpret mode,
as ``tests/test_kernels.py`` runs it), its jnp oracle and the model's
``dense_attention``, and to the port's op, which on CPU tensors runs its
plain PyTorch version. Tolerances are the reference's own: 2e-5 in float32
and 2e-2 in bfloat16. The CUDA kernel is held against the same plain
version on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``); the
last tests check how ``chip_smoke.py`` reports that kernel's build and
launches.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro.models.attention import dense_attention as jax_dense
from repro_torch.kernels.flash_attention.flash_attention import (
    ROUTES, flash_route)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models.attention import attention, dense_attention
from repro_torch.models.config import ModelConfig

BF16 = "bfloat16"


def _inputs(b, hq, hkv, sq, d, dtype, seed=0, skv=None):
    rng = np.random.RandomState(seed)
    skv = sq if skv is None else skv
    arrays = [rng.randn(b, hq, sq, d) * 0.5, rng.randn(b, hkv, skv, d) * 0.5,
              rng.randn(b, hkv, skv, d) * 0.5]
    arrays = [a.astype(np.float32) for a in arrays]
    if dtype == BF16:
        jx = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
        tx = [torch.from_numpy(a).bfloat16() for a in arrays]
    else:
        jx = [jnp.asarray(a) for a in arrays]
        tx = [torch.from_numpy(a) for a in arrays]
    return jx, tx


def _close(got, want, dtype):
    tol = 2e-2 if dtype == BF16 else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window,cap,dtype", [
    (2, 4, 2, 256, 64, True, None, None, "float32"),
    (1, 4, 4, 256, 64, True, 128, 50.0, "float32"),
    (1, 2, 1, 128, 32, False, None, None, "float32"),
    (1, 8, 2, 512, 64, True, None, 30.0, "float32"),
    (2, 2, 2, 256, 128, True, 64, None, "float32"),
    (1, 4, 2, 256, 64, True, None, None, BF16),
])
def test_flash_attention_sweep_matches_jax(b, hq, hkv, s, d, causal, window,
                                           cap, dtype):
    """The sweep of ``test_kernels.py::test_flash_attention_sweep``."""
    (jq, jk, jv), (q, k, v) = _inputs(b, hq, hkv, s, d, dtype)
    got = flash_attention(q, k, v, causal=causal, window=window, cap=cap,
                          bq=64, bk=64)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, jax_flash(jq, jk, jv, causal=causal, window=window, cap=cap,
                          bq=64, bk=64), dtype)
    _close(got, jax_ref(jq, jk, jv, causal=causal, window=window, cap=cap),
           dtype)
    _close(flash_attention(q, k, v, causal=causal, window=window, cap=cap,
                           impl="ref"),
           jax_ref(jq, jk, jv, causal=causal, window=window, cap=cap), dtype)


def test_flash_attention_block_shape_independence():
    (jq, jk, jv), (q, k, v) = _inputs(1, 2, 2, 256, 64, "float32", seed=1)
    o1 = flash_attention(q, k, v, bq=64, bk=64)
    o2 = flash_attention(q, k, v, bq=128, bk=32)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=2e-5)
    _close(o1, jax_flash(jq, jk, jv, bq=128, bk=32), "float32")


@pytest.mark.parametrize("dtype", ["float32", BF16])
def test_gqa_group_of_seven_like_qwen2(dtype):
    """qwen2-0.5b's head layout: 14 query heads over 2 kv heads."""
    (jq, jk, jv), (q, k, v) = _inputs(2, 14, 2, 128, 64, dtype, seed=2)
    got = flash_attention(q, k, v)
    _close(got, jax_flash(jq, jk, jv, bq=64, bk=64), dtype)
    _close(got, jax_ref(jq, jk, jv), dtype)


@pytest.mark.parametrize("kv_len,causal,window", [
    (100, True, None), (256, True, None), (37, False, None),
    (200, True, 64), (1, True, None)])
def test_kv_len_matches_pallas(kv_len, causal, window):
    (jq, jk, jv), (q, k, v) = _inputs(1, 4, 2, 256, 64, "float32", seed=3)
    got = flash_attention(q, k, v, causal=causal, window=window,
                          kv_len=kv_len)
    _close(got, flash_attention_pallas(jq, jk, jv, causal=causal,
                                       window=window, bq=64, bk=64,
                                       kv_len=kv_len), "float32")
    _close(got, jax_ref(jq, jk, jv, causal=causal, window=window,
                        kv_len=kv_len), "float32")


@pytest.mark.parametrize("sq,skv,causal,window,cap,d,dtype", [
    (200, 200, True, None, None, 64, "float32"),
    (544, 544, True, None, None, 64, "float32"),
    (33, 77, False, None, 50.0, 96, "float32"),
    (130, 130, True, 48, 50.0, 256, BF16),
    (544, 544, True, None, None, 64, BF16),
])
def test_ragged_lengths_match_dense_attention(sq, skv, causal, window, cap,
                                              d, dtype):
    """Sq and Skv that no tile divides, against the model's
    ``dense_attention`` (the route JAX's ``attention`` takes for them)."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 4, 2, sq, d, dtype, seed=4,
                                      skv=skv)
    want = jax_dense(jq, jk, jv, causal=causal, window=window, cap=cap)
    _close(flash_attention(q, k, v, causal=causal, window=window, cap=cap),
           want, dtype)
    _close(dense_attention(q, k, v, causal=causal, window=window, cap=cap),
           want, dtype)


def test_model_attention_takes_the_plain_version_on_the_cpu():
    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=64, vocab=16)
    (jq, jk, jv), (q, k, v) = _inputs(1, 4, 2, 40, 16, "float32", seed=5)
    for impl in ("scan_kv", "tri_unroll", "dense"):
        got = attention(cfg, q, k, v, window=8, cap=30.0, impl=impl)
        _close(got, jax_dense(jq, jk, jv, window=8, cap=30.0), "float32")
    with pytest.raises(ValueError, match="unknown attn impl"):
        attention(cfg, q, k, v, impl="flash")


def test_numpy_inputs_and_impl_names():
    rng = np.random.RandomState(6)
    q = rng.randn(1, 2, 16, 8).astype(np.float32)
    got = flash_attention(q, q, q, device="cpu")
    want = flash_attention_ref(*(torch.from_numpy(q),) * 3)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="unknown impl"):
        flash_attention(q, q, q, impl="pallas", device="cpu")


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "flash_attention_mma"),    # qwen2, olmo, llava
    (torch.bfloat16, 96, "flash_attention_mma"),    # phi3
    (torch.bfloat16, 128, "flash_attention_mma"),
    (torch.bfloat16, 1, "flash_attention_mma"),
    (torch.bfloat16, 129, "flash_attention_mma"),
    (torch.bfloat16, 192, "flash_attention_mma"),   # deepseek-v2's MLA
    (torch.bfloat16, 256, "flash_attention_mma"),   # gemma2
    (torch.float32, 64, "flash_attention"),         # no TF32
    (torch.float32, 256, "flash_attention"),
])
def test_route_dispatch(dtype, d, route):
    """bfloat16 at any D up to 256 takes the tensor-core route; float32
    (full float32 products) the CUDA-core one."""
    assert flash_route(dtype, d) == route
    assert route in ROUTES


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


#: an ``-Xptxas -v`` build log in the form nvcc prints it
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_mma_kernelILi192EEEvNS_6ParamsEi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116flash_mma_kernelILi192EEEvNS_6ParamsEi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 239 registers, used 1 barriers, 480 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_mma_kernelILi96EEEvNS_6ParamsEi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116flash_mma_kernelILi96EEEvNS_6ParamsEi
    24 bytes stack frame, 24 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 480 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112flash_kernelILi64ELi64ELi64EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112flash_kernelILi64ELi64ELi64EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 2048 bytes smem, 480 bytes cmem[0]
"""


def test_ptxas_report_reads_each_instance_of_the_named_kernels():
    """``chip_smoke.ptxas_report`` parses the text of a build log: one entry
    an instance of the kernels it is asked for, by the name its gate uses,
    and nothing of the others."""
    smoke = _smoke()
    rep = smoke.ptxas_report(PTXAS_LOG)
    assert rep == {
        "flash_mma_kernelILi192E": dict(
            stack_bytes=0, spill_store_bytes=0, spill_load_bytes=0,
            registers=239, static_smem_bytes=0),
        "flash_mma_kernelILi96E": dict(
            stack_bytes=24, spill_store_bytes=24, spill_load_bytes=24,
            registers=168, static_smem_bytes=0)}
    assert set(smoke.PTXAS_GATED_INSTANCES) <= set(rep)
    both = smoke.ptxas_report(PTXAS_LOG, ("flash_mma_kernel", "flash_kernel"))
    assert both["flash_kernelILi64ELi64ELi64E"] == dict(
        stack_bytes=0, spill_store_bytes=0, spill_load_bytes=0,
        registers=128, static_smem_bytes=2048)
    assert len(both) == 3


def test_kernels_line_counts_launches_only_of_served_models():
    """A flash shape of a model that a phase served carries the launches
    counted in that prefill (0 where the route did not run); one of a model
    that no phase serves has no count."""
    smoke = _smoke()
    served = {"deepseek_v2_236b": {"prefill_launches": {
        "flash_attention_mma": 4}}}
    row = dict(arch="deepseek_v2_236b", route="flash_attention_mma")
    assert smoke._by_shape_row(row, "flash_attention_mma", served) == dict(
        row, served=True, launches_a_prefill=4)
    assert smoke._by_shape_row(row, "flash_attention", served)[
        "launches_a_prefill"] == 0
    gemma = dict(arch="gemma2_2b", route="flash_attention_mma")
    assert smoke._by_shape_row(gemma, "flash_attention_mma", served) == dict(
        gemma, served=False, launches_a_prefill=None)
    assert any(r[0] == "gemma2_2b" for r in smoke.FLASH_MODEL_SHAPES)
