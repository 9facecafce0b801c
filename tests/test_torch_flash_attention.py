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
    MMA_TILE, ROUTES, flash_route)
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


@pytest.mark.parametrize("d", [64, 192, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_pallas_rows_with_all_visited_keys_masked_average_their_tiles(causal,
                                                                     d):
    """kv_len = 0 masks every key. The Pallas kernel at 64 x 64 blocks then
    averages, in each row, the keys of the kv tiles it visits (all of them
    without causality; up to its q tile's diagonal with it): the value
    ``tests/test_torch_gpu.py`` holds both CUDA routes to at every head
    dim, since both keep the 64 x 64 tile."""
    (jq, jk, jv), _ = _inputs(1, 2, 1, 256, d, "float32", seed=7)
    got = np.asarray(flash_attention_pallas(jq, jk, jv, causal=causal,
                                            bq=64, bk=64, kv_len=0))
    vf = np.asarray(jv)[0, 0]
    for row in (0, 63, 64, 150, 255):
        last = 256 if not causal else (row // MMA_TILE + 1) * MMA_TILE
        np.testing.assert_allclose(got[0, :, row],
                                   np.broadcast_to(vf[:last].mean(0), (2, d)),
                                   atol=2e-5, rtol=2e-5)


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


#: an ``-Xptxas -v`` build log in the form nvcc prints it: the
#: tensor-core kernel's six instances (DP = 96 with 24 bytes spilled, DP =
#: 256 with its wgmma serialized) and an earlier source's CUDA-core kernel
MMA = "_ZN12_GLOBAL__N_116flash_mma_kernelILi{}EEEvNS_7MmaMapsENS_6ParamsEi"
PTXAS_LOG = "".join(f"""\
ptxas info    : Compiling entry function '{MMA.format(dp)}' for 'sm_90a'
ptxas info    : Function properties for {MMA.format(dp)}
    {24 * (dp == 96)} bytes stack frame, {24 * (dp == 96)} bytes spill stores, {24 * (dp == 96)} bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1024 bytes cmem[0]
""" for dp in (32, 64, 96, 128, 192, 256)) + f"""\
ptxas info    : (C7513) Potential Performance Loss: wgmma.mma_async instructions are serialized due to non wgmma instructions defining input registers of a wgmma between start and end of the pipeline stage in the function '{MMA.format(256)}'
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112flash_kernelILi64ELi64ELi64EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112flash_kernelILi64ELi64ELi64EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 2048 bytes smem, 480 bytes cmem[0]
"""
SERIALIZED = ("non wgmma instructions defining input registers of a wgmma "
              "between start and end of the pipeline stage")
#: the same log's lines for the CUDA-core kernel's instances, one a padded
#: head dim (DP = 192 with 8 bytes spilled)
F32_LOG = "".join(f"""\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112flash_kernelILi{dp}EEEvNS_6ParamsEi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112flash_kernelILi{dp}EEEvNS_6ParamsEi
    {8 * (dp == 192)} bytes stack frame, {8 * (dp == 192)} bytes spill stores, {8 * (dp == 192)} bytes spill loads
ptxas info    : Used {64 + dp // 2} registers, used 1 barriers, 480 bytes cmem[0]
""" for dp in (32, 64, 96, 128, 192, 256))


def test_ptxas_report_reads_each_instance_of_the_named_kernels():
    """``chip_smoke.ptxas_report`` parses the text of a build log: one entry
    an instance of the kernels it is asked for, by the name its gate uses,
    and nothing of the others. The CUDA-core kernel (``flash_kernel``) is
    among the kernels it reads by default, and each of its instances is
    gated: a spill in one of them is read as such."""
    smoke = _smoke()
    rep = smoke.ptxas_report(PTXAS_LOG + F32_LOG)
    f32 = {f"flash_kernelILi{dp}E": dict(
        stack_bytes=8 * (dp == 192), spill_store_bytes=8 * (dp == 192),
        spill_load_bytes=8 * (dp == 192), registers=64 + dp // 2,
        static_smem_bytes=0) for dp in smoke.FLASH_F32_DPS}
    mma = {f"flash_mma_kernelILi{dp}E": dict(
        stack_bytes=24 * (dp == 96), spill_store_bytes=24 * (dp == 96),
        spill_load_bytes=24 * (dp == 96), registers=168,
        static_smem_bytes=0) for dp in smoke.FLASH_MMA_DPS}
    mma["flash_mma_kernelILi256E"]["wgmma_serialized"] = SERIALIZED
    assert rep == {
        **mma,
        # an earlier source's instance, as tools/flash_variants.py reads a
        # parent's build log
        "flash_kernelILi64ELi64ELi64E": dict(
            stack_bytes=0, spill_store_bytes=0, spill_load_bytes=0,
            registers=128, static_smem_bytes=2048),
        **f32}
    assert set(smoke.PTXAS_GATED_INSTANCES) == {
        *mma, *f32, *smoke.WKV_SPLIT_INSTANCES}
    assert "flash_kernel" in smoke.PTXAS_KERNELS
    gated = {fn: rep[fn] for fn in smoke.PTXAS_GATED_INSTANCES if fn in rep}
    assert [fn for fn, r in gated.items() if r["spill_store_bytes"]] == [
        "flash_mma_kernelILi96E", "flash_kernelILi192E"]
    assert [fn for fn, r in gated.items() if "wgmma_serialized" in r] == [
        "flash_mma_kernelILi256E"]
    assert set(smoke.ptxas_report(PTXAS_LOG + F32_LOG, (
        "flash_mma_kernel",))) == set(mma)


def test_ptxas_report_reads_the_wgmma_serialization_notice():
    """ptxas names the function it serialized: the notice is read into that
    instance's report wherever it stands in the log, and one without a name
    goes to the instance being compiled; a notice of a kernel that is not
    asked for is dropped."""
    smoke = _smoke()
    note = ("ptxas info    : (C7510) Potential Performance Loss: "
            "wgmma.mma_async instructions are serialized due to "
            "insufficient register resources for the wgmma pipeline")
    before = f"{note} in the function '{MMA.format(64)}'\n"
    unnamed = f"{note}\n"
    other = (f"{note} in the function "
             f"'_ZN12_GLOBAL__N_111wkv_kernelILi64EEEvv'\n")
    rep = smoke.ptxas_report(before + other + PTXAS_LOG.replace(
        "ptxas info    : Used 168 registers, used 1 barriers, 1024 bytes "
        "cmem[0]\nptxas info    : Compiling entry function '"
        + MMA.format(128), "ptxas info    : Used 168 registers, used 1 "
        "barriers, 1024 bytes cmem[0]\n" + unnamed + "ptxas info    : "
        "Compiling entry function '" + MMA.format(128)),
        ("flash_mma_kernel",))
    reason = "insufficient register resources for the wgmma pipeline"
    assert {fn: r["wgmma_serialized"] for fn, r in rep.items()
            if "wgmma_serialized" in r} == {
        "flash_mma_kernelILi64E": reason,
        "flash_mma_kernelILi96E": reason,
        "flash_mma_kernelILi256E": SERIALIZED}
    assert rep["flash_mma_kernelILi64E"]["registers"] == 168


def test_kernels_line_counts_launches_only_of_served_models():
    """A flash shape of a model that a phase served carries the launches
    counted in that prefill (0 where the route did not run); one of a model
    that no phase serves has no count."""
    smoke = _smoke()
    served = {"deepseek_v2_236b": {"prefill_launches": {
        "flash_attention_mma": 4}}}
    row = dict(arch="deepseek_v2_236b", what="attention",
               route="flash_attention_mma")
    assert smoke._by_shape_row(row, "flash_attention_mma", served) == dict(
        row, served=True, launches_a_prefill=4)
    assert smoke._by_shape_row(row, "flash_attention", served)[
        "launches_a_prefill"] == 0
    gemma = dict(arch="gemma2_2b", what="attention",
                 route="flash_attention_mma")
    assert smoke._by_shape_row(gemma, "flash_attention_mma", served) == dict(
        gemma, served=False, launches_a_prefill=None)
    assert any(r[0] == "gemma2_2b" for r in smoke.FLASH_MODEL_SHAPES)
    # the train shape is timed beside the prefills, with no prefill count
    arch, what = smoke.FLASH_TRAIN_SHAPE[:2]
    train = dict(arch=arch, what=what, route="flash_attention_mma")
    assert smoke.FLASH_TRAIN_SHAPE in smoke.FLASH_MODEL_SHAPES
    assert smoke._by_shape_row(train, "flash_attention_mma", {arch: {
        "prefill_launches": {"flash_attention_mma": 24}}}) == dict(
        train, served=False, launches_a_prefill=None)
    assert smoke.FLASH_TRAIN_SHAPE[2:8] == next(
        (b, hq, hkv, s, s, d) for label, b, hq, hkv, s, d, *_
        in smoke.GRAD_FLASH_CASES if label == "qwen2 train")


def test_float32_timing_shapes_are_the_consistency_phase_calls(monkeypatch):
    """``chip_smoke.FLASH_F32_SHAPES`` times the CUDA-core route at every
    attention call of the float32 consistency phase, with its launches:
    each arch of ``CONSISTENCY`` whose route is ``flash_attention`` runs
    ``forward_full`` over s tokens and ``prefill`` over the first cut on the
    meta device, at full width and the phase's depth, and its calls, by
    shape and count, are the table's rows of that arch."""
    import collections
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import forward_full, init_params, prefill

    smoke = _smoke()
    calls = collections.Counter()
    plain = flash_ops.flash_attention

    def record(q, k, v, *, causal=True, **kw):
        assert not any(kw.values()), kw            # no window, cap, q0
        assert v.shape == k.shape
        calls[(*q.shape[:3], *k.shape[1:], causal)] += 1
        return plain(q, k, v, causal=causal, **kw)

    monkeypatch.setattr(flash_ops, "flash_attention", record)
    table = collections.defaultdict(collections.Counter)
    for (arch, _, b, hq, hkv, sq, skv, d, causal, _,
         n) in smoke.FLASH_F32_SHAPES:
        table[arch][(b, hq, sq, hkv, skv, d, causal)] += n
    archs = [a for a, st in smoke.CONSISTENCY.items()
             if st["route"] == "flash_attention"]
    assert sorted(table) == sorted(archs)
    for arch in archs:
        settings = smoke.CONSISTENCY[arch]
        size = {**smoke.CONSISTENCY_SIZE, **settings}
        cfg, _ = smoke._cut(get_config(arch), settings.get("n_layers"))
        cfg = dataclasses.replace(cfg, dtype="float32")
        params = init_params(cfg, None, "meta")
        tokens = torch.zeros((1, size["s"]), dtype=torch.int32,
                             device="meta")
        batch = {"tokens": tokens}
        key = "tokens"
        if cfg.family == "encdec":
            key = "dec_tokens"
            batch = {"frames": torch.zeros((1, size["cut"], cfg.d_model),
                                           device="meta"), key: tokens}
        calls.clear()
        forward_full(cfg, params, batch)
        prefill(cfg, params, dict(batch, **{key: tokens[:, :size["cut"]]}),
                size["s"])
        assert sum(calls.values()) == 2 * smoke.attn_calls(cfg)
        assert calls == table[arch], arch
    assert sum(sum(c.values()) for c in table.values()) == 168


def test_float32_row_launches_are_read_by_arch_and_call_shape():
    """``chip_smoke.f32_row_launches`` reports each ``FLASH_F32_SHAPES`` row
    with the launches the consistency run counted at its arch and call
    shape, and fails where the run's split differs from the table's, even
    with the total the same: between two archs, between two shapes of one
    arch, or against an arch's launch count."""
    import copy

    smoke = _smoke()
    by_arch = {}
    for arch, _, *shape, _, n in smoke.FLASH_F32_SHAPES:
        row = by_arch.setdefault(arch, dict(
            launches={"flash_attention": 0}, launches_by_shape={}))
        row["launches"]["flash_attention"] += n
        row["launches_by_shape"][smoke._call_key("flash_attention",
                                                 *shape)] = n
    by_arch["rwkv6_7b"] = dict(launches={"wkv_split": 64},
                               launches_by_shape={})
    assert smoke.f32_row_launches(by_arch) == [
        r[-1] for r in smoke.FLASH_F32_SHAPES]

    def moved(src, dst):
        bad = copy.deepcopy(by_arch)
        for (arch, i), step in ((src, -1), (dst, 1)):
            row = bad[arch]
            key = list(row["launches_by_shape"])[i]
            row["launches_by_shape"][key] += step
            row["launches"]["flash_attention"] += step
        return bad

    for bad in (moved(("qwen2_0_5b", 0), ("seamless_m4t_medium", 0)),
                moved(("seamless_m4t_medium", 0),
                      ("seamless_m4t_medium", 1))):
        assert sum(r["launches"].get("flash_attention", 0)
                   for r in bad.values()) == 168
        with pytest.raises(smoke.PhaseError, match="by call shape"):
            smoke.f32_row_launches(bad)
    bad = copy.deepcopy(by_arch)
    bad["olmoe_1b_7b"]["launches"]["flash_attention"] += 1
    with pytest.raises(smoke.PhaseError, match="in all"):
        smoke.f32_row_launches(bad)


def test_flash_variants_finds_every_instance_of_both_routes():
    """``tools/flash_variants.py`` reads the instances of each route from
    the source it builds, for its occupancy report."""
    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "flash_variants", root / "tools" / "flash_variants.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = (root / "src/repro_torch/kernels/flash_attention/csrc/"
           "flash_attention.cu").read_text()
    mma, f32 = tool._instances(src)
    assert sorted(mma) == list(_smoke().FLASH_MMA_DPS)
    assert sorted(f32) == list(_smoke().FLASH_F32_DPS)
    assert all("F32Tile" in line and line.endswith("kF32Threads);")
               for line in f32.values())
    assert all(f"flash_mma_kernel<{dp}>, MmaTile<{dp}>::bytes" in line
               and line.endswith("kMmaThreads);")
               for dp, line in mma.items())
    assert {row[0] for row in tool.SHAPES["float32"]} == {
        f"{r[0]} {r[1]}" for r in _smoke().FLASH_F32_SHAPES}
    # in bf16 every shape chip_smoke.py times, the train shape included
    assert {f"{r[0]} {r[1]}" for r in _smoke().FLASH_MODEL_SHAPES} <= {
        row[0] for row in tool.SHAPES["bfloat16"]}
