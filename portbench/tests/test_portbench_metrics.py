"""The per-layer readers: each metric from synthetic readings, and nothing
where a run gives it nothing to read (never a 0 for a share)."""

import pytest

from portbench import spec
from portbench.counts import kernels
from portbench.counts.peaks import BF16_FLOP_PER_S


def readings(trace=None, rounds=None, config="olmoe-1b-7b"):
    return dict(config=spec.config(config), mix=spec.traffic("code32"),
                rounds=rounds or [], trace=trace, window_s=1.0)


def test_flash_mma_roofline_is_the_bound_over_the_kernel_time():
    read = spec.metric_reader("flash_mma_roofline")
    shape = ("flash_attention_mma", 32, 16, 16, 3840, 3840, 128, True)
    bound = kernels.flash_bound(*shape[1:], 2)["bound_s"]
    trace = dict(flash_shapes={shape: 16, ("flash_attention", 1, 1, 1, 8,
                                           8, 64, True): 3},
                 kernel_s={"void flash_mma_kernel<128>(...)": 16 * bound * 2,
                           "other": 1.0})
    assert read(readings(trace)) == pytest.approx(50.0)
    assert read(readings(dict(trace, flash_shapes={}))) is None
    assert read(readings(None)) is None


def test_wkv_split_roofline_needs_one_launch_a_layer_of_each_prefill():
    read = spec.metric_reader("wkv_split_roofline")
    rounds = [dict(length=512, batch=4), dict(length=3840, batch=4)]
    bound = sum(32 * kernels.wkv_split_bound(4, 64, r["length"], 64, 64,
                                             16, 2)["bound_s"]
                for r in rounds)
    trace = dict(rounds=rounds, launches={"wkv_split": 64},
                 kernel_s={"wkv_split_kernel<bf16>": bound * 4})
    assert read(readings(trace, config="rwkv6-7b")) == pytest.approx(25.0)
    trace["launches"] = {"wkv_split": 63}
    assert read(readings(trace, config="rwkv6-7b")) is None


def test_device_idle_share_divides_by_the_window_not_the_traced_wall():
    read = spec.metric_reader("device_idle_share")
    trace = dict(busy_s=3.0, window_s=6.5, device_events=10)
    rounds = [dict(length=512, batch=32)] * 12
    got = read(dict(readings(trace, rounds), window_s=8.0))
    assert got == pytest.approx(25.0)
    assert read(dict(readings(dict(trace, device_events=0), rounds),
                     window_s=8.0)) is None
    assert read(dict(readings(trace), window_s=8.0)) is None


def test_prefill_mfu_and_decode_step_ms_read_the_window():
    c = spec.config("olmoe-1b-7b")
    flops = spec.counts("moe").prefill_flops(c, 32, 1024)
    wall = flops / BF16_FLOP_PER_S * 4
    rounds = [dict(length=1024, batch=32, prefill_s=wall, decode_s=0.6,
                   decode_steps=12),
              dict(length=1024, batch=32, prefill_s=wall, decode_s=1.2,
                   decode_steps=12)]
    assert spec.metric_reader("prefill_mfu")(readings(rounds=rounds)) \
        == pytest.approx(25.0)
    assert spec.metric_reader("decode_step_ms")(readings(rounds=rounds)) \
        == pytest.approx(75.0)
    assert spec.metric_reader("prefill_mfu")(readings()) is None
    assert spec.metric_reader("decode_step_ms")(readings()) is None


def test_trace_reduction_unions_device_spans_and_labels_idle_time():
    from portbench import trace
    ev = [dict(ph="X", cat="user_annotation", name="prefill:512", ts=0,
               dur=100),
          dict(ph="X", cat="user_annotation", name="decode:512", ts=100,
               dur=100),
          dict(ph="X", cat="kernel", name="a", ts=10, dur=50),
          dict(ph="X", cat="kernel", name="b", ts=40, dur=40),
          dict(ph="X", cat="gpu_memcpy", name="copy", ts=150, dur=10),
          dict(ph="X", cat="gpu_user_annotation", name="prefill:512", ts=0,
               dur=200),
          dict(ph="X", cat="cpu_op", name="aten::mm", ts=0, dur=5)]
    red = trace.reduce_events(ev)
    assert red["busy_s"] == pytest.approx(80e-6)
    assert red["kernel_s"] == pytest.approx({"a": 50e-6, "b": 40e-6,
                                             "copy": 10e-6})
    assert red["idle_gaps"] == pytest.approx({"prefill:512": 30e-6,
                                              "decode:512": 90e-6})
    out = trace.breakdown(dict(red, window_s=200e-6), top=2)
    assert [n for n, _ in out["device_ops"]] == ["a", "b"]
    assert out["idle_gaps"][0][0] == "decode:512"
