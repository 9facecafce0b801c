"""``tools/span_profile.py`` on the CPU: the reduction of a Chrome trace by
the port's spans, on synthetic traces whose device events name their host
launches by ``correlation`` id; its three readers; and a rehearsal of the
whole tool on tiny cells (no card: no device events, the spans and counters
only)."""

import copy
import importlib.util
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "span_profile", ROOT / "tools" / "span_profile.py")
sp = importlib.util.module_from_spec(_spec)
sys.modules.setdefault("span_profile", sp)
_spec.loader.exec_module(sp)

from portbench import spec  # noqa: E402
from portbench.trace import reduce_events  # noqa: E402

HOST = dict(pid=1, tid=10)
CARD = dict(pid=0, tid=7)


def _x(cat, name, ts, dur, where, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, args=args,
                **where)


def _trace(program=True):
    """One benchmark span ``decode:8`` [0, 1000) µs; inside it, when
    ``program``, ``model.decode_step`` [10, 900) holding two ``layer``s
    [20, 400) and [400, 800), the first with ``attn.core`` [30, 100), the
    second with ``moe.experts`` [410, 500). Five launches: 1 in
    ``attn.core`` (it runs at [420, 480), while the host is in
    ``moe.experts``), 2 in the first layer's own time, 3 in
    ``moe.experts``, 4 in the step's own time, 5 outside every program
    span; and one device event, 99, with no launch in the trace."""
    ev = [_x("user_annotation", "decode:8", 0, 1000, HOST)]
    if program:
        ev += [_x("user_annotation", n, a, b - a, HOST) for n, a, b in (
            ("model.decode_step", 10, 900), ("layer", 20, 400),
            ("attn.core", 30, 100), ("layer", 400, 800),
            ("moe.experts", 410, 500))]
    for corr, at in ((1, 35), (2, 150), (3, 420), (4, 850), (5, 950)):
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", at, 3, HOST,
                     correlation=corr))
    for corr, a, b in ((1, 420, 480), (2, 600, 650), (3, 700, 720),
                       (4, 900, 910), (5, 960, 990), (99, 995, 998)):
        ev.append(_x("kernel", f"k{corr}", a, b - a, CARD, correlation=corr))
    ev.append(dict(ph="M", name="process_name", pid=0, tid=0, args={}))
    return ev


def test_device_events_go_to_the_innermost_span_open_at_their_launch():
    red = sp.reduce_by_span(_trace())
    spans = red["program_spans"]
    assert set(spans) == {"model.decode_step", "layer", "attn.core",
                          "moe.experts"}
    us = pytest.approx

    def got(name):
        s = spans[name]
        return (s["calls"], s["launches"], s["device_s"] * 1e6,
                s["incl_launches"], s["incl_device_s"] * 1e6,
                s["idle_s"] * 1e6)

    # kernel 1 ran under the host's moe.experts, but attn.core launched it
    assert got("attn.core") == (1, 1, us(60), 1, us(60), us(70))
    assert got("moe.experts") == (1, 1, us(20), 1, us(20), us(30))
    assert got("layer") == (2, 1, us(50), 3, us(130), us(550))
    assert got("model.decode_step") == (1, 1, us(10), 4, us(140), us(110))
    assert red["covered"]["decode"]["device_s"] == us(170e-6)
    assert red["covered"]["decode"]["in_program_s"] == us(140e-6)
    assert red["covered"]["prefill"] == {"device_s": 0.0,
                                         "in_program_s": 0.0}
    assert red["unmatched"] == 1


def test_idle_gaps_are_named_by_benchmark_span_then_program_span():
    red = sp.reduce_by_span(_trace())
    gaps = {k: v * 1e6 for k, v in red["idle_gaps"].items()}
    assert gaps == pytest.approx({
        "decode:8": 67, "decode:8/model.decode_step": 110,
        "decode:8/layer": 550, "decode:8/attn.core": 70,
        "decode:8/moe.experts": 30})
    plain = reduce_events(_trace())
    assert sum(red["idle_gaps"].values()) == pytest.approx(
        sum(plain["idle_gaps"].values()))
    assert plain["idle_gaps"] == pytest.approx({"decode:8": 827e-6})


def test_a_trace_without_program_spans_reduces_as_before():
    for program in (False, True):
        events = _trace(program)
        plain = reduce_events(events)
        red = sp.reduce_by_span(events)
        for key in plain:
            if key != "idle_gaps" or not program:
                assert red[key] == plain[key], key
    red = sp.reduce_by_span(_trace(False))
    assert red["program_spans"] == {}
    assert {name: fn(red) for name, fn in sp.READERS.items()} == {
        "decode_launches": None, "decode_busy_ms": None,
        "moe_slot_use": None}


def test_readers():
    red = sp.reduce_by_span(_trace())
    red["program_counters"] = {"moe.choices": 1000, "moe.kept": 900,
                               "moe.slots": 1200}
    assert sp.decode_launches(red) == 4
    assert sp.decode_busy_ms(red) == pytest.approx(0.14)
    assert sp.moe_slot_use(red) == pytest.approx(75.0)
    red["program_counters"] = {}
    assert sp.moe_slot_use(red) is None
    step = red["program_spans"]["model.decode_step"]
    step.update(incl_launches=0, incl_device_s=0.0)
    assert sp.decode_launches(red) is None and sp.decode_busy_ms(red) is None


def test_nested_spans_flatten_to_their_innermost_pieces():
    segs = sp._segments([(0, 10, "a"), (2, 5, "b"), (3, 4, "c"),
                         (5, 12, "d"), (20, 30, "e")])
    assert segs == [(0, 2, ("a",)), (2, 3, ("a", "b")),
                    (3, 4, ("a", "b", "c")), (4, 5, ("a", "b")),
                    (5, 10, ("a", "d")), (20, 30, ("e",))]


SMALL = {"moe": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                     d_ff=64, vocab=256, n_experts=4, top_k=2, d_expert=64),
         "ssm": dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
                     d_ff=128, vocab=256)}


@pytest.mark.parametrize("cell", ["olmoe-1b-7b.code32", "rwkv6-7b.code16"])
def test_the_tool_runs_a_tiny_cell_on_the_cpu(cell):
    c = copy.deepcopy(spec.cell(cell))
    c["config"]["model"].update(SMALL[c["config"]["family"]])
    c["config"]["dtype"] = "float32"
    c["traffic"].update(clients=4, prompt_lengths=[32, 16], output_tokens=4,
                        max_len=48)
    got = sp.profile_cell(c, 2147483649, "cpu")
    assert got["device"] == "cpu"
    assert [r["recorded"] for r in got["traced_cycles"]] == [False, True]
    assert all(r["device_events"] == 0 for r in got["traced_cycles"])
    spans = got["trace"]["program_spans"]
    steps = 2 * 3                                  # rounds x decode steps
    assert spans["model.decode_step"]["calls"] == steps
    assert spans["model.prefill"]["calls"] == 2
    assert got["readings"]["decode_launches"] is None
    assert got["checks"]["syncs_recording"] is None
    # a step, its embed and head; a layer: 9 spans and obs.count (moe), or
    # 4 spans (rwkv6)
    per_layer = 10 if c["config"]["family"] == "moe" else 4
    assert got["checks"]["spans_per_decode_step"] == 3 + 2 * per_layer
    assert got["off_cost"]["span_us"] > 0
    split = got["split_counters"]
    if c["config"]["family"] == "moe":
        assert got["readings"]["moe_slot_use"] > 0
        # another cycle's prompts: the same shapes, other routing
        for k in ("moe.choices", "moe.slots"):
            assert split["prefill"][k] + split["decode"][k] \
                == got["counters"][k]
        assert split["decode"]["moe.choices"] == steps * 4 * 2 * 2
        assert 0 < split["decode"]["moe.kept"] \
            <= split["decode"]["moe.choices"]
    else:
        assert got["readings"]["moe_slot_use"] is None
        assert got["counters"] == {} and split["decode"] == {}
