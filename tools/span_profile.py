#!/usr/bin/env python3
"""Device and idle time by the port's own spans (``repro_torch/obs.py``), in
one cell of ``BENCHMARK.json``, on the CUDA card.

    python3 tools/span_profile.py --workload olmoe-1b-7b.code32 \\
        --seed 2801 --out <dir>

Set-up as the benchmark's run makes it (``portbench/bench.py``: the cell's
configuration, weights drawn from the seed, the port's prefill and decode
steps, the warm-up), then:

1. one cycle of the mix without the profiler: its wall, the divisor of an
   idle share;
2. traced cycles, as the benchmark's ``--trace 1`` runs them
   (``portbench/serving.py``'s rounds under ``torch.profiler``, the
   benchmark's spans ``<kind>:<prompt length>``), in turns without and with
   ``obs.recording()`` inside the profiler: each one's wall, busy time and
   device operations, so the difference is what recording costs;
3. the recorded trace reduced by program span (:func:`reduce_by_span`):
   each span's calls, device operations launched while it was the
   innermost span open on the launching thread (the device event's
   ``correlation`` id names its host launch), the union of their device
   spans, and the idle time while it was innermost; the idle gaps named
   ``<benchmark span>/<program span>``; the share of the prefill's and
   decode's device time that lies under some program span; and
   :data:`READERS`' three readings;
4. one cycle, untraced, with a recording around each prefill and each
   decode call apart: the MoE counters of prefill and decode;
5. one round's decode steps under ``torch.cuda.set_sync_debug_mode("warn")``
   with recording on and off: each op that synchronizes, by the line of the
   port that called it; the spans a decode step opens; and the host cost of
   ``obs.span`` and ``obs.count`` with recording off.

Writes everything to ``<out>/<cell>.json`` and prints a summary line. It
imports nothing of JAX. Without a card it refuses to run; the CPU tests
call :func:`profile_cell` on a tiny cell.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import json
import os
import re
import sys
import tempfile
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench import bench, serving, spec, traffic, weights  # noqa: E402
from portbench.trace import SPAN_KINDS, _union, reduce_events  # noqa: E402
from repro_torch import obs  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: a program span's name: dotted words (``obs.py``); the benchmark's spans
#: hold a ``:`` and the profiler's own steps a ``#``
PROGRAM = re.compile(r"[A-Za-z_]\w*(\.\w+)*\Z")
#: the benchmark's spans whose device time must lie under program spans
COVERED_KINDS = ("prefill", "decode")


def _is_bench(name: str) -> bool:
    """A span of the benchmark's, as ``portbench/trace.py`` tells them."""
    return name.split(":")[0] in SPAN_KINDS


def _is_program(name: str) -> bool:
    return PROGRAM.match(name) is not None and not _is_bench(name)


def _segments(spans):
    """Disjoint (start, end, stack) pieces of the time that the nested
    ``spans`` (start, end, name) of one thread cover; ``stack`` names the
    spans open there, outermost first. A span that outlasts its parent (a
    rounding of the trace's clock) is cut at the parent's end."""
    out, stack, t = [], [], None

    def advance(upto):
        nonlocal t
        if stack and t is not None and upto > t:
            out.append((t, upto, tuple(n for _, n in stack)))
        t = upto if t is None else max(t, upto)

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= a:
            advance(stack[-1][0])
            stack.pop()
        advance(a)
        if stack:
            b = min(b, stack[-1][0])
        stack.append((b, name))
    while stack:
        advance(stack[-1][0])
        stack.pop()
    return out


def _stack_at(segs, starts, ts):
    i = bisect.bisect_right(starts, ts) - 1
    if i >= 0 and ts < segs[i][1]:
        return segs[i][2]
    return ()


def _pieces(segs, starts, a, b):
    """(length, stack) pieces of [a, b), stack () where no span is open."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    t = a
    while t < b:
        if i < len(segs) and segs[i][1] <= t:
            i += 1
            continue
        if i >= len(segs) or segs[i][0] >= b:
            yield b - t, ()
            return
        s0, s1, st = segs[i]
        if s0 > t:
            yield s0 - t, ()
            t = s0
        end = min(s1, b)
        yield end - t, st
        t = end
        i += 1


def _innermost(stack):
    for name in reversed(stack):
        if _is_program(name):
            return name
    return None


def _bench_of(stack):
    for name in stack:
        if _is_bench(name):
            return name
    return None


def reduce_by_span(events) -> dict:
    """``portbench/trace.py``'s ``reduce_events`` of a Chrome trace, with
    the device's work and idle time put to the program's spans.

    Adds ``program_spans`` (by name: ``calls``; ``launches``, the device
    operations whose host launch fell while it was the innermost program
    span open on the launching thread, and ``device_s``, the union of
    their device spans (self); ``incl_launches`` and ``incl_device_s``, the
    same for every launch under it, nested spans included; ``idle_s``, the
    device's idle time while it was the innermost span on the thread of the
    benchmark's spans), ``covered`` (by the kind of benchmark span a launch
    fell in, ``prefill`` and ``decode``: ``device_s`` summed over its
    device operations and ``in_program_s``, the part launched under some
    program span), ``by_phase`` (by that kind, then by innermost program
    span, ``-`` for none: ``launches``, ``device_s`` summed, ``idle_s`` and
    the ``kernels`` with the most device time, [name, launches, seconds])
    and ``unmatched`` (device operations with no host launch in the
    trace). An idle gap inside a program span is named ``<benchmark
    span>/<innermost program span>``. For a trace without program spans
    every key of ``reduce_events`` keeps its value; with them only the
    names of ``idle_gaps`` differ, and its total is the same."""
    red = reduce_events(events)
    annotations = collections.defaultdict(list)
    launch_at, device = {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat == "user_annotation":
            a = float(e["ts"])
            annotations[(e.get("pid"), e.get("tid"))].append(
                (a, a + float(e["dur"]), e["name"]))
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch_at[e["args"]["correlation"]] = (
                (e.get("pid"), e.get("tid")), float(e["ts"]))
        elif cat in DEVICE_CATS:
            a = float(e["ts"])
            device.append((a, a + float(e["dur"]),
                           e.get("args", {}).get("correlation"), e["name"]))
    calls = collections.Counter(
        name for spans in annotations.values() for _, _, name in spans
        if _is_program(name))
    red["program_spans"] = {}
    red["covered"] = {k: {"device_s": 0.0, "in_program_s": 0.0}
                      for k in COVERED_KINDS}
    red["unmatched"] = 0
    if not calls:
        return red
    phases = collections.defaultdict(lambda: collections.defaultdict(
        lambda: {"launches": 0, "device_s": 0.0, "idle_s": 0.0,
                 "kernels": collections.defaultdict(lambda: [0, 0.0])}))

    segs = {key: _segments(spans) for key, spans in annotations.items()}
    starts = {key: [s[0] for s in v] for key, v in segs.items()}
    self_iv = collections.defaultdict(list)
    incl_iv = collections.defaultdict(list)
    for a, b, corr, kernel in device:
        launch = launch_at.get(corr)
        if launch is None:
            red["unmatched"] += 1
            continue
        key, ts = launch
        stack = _stack_at(segs.get(key, []), starts.get(key, []), ts)
        inner = _innermost(stack)
        if inner is not None:
            self_iv[inner].append((a, b))
        for name in set(stack):
            if _is_program(name):
                incl_iv[name].append((a, b))
        bench_span = _bench_of(stack)
        kind = bench_span.split(":")[0] if bench_span else None
        cell = phases[kind or "other"][inner or "-"]
        cell["launches"] += 1
        cell["device_s"] += (b - a) / 1e6
        cell["kernels"][kernel][0] += 1
        cell["kernels"][kernel][1] += (b - a) / 1e6
        if kind in red["covered"]:
            red["covered"][kind]["device_s"] += (b - a) / 1e6
            if inner is not None:
                red["covered"][kind]["in_program_s"] += (b - a) / 1e6

    def busy_s(iv):
        return sum(b - a for a, b in _union(iv)) / 1e6

    idle = collections.Counter()
    gaps = collections.Counter()
    host = [(a, b) for spans in annotations.values()
            for a, b, name in spans if _is_bench(name)]
    if host:
        owner = max(annotations, key=lambda k: sum(
            _is_bench(n) for _, _, n in annotations[k]))
        merged = _union((a, b) for a, b, _, _ in device)
        first = min(a for a, _ in host)
        edges = [[first, first], *merged, [max(b for _, b in host)] * 2]
        for (_, end), (start, _) in zip(edges, edges[1:]):
            if start <= end:
                continue
            for length, stack in _pieces(segs[owner], starts[owner], end,
                                         start):
                bench_span, inner = _bench_of(stack), _innermost(stack)
                if inner is not None:
                    idle[inner] += length / 1e6
                kind = bench_span.split(":")[0] if bench_span else "other"
                phases[kind][inner or "-"]["idle_s"] += length / 1e6
                name = "other" if bench_span is None else (
                    f"{bench_span}/{inner}" if inner else bench_span)
                gaps[name] += length / 1e6
        red["idle_gaps"] = dict(gaps)
    red["program_spans"] = {
        name: dict(calls=calls[name], launches=len(self_iv[name]),
                   device_s=busy_s(self_iv[name]),
                   incl_launches=len(incl_iv[name]),
                   incl_device_s=busy_s(incl_iv[name]),
                   idle_s=idle[name])
        for name in sorted(calls)}
    red["by_phase"] = {
        kind: {name: dict(c, kernels=sorted(
            ([k, n, t] for k, (n, t) in c["kernels"].items()),
            key=lambda x: -x[2])[:6]) for name, c in spans.items()}
        for kind, spans in phases.items()}
    return red


# ------------------------------------------------------------- the readers
def decode_launches(red):
    """Device operations launched inside ``model.decode_step``, a step (None
    where the trace saw none: no device)."""
    s = red.get("program_spans", {}).get("model.decode_step")
    if not s or not s["calls"] or not s["incl_launches"]:
        return None
    return s["incl_launches"] / s["calls"]


def decode_busy_ms(red):
    """The union of those operations' device spans, a step, in ms: the
    card's own work a step, which the profiler's host cost does not
    stretch."""
    s = red.get("program_spans", {}).get("model.decode_step")
    if not s or not s["calls"] or not s["incl_launches"]:
        return None
    return s["incl_device_s"] / s["calls"] * 1e3


def moe_slot_use(red):
    """``moe.kept`` over ``moe.slots``, in %: the expert GEMMs' rows that
    hold a token."""
    c = red.get("program_counters") or {}
    if not c.get("moe.slots"):
        return None
    return 100.0 * c.get("moe.kept", 0) / c["moe.slots"]


READERS = {"decode_launches": decode_launches,
           "decode_busy_ms": decode_busy_ms, "moe_slot_use": moe_slot_use}


# ------------------------------------------------------------- on the card
def _read_trace(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _activities(device):
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def traced_cycle(run, device, record: bool):
    """``run(mark)`` under the profiler, with ``obs.recording()`` inside it
    when ``record``: (run's result, the reduced trace with ``window_s``
    (host wall, ending in a synchronize) and ``program_counters``)."""
    from torch.profiler import profile, record_function
    with profile(activities=_activities(device)) as prof:
        t0 = serving.now()
        rec = obs.recording() if record else contextlib.nullcontext({})
        with rec as tallies:
            out = run(record_function)
            serving.sync(device)
        window_s = serving.now() - t0
    red = reduce_by_span(_read_trace(prof))
    red.update(window_s=window_s, program_counters=dict(tallies))
    return out, red


def _split_counters(steps, params, mix, seed, vocab, device, first):
    """One cycle with a recording around each prefill and each decode call:
    the tallies of each phase apart."""
    prefill, decode = steps
    got = {"prefill": collections.Counter(), "decode": collections.Counter()}

    def recorded(fn, phase):
        def call(*args):
            with obs.recording() as t:
                out = fn(*args)
            got[phase].update(t)
            return out
        return call

    serving.run_rounds((recorded(prefill, "prefill"),
                        recorded(decode, "decode")), params, mix, seed, vocab,
                       device, first=first, count=traffic.cycle(mix))
    return {k: dict(v) for k, v in got.items()}


def _decode_checks(steps, params, mix, seed, vocab, device, i) -> dict:
    """One round's prefill, then its decode steps with
    ``torch.cuda.set_sync_debug_mode("warn")``, recording on and then off:
    ``syncs_recording`` and ``syncs_off`` count the synchronizing ops by
    the line of the port that called them (``{}`` on the card: none; None
    on the CPU: not checked). And the program spans one recorded decode
    step opens."""
    from torch.profiler import profile
    prefill, decode = steps
    tokens = torch.from_numpy(traffic.prompts(mix, seed, i, vocab)).to(device)
    s = tokens.shape[1]
    on_card = device.type == "cuda"
    out = {}
    for record in (True, False):
        logits, cache = prefill(params, {"tokens": tokens})
        tok = serving.greedy(logits)
        serving.sync(device)
        rec = obs.recording() if record else contextlib.nullcontext({})
        syncs = collections.Counter()

        def seen(message, *args, **kwargs):
            # the sync debug mode's own message; its one-time warning
            # that it is a prototype says "synchronizing" too
            if "called a synchronizing CUDA operation" in str(message):
                syncs[" < ".join(
                    f"{Path(f.filename).name}:{f.lineno}"
                    for f in reversed(traceback.extract_stack())
                    if "repro_torch" in f.filename)] += 1

        with rec, warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = seen
            if on_card:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                for j in range(mix["output_tokens"] - 1):
                    logits, cache = decode(params, cache, tok, s + j)
                    tok = serving.greedy(logits)
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode(0)
        serving.sync(device)
        out["syncs_recording" if record else "syncs_off"] = \
            dict(syncs) if on_card else None
    with profile(activities=_activities(device)) as prof:
        with obs.recording():
            decode(params, cache, tok, s + mix["output_tokens"] - 1)
            serving.sync(device)
    out["spans_per_decode_step"] = sum(
        1 for e in _read_trace(prof) if e.get("ph") == "X"
        and e.get("cat") == "user_annotation" and _is_program(e["name"]))
    del cache
    return out


def _off_cost(n: int = 200_000) -> dict:
    """Host µs of one ``obs.span`` (a ``with`` of it) and one ``obs.count``
    with recording off, each less an empty loop's."""
    now = serving.now
    t0 = now()
    for _ in range(n):
        pass
    empty = now() - t0
    t0 = now()
    for _ in range(n):
        with obs.span("layer"):
            pass
    spans = now() - t0
    t0 = now()
    for _ in range(n):
        obs.count("moe.kept", 1)
    counts = now() - t0
    return {"span_us": (spans - empty) / n * 1e6,
            "count_us": (counts - empty) / n * 1e6}


def profile_cell(cell: dict, seed: int, device, pairs: int = 1) -> dict:
    """Everything the module docstring lists, for one cell."""
    config, mix = cell["config"], cell["traffic"]
    traffic.validate(mix)
    device = torch.device(device)
    from repro_torch.launch.steps import params_struct
    cfg = bench.port_config(config)
    vocab = cfg.vocab
    n = traffic.cycle(mix)
    result = {"cell": cell["workload"]["name"], "seed": seed,
              "device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu")}
    with torch.inference_mode():
        params = weights.draw(params_struct(cfg), config["init"], seed,
                              device)
        steps = bench.port_steps(cfg, mix)
        serving.warm_up(steps, params, mix, seed, vocab, device)
        first = 0
        t0 = serving.now()
        serving.run_rounds(steps, params, mix, seed, vocab, device,
                           first=first, count=n)
        result["cycle_s"] = serving.now() - t0
        first += n
        cycles = []
        for record in ([False, True, True, False] * pairs)[:2 * pairs]:
            rounds, red = traced_cycle(
                lambda mark, f=first: serving.run_rounds(
                    steps, params, mix, seed, vocab, device, first=f,
                    count=n, mark=mark), device, record)
            first += n
            idle = collections.Counter()
            for name, t in red["idle_gaps"].items():
                idle[name.split(":")[0]] += t
            cycles.append(dict(recorded=record, window_s=red["window_s"],
                               busy_s=red["busy_s"],
                               device_events=red["device_events"],
                               idle_by_kind=dict(idle),
                               prefill_s=sum(r["prefill_s"] for r in rounds),
                               decode_s=sum(r["decode_s"] for r in rounds)))
            if record:
                recorded = red
        result["traced_cycles"] = cycles
        result["readings"] = {name: fn(recorded)
                              for name, fn in READERS.items()}
        result["counters"] = recorded["program_counters"]
        result["split_counters"] = _split_counters(
            steps, params, mix, seed, vocab, device, first)
        first += n
        result["checks"] = _decode_checks(steps, params, mix, seed, vocab,
                                          device, first)
    result["off_cost"] = _off_cost()
    result["trace"] = {k: recorded[k] for k in (
        "busy_s", "window_s", "device_events", "program_spans", "covered",
        "by_phase", "unmatched")}
    result["trace"]["idle_gaps"] = sorted(
        recorded["idle_gaps"].items(), key=lambda kv: -kv[1])
    result["trace"]["kernel_s"] = sorted(
        recorded["kernel_s"].items(), key=lambda kv: -kv[1])[:40]
    return result


def summary(result: dict) -> dict:
    """The result's headline numbers, for one line of output."""
    spans = result["trace"]["program_spans"]
    top = sorted(spans.items(), key=lambda kv: -kv[1]["device_s"])[:8]
    return {"cell": result["cell"], "seed": result["seed"],
            "readings": result["readings"],
            "covered": {k: v["in_program_s"] / v["device_s"]
                        if v["device_s"] else None
                        for k, v in result["trace"]["covered"].items()},
            "cycles": result["traced_cycles"],
            "top_device_s": [[k, v["device_s"]] for k, v in top],
            "checks": result["checks"], "off_cost": result["off_cost"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=1,
                    help="traced cycles without and with recording, each")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_profile: no CUDA card", file=sys.stderr)
        return 2
    result = profile_cell(spec.cell(args.workload), args.seed,
                          torch.device("cuda", 0), args.pairs)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / f"{args.workload}.json", "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(summary(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
