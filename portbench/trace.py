"""The traced cycle: one pass over the mix's lengths under
``torch.profiler``, after the measured window, reduced to what the
per-layer readers and ``breakdown`` need.

Busy time is the union of the device's kernel and copy spans (the reduction
of the port's ``chip_smoke.profile_busy``, copied); the traced window is
the host's wall time of the cycle, ending in a synchronize. The device's
idle time inside the host's spans is put to the spans the host was in
meanwhile (``<span>:<prompt length>``).
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

from .serving import now, sync

SPAN_KINDS = ("inputs", "prefill", "sample", "decode")


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _split(gaps, spans, starts, a, b):
    """Add the idle interval [a, b) to ``gaps`` by the host spans it
    overlaps (``spans`` sorted and disjoint, ``starts`` their starts);
    time in no span counts as ``other``."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    t = a
    while t < b and i < len(spans):
        s0, s1, name = spans[i]
        if s1 <= t:
            i += 1
            continue
        end = min(max(s0, t), b)
        if end > t:
            gaps["other"] += (end - t) / 1e6
            t = end
            continue
        end = min(s1, b)
        gaps[name] += (end - t) / 1e6
        t = end
        i += 1
    if t < b:
        gaps["other"] += (b - t) / 1e6


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def reduce_events(events) -> dict:
    """Busy time, kernel time by name and idle gaps by host span, in
    seconds, from the events of a Chrome trace the profiler wrote (each
    with ``cat``, ``name``, ``ts`` and ``dur`` in microseconds)."""
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        if e.get("cat") in DEVICE_CATS:
            device.append(span)
        elif e.get("cat") == "user_annotation" \
                and e["name"].split(":")[0] in SPAN_KINDS:
            host.append(span)
    host.sort()
    merged = _union((a, b) for a, b, _ in device)
    busy_us = sum(b - a for a, b in merged)
    by_name = collections.Counter()
    for a, b, name in device:
        by_name[name] += (b - a) / 1e6
    gaps = collections.Counter()
    starts = [a for a, _, _ in host]
    if host:
        edges = [[host[0][0], host[0][0]], *merged,
                 [max(b for _, b, _ in host)] * 2]
        for (_, end), (start, _) in zip(edges, edges[1:]):
            if start > end:
                _split(gaps, host, starts, end, start)
    return dict(busy_s=busy_us / 1e6, kernel_s=dict(by_name),
                idle_gaps=dict(gaps), device_events=len(device))


def traced(fn, device):
    """Run ``fn(mark)`` under the profiler, ``mark`` naming host spans.
    Returns (fn's result, the reduced trace with ``window_s``). The trace
    goes through a Chrome trace file in the temporary directory, removed
    once read."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = now()
        out = fn(record_function)
        sync(device)
        window_s = now() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    red = reduce_events(events)
    red["window_s"] = window_s
    return out, red


def breakdown(red: dict, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle time
    by host span, each at most ``top`` entries of [name, seconds]."""
    ops = sorted(red["kernel_s"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(red["idle_gaps"].items(), key=lambda kv: -kv[1])[:top]
    return dict(device_ops=[[n[:120], s] for n, s in ops],
                idle_gaps=[[n, s] for n, s in gaps])
