"""Parse collective traffic out of optimized (post-SPMD) HLO text (the
counterpart of ``repro/launch/hlo_stats.py``, a plain-Python copy).

A compiler's cost analysis gives FLOPs and HBM bytes but not collective
traffic, so we sum the operand/result sizes of every collective op in a
module and convert to *per-device link bytes* with ring-algorithm factors
(:func:`link_bytes`, which the port's dry run also applies to the
collectives it counts on its fake process group):

  op                    bytes on the busiest link (size N = result bytes)
  all-reduce            2N (reduce-scatter + all-gather phases)
  all-gather            N * (k-1)/k  ~ N
  reduce-scatter        N_input * (k-1)/k ~ N_input
  all-to-all            N * (k-1)/k  ~ N
  collective-permute    N

(k = replica-group size, parsed from the op when available.)
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\([^)]*\)|[\w\[\],{}\s/]+?)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(-start|-done)?\b")
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def link_bytes(op: str, nbytes: int, k: int) -> float:
    """Bytes over the busiest link of one ``op`` (an HLO collective name)
    whose result is ``nbytes``, in a group of ``k`` ranks (0 or 1: unknown
    or one rank, taken as factor 1), by the ring factors above."""
    frac = (k - 1) / k if k > 1 else 1.0
    if op == "all-reduce":
        return 2.0 * nbytes * frac
    if op in ("all-gather", "all-to-all"):
        return nbytes * frac
    if op == "reduce-scatter":
        # result is the scattered shard; input = result * k
        return nbytes * (k if k > 1 else 1) * frac
    if op == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective {op!r}")


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    result_bytes: Dict[str, int]
    link_bytes: float              # per-device bytes over the busiest link

    def total_result_bytes(self) -> int:
        return sum(self.result_bytes.values())


def collective_stats(hlo_text: str) -> CollectiveStats:
    counts: Dict[str, int] = {c: 0 for c in _COLLECTIVES}
    result_bytes: Dict[str, int] = {c: 0 for c in _COLLECTIVES}
    link = 0.0
    for line in hlo_text.splitlines():
        m = _OP_RE.match(line)
        if not m:
            continue
        shape_str, op, phase = m.group(1), m.group(2), m.group(3)
        if phase == "-done":
            continue                    # counted at -start
        nbytes = _shape_bytes(shape_str)
        counts[op] += 1
        result_bytes[op] += nbytes
        gm = _GROUPS_RE.search(line)
        link += link_bytes(op, nbytes, int(gm.group(2)) if gm else 0)
    return CollectiveStats(counts=counts, result_bytes=result_bytes,
                           link_bytes=link)
