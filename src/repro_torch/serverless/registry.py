"""Function registry: the Fn-style catalog of deployable functions.

A :class:`FunctionDef` is deliberately tiny — the subsystem reproduces the
paper's *control/data-plane* claims, so what matters per function is its
resource envelope (MR working set), its service time, and the payload it
emits to the next stage of a chain. ``handler`` hooks let tests inject
real byte-transforming logic (the chain verifies payload bytes end to
end, not just timings).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

#: handler(payload bytes-array) -> output bytes-array (numpy uint8)
Handler = Callable[[np.ndarray], np.ndarray]


def _passthrough(payload: np.ndarray) -> np.ndarray:
    return payload


@dataclasses.dataclass(frozen=True)
class FunctionDef:
    """One deployable function."""
    name: str
    #: service time of the function body itself (everything that is NOT
    #: fork / control plane / data plane — kept small on purpose: the
    #: paper's point is that transfer dominates short functions)
    compute_us: float = 50.0
    #: registered working-set size (qreg_mr'd at container bring-up)
    mr_bytes: int = 64 * 1024
    #: payload bytes this function emits for the next stage (chains); a
    #: handler may emit a different size — this is the planning hint
    out_bytes: int = 1024
    #: byte transform applied to the incoming payload (identity default)
    handler: Handler = _passthrough


class FunctionRegistry:
    """name -> FunctionDef, plus chain composition."""

    def __init__(self) -> None:
        self._fns: Dict[str, FunctionDef] = {}

    def register(self, fn: FunctionDef) -> FunctionDef:
        if fn.name in self._fns:
            raise ValueError(f"function {fn.name!r} already registered")
        self._fns[fn.name] = fn
        return fn

    def get(self, name: str) -> FunctionDef:
        if name not in self._fns:
            raise KeyError(f"unknown function {name!r}")
        return self._fns[name]

    def names(self) -> List[str]:
        return sorted(self._fns)

    def chain(self, *names: str) -> List[FunctionDef]:
        """Resolve a pipeline A->B->C; validates every stage exists."""
        if not names:
            raise ValueError("empty chain")
        return [self.get(n) for n in names]


def default_registry(payload_bytes: int = 1024,
                     compute_us: float = 50.0) -> FunctionRegistry:
    """The ServerlessBench-TestCase5-style three-stage demo app used by
    the benchmarks/examples: extract -> transform -> load."""
    reg = FunctionRegistry()

    def _xor(tag: int) -> Handler:
        def h(payload: np.ndarray) -> np.ndarray:
            return (payload ^ np.uint8(tag)).astype(np.uint8)
        return h

    for i, name in enumerate(("extract", "transform", "load")):
        reg.register(FunctionDef(
            name=name, compute_us=compute_us, out_bytes=payload_bytes,
            mr_bytes=max(64 * 1024, 4 * payload_bytes),
            handler=_xor(i + 1)))
    return reg
