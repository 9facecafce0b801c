"""The executable pool of the elastic runtime (the counterpart of the pure
Python part of ``repro/elastic/runtime.py``: ``PoolEntry`` and
``ExecutablePool``, copied).

In JAX the pool caches compiled ``jit`` executables. PyTorch runs eagerly,
so the port's serving workers store the plain step callable; the pool's
``get`` / ``put`` / ``specialize_async`` semantics (the paper's hybrid
pool: a generic entry now, a specialised one built in the background) are
unchanged.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple


# =========================================================== executable pool
@dataclasses.dataclass
class PoolEntry:
    value: Any
    kind: str                  # "generic" | "specialized"
    compile_s: float
    uses: int = 0


class ExecutablePool:
    """Compiled-executable cache with background specialization.

    ``get(key)`` never blocks on compilation: it returns a generic entry
    (coarsened key) when the exact one is missing, and (optionally) kicks
    off a background specialize — exactly the DCQP-now / RCQP-later policy
    of the paper's hybrid pool.
    """

    def __init__(self, coarsen: Callable[[Any], Any] = lambda k: None,
                 max_entries: int = 64):
        self._entries: Dict[Any, PoolEntry] = {}
        self._lock = threading.Lock()
        self._inflight: Dict[Any, threading.Thread] = {}
        self._coarsen = coarsen
        self.max_entries = max_entries
        self.stat_hits = 0
        self.stat_generic_hits = 0
        self.stat_misses = 0

    def put(self, key, value, kind="specialized", compile_s=0.0):
        with self._lock:
            if len(self._entries) >= self.max_entries:
                lru = min(self._entries.items(), key=lambda kv: kv[1].uses)
                del self._entries[lru[0]]
            self._entries[key] = PoolEntry(value, kind, compile_s)

    def get(self, key) -> Tuple[str, Optional[Any]]:
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                ent.uses += 1
                self.stat_hits += 1
                return ent.kind, ent.value
            coarse = self._coarsen(key)
            ent = self._entries.get(coarse)
            if ent is not None:
                ent.uses += 1
                self.stat_generic_hits += 1
                return "generic", ent.value
            self.stat_misses += 1
            return "miss", None

    def specialize_async(self, key, builder: Callable[[], Any]) -> None:
        """Background compile (never on the caller's critical path)."""
        with self._lock:
            if key in self._entries or key in self._inflight:
                return

        def work():
            t0 = time.time()
            value = builder()
            self.put(key, value, "specialized", time.time() - t0)
            with self._lock:
                self._inflight.pop(key, None)

        t = threading.Thread(target=work, daemon=True)
        with self._lock:
            self._inflight[key] = t
        t.start()

    def wait_all(self) -> None:
        for t in list(self._inflight.values()):
            t.join()
