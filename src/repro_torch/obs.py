"""Spans and counters inside the port's serving path, for a profiler run.

``span(name)`` is a ``torch.profiler.record_function`` range while
recording is on, so that the program's spans land in the same trace as the
device's kernels, on one clock: a device operation belongs to the innermost
span open on the launching thread when its launch was issued (its
``correlation`` id ties the two). While recording is off ``span`` returns
one shared no-op context: it builds no ``record_function`` and enters no
profiler op, so the serving path pays a function call and a ``with`` a span.

``count(name, value)`` adds an int, or the sum of a device tensor, into a
tally. A tensor's sum stays on its device, one of the tally's partial sums
until the recording ends: no host read, no sync, and no launch beyond the
sum's own. That is one reduction (and a memset where it spans several
blocks) for a tensor of a number type; a bool tensor adds a cast, so a
caller that has the mask as numbers passes those. The sum is taken in the
tensor's dtype and must be exact there: a float32 0/1 mask of fewer than
2**24 elements is. While recording is off it does nothing.

``recording()`` turns both on for the block it wraps and, on exit, reads
every tally to the host once: ``with recording() as tallies:`` leaves a dict
of ints in ``tallies``. Nothing else turns recording on: no environment
variable, no config field. Recordings do not nest.

Span names are dotted, with no ``:`` and no ``/``: the benchmark's own spans
are ``<kind>:<prompt length>``, and an idle gap inside a program span is
named ``<benchmark span>/<program span>``
(``tools/span_profile.py`` reduces a trace so, by launch).

The spans of the port (``tools/span_profile.py`` reads each as device and
idle time by module: its self time, what no nested span covers):

- ``model.prefill``, ``model.decode_step``: ``models/model.py``'s
  ``prefill`` and ``decode_step``, the whole call. ``decode_launches`` and
  ``decode_busy_ms`` read the device work launched inside
  ``model.decode_step``, over its calls;
- ``model.embed``: ``embed``, the token lookup;
- ``model.head``: ``unembed_chunk``, the float32 head with its weight
  cast (in ``decode_step`` the final norm too);
- ``layer``: one layer body of ``run_dense_full`` / ``run_dense_decode``
  and ``run_ssm_full`` / ``run_ssm_decode``; its norms and residual adds
  are its self time;
- ``attn.qkv``, ``attn.core``, ``attn.cache_write``, ``attn.out``:
  ``models/blocks.py``'s ``qkv_project`` (with rope), the ``attention`` /
  ``decode_attention`` call, the decode step's two ``write_at``,
  ``attn_out``;
- ``kv.collect``: ``run_dense_full``'s stack of K/V and
  ``_kv_cache_from``'s padding to ``max_len``;
- ``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``:
  ``models/moe.py``'s ``_route`` (with the aux loss), the slot table and
  the gather, ``_expert_ffn``, the weighting and ``_combine``;
- ``rwkv.time_mix``, ``rwkv.wkv``, ``rwkv.channel_mix``:
  ``models/rwkv6.py``'s ``time_mix`` (around the scan), ``wkv_chunked`` /
  ``wkv_decode``, ``channel_mix``;
- ``ssm.state_collect``: ``run_ssm_full``'s stack of the layers' states;
- ``obs.count``: a tensor's sum in ``count``, the device work that
  recording itself adds.

The counters (tallies of one recording; ``moe_ffn_gather``, each call):

- ``moe.choices``: T * K (token, choice) pairs routed;
- ``moe.kept``: the pairs that found a capacity slot (``keep``'s sum, as
  the float32 mask the dispatch builds anyway: one reduction, no cast);
  ``moe.choices - moe.kept`` were dropped by capacity;
- ``moe.slots``: E * C, the rows handed to the expert GEMMs.
  ``moe_slot_use`` = ``moe.kept / moe.slots``.

The port's two launch counters, host-side and always on, stay where they
are: ``kernels/_build.launches`` (launches by C entry point; the
benchmark's ``launches`` lines and ``wkv_split_roofline``) and
``kernels/flash_attention/flash_attention.launches_by_shape``
(``flash_mma_roofline``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional

import torch

_OFF = contextlib.nullcontext()


class _Tallies:
    """One recording's tallies: host ints, and partial sums (0-d tensors,
    one a call) that stay on their device until the recording ends."""

    def __init__(self):
        self.host: Dict[str, int] = {}
        self.device: Dict[str, List[torch.Tensor]] = {}

    def add(self, name: str, value) -> None:
        if isinstance(value, torch.Tensor):
            with torch.profiler.record_function("obs.count"):
                self.device.setdefault(name, []).append(value.detach().sum())
        else:
            self.host[name] = self.host.get(name, 0) + int(value)

    def read(self) -> Dict[str, int]:
        out = dict(self.host)
        if self.device:
            sums = torch.stack([torch.stack(p).to(torch.int64).sum()
                                for p in self.device.values()])
            for name, v in zip(self.device, sums.tolist()):
                out[name] = out.get(name, 0) + v
        return out


_recording: Optional[_Tallies] = None


def span(name: str):
    """A ``record_function(name)`` range while recording, else one shared
    no-op context."""
    if _recording is None:
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, value) -> None:
    """Add ``value`` (an int, or a tensor whose elements are summed on its
    device) into the tally ``name`` while recording; else nothing."""
    if _recording is not None:
        _recording.add(name, value)


@contextlib.contextmanager
def recording() -> Iterator[Dict[str, int]]:
    """Spans and counters on for the block; the dict it yields holds every
    tally, read to the host once, when the block ends."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a recording is already open")
    tallies: Dict[str, int] = {}
    _recording = rec = _Tallies()
    try:
        yield tallies
    finally:
        _recording = None
    tallies.update(rec.read())
