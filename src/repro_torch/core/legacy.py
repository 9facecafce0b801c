"""DEPRECATED client helpers over the raw queue syscalls (a copy of
``repro/core/legacy.py`` over the port's ``core``).

Application code should use the session layer
(:mod:`repro_torch.core.session`: ``connect`` / ``Session`` / ``Future`` /
``listen``) instead of driving ``KRCoreModule.sys_q*`` directly. These
thin pass-throughs keep the old client idiom importable, for code that
measures the raw syscall surface itself and for out-of-tree scripts.

Importing this module emits a single :class:`DeprecationWarning`.
"""

from __future__ import annotations

import warnings
from typing import Generator, List, Optional

from .fabric import MemoryRegion
from .qp import WorkRequest

warnings.warn(
    "repro_torch.core.legacy: the raw sys_q* client helpers are "
    "deprecated — use the session layer (repro_torch.core.connect / Session / Future)",
    DeprecationWarning, stacklevel=2)


def qpush(module, qd: int, wr_list: List[WorkRequest]) -> Generator:
    """DEPRECATED: one syscall crossing, caller-controlled signaling."""
    return (yield from module.sys_qpush(qd, wr_list))


def qpush_batch(module, qd: int, wr_list: List[WorkRequest],
                signal_interval: Optional[int] = None) -> Generator:
    """DEPRECATED: the batched push (Session plans this for you now)."""
    return (yield from module.qpush_batch(qd, wr_list,
                                          signal_interval=signal_interval))


def qpop(module, qd: int) -> Generator:
    """DEPRECATED: non-blocking pop of one CompEntry."""
    return (yield from module.sys_qpop(qd))


def qpop_batch(module, qd: int, max_n: int = 64) -> Generator:
    """DEPRECATED: bulk pop."""
    return (yield from module.qpop_batch(qd, max_n=max_n))


def qpop_block(module, qd: int, poll_us: float = 0.2) -> Generator:
    """DEPRECATED: spin until one completion arrives."""
    return (yield from module.qpop_block(qd, poll_us=poll_us))


def qpop_batch_block(module, qd: int, n: int,
                     poll_us: float = 0.2) -> Generator:
    """DEPRECATED: spin until exactly ``n`` completions arrive."""
    return (yield from module.qpop_batch_block(qd, n, poll_us=poll_us))


def qpush_recv(module, qd: int, mr: MemoryRegion, offset: int, length: int,
               wr_id: int) -> Generator:
    """DEPRECATED: post a receive buffer (Listener leases these now)."""
    return (yield from module.sys_qpush_recv(qd, mr, offset, length, wr_id))


def qpop_msgs(module, qd: int, max_n: Optional[int] = None) -> Generator:
    """DEPRECATED: poll received messages (Listener.recv replaces this)."""
    return (yield from module.sys_qpop_msgs(qd, max_n=max_n))
