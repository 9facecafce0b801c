"""Minimal discrete-event simulation engine (microsecond clock).

A small simpy-like kernel used by the simulated RDMA fabric. Processes are
Python generators that yield events:

  * ``Timeout(us)``      — resume after ``us`` microseconds.
  * ``resource.acquire()`` — FIFO resource with ``capacity`` slots.
  * ``store.get()``      — blocking FIFO queue (message channels).
  * another ``Process``  — join (resume when it finishes; its return value
                           is delivered via StopIteration).

The engine is deterministic: ties are broken by insertion order.
"""

from __future__ import annotations

import heapq
import itertools
from collections import deque
from typing import Any, Callable, Deque, Generator, List, Optional, Tuple


class Event:
    """A one-shot event that processes can wait on."""

    __slots__ = ("env", "_value", "_done", "_waiters", "callbacks")

    def __init__(self, env: "Environment"):
        self.env = env
        self._value: Any = None
        self._done = False
        self._waiters: List["Process"] = []
        self.callbacks: List[Callable[["Event"], None]] = []

    @property
    def triggered(self) -> bool:
        return self._done

    @property
    def value(self) -> Any:
        return self._value

    def succeed(self, value: Any = None) -> "Event":
        if self._done:
            raise RuntimeError("event already triggered")
        self._value = value
        self._done = True
        for cb in self.callbacks:
            cb(self)
        for proc in self._waiters:
            self.env._schedule(0.0, proc, value)
        self._waiters.clear()
        return self

    def _wait(self, proc: "Process") -> None:
        if self._done:
            self.env._schedule(0.0, proc, self._value)
        else:
            self._waiters.append(proc)


class Timeout(Event):
    __slots__ = ("delay",)

    def __init__(self, env: "Environment", delay: float):
        super().__init__(env)
        if delay < 0:
            raise ValueError(f"negative timeout {delay}")
        self.delay = float(delay)

    def _wait(self, proc: "Process") -> None:
        self.env._schedule(self.delay, proc, None)


class Process(Event):
    """Wraps a generator; itself an Event that fires when the gen returns."""

    __slots__ = ("gen", "name")

    def __init__(self, env: "Environment", gen: Generator, name: str = "?"):
        super().__init__(env)
        self.gen = gen
        self.name = name
        env._schedule(0.0, self, None)

    def _step(self, send_value: Any) -> None:
        try:
            target = self.gen.send(send_value)
        except StopIteration as stop:
            self.succeed(stop.value)
            return
        if not isinstance(target, Event):
            raise TypeError(
                f"process {self.name!r} yielded non-event {target!r}")
        target._wait(self)


class Environment:
    """Event loop with a float microsecond clock."""

    def __init__(self) -> None:
        self.now: float = 0.0
        self._heap: List[Tuple[float, int, Process, Any]] = []
        self._counter = itertools.count()

    # -- scheduling ------------------------------------------------------
    def _schedule(self, delay: float, proc: Process, value: Any) -> None:
        heapq.heappush(
            self._heap, (self.now + delay, next(self._counter), proc, value))

    def process(self, gen: Generator, name: str = "?") -> Process:
        return Process(self, gen, name)

    def timeout(self, delay_us: float) -> Timeout:
        return Timeout(self, delay_us)

    def event(self) -> Event:
        return Event(self)

    # -- run loops -------------------------------------------------------
    def run(self, until: Optional[float] = None) -> float:
        """Run until the heap drains (or the clock passes ``until``)."""
        while self._heap:
            t, _, proc, value = self._heap[0]
            if until is not None and t > until:
                self.now = until
                return self.now
            heapq.heappop(self._heap)
            self.now = t
            proc._step(value)
        return self.now

    def run_process(self, gen: Generator, name: str = "?") -> Any:
        """Convenience: spawn ``gen``, run to completion, return its value."""
        proc = self.process(gen, name)
        self.run()
        if not proc.triggered:
            raise RuntimeError(f"process {name!r} deadlocked")
        return proc.value


class Resource:
    """FIFO resource with ``capacity`` concurrent slots (e.g. NIC cmd unit)."""

    __slots__ = ("env", "capacity", "_in_use", "_queue", "name")

    def __init__(self, env: Environment, capacity: int = 1, name: str = "?"):
        self.env = env
        self.capacity = capacity
        self._in_use = 0
        self._queue: Deque[Event] = deque()
        self.name = name

    def acquire(self) -> Event:
        ev = self.env.event()
        if self._in_use < self.capacity:
            self._in_use += 1
            ev.succeed()
        else:
            self._queue.append(ev)
        return ev

    def release(self) -> None:
        if self._queue:
            self._queue.popleft().succeed()
        else:
            self._in_use -= 1

    def serve(self, service_us: float) -> Generator:
        """acquire -> hold ``service_us`` -> release (generator helper)."""
        yield self.acquire()
        try:
            yield self.env.timeout(service_us)
        finally:
            self.release()

    @property
    def queue_len(self) -> int:
        return len(self._queue)


class Broadcast:
    """Edge-triggered broadcast notifier (the completion-channel analogue).

    Unlike :class:`Store` — where one ``put`` wakes exactly one getter —
    a ``poke`` wakes EVERY currently-subscribed event: the shape of a
    hardware completion event (``ibv_req_notify_cq``), where any number
    of blocked consumers of a shared CQ must all observe the edge.

    ``stat_pokes`` is monotonic, so a consumer can answer "anything new
    since I last looked?" with a plain integer compare — no event, no
    syscall. Lost-wakeup-free blocking is the standard arm-then-check
    dance: subscribe an event FIRST, re-check the condition (the poke
    counters), and only then yield the event; a poke landing between
    subscribe and yield triggers the event, which resumes immediately.
    """

    __slots__ = ("env", "_waiters", "stat_pokes")

    def __init__(self, env: Environment):
        self.env = env
        self._waiters: List[Event] = []
        self.stat_pokes = 0

    def subscribe(self, ev: Event) -> Event:
        self._waiters.append(ev)
        return ev

    def poke(self) -> None:
        self.stat_pokes += 1
        if self._waiters:
            waiters, self._waiters = self._waiters, []
            for ev in waiters:
                if not ev.triggered:
                    ev.succeed()


class Store:
    """Unbounded FIFO message channel."""

    __slots__ = ("env", "_items", "_getters")

    def __init__(self, env: Environment):
        self.env = env
        self._items: Deque[Any] = deque()
        self._getters: Deque[Event] = deque()

    def put(self, item: Any) -> None:
        if self._getters:
            self._getters.popleft().succeed(item)
        else:
            self._items.append(item)

    def get(self) -> Event:
        ev = self.env.event()
        if self._items:
            ev.succeed(self._items.popleft())
        else:
            self._getters.append(ev)
        return ev

    def __len__(self) -> int:
        return len(self._items)
