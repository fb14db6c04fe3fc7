"""Counters, gauges and timers of one graph: plain dicts under a lock.

The graph's transaction manager, snapshot path and snapshot manager bump
them (``tx.commits``, ``graph.mutations``, ``compact.passes``,
``compact.full_uploads``, ...); :data:`global_metrics` is the process's. A timer keeps ``(count, total seconds,
max seconds)`` per name.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager


class Metrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: dict[str, int] = {}
        self.gauges: dict[str, float] = {}
        self.timings: dict[str, tuple[int, float, float]] = {}

    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            n, total, top = self.timings.get(name, (0, 0.0, 0.0))
            self.timings[name] = (n + 1, total + seconds, max(top, seconds))

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)


#: the process-wide metrics (the fault registry's ``fault.injected``)
global_metrics = Metrics()
