"""A bounded, thread-safe LRU cache for loaded atoms and incidence
arrays, and the memory watcher that clears such caches when the process
grows past a threshold."""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Generic, Hashable, Optional, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")

_MISSING = object()


class LRUCache(Generic[K, V]):
    """Bounded LRU. Every access takes the lock: a ``move_to_end`` racing
    an eviction on another thread would raise."""

    __slots__ = ("_d", "_lock", "capacity", "hits", "misses")

    def __init__(self, capacity: int = 1 << 16):
        self._d: OrderedDict[K, V] = OrderedDict()
        self._lock = threading.Lock()
        self.capacity = capacity
        self.hits = 0
        self.misses = 0

    def get(self, key: K, default: Any = None) -> Optional[V]:
        with self._lock:
            v = self._d.get(key, _MISSING)
            if v is _MISSING:
                self.misses += 1
                return default
            self._d.move_to_end(key)
            self.hits += 1
            return v

    def put(self, key: K, value: V) -> None:
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)

    def invalidate(self, key: K) -> None:
        with self._lock:
            self._d.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: K) -> bool:
        return key in self._d


class MemoryWarningSystem:
    """Clears caches when the process's resident set passes a threshold.

    Listeners are shrink callbacks; :meth:`check_now` reads the resident
    set from ``/proc/self/statm`` and calls each of them when it is over
    ``threshold_bytes``. A daemon thread polls every ``interval_s``.

    Nothing is dropped quietly: a listener that raises is counted in
    ``listener_errors`` (and ``cache.memwatch_listener_errors`` of
    ``metrics``, where given) with the last exception kept in
    ``last_error``, and the other listeners still run; a sweep that raises
    is counted in ``sweep_errors`` (``cache.memwatch_sweep_errors``) and
    the thread goes on polling.
    """

    def __init__(self, threshold_bytes: int, interval_s: float = 5.0,
                 metrics=None):
        self.threshold_bytes = int(threshold_bytes)
        self.interval_s = interval_s
        self.metrics = metrics
        self._listeners: list = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.triggered = 0
        self.listener_errors = 0
        self.sweep_errors = 0
        self.last_error: Optional[BaseException] = None

    def add_listener(self, fn) -> None:
        self._listeners.append(fn)

    @staticmethod
    def rss_bytes() -> int:
        """The current resident set in bytes; 0 where ``/proc`` has none
        (a lifetime peak would latch the watcher on once tripped)."""
        import os

        try:
            with open("/proc/self/statm") as f:
                pages = int(f.read().split()[1])
        except OSError:
            return 0
        return pages * os.sysconf("SC_PAGE_SIZE")

    def _count(self, what: str, err: BaseException) -> None:
        self.last_error = err
        if what == "listener":
            self.listener_errors += 1
        else:
            self.sweep_errors += 1
        if self.metrics is not None:
            self.metrics.incr(f"cache.memwatch_{what}_errors")

    def check_now(self) -> bool:
        """Fire the listeners if over the threshold; whether it fired."""
        if self.threshold_bytes <= 0:
            return False
        if self.rss_bytes() <= self.threshold_bytes:
            return False
        self.triggered += 1
        for fn in list(self._listeners):
            try:
                fn()
            except Exception as e:  # noqa: BLE001 - counted, not dropped
                self._count("listener", e)
        return True

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.check_now()
                except Exception as e:  # noqa: BLE001 - the watch outlives it
                    self._count("sweep", e)

        self._thread = threading.Thread(target=loop, name="hgdb-memwatch",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
