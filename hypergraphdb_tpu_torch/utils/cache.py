"""A bounded, thread-safe LRU cache for loaded atoms and incidence
arrays."""

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
