"""Atom identity: dense integer handles and their factories.

An atom id indexes host tables and the snapshot's CSR arrays directly.
The sequential factory hands out ids in order, and the order is part of a
result: the same operations must give the same handles in this package and
in the JAX package, or their packed snapshots cannot be compared. UUIDs
are an optional exchange alias mapped to dense ids.
"""

from __future__ import annotations

import threading
import uuid

#: a handle is a plain non-negative int; -1 is the null handle, the CSR
#: arrays' padding sentinel
HGHandle = int

NULL_HANDLE: HGHandle = -1


class HandleFactory:
    """Allocates fresh handles."""

    def make(self) -> HGHandle:
        raise NotImplementedError

    def make_many(self, n: int) -> range:
        """``n`` contiguous handles (the bulk ingest path)."""
        raise NotImplementedError

    @property
    def null_handle(self) -> HGHandle:
        return NULL_HANDLE

    def reset(self, next_id: int) -> None:
        """Fast-forward the allocator past ``next_id``."""
        raise NotImplementedError


class SequentialHandleFactory(HandleFactory):
    """Dense sequential ids, the default. Thread-safe."""

    def __init__(self, start: int = 0):
        self._lock = threading.Lock()
        self._next = start

    def make(self) -> HGHandle:
        with self._lock:
            h = self._next
            self._next += 1
            return h

    def make_many(self, n: int) -> range:
        with self._lock:
            first = self._next
            self._next += n
            return range(first, first + n)

    def reset(self, next_id: int) -> None:
        with self._lock:
            if next_id > self._next:
                self._next = next_id

    @property
    def peek(self) -> int:
        """The next id this factory would hand out."""
        return self._next


class UUIDHandleFactory(HandleFactory):
    """Dense ids plus a bidirectional UUID alias table."""

    def __init__(self, start: int = 0):
        self._seq = SequentialHandleFactory(start)
        self._lock = threading.Lock()
        self._to_uuid: dict[int, uuid.UUID] = {}
        self._from_uuid: dict[uuid.UUID, int] = {}

    def make(self) -> HGHandle:
        h = self._seq.make()
        u = uuid.uuid4()
        with self._lock:
            self._to_uuid[h] = u
            self._from_uuid[u] = h
        return h

    def make_many(self, n: int) -> range:
        r = self._seq.make_many(n)
        with self._lock:
            for h in r:
                u = uuid.uuid4()
                self._to_uuid[h] = u
                self._from_uuid[u] = h
        return r

    def reset(self, next_id: int) -> None:
        self._seq.reset(next_id)

    def uuid_of(self, h: HGHandle) -> uuid.UUID | None:
        return self._to_uuid.get(h)
