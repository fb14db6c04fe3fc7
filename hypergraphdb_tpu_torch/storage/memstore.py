"""The in-memory storage backend: dicts for records and payloads, sorted
containers for incidence sets and index keys.

The sorted containers are the port's own (``utils/sortedshim.py``): the
card's machine has no ``sortedcontainers``. Incidence sets and index value
sets keep a cached sorted numpy array, so repeated reads (the pack, joins)
are O(1) after the first.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

import numpy as np

from hypergraphdb_tpu_torch.core.handles import HGHandle
from hypergraphdb_tpu_torch.storage.api import (
    HGIndex,
    HGSortedResultSet,
    StorageBackend,
)
from hypergraphdb_tpu_torch.utils.sortedshim import SortedDict, SortedList


class _SortedHandleSet:
    """A mutable sorted set of int64 handles with a cached numpy array."""

    __slots__ = ("_sl", "_snap")

    def __init__(self) -> None:
        self._sl = SortedList()
        self._snap: Optional[np.ndarray] = None

    def add(self, h: int) -> None:
        if h not in self._sl:
            self._sl.add(h)
            self._snap = None

    def discard(self, h: int) -> None:
        try:
            self._sl.remove(h)
            self._snap = None
        except ValueError:
            pass

    def snapshot(self) -> np.ndarray:
        if self._snap is None:
            self._snap = np.fromiter(self._sl, dtype=np.int64,
                                     count=len(self._sl))
        return self._snap

    def __len__(self) -> int:
        return len(self._sl)

    def __contains__(self, h: int) -> bool:
        return h in self._sl


class MemIndex(HGIndex):
    """bytes key → sorted handle set."""

    def __init__(self, name: str):
        self.name = name
        self._kv: SortedDict = SortedDict()      # bytes -> _SortedHandleSet

    def add_entry(self, key: bytes, value: HGHandle) -> None:
        s = self._kv.get(key)
        if s is None:
            s = self._kv[key] = _SortedHandleSet()
        s.add(value)

    def remove_entry(self, key: bytes, value: HGHandle) -> None:
        s = self._kv.get(key)
        if s is not None:
            s.discard(value)
            if not len(s):
                del self._kv[key]

    def remove_all_entries(self, key: bytes) -> None:
        self._kv.pop(key, None)

    def find(self, key: bytes) -> HGSortedResultSet:
        s = self._kv.get(key)
        if s is None:
            return HGSortedResultSet.EMPTY
        return HGSortedResultSet(s.snapshot())

    def bulk_items(self, lo=None):
        keys = self._kv.irange(minimum=lo) if lo is not None else self._kv
        for k in keys:
            yield k, self._kv[k].snapshot()


class MemStorage(StorageBackend):
    def __init__(self) -> None:
        self._links: dict[int, tuple[int, ...]] = {}
        self._data: dict[int, bytes] = {}
        self._incidence: dict[int, _SortedHandleSet] = {}
        self._indices: dict[str, MemIndex] = {}

    def store_link(self, h: HGHandle, targets: Sequence[HGHandle]) -> None:
        self._links[h] = tuple(int(t) for t in targets)

    def get_link(self, h: HGHandle) -> Optional[tuple[HGHandle, ...]]:
        return self._links.get(h)

    def remove_link(self, h: HGHandle) -> None:
        self._links.pop(h, None)

    def store_data(self, h: HGHandle, data: bytes) -> None:
        self._data[h] = bytes(data)

    def get_data(self, h: HGHandle) -> Optional[bytes]:
        return self._data.get(h)

    def remove_data(self, h: HGHandle) -> None:
        self._data.pop(h, None)

    def add_incidence_link(self, atom: HGHandle, link: HGHandle) -> None:
        s = self._incidence.get(atom)
        if s is None:
            s = self._incidence[atom] = _SortedHandleSet()
        s.add(link)

    def remove_incidence_link(self, atom: HGHandle, link: HGHandle) -> None:
        s = self._incidence.get(atom)
        if s is not None:
            s.discard(link)
            if not len(s):
                del self._incidence[atom]

    def remove_incidence_set(self, atom: HGHandle) -> None:
        self._incidence.pop(atom, None)

    def get_incidence_set(self, atom: HGHandle) -> HGSortedResultSet:
        s = self._incidence.get(atom)
        if s is None:
            return HGSortedResultSet.EMPTY
        return HGSortedResultSet(s.snapshot())

    def get_index(self, name: str, create: bool = True
                  ) -> Optional[MemIndex]:
        idx = self._indices.get(name)
        if idx is None and create:
            idx = self._indices[name] = MemIndex(name)
        return idx

    def index_names(self) -> list[str]:
        return sorted(self._indices)

    def bulk_links(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        ids = sorted(self._links)
        recs = [self._links[i] for i in ids]
        lengths = np.fromiter(map(len, recs), dtype=np.int64,
                              count=len(recs))
        offsets = np.zeros(len(ids) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        flat = np.fromiter(itertools.chain.from_iterable(recs),
                           dtype=np.int64, count=int(offsets[-1]))
        return np.asarray(ids, dtype=np.int64), offsets, flat

    def max_handle(self) -> int:
        m = -1
        for table in (self._links, self._data, self._incidence):
            if table:
                m = max(m, max(table))
        return m + 1
