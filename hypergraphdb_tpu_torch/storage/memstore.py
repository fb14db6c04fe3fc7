"""The in-memory storage backend: dicts for records and payloads, sorted
containers for incidence sets and index keys.

The sorted containers are the port's own (``utils/sortedshim.py``): the
card's machine has no ``sortedcontainers``. Incidence sets and index value
sets keep a cached sorted numpy array, so repeated reads (the pack, joins)
are O(1) after the first.
"""

from __future__ import annotations

import itertools
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

from hypergraphdb_tpu_torch.core.handles import HGHandle
from hypergraphdb_tpu_torch.storage.api import (
    HGBidirectionalIndex,
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


def _sorted_union(parts: list) -> np.ndarray:
    """The sorted distinct values of several sorted arrays: one sort and a
    neighbour compare (``np.unique`` may hash instead, several times
    slower on a range of millions of handles)."""
    a = np.sort(np.concatenate(parts), kind="stable")
    if len(a) > 1:
        a = a[np.concatenate(([True], a[1:] != a[:-1]))]
    return a


class MemIndex(HGBidirectionalIndex):
    """bytes key → sorted handle set. The inverse map (handle → keys) that
    :meth:`find_by_value` reads is built on its first call and kept from
    then on, so an index nobody asks by value pays nothing for it.

    The build may run beside a writer (a reader outside the commit lock):
    it holds ``_vk_lock`` with ``_building`` set, and a writer that finds
    no map yet but a build under way waits for it and patches the new map
    (:meth:`_inverse_for_write`), so no entry written during a build is
    lost from the map."""

    def __init__(self, name: str):
        self.name = name
        self._kv: SortedDict = SortedDict()      # bytes -> _SortedHandleSet
        self._vk: Optional[dict[int, set[bytes]]] = None  # handle -> keys
        self._vk_lock = threading.Lock()
        self._building = False

    def _inverse_for_write(self) -> Optional[dict[int, set[bytes]]]:
        """The inverse map a writer must patch after changing ``_kv``, or
        None when there is none and no build is under way (a later build
        reads the change from ``_kv``)."""
        # ``_building`` first: a build sets ``_vk`` before it clears
        # ``_building``, so a writer that saw neither changed ``_kv``
        # before the build began, and the build reads the change
        building = self._building
        vk = self._vk
        if vk is not None or not building:
            return vk
        with self._vk_lock:
            return self._vk

    def add_entry(self, key: bytes, value: HGHandle) -> None:
        s = self._kv.get(key)
        if s is None:
            s = self._kv[key] = _SortedHandleSet()
        s.add(value)
        vk = self._inverse_for_write()
        if vk is not None:
            vk.setdefault(value, set()).add(key)

    @staticmethod
    def _drop_inverse(vk: dict, key: bytes, value: int) -> None:
        ks = vk.get(value)
        if ks is not None:
            ks.discard(key)
            if not ks:
                del vk[value]

    def remove_entry(self, key: bytes, value: HGHandle) -> None:
        s = self._kv.get(key)
        if s is not None:
            s.discard(value)
            if not len(s):
                del self._kv[key]
        vk = self._inverse_for_write()
        if vk is not None:
            self._drop_inverse(vk, key, value)

    def remove_all_entries(self, key: bytes) -> None:
        s = self._kv.pop(key, None)
        vk = self._inverse_for_write() if s is not None else None
        if vk is not None:
            for v in s.snapshot().tolist():
                self._drop_inverse(vk, key, v)

    def find(self, key: bytes) -> HGSortedResultSet:
        s = self._kv.get(key)
        if s is None:
            return HGSortedResultSet.EMPTY
        return HGSortedResultSet(s.snapshot())

    def count(self, key: bytes) -> int:
        s = self._kv.get(key)
        return 0 if s is None else len(s)

    def key_count(self) -> int:
        return len(self._kv)

    def scan_keys(self) -> Iterator[bytes]:
        return iter(self._kv)

    def find_range(self, lo: Optional[bytes] = None,
                   hi: Optional[bytes] = None, lo_inclusive: bool = True,
                   hi_inclusive: bool = False) -> HGSortedResultSet:
        keys = self._kv.irange(lo, hi, (lo_inclusive, hi_inclusive))
        parts = [self._kv[k].snapshot() for k in keys]
        if not parts:
            return HGSortedResultSet.EMPTY
        return HGSortedResultSet(_sorted_union(parts))

    def count_range(self, lo: Optional[bytes] = None,
                    hi: Optional[bytes] = None, lo_inclusive: bool = True,
                    hi_inclusive: bool = False,
                    cap: Optional[int] = None) -> int:
        n = 0
        for k in self._kv.irange(lo, hi, (lo_inclusive, hi_inclusive)):
            n += len(self._kv[k])
            if cap is not None and n >= cap:
                return cap
        return n

    def find_by_value(self, value: HGHandle) -> list[bytes]:
        vk = self._vk
        if vk is None:
            with self._vk_lock:
                vk = self._vk
                if vk is None:
                    self._building = True
                    try:
                        vk = {}
                        for k in self._kv:
                            hs = self._kv.get(k)
                            for v in (() if hs is None
                                      else hs.snapshot().tolist()):
                                vk.setdefault(v, set()).add(k)
                        self._vk = vk
                    finally:
                        self._building = False
        return sorted(vk.get(int(value), ()))

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

    def startup(self) -> None:
        pass

    def shutdown(self) -> None:
        pass

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

    def remove_index(self, name: str) -> None:
        self._indices.pop(name, None)

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

    def iter_record_handles(self) -> set:
        """Every handle this backend holds a record of (a link, a payload
        or an incidence set): what ``PartitionedStorage.repartition`` walks
        to find the records whose owner changed."""
        return set(self._links) | set(self._data) | set(self._incidence)

    def max_handle(self) -> int:
        m = -1
        for table in (self._links, self._data, self._incidence):
            if table:
                m = max(m, max(table))
        return m + 1
