"""The storage contract every backend implements.

Handles are dense ints, index keys are order-preserving bytes (memcmp is
the one comparator), and a backend holds committed state only: buffering
and validation live in ``tx/manager.py`` above it. Every read that feeds a
snapshot comes out in bulk as numpy arrays (``bulk_links``,
``bulk_items``), the pack's fast path. A backend is single-writer: the
transaction manager serialises commit application.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from hypergraphdb_tpu_torch.core.handles import HGHandle


class HGSortedResultSet:
    """A sorted, random-access result over int64 handles, backed by a
    sorted numpy array."""

    __slots__ = ("_a",)

    def __init__(self, sorted_array: np.ndarray):
        self._a = np.asarray(sorted_array, dtype=np.int64)

    def array(self) -> np.ndarray:
        return self._a

    def __len__(self) -> int:
        return len(self._a)

    def __iter__(self) -> Iterator[int]:
        return iter(self._a.tolist())

    def __contains__(self, h: int) -> bool:
        i = np.searchsorted(self._a, h)
        return i < len(self._a) and self._a[i] == h

    EMPTY: "HGSortedResultSet"


HGSortedResultSet.EMPTY = HGSortedResultSet(np.empty(0, dtype=np.int64))


class HGIndex:
    """A named sorted index: bytes key → sorted set of int64 values (keys
    are order-preserving bytes)."""

    name: str

    def add_entry(self, key: bytes, value: HGHandle) -> None:
        raise NotImplementedError

    def remove_entry(self, key: bytes, value: HGHandle) -> None:
        raise NotImplementedError

    def remove_all_entries(self, key: bytes) -> None:
        raise NotImplementedError

    def find(self, key: bytes) -> HGSortedResultSet:
        raise NotImplementedError

    def find_first(self, key: bytes) -> Optional[HGHandle]:
        rs = self.find(key)
        return int(rs.array()[0]) if len(rs) else None

    def count(self, key: bytes) -> int:
        return len(self.find(key))

    def key_count(self) -> int:
        raise NotImplementedError

    def scan_keys(self) -> Iterator[bytes]:
        raise NotImplementedError

    def scan_values(self) -> Iterator[HGHandle]:
        for k in self.scan_keys():
            yield from self.find(k)

    def bulk_items(self, lo: Optional[bytes] = None
                   ) -> Iterator[tuple[bytes, np.ndarray]]:
        """``(key, sorted int64 array)`` pairs in key order from the first
        key >= ``lo``: the pack's path."""
        for k in self.scan_keys():
            if lo is not None and k < lo:
                continue
            yield k, self.find(k).array()

    def count_range(self, lo: Optional[bytes] = None,
                    hi: Optional[bytes] = None, lo_inclusive: bool = True,
                    hi_inclusive: bool = False,
                    cap: Optional[int] = None) -> int:
        """Entries (not keys) in the key range, exact up to ``cap`` and
        clamped to it: the planner's cardinality of a range scan."""
        n = 0
        for k, hs in self.bulk_items(lo=lo):
            if lo is not None and not lo_inclusive and k == lo:
                continue
            if hi is not None and (k > hi or (k == hi and not hi_inclusive)):
                break
            n += len(hs)
            if cap is not None and n >= cap:
                return cap
        return n

    def find_range(self, lo: Optional[bytes] = None,
                   hi: Optional[bytes] = None, lo_inclusive: bool = True,
                   hi_inclusive: bool = False) -> HGSortedResultSet:
        """The union of the values of every key in the range."""
        raise NotImplementedError

    def find_lt(self, key: bytes) -> HGSortedResultSet:
        return self.find_range(hi=key, hi_inclusive=False)

    def find_lte(self, key: bytes) -> HGSortedResultSet:
        return self.find_range(hi=key, hi_inclusive=True)

    def find_gt(self, key: bytes) -> HGSortedResultSet:
        return self.find_range(lo=key, lo_inclusive=False)

    def find_gte(self, key: bytes) -> HGSortedResultSet:
        return self.find_range(lo=key, lo_inclusive=True)

    def find_by_value(self, value: HGHandle) -> list[bytes]:
        """The keys that hold ``value``, sorted."""
        raise NotImplementedError

    def count_keys(self, value: HGHandle) -> int:
        return len(self.find_by_value(value))


class StorageBackend:
    """Committed-state store: link records, data payloads, incidence sets
    and named indexes. Only the transaction manager mutates it."""

    def startup(self) -> None: ...
    def shutdown(self) -> None: ...

    def commit_batch_begin(self) -> None:
        """Start of one transaction's mutations (a durability marker;
        no-op in memory)."""

    def commit_batch_end(self) -> None:
        """Seal the commit batch."""

    def commit_batch_abort(self) -> None:
        """Mark the open commit batch failed."""

    def store_link(self, h: HGHandle, targets: Sequence[HGHandle]) -> None:
        raise NotImplementedError

    def get_link(self, h: HGHandle) -> Optional[tuple[HGHandle, ...]]:
        raise NotImplementedError

    def remove_link(self, h: HGHandle) -> None:
        raise NotImplementedError

    def contains_link(self, h: HGHandle) -> bool:
        return self.get_link(h) is not None

    def store_data(self, h: HGHandle, data: bytes) -> None:
        raise NotImplementedError

    def get_data(self, h: HGHandle) -> Optional[bytes]:
        raise NotImplementedError

    def remove_data(self, h: HGHandle) -> None:
        raise NotImplementedError

    def add_incidence_link(self, atom: HGHandle, link: HGHandle) -> None:
        raise NotImplementedError

    def remove_incidence_link(self, atom: HGHandle, link: HGHandle) -> None:
        raise NotImplementedError

    def remove_incidence_set(self, atom: HGHandle) -> None:
        raise NotImplementedError

    def get_incidence_set(self, atom: HGHandle) -> HGSortedResultSet:
        raise NotImplementedError

    def incidence_count(self, atom: HGHandle) -> int:
        return len(self.get_incidence_set(atom))

    def get_index(self, name: str, create: bool = True
                  ) -> Optional[HGIndex]:
        raise NotImplementedError

    def remove_index(self, name: str) -> None:
        raise NotImplementedError

    def index_names(self) -> list[str]:
        raise NotImplementedError

    def bulk_links(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(link_ids, target_offsets, flat_targets)`` over all records,
        ids ascending: ``flat_targets[target_offsets[i]:target_offsets[i +
        1]]`` is record ``link_ids[i]``."""
        raise NotImplementedError

    def max_handle(self) -> int:
        """One past the largest handle the store holds."""
        raise NotImplementedError
