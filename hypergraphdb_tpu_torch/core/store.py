"""HGStore — the transaction-aware store façade.

The one object through which the graph talks to storage: link records,
value payloads, incidence sets and named indexes, every read and write
routed through the current transaction's overlay (read-your-writes, reads
at the transaction's begin, commit-time validation; ``tx/manager.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from hypergraphdb_tpu_torch.core.handles import HGHandle
from hypergraphdb_tpu_torch.storage.api import (
    HGBidirectionalIndex,
    HGIndex,
    HGSortedResultSet,
    StorageBackend,
)
from hypergraphdb_tpu_torch.tx.manager import (
    _TOMBSTONE,
    HGTransactionManager,
    _IdxDelta,
    _IncDelta,
)
from hypergraphdb_tpu_torch.utils.cache import LRUCache


def _merge_overlay(base: np.ndarray, deltas: list, wiped_attr: str
                   ) -> np.ndarray:
    """``base`` with the transaction chain's set deltas (innermost first in
    ``deltas``) applied outermost first; ``wiped_attr`` names the flag that
    empties the set."""
    added: set[int] = set()
    removed: set[int] = set()
    wiped = False
    for d in reversed(deltas):
        if getattr(d, wiped_attr):
            wiped, added, removed = True, set(), set()
        added |= d.added
        added -= d.removed
        removed |= d.removed
        removed -= d.added
    vals = set() if wiped else set(base.tolist())
    vals -= removed
    vals |= added
    return np.asarray(sorted(vals), dtype=np.int64)


class HGStore:
    def __init__(self, backend: StorageBackend, txman: HGTransactionManager,
                 incidence_cache_entries: int = 0,
                 max_cached_incidence_set_size: int = 0):
        self.backend = backend
        self.tx = txman
        # (cell version, read-only array) per atom: version-checked, so
        # invalidation is free
        self._inc_cache = (LRUCache(incidence_cache_entries)
                           if incidence_cache_entries > 0 else None)
        self._inc_cache_max = max_cached_incidence_set_size

    def _committed_incidence(self, atom: int, sv: Optional[int]
                             ) -> np.ndarray:
        """The committed incidence array of ``atom`` at snapshot ``sv``
        (None = latest), through the LRU where it can. A miss goes through
        the MVCC reconstruction pinned at the observed version: a raw
        backend read racing a commit's apply could pair the new array with
        the old version."""
        cache = self._inc_cache
        ver = self.tx.cell_version(("inc", atom))
        if cache is not None and (sv is None or ver <= sv):
            hit = cache.get(atom)
            if hit is not None and hit[0] == ver:
                return hit[1]
        arr = self.tx.inc_at(atom, sv if sv is not None else ver)
        if (cache is not None and len(arr) <= self._inc_cache_max
                and (sv is None or ver <= sv)
                and self.tx.cell_version(("inc", atom)) == ver):
            arr.setflags(write=False)  # shared across readers
            cache.put(atom, (ver, arr))
        return arr

    # ---- links ----------------------------------------------------------
    def store_link(self, h: HGHandle, targets: Sequence[HGHandle]) -> None:
        tx = self.tx.current()
        if tx is None:
            self.backend.store_link(h, targets)
        else:
            tx.links[int(h)] = tuple(int(t) for t in targets)

    def get_link(self, h: HGHandle) -> Optional[tuple[HGHandle, ...]]:
        h = int(h)
        tx = self.tx.current()
        while tx is not None:
            if h in tx.links:
                v = tx.links[h]
                return None if v is _TOMBSTONE else v
            tx = tx.parent
        cur = self.tx.current()
        if cur is None:
            return self.backend.get_link(h)
        cur.note_read(("link", h))
        return self.tx.link_at(h, cur.start_version)

    def remove_link(self, h: HGHandle) -> None:
        tx = self.tx.current()
        if tx is None:
            self.backend.remove_link(int(h))
        else:
            tx.links[int(h)] = _TOMBSTONE

    def contains_link(self, h: HGHandle) -> bool:
        return self.get_link(h) is not None

    # ---- data -----------------------------------------------------------
    def store_data(self, h: HGHandle, data: bytes) -> None:
        tx = self.tx.current()
        if tx is None:
            self.backend.store_data(int(h), data)
        else:
            tx.data[int(h)] = bytes(data)

    def get_data(self, h: HGHandle) -> Optional[bytes]:
        h = int(h)
        tx = self.tx.current()
        while tx is not None:
            if h in tx.data:
                v = tx.data[h]
                return None if v is _TOMBSTONE else v
            tx = tx.parent
        cur = self.tx.current()
        if cur is None:
            return self.backend.get_data(h)
        cur.note_read(("data", h))
        return self.tx.data_at(h, cur.start_version)

    def remove_data(self, h: HGHandle) -> None:
        tx = self.tx.current()
        if tx is None:
            self.backend.remove_data(int(h))
        else:
            tx.data[int(h)] = _TOMBSTONE

    # ---- incidence ------------------------------------------------------
    def add_incidence_link(self, atom: HGHandle, link: HGHandle) -> None:
        tx = self.tx.current()
        if tx is None:
            self.backend.add_incidence_link(int(atom), int(link))
        else:
            tx.inc.setdefault(int(atom), _IncDelta()).add(int(link))

    def remove_incidence_link(self, atom: HGHandle, link: HGHandle) -> None:
        tx = self.tx.current()
        if tx is None:
            self.backend.remove_incidence_link(int(atom), int(link))
        else:
            tx.inc.setdefault(int(atom), _IncDelta()).remove(int(link))

    def remove_incidence_set(self, atom: HGHandle) -> None:
        tx = self.tx.current()
        if tx is None:
            self.backend.remove_incidence_set(int(atom))
        else:
            tx.inc.setdefault(int(atom), _IncDelta()).clear()

    def get_incidence_set(self, atom: HGHandle) -> HGSortedResultSet:
        atom = int(atom)
        tx = self.tx.current()
        if tx is not None:
            tx.note_read(("inc", atom))
            base = self._committed_incidence(atom, tx.start_version)
        else:
            base = self._committed_incidence(atom, None)
        deltas = []
        t = tx
        while t is not None:
            d = t.inc.get(atom)
            if d is not None:
                deltas.append(d)
            t = t.parent
        if not deltas:
            return HGSortedResultSet(base)
        return HGSortedResultSet(_merge_overlay(base, deltas, "cleared"))

    def incidence_count(self, atom: HGHandle) -> int:
        return len(self.get_incidence_set(atom))

    # ---- indexes --------------------------------------------------------
    def get_index(self, name: str, create: bool = True
                  ) -> Optional["TxIndexView"]:
        idx = self.backend.get_index(name, create=create)
        if idx is None:
            return None
        return TxIndexView(self, name, idx)

    def remove_index(self, name: str) -> None:
        self.backend.remove_index(name)

    def index_names(self) -> list[str]:
        return self.backend.index_names()


class TxIndexView(HGBidirectionalIndex):
    """A transaction-aware view over a backend index."""

    def __init__(self, store: HGStore, name: str, backing: HGIndex):
        self.name = name
        self._store = store
        self._backing = backing

    def _tx(self):
        return self._store.tx.current()

    def _delta(self, tx, key: bytes, value: Optional[int]) -> _IdxDelta:
        key = bytes(key)
        if value is not None:
            tx.idx_by_value.setdefault((self.name, value), set()).add(key)
        return tx.idx.setdefault((self.name, key), _IdxDelta())

    def add_entry(self, key: bytes, value: HGHandle) -> None:
        tx = self._tx()
        if tx is None:
            self._backing.add_entry(key, int(value))
        else:
            self._delta(tx, key, int(value)).add(int(value))

    def remove_entry(self, key: bytes, value: HGHandle) -> None:
        tx = self._tx()
        if tx is None:
            self._backing.remove_entry(key, int(value))
        else:
            self._delta(tx, key, int(value)).remove(int(value))

    def remove_all_entries(self, key: bytes) -> None:
        tx = self._tx()
        if tx is None:
            self._backing.remove_all_entries(key)
        else:
            d = self._delta(tx, key, None)
            d.added.clear()
            d.removed.clear()
            d.removed_all = True
            tx.idx_wiped.setdefault(self.name, set()).add(bytes(key))

    def _deltas_for(self, key: bytes) -> list[_IdxDelta]:
        out = []
        t = self._tx()
        while t is not None:
            d = t.idx.get((self.name, key))
            if d is not None:
                out.append(d)
            t = t.parent
        return out

    def find(self, key: bytes) -> HGSortedResultSet:
        key = bytes(key)
        tx = self._tx()
        if tx is not None:
            tx.note_read(("idx", self.name, key))
            base = self._store.tx.idx_at(self.name, key, tx.start_version)
        else:
            base = self._backing.find(key).array()
        deltas = self._deltas_for(key)
        if not deltas:
            return HGSortedResultSet(base)
        return HGSortedResultSet(_merge_overlay(base, deltas, "removed_all"))

    def count(self, key: bytes) -> int:
        """``len(find(key))``; a key this transaction chain has not
        written is counted without building its array."""
        key = bytes(key)
        tx = self._tx()
        if tx is None:
            return self._backing.count(key)
        if self._deltas_for(key):
            return len(self.find(key))
        tx.note_read(("idx", self.name, key))
        return self._store.tx.idx_count_at(self.name, key, tx.start_version)

    def key_count(self) -> int:
        return self._backing.key_count()

    def _touched_keys(self, tx, keep) -> set[bytes]:
        """Keys of this index to re-read through :meth:`find`: the ones the
        transaction chain wrote and the ones other commits moved past the
        transaction's snapshot, filtered by ``keep``."""
        touched: set[bytes] = set()
        t = tx
        while t is not None:
            for (nm, k), d in t.idx.items():
                if (nm == self.name and keep(k)
                        and (d.added or d.removed or d.removed_all)):
                    touched.add(k)
            t = t.parent
        touched.update(k for k in self._store.tx.idx_keys_changed_since(
            self.name, tx.start_version) if keep(k))
        return touched

    def scan_keys(self):
        tx = self._tx()
        touched = (set() if tx is None
                   else self._touched_keys(tx, lambda k: True))
        if not touched:
            yield from self._backing.scan_keys()
            return
        seen = set()
        for k in self._backing.scan_keys():
            seen.add(k)
            if k not in touched or len(self.find(k)):
                yield k
        for k in sorted(touched - seen):
            if len(self.find(k)):
                yield k

    def find_range(self, lo: Optional[bytes] = None,
                   hi: Optional[bytes] = None, lo_inclusive: bool = True,
                   hi_inclusive: bool = False) -> HGSortedResultSet:
        base = self._backing.find_range(lo, hi, lo_inclusive,
                                        hi_inclusive).array()
        tx = self._tx()
        if tx is None:
            return HGSortedResultSet(base)

        def in_range(k: bytes) -> bool:
            if lo is not None and (k < lo or (k == lo and not lo_inclusive)):
                return False
            return hi is None or k < hi or (k == hi and hi_inclusive)

        touched = self._touched_keys(tx, in_range)
        if not touched:
            return HGSortedResultSet(base)
        vals = set(base.tolist())
        for k in touched:
            committed = set(self._backing.find(k).array().tolist())
            merged = set(self.find(k).array().tolist())
            vals -= committed - merged
            vals |= merged
        return HGSortedResultSet(np.asarray(sorted(vals), dtype=np.int64))

    def count_range(self, lo: Optional[bytes] = None,
                    hi: Optional[bytes] = None, lo_inclusive: bool = True,
                    hi_inclusive: bool = False,
                    cap: Optional[int] = None) -> int:
        """``len(find_range(...))`` clamped to ``cap``: the backend's own
        count when no key in the range differs from what this transaction
        reads (one ordered scan of the range, not of every key), else the
        merged range's size."""
        tx = self._tx()
        if tx is not None:
            def in_range(k: bytes) -> bool:
                if lo is not None and (k < lo or (k == lo and not lo_inclusive)):
                    return False
                return hi is None or k < hi or (k == hi and hi_inclusive)

            if self._touched_keys(tx, in_range):
                n = len(self.find_range(lo, hi, lo_inclusive, hi_inclusive))
                return n if cap is None else min(n, cap)
        return self._backing.count_range(lo, hi, lo_inclusive, hi_inclusive,
                                         cap)

    def find_by_value(self, value: HGHandle) -> list[bytes]:
        """The keys holding ``value``: the backend's, then each level of
        the transaction chain from the innermost out, through the levels'
        (index, value) maps, so a lookup costs the keys that name the
        value, not every key the transaction wrote."""
        value = int(value)
        keys = set(self._backing.find_by_value(value))
        t = self._tx()
        while t is not None:
            cand = t.idx_by_value.get((self.name, value), set())
            wiped = t.idx_wiped.get(self.name)
            for k in (cand | wiped) if wiped else cand:
                d = t.idx.get((self.name, k))
                if d is None:
                    continue
                if value in d.added:
                    keys.add(k)
                elif value in d.removed or d.removed_all:
                    keys.discard(k)
            t = t.parent
        return sorted(keys)
