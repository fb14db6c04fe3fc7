"""Partitioned storage: one front over N child backends, and the gid-range
partition map it shares with the device mesh.

:class:`PartitionedStorage` routes every storage operation across its
children:

- records route by handle, ``h % n``: the owner of atom ``h`` holds its
  record, payload and incidence set;
- index entries route by a stable hash of the key (:func:`_key_part`);
  range scans and key enumeration merge every child's sorted answer;
- commit-batch barriers fan out to every child, one after another. Each
  child replays atomically to its own last barrier, so a crash between two
  children's barriers can leave one a commit ahead of another.

Children are any backend: memory for tests, native WAL stores for a
durable grid (``core/graph.py`` opens them under ``location``, with the
partition count recorded in ``partitions.json``). The storage grid does
not route by :class:`PartitionMap` (the JAX package's range routing and
``repartition`` have no caller and are not ported): the sharded snapshot
(``parallel/sharded``) derives its per-shard row ranges from the map, and
the sharded serving executor advertises it in ``/healthz``.
"""

from __future__ import annotations

import heapq
import zlib
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from hypergraphdb_tpu_torch.core.handles import HGHandle
from hypergraphdb_tpu_torch.storage.api import (
    HGBidirectionalIndex,
    HGSortedResultSet,
    StorageBackend,
)


def _key_part(key: bytes, n: int) -> int:
    """Stable partition of an index key (a content hash, not Python's
    ``hash``: it must agree across processes)."""
    return zlib.crc32(bytes(key)) % n


@dataclass(frozen=True)
class PartitionMap:
    """Contiguous gid-range ownership: the one partition map the device
    mesh and the serving tier read.

    The id space ``[0, capacity)`` splits into ``n_parts`` ranges of
    ``part_size`` ids each, ``part_size`` rounded up to ``align`` so a
    shard's packed frontier words stay whole. Ids at or past ``capacity``
    (atoms minted after the map was cut) clamp into the last range, so
    ownership is total at any moment. Frozen and hashable."""

    n_parts: int
    part_size: int       # ids per range, align-rounded
    capacity: int        # id space the map was cut for

    #: alignment of a shard's row range (whole packed words)
    ALIGN = 128

    @staticmethod
    def for_mesh(capacity: int, n_parts: int,
                 align: int = ALIGN) -> "PartitionMap":
        """The map of an ``n_parts``-way split of ``[0, capacity)``:
        ranges of ``ceil(capacity / (n_parts * align)) * align`` ids, the
        sharded snapshot's per-shard row range."""
        if n_parts < 1:
            raise ValueError("n_parts must be >= 1")
        capacity = max(int(capacity), 1)
        part_size = -(-capacity // (n_parts * align)) * align
        return PartitionMap(n_parts=int(n_parts), part_size=part_size,
                            capacity=capacity)

    def owner_of(self, gid: int) -> int:
        """The range owner of one gid (ids past the capacity clamp into the
        last range)."""
        if gid < 0:
            raise ValueError(f"negative gid {gid}")
        return min(int(gid) // self.part_size, self.n_parts - 1)

    def owner_np(self, gids: np.ndarray) -> np.ndarray:
        """:meth:`owner_of` over an array (int64)."""
        return np.minimum(
            np.asarray(gids, dtype=np.int64) // self.part_size,
            self.n_parts - 1,
        )

    def range_of(self, part: int) -> tuple[int, int]:
        """The ``[lo, hi)`` id range of one partition; the last range
        reaches at least the capacity (it owns every clamped id)."""
        lo = part * self.part_size
        hi = (lo + self.part_size if part < self.n_parts - 1
              else max(lo + self.part_size, self.capacity))
        return lo, hi

    def ranges(self) -> list:
        return [self.range_of(p) for p in range(self.n_parts)]

    def to_dict(self) -> dict:
        """The wire shape ``/healthz`` advertises."""
        return {
            "n_parts": self.n_parts,
            "part_size": self.part_size,
            "capacity": self.capacity,
            "ranges": [[lo, hi] for lo, hi in self.ranges()],
        }

    def repartitioned(self, capacity: int) -> "PartitionMap":
        """The same ``n_parts`` split re-cut for a grown id space."""
        return PartitionMap.for_mesh(capacity, self.n_parts)


class PartitionedIndex(HGBidirectionalIndex):
    """Key-routed view over the per-partition indices of one logical name."""

    def __init__(self, children: list[HGBidirectionalIndex]):
        self._children = children

    def _owner(self, key: bytes) -> HGBidirectionalIndex:
        return self._children[_key_part(key, len(self._children))]

    # -- single-key ops route to the owner ------------------------------------
    def add_entry(self, key: bytes, value: HGHandle) -> None:
        self._owner(key).add_entry(key, value)

    def remove_entry(self, key: bytes, value: HGHandle) -> None:
        self._owner(key).remove_entry(key, value)

    def remove_all_entries(self, key: bytes) -> None:
        self._owner(key).remove_all_entries(key)

    def find(self, key: bytes) -> HGSortedResultSet:
        return self._owner(key).find(key)

    def find_first(self, key: bytes) -> Optional[HGHandle]:
        return self._owner(key).find_first(key)

    def count(self, key: bytes) -> int:
        return self._owner(key).count(key)

    # -- whole-index ops merge across partitions -------------------------------
    def key_count(self) -> int:
        return sum(c.key_count() for c in self._children)

    def scan_keys(self) -> Iterator[bytes]:
        # each child scans in sorted order; k-way merge keeps the global
        # sorted-key contract range scans rely on
        yield from heapq.merge(*(c.scan_keys() for c in self._children))

    def scan_values(self) -> Iterator[HGHandle]:
        for c in self._children:
            yield from c.scan_values()

    def bulk_items(self, lo=None):
        yield from heapq.merge(
            *(c.bulk_items(lo) for c in self._children), key=lambda kv: kv[0]
        )

    def find_range(
        self,
        lo: Optional[bytes] = None,
        hi: Optional[bytes] = None,
        lo_inclusive: bool = True,
        hi_inclusive: bool = False,
    ) -> HGSortedResultSet:
        parts = [
            c.find_range(lo, hi, lo_inclusive, hi_inclusive).array()
            for c in self._children
        ]
        parts = [p for p in parts if len(p)]
        if not parts:
            return HGSortedResultSet(np.empty(0, dtype=np.int64))
        return HGSortedResultSet(np.unique(np.concatenate(parts)))

    def find_lt(self, key: bytes) -> HGSortedResultSet:
        return self.find_range(hi=key, hi_inclusive=False)

    def find_lte(self, key: bytes) -> HGSortedResultSet:
        return self.find_range(hi=key, hi_inclusive=True)

    def find_gt(self, key: bytes) -> HGSortedResultSet:
        return self.find_range(lo=key, lo_inclusive=False)

    def find_gte(self, key: bytes) -> HGSortedResultSet:
        return self.find_range(lo=key, lo_inclusive=True)

    def find_by_value(self, value: HGHandle) -> list[bytes]:
        keys: list[bytes] = []
        for c in self._children:
            keys.extend(c.find_by_value(value))
        return sorted(set(keys))

    def count_keys(self, value: HGHandle) -> int:
        return len(self.find_by_value(value))


class PartitionedStorage(StorageBackend):
    """Handle-routed record storage + key-routed indices over N children."""

    def __init__(
        self,
        partitions: Sequence[StorageBackend] = (),
        n_partitions: int = 4,
        factory: Optional[Callable[[int], StorageBackend]] = None,
    ):
        if partitions:
            self._parts = list(partitions)
        else:
            if factory is None:
                from hypergraphdb_tpu_torch.storage.memstore import MemStorage

                factory = lambda i: MemStorage()  # noqa: E731
            self._parts = [factory(i) for i in range(n_partitions)]
        if not self._parts:
            raise ValueError("need at least one partition")

    # -- lifecycle --------------------------------------------------------------
    def startup(self) -> None:
        for p in self._parts:
            p.startup()

    def shutdown(self) -> None:
        for p in self._parts:
            p.shutdown()

    def checkpoint(self) -> None:
        for p in self._parts:
            p.checkpoint()

    def commit_batch_begin(self) -> None:
        for p in self._parts:
            p.commit_batch_begin()

    def commit_batch_end(self) -> None:
        for p in self._parts:
            p.commit_batch_end()

    def commit_batch_abort(self) -> None:
        for p in self._parts:
            p.commit_batch_abort()

    # -- record routing ---------------------------------------------------------
    def _own(self, h: HGHandle) -> StorageBackend:
        return self._parts[int(h) % len(self._parts)]

    def store_link(self, h: HGHandle, targets: Sequence[HGHandle]) -> None:
        self._own(h).store_link(h, targets)

    def get_link(self, h: HGHandle):
        return self._own(h).get_link(h)

    def remove_link(self, h: HGHandle) -> None:
        self._own(h).remove_link(h)

    def contains_link(self, h: HGHandle) -> bool:
        return self._own(h).contains_link(h)

    def store_data(self, h: HGHandle, data: bytes) -> None:
        self._own(h).store_data(h, data)

    def get_data(self, h: HGHandle) -> Optional[bytes]:
        return self._own(h).get_data(h)

    def remove_data(self, h: HGHandle) -> None:
        self._own(h).remove_data(h)

    def contains_data(self, h: HGHandle) -> bool:
        return self._own(h).contains_data(h)

    def add_incidence_link(self, atom: HGHandle, link: HGHandle) -> None:
        self._own(atom).add_incidence_link(atom, link)

    def remove_incidence_link(self, atom: HGHandle, link: HGHandle) -> None:
        self._own(atom).remove_incidence_link(atom, link)

    def remove_incidence_set(self, atom: HGHandle) -> None:
        self._own(atom).remove_incidence_set(atom)

    def get_incidence_set(self, atom: HGHandle) -> HGSortedResultSet:
        return self._own(atom).get_incidence_set(atom)

    def incidence_count(self, atom: HGHandle) -> int:
        return self._own(atom).incidence_count(atom)

    # -- indices ----------------------------------------------------------------
    def get_index(self, name: str, create: bool = True):
        children = []
        for p in self._parts:
            idx = p.get_index(name, create=create)
            if idx is None:
                return None
            children.append(idx)
        return PartitionedIndex(children)

    def remove_index(self, name: str) -> None:
        for p in self._parts:
            p.remove_index(name)

    def index_names(self) -> list[str]:
        names: set[str] = set()
        for p in self._parts:
            names.update(p.index_names())
        return sorted(names)

    # -- bulk export ------------------------------------------------------------
    def bulk_links(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Concatenate the partitions' record tables, re-sorted to the
        id-ascending order the snapshot packer expects."""
        ids_l, offs_l, flats_l = [], [], []
        for p in self._parts:
            ids, offsets, flat = p.bulk_links()
            ids_l.append(np.asarray(ids, dtype=np.int64))
            offs_l.append(np.asarray(offsets, dtype=np.int64))
            flats_l.append(np.asarray(flat, dtype=np.int64))
        total_ids = np.concatenate(ids_l) if ids_l else np.empty(0, np.int64)
        if not len(total_ids):
            return total_ids, np.zeros(1, np.int64), np.empty(0, np.int64)
        # vectorized global re-sort (this is the snapshot-pack hot path):
        # permute record lengths by id order, then gather each record's
        # flat slice via repeat/offset arithmetic — no per-record python
        all_lens = np.concatenate(
            [o[1:] - o[:-1] for o in offs_l]
        ).astype(np.int64)
        # rebase starts into the concatenated flat array
        flat_cat = (
            np.concatenate(flats_l) if flats_l else np.empty(0, np.int64)
        )
        base = 0
        rebased = []
        for o, f in zip(offs_l, flats_l):
            rebased.append(o[:-1].astype(np.int64) + base)
            base += len(f)
        all_starts = np.concatenate(rebased)
        order = np.argsort(total_ids, kind="stable")
        out_ids = total_ids[order]
        lens = all_lens[order]
        starts = all_starts[order]
        out_offsets = np.zeros(len(out_ids) + 1, dtype=np.int64)
        np.cumsum(lens, out=out_offsets[1:])
        total = int(lens.sum())
        if total:
            idx = np.repeat(
                starts - np.concatenate([[0], np.cumsum(lens)[:-1]]), lens
            ) + np.arange(total, dtype=np.int64)
            out_flat = flat_cat[idx]
        else:
            out_flat = np.empty(0, np.int64)
        return out_ids, out_offsets, out_flat

    def max_handle(self) -> int:
        return max(p.max_handle() for p in self._parts)
