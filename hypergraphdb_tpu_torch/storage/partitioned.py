"""The gid-range partition map of the partitioned store and the mesh.

The port of :class:`PartitionMap` from
``hypergraphdb_tpu/storage/partitioned.py`` (:53 onwards). The sharded
snapshot (``parallel/sharded``) derives its per-shard row ranges from it
and the sharded serving executor advertises it in ``/healthz``. The
partitioned storage backend of the same file is not ported yet (ROADMAP
queue 1, item 2).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class PartitionMap:
    """Contiguous gid-range ownership: the one partition map the storage
    grid, the device mesh and the serving tier all read.

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
