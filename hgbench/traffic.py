"""The one traffic generator: what a mix file's parameters and ``--seed``
give, as plain numpy draws. The program only ever sees the draws.

Every draw comes from its own stream, ``stream(seed, *keys)``, so one
seed gives the same graph, the same request seeds and the same sample in
every run, whatever else a run draws or how far its window gets.
"""

from __future__ import annotations

import numpy as np

#: stream keys: the graph, the warm-up requests, the timed requests, the
#: sample of answers the reference checks, the lanes of a batch whose
#: whole reach sets it checks, and the served answers kept
GRAPH, WARM, REQUESTS, SAMPLE, SETS, KEEP = 0, 1, 2, 4, 5, 6


def stream(seed: int, *keys: int) -> np.random.Generator:
    """A generator for one purpose of one run. ``seed`` is any whole
    number (folded into 64 bits)."""
    return np.random.default_rng([int(seed) % (1 << 64), *keys])


def batch_seeds(seed: int, batch: int, n: int, lo: int, hi: int,
                key: int = REQUESTS) -> np.ndarray:
    """Batch ``batch`` of ``n`` BFS seeds drawn uniformly from ids
    ``[lo, hi)``: each batch a new draw, the same for one seed."""
    return stream(seed, key, batch).integers(lo, hi, size=n).astype(np.int32)


class Requests:
    """Single-request seeds from ``[lo, hi)``, taken one at a time in the
    order of one stream however many a window takes."""

    BLOCK = 1 << 16

    def __init__(self, seed: int, lo: int, hi: int, key: int = REQUESTS):
        self.r, self.lo, self.hi = stream(seed, key), lo, hi
        self.pool: list = []

    def next(self) -> int:
        if not self.pool:
            self.pool = self.r.integers(self.lo, self.hi,
                                        self.BLOCK).tolist()[::-1]
        return self.pool.pop()

    def take(self, n: int) -> np.ndarray:
        return np.asarray([self.next() for _ in range(n)], dtype=np.int64)


def sample(seed: int, n_total: int, n: int, key: int = SAMPLE
           ) -> np.ndarray:
    """Sorted indices of ``n`` of ``n_total`` answers (all when fewer)."""
    if n_total <= n:
        return np.arange(n_total)
    return np.sort(stream(seed, key).choice(n_total, size=n, replace=False))


def spread_lanes(seed: int, width: int, group: int, per_group: int,
                 key: int) -> np.ndarray:
    """``per_group`` distinct lanes drawn in every ``group`` lanes of a
    ``width``-lane batch, so each block of lanes that the program handles
    apart (a warp's 32, a line's 1,024) has some checked."""
    r = stream(seed, key)
    group = min(group, width)
    per = min(per_group, group)
    return np.concatenate([
        g + np.sort(r.choice(min(group, width - g), size=min(
            per, width - g), replace=False))
        for g in range(0, width, group)]).astype(np.int64)
