"""The numpy host BFS that device results are checked against.

The port's copy of ``host_bfs_vectorized`` from the reference benchmark
(``bench.py``): frontier BFS with vectorized CSR gathers, one seed at a time.
It returns each seed's reach set and edge count rather than a rate, and it
dedups with a bitmap over the id space instead of ``np.unique``, which keeps
a hop linear in the rows it touches at 10M-atom scale.
"""

from __future__ import annotations

import numpy as np


def gather_ragged(flat: np.ndarray, starts: np.ndarray,
                  lens: np.ndarray) -> np.ndarray:
    """Concatenation of the rows ``flat[s:s+l]``."""
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=flat.dtype)
    idx = np.repeat(
        starts - np.concatenate([[0], np.cumsum(lens)[:-1]]), lens
    ) + np.arange(total)
    return flat[idx]


def _dedup(ids: np.ndarray, size: int) -> np.ndarray:
    mask = np.zeros(size, dtype=bool)
    mask[ids] = True
    return np.flatnonzero(mask)


def host_bfs(snap, seed: int, max_hops: int) -> tuple[np.ndarray, int]:
    """(sorted reached atom ids, seed included; incidence edges touched by
    the frontiers of every hop) for one seed: frontier atom → incident
    links → their targets."""
    n1 = snap.num_atoms + 1
    inc_off = snap.inc_offsets.astype(np.int64)
    tgt_off = snap.tgt_offsets.astype(np.int64)
    inc, tgt = snap.inc_links, snap.tgt_flat
    visited = np.zeros(n1, dtype=bool)
    visited[seed] = True
    frontier = np.asarray([seed], dtype=np.int64)
    edges = 0
    for _ in range(max_hops):
        starts = inc_off[frontier]
        lens = inc_off[frontier + 1] - starts
        edges += int(lens.sum())
        links = _dedup(gather_ragged(inc, starts, lens), n1)
        ts = gather_ragged(tgt, tgt_off[links], tgt_off[links + 1] - tgt_off[links])
        nxt = _dedup(ts, n1)
        nxt = nxt[~visited[nxt]]
        visited[nxt] = True
        frontier = nxt
        if not len(frontier):
            break
    return np.flatnonzero(visited[: snap.num_atoms]), edges
