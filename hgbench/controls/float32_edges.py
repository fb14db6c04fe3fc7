"""The control of a configuration that states exact (int64) counts: the
plain reference with each lane's degrees summed in float32, a hop at a
time, and the hops added in float32, the precision below the float64 the
program counts in. Edge totals past 2^24 round; reach sets and counts stay
exact."""

import numpy as np

from hgbench.reference import bfs as ref_bfs


def float32_sums(words: np.ndarray, weights, m: int) -> np.ndarray:
    w32 = np.asarray(weights, dtype=np.float32)
    out = np.zeros(m, dtype=np.float32)
    for j in range(m):
        on = ((words >> np.uint64(j)) & np.uint64(1)).astype(bool)
        out[j] = w32[on].sum(dtype=np.float32)
    return out


def answer(tables: dict, seeds, hops: int) -> ref_bfs.Lanes:
    g = ref_bfs.Graph(tables["tgt_offsets"], tables["tgt_flat"],
                      tables["n_atoms"])
    return ref_bfs.lanes(g, seeds, hops, edge_sums=float32_sums)
