"""The control of a configuration that states exact reads of the pinned
view: the plain reference answering from a stale view, one that lacks
the last :data:`STALE_SHARE` of the links loaded (the links with the
highest ids lose their targets)."""

import numpy as np

from hgbench.reference import bfs as ref_bfs

STALE_SHARE = 0.01


def answer(tables: dict, seeds, hops: int) -> ref_bfs.Lanes:
    off = np.asarray(tables["tgt_offsets"], dtype=np.int64)
    links = np.flatnonzero(np.diff(off))
    cut = links[-max(1, int(round(STALE_SHARE * len(links))))]
    stale = off.copy()
    stale[cut + 1 :] = off[cut]
    g = ref_bfs.Graph(stale, tables["tgt_flat"], tables["n_atoms"])
    return ref_bfs.lanes(g, seeds, hops)
