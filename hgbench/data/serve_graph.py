"""The served graph of bench c6 and c8: a frozen copy of the draw in
``chip_smoke.serve_graph``.

``n_entities`` entity atoms with the int values ``0..n_entities-1``, then
``n_links`` binary links between uniformly drawn entities, loaded in
chunks of ``load_chunk`` links; a link's value is its position in the load.
"""

from __future__ import annotations

import numpy as np

from hgbench import traffic


def draw(cfg: dict, seed: int) -> dict:
    """The graph as id-space tables: entities ``0..n_entities-1``, link
    ``i`` at id ``n_entities + i`` with the two targets ``pairs[i]``."""
    n = cfg["n_entities"]
    pairs = links(traffic.stream(seed, traffic.GRAPH), n, cfg["n_links"],
                  cfg["load_chunk"])
    m = len(pairs)
    tgt_offsets = np.zeros(n + m + 1, dtype=np.int64)
    tgt_offsets[n + 1 :] = 2 * np.arange(1, m + 1)
    return {"tgt_offsets": tgt_offsets,
            "tgt_flat": pairs.reshape(-1).astype(np.int32),
            "n_atoms": n + m, "entities": (0, n), "links": (n, n + m)}


def links(r: np.random.Generator, n_entities: int, n_links: int,
          chunk: int) -> np.ndarray:
    """(n_links, 2) int64 entity indices of each link's two targets, in
    load order."""
    out = np.empty((n_links, 2), dtype=np.int64)
    for st in range(0, n_links, chunk):
        m = min(chunk, n_links - st)
        out[st : st + m, 0] = r.integers(0, n_entities, size=m)
        out[st : st + m, 1] = r.integers(0, n_entities, size=m)
    return out
