"""``system: served_graph``: the drawn graph loaded through
``bulk_import`` (entities with the values ``0..n-1``, then the links in
chunks of ``load_chunk``, a link's value its position in the load), its
snapshot manager on the card with the configuration's ``manager``
settings, and a ``ServeRuntime`` over it with its ``serve`` settings.

The tables hold the entities at ids ``0..n-1`` and the links after them,
each link's targets entities: an entity's handle is the first entity's
plus its id."""

from __future__ import annotations

import numpy as np


class Served:
    def __init__(self, cfg: dict, tables: dict, dev):
        from hypergraphdb_tpu_torch.core.graph import HyperGraph

        e0, e1 = tables["entities"]
        l0, l1 = tables["links"]
        off, tgt = tables["tgt_offsets"], tables["tgt_flat"]
        if e0 != 0 or l0 != e1 or (len(tgt) and tgt.max() >= e1):
            raise ValueError("a served graph's tables hold the entities "
                             "first, and links between entities after")
        self.n_entities = n = e1
        self.graph = g = HyperGraph()
        ents = g.bulk_import(values=list(range(n)))
        self.e0 = int(ents[0])
        if len(ents) != n or int(ents[-1]) != self.e0 + n - 1:
            raise RuntimeError("bulk_import gave a non-contiguous range")
        chunk = cfg["load_chunk"]
        for st in range(l0, l1, chunk):
            end = min(st + chunk, l1)
            flat = tgt[off[st] : off[end]].astype(np.int64) + self.e0
            lists = np.split(flat, off[st + 1 : end] - off[st])
            g.bulk_import(values=list(range(st - l0, end - l0)),
                          target_lists=[a.tolist() for a in lists])
        self.mgr = g.enable_incremental(device=dev, **cfg["manager"])

    def serve(self, cfg: dict, dev) -> None:
        from hypergraphdb_tpu_torch.serve import ServeConfig, ServeRuntime

        s = cfg["serve"]
        self.rt = ServeRuntime(self.graph, ServeConfig(
            buckets=tuple(s["buckets"]), max_linger_s=s["max_linger_s"],
            top_r=s["top_r"], device=str(dev)))

    def handles(self, idx) -> np.ndarray:
        return self.e0 + np.asarray(idx, dtype=np.int64)

    def executor_timing_reset(self) -> None:
        ex = self.rt.executor
        with ex._timing_lock:
            ex.timing.clear()

    def close(self) -> None:
        self.rt.close(drain=True, timeout=120)
        self.graph.close()


def build(cfg: dict, tables: dict, dev) -> Served:
    return Served(cfg, tables, dev)
