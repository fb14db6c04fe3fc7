"""Benchmark graph families, built straight into a snapshot.

The port's copy of ``dbpedia_snapshot`` from
``hypergraphdb_tpu/models/generators.py``: the same random draws in the same
order, so one seed gives the same topology arrays in both packages.
"""

from __future__ import annotations

import numpy as np

from hypergraphdb_tpu_torch.ops.snapshot import CSRSnapshot


def dbpedia_snapshot(
    n_entities: int = 2_000_000,
    n_links: int = 8_000_000,
    max_arity: int = 10,
    n_properties: int = 64,
    zipf_a: float = 1.1,
    seed: int = 13,
):
    """Columnar DBpedia-shaped build at benchmark scale (10M atoms, about
    48M target entries at the defaults) through ``CSRSnapshot.from_tables``.

    Id layout: [0] entity-type atom, [1..P] property-type atoms,
    [T..T+n_entities) entity nodes, then links. Each link's first target is
    zipf-skewed (hubs), the rest uniform; a link's type is its property.

    Returns (snapshot, info) where info has the id ranges and type handles.
    """
    r = np.random.default_rng(seed)
    T = 1 + n_properties
    N = T + n_entities + n_links
    e0 = T
    l0 = T + n_entities

    type_of = np.zeros(N, dtype=np.int32)
    props = r.integers(0, n_properties, size=n_links).astype(np.int32)
    type_of[l0:] = 1 + props              # links: type = their property atom

    is_link = np.zeros(N, dtype=bool)
    is_link[l0:] = True

    arities = r.integers(2, max_arity + 1, size=n_links).astype(np.int64)
    total = int(arities.sum())
    tgt_offsets = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(arities, out=tgt_offsets[l0 + 1 :])

    tgt_flat = e0 + r.integers(0, n_entities, size=total).astype(np.int64)
    subj = e0 + (r.zipf(zipf_a, size=n_links) % n_entities)
    tgt_flat[tgt_offsets[l0:-1][:n_links]] = subj  # first slot of each link

    snap = CSRSnapshot.from_tables(
        type_of, is_link, tgt_offsets, tgt_flat.astype(np.int32)
    )
    info = {
        "entity_type": 0,
        "property_types": list(range(1, T)),
        "entities": (e0, l0),
        "links": (l0, N),
        "n_atoms": N,
        "total_arity": total,
    }
    return snap, info
