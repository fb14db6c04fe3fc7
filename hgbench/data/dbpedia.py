"""The DBpedia-shaped tables of BASELINE configs 3 and 4, drawn from a
generator: a frozen copy of the table draw of
``hypergraphdb_tpu_torch.models.generators.dbpedia_snapshot``.

Id layout: [0] the entity type, [1..P] the property types, then the
entities, then the links. Each link has 2..max_arity targets, all
entities, uniform except the first, which is zipf-skewed (the hubs); a
link's type is its property's atom. An entity's value rank is its index
among the entities, a link's its property id.
"""

from __future__ import annotations

import numpy as np

from hgbench import traffic


def draw(cfg: dict, seed: int) -> dict:
    """A configuration's tables (its ``n_entities``, ``n_links``,
    ``max_arity``, ``n_properties``, ``zipf_a``) drawn from the seed."""
    return tables(traffic.stream(seed, traffic.GRAPH), cfg["n_entities"],
                  cfg["n_links"], cfg["max_arity"], cfg["n_properties"],
                  cfg["zipf_a"])


def tables(r: np.random.Generator, n_entities: int, n_links: int,
           max_arity: int, n_properties: int, zipf_a: float) -> dict:
    """The columnar tables ``CSRSnapshot.from_tables`` takes, and the id
    ranges: ``type_of``, ``is_link``, ``tgt_offsets`` (int64),
    ``tgt_flat`` (int32), ``value_rank``, ``entities``, ``links``."""
    T = 1 + n_properties
    N = T + n_entities + n_links
    e0 = T
    l0 = T + n_entities

    type_of = np.zeros(N, dtype=np.int32)
    props = r.integers(0, n_properties, size=n_links).astype(np.int32)
    type_of[l0:] = 1 + props

    is_link = np.zeros(N, dtype=bool)
    is_link[l0:] = True

    arities = r.integers(2, max_arity + 1, size=n_links).astype(np.int64)
    total = int(arities.sum())
    tgt_offsets = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(arities, out=tgt_offsets[l0 + 1 :])

    tgt_flat = e0 + r.integers(0, n_entities, size=total).astype(np.int64)
    subj = e0 + (r.zipf(zipf_a, size=n_links) % n_entities)
    tgt_flat[tgt_offsets[l0:-1][:n_links]] = subj

    value_rank = np.zeros(N, dtype=np.uint64)
    value_rank[l0:] = props.astype(np.uint64)
    value_rank[e0:l0] = np.arange(n_entities, dtype=np.uint64)
    return {
        "type_of": type_of, "is_link": is_link, "tgt_offsets": tgt_offsets,
        "tgt_flat": tgt_flat.astype(np.int32), "value_rank": value_rank,
        "entities": (e0, l0), "links": (l0, N), "n_atoms": N,
        "property_types": list(range(1, T)),
    }
