"""Benchmark graph families.

The port's copies of ``hypergraphdb_tpu/models/generators.py``'s
``dbpedia_snapshot`` (built straight into a snapshot), ``zipf_hypergraph``,
``wordnet_like`` and ``dbpedia_like`` (built through the graph's ingest
API, so they double as ingest benchmarks): the same random draws in the same order, so one
seed gives the same graph in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from hypergraphdb_tpu_torch.ops.snapshot import CSRSnapshot


@dataclass(frozen=True)
class Synset:
    """WordNet-style node payload."""

    lemma: str = ""
    pos: str = "n"


@dataclass(frozen=True)
class Entity:
    """DBpedia-style node payload."""

    uri: str = ""


def zipf_hypergraph(graph, n_nodes: int = 10_000, n_links: int = 5_000,
                    max_arity: int = 5, zipf_a: float = 1.3, seed: int = 7,
                    values: bool = True):
    """Skewed-degree hypergraph (the shape of lexical graphs): returns
    (node_handles, link_handles)."""
    r = np.random.default_rng(seed)
    nodes = graph.bulk_import(values=np.arange(n_nodes).tolist())
    node0 = int(nodes[0])
    popularity = r.zipf(zipf_a, size=n_links * (max_arity + 1)) % n_nodes
    arities = r.integers(2, max_arity + 1, size=n_links)
    target_lists = []
    k = 0
    for a in arities:
        ts = popularity[k : k + a]
        k += a
        target_lists.append([node0 + int(t) for t in ts])
    links = graph.bulk_import(
        values=list(range(n_links)) if values else [None] * n_links,
        target_lists=target_lists,
    )
    return nodes, links


#: WordNet relation inventory (name, approximate share of links)
WORDNET_RELS = (
    ("hypernym", 0.40),
    ("hyponym", 0.25),
    ("meronym", 0.12),
    ("holonym", 0.08),
    ("antonym", 0.05),
    ("entailment", 0.05),
    ("similar-to", 0.05),
)


def wordnet_like(graph, n_synsets: int = 20_000, n_relations: int = 40_000,
                 seed: int = 11):
    """WordNet-shaped typed graph: ``Synset`` nodes + binary relation links
    whose VALUE is the relation name (so typed-incident queries exercise
    the by-value/by-type paths). Returns (synset_handles, rel_handles)."""
    r = np.random.default_rng(seed)
    poses = np.array(["n", "v", "a", "r"])
    synsets = graph.add_nodes_bulk([
        Synset(f"lemma{i}", str(poses[i % 4])) for i in range(n_synsets)
    ])
    s0 = int(synsets[0])
    names = [n for n, _ in WORDNET_RELS]
    probs = np.array([p for _, p in WORDNET_RELS])
    probs = probs / probs.sum()
    rel_names = r.choice(names, size=n_relations, p=probs)
    # hypernym chains give depth; the rest are zipf-skewed
    src = r.zipf(1.2, size=n_relations) % n_synsets
    dst = (src + r.integers(1, max(2, n_synsets // 10),
                            size=n_relations)) % n_synsets
    targets = [[s0 + int(a), s0 + int(b)] for a, b in zip(src, dst)]
    rels = graph.add_links_bulk(targets, values=[str(n) for n in rel_names])
    return synsets, rels



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
    Value ranks: an entity's is its index among the entities, a link's its
    property id (every kind byte 0), so value windows meet real skew.

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

    value_rank = np.zeros(N, dtype=np.uint64)
    value_rank[l0:] = props.astype(np.uint64)
    value_rank[e0:l0] = np.arange(n_entities, dtype=np.uint64)

    snap = CSRSnapshot.from_tables(
        type_of, is_link, tgt_offsets, tgt_flat.astype(np.int32),
        value_rank=value_rank,
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


def dbpedia_like(graph, n_entities: int = 100_000, n_triples: int = 500_000,
                 n_properties: int = 64, seed: int = 13, batch: int = 100_000):
    """DBpedia-shaped graph at configurable scale: ``Entity`` nodes and
    property links (value = property id). Ingests in batches so 10M-atom
    builds stream. Returns (entity_handles, first_link_handle)."""
    r = np.random.default_rng(seed)
    entities = graph.bulk_import(
        values=[Entity(f"e/{i}") for i in range(n_entities)]
    )
    e0 = int(entities[0])
    first_link = None
    remaining = n_triples
    while remaining > 0:
        m = min(batch, remaining)
        remaining -= m
        subj = r.zipf(1.1, size=m) % n_entities
        obj = r.integers(0, n_entities, size=m)
        props = r.integers(0, n_properties, size=m)
        links = graph.bulk_import(
            values=[int(p) for p in props],
            target_lists=[[e0 + int(a), e0 + int(b)]
                          for a, b in zip(subj, obj)],
        )
        if first_link is None:
            first_link = int(links[0])
    return entities, first_link
