"""Each mix's draw is fixed by ``--seed``: the same seed gives the same
graph, requests and arrivals, another seed others."""

import numpy as np
import pytest

from hgbench import traffic
from hgbench.data import dbpedia, serve_graph

SEEDS = (0, 7, 2**31 + 5, 2**40 + 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_batch_seeds_fixed_by_seed(seed):
    a = traffic.batch_seeds(seed, 3, 4096, 65, 2_000_065)
    b = traffic.batch_seeds(seed, 3, 4096, 65, 2_000_065)
    assert np.array_equal(a, b) and a.dtype == np.int32
    assert a.min() >= 65 and a.max() < 2_000_065
    assert not np.array_equal(a, traffic.batch_seeds(seed, 4, 4096, 65,
                                                     2_000_065))
    assert not np.array_equal(a, traffic.batch_seeds(seed + 1, 3, 4096, 65,
                                                     2_000_065))


@pytest.mark.parametrize("seed", SEEDS)
def test_requests_and_sample_fixed_by_seed(seed):
    a = traffic.Requests(seed, 0, 200_000).take(70_000)
    b = traffic.Requests(seed, 0, 200_000)
    assert np.array_equal(a, [b.next() for _ in range(70_000)])
    assert a.min() >= 0 and a.max() < 200_000
    assert not np.array_equal(a[:100], traffic.Requests(
        seed + 1, 0, 200_000).take(100))
    s = traffic.sample(seed, 50_000, 384)
    assert np.array_equal(s, traffic.sample(seed, 50_000, 384))
    assert len(np.unique(s)) == 384
    assert np.array_equal(traffic.sample(seed, 10, 384), np.arange(10))


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_graphs_fixed_by_seed(seed):
    cfg = {"n_entities": 3000, "n_links": 12000, "max_arity": 10,
           "n_properties": 64, "zipf_a": 1.1, "load_chunk": 1500}
    a, b, c = (dbpedia.draw(cfg, s) for s in (seed, seed, seed + 1))
    for k in ("type_of", "tgt_offsets", "tgt_flat", "value_rank"):
        assert np.array_equal(a[k], b[k])
    assert not np.array_equal(a["tgt_flat"], c["tgt_flat"])
    p, q = serve_graph.draw(cfg, seed), serve_graph.draw(cfg, seed)
    assert np.array_equal(p["tgt_flat"], q["tgt_flat"])
    assert p["n_atoms"] == 15000 and len(p["tgt_flat"]) == 24000
    assert p["tgt_flat"].max() < 3000


def test_dbpedia_draw_is_the_generators():
    """The frozen copy draws what the program's generator draws from the
    same generator state."""
    from hypergraphdb_tpu_torch.models import dbpedia_snapshot

    snap, info = dbpedia_snapshot(n_entities=3000, n_links=12000, seed=13)
    t = dbpedia.tables(np.random.default_rng(13), 3000, 12000, 10, 64, 1.1)
    n = t["n_atoms"]
    assert n == info["n_atoms"] and t["entities"] == info["entities"]
    assert np.array_equal(snap.tgt_offsets[: n + 1].astype(np.int64),
                          t["tgt_offsets"])
    assert np.array_equal(snap.tgt_flat[: snap.n_edges_tgt], t["tgt_flat"])
