"""The plain reference equals the port at a tiny size on the CPU: the
batched BFS lane (every lane's reach set, count and edge total) and the
served BFS through ``ServeRuntime`` (count, truncation, first_r); and the
reference's 64-seed passes equal its one-seed statement."""

import numpy as np
import pytest

import hgbench_tiny as tiny
from hgbench import spec, traffic
from hgbench.data import dbpedia, serve_graph
from hgbench.reference import bfs as ref_bfs

BFS = "dbpedia-10m.bfs3-k4096"
SERVED = "serve-600k.bfs2-closed2048"


def _snapshot(cfg, t):
    return spec.load_module(spec.HERE / "systems" / "snapshot.py").build(
        cfg, t)


@pytest.mark.parametrize("seed,hops", [(3, 1), (4, 2), (2**31 + 9, 3)])
def test_bfs_lane_equals_reference(seed, hops):
    from hypergraphdb_tpu_torch.ops import ellbfs

    cfg = tiny.cell(BFS).config
    t = dbpedia.draw(cfg, seed)
    snap = _snapshot(cfg, t)
    e0, e1 = t["entities"]
    seeds = traffic.batch_seeds(seed, 0, 64, e0, e1)
    res = ellbfs.bfs_pull(snap, seeds, hops, k_block=64, fused=True,
                          device="cpu")
    want = ref_bfs.answer(t, seeds, hops)
    assert np.array_equal(res.reach_counts.numpy(), want.counts)
    assert np.array_equal(res.edges_touched, want.edges)
    for k, got in enumerate(ellbfs.visited_rows(res, t["n_atoms"])):
        assert np.array_equal(got, want.reach_set(k))


@pytest.mark.parametrize("seed,hops", [(7, 1), (8, 2), (2**35 + 1, 3)])
def test_passes_equal_one_seed_bfs(seed, hops):
    """A sparser graph than the cell's, so that reach sets differ."""
    t = dbpedia.draw(dict(tiny.cell(BFS).config, n_entities=20000,
                          n_links=6000), seed)
    g = ref_bfs.Graph(t["tgt_offsets"], t["tgt_flat"], t["n_atoms"])
    seeds = traffic.batch_seeds(seed, 0, 150, *t["entities"])
    seeds[5] = seeds[6]  # two lanes of one pass on one atom
    got = ref_bfs.lanes(g, seeds, hops)
    sizes = set()
    for i, s in enumerate(seeds):
        want, edges = ref_bfs.bfs(g, int(s), hops)
        assert got.counts[i] == len(want) and got.edges[i] == edges
        assert np.array_equal(got.reach_set(i), want)
        sizes.add(len(want))
    assert len(sizes) > 10


def test_reference_degrees_are_the_snapshots():
    cfg = tiny.cell(BFS).config
    t = dbpedia.draw(cfg, 5)
    snap = _snapshot(cfg, t)
    g = ref_bfs.Graph(t["tgt_offsets"], t["tgt_flat"], t["n_atoms"])
    deg = np.diff(snap.inc_offsets[: t["n_atoms"] + 1])
    assert np.array_equal(g.deg, deg)


@pytest.mark.parametrize("seed", [6, 2**33 + 1])
def test_served_bfs_equals_reference(seed):
    from hypergraphdb_tpu_torch.serve import ServeConfig, ServeRuntime

    cfg = tiny.cell(SERVED).config
    t = serve_graph.draw(cfg, seed)
    sv = spec.load_module(spec.HERE / "systems" / "served_graph.py").build(
        cfg, t, "cpu")
    rt = ServeRuntime(sv.graph, ServeConfig(device="cpu", manual=True,
                                            top_r=16))
    seeds = traffic.Requests(seed, *t["entities"]).take(80)
    futs = [rt.submit_bfs(int(h), max_hops=2) for h in sv.handles(seeds)]
    while rt.step(drain=True):
        pass
    want = ref_bfs.answer(t, seeds, 2)
    for i, f in enumerate(futs):
        res = f.result(timeout=60)
        w = sv.e0 + want.reach_set(i)
        assert res.count == len(w)
        assert res.truncated == (len(w) > 16)
        assert np.array_equal(np.asarray(res.matches, np.int64), w[:16])
    rt.close()
    sv.graph.close()


@pytest.mark.parametrize("name", [BFS, SERVED])
def test_tiny_cell_runs_correct(name):
    r = tiny.run(tiny.cell(name))
    assert r.checks and r.correct, r.checks
    assert r.attempted > 0 and r.failed == 0
    assert r.setup_s > 0 and all(v > 0 for v in r.e2e.values())
