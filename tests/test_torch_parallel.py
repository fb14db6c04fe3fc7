"""The port's sharded execution (``parallel/sharded.py``) against the
reference's, after ``tests/test_parallel.py``: the same graphs built in
both packages, the reference on its 8 forced CPU devices and the port on
``make_mesh(["cpu"] * 8)`` (one device meshed eight times). The sharded
BFS's visited words, levels and edge counts equal the reference's sharded
ones and the port's single-device BFS bit for bit; the blocked driver
equals one run; the sharded delta and the sharded pattern with its
memtable merge equal the reference's and the live host query. A stale
delta is refused, by epoch as well as by capacity (the reference can see
only the latter).

Tolerance: exact equality."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_random_hypergraph

PKGS = ("hypergraphdb_tpu", "hypergraphdb_tpu_torch")


def u32(t) -> np.ndarray:
    return np.asarray(t.numpy() if torch.is_tensor(t) else t).view(np.uint32)


@pytest.fixture(scope="module")
def meshes():
    from hypergraphdb_tpu.parallel import make_mesh as ref_mesh
    from hypergraphdb_tpu_torch.parallel import make_mesh

    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return ref_mesh(), make_mesh(["cpu"] * 8)


def graphs():
    import hypergraphdb_tpu as hg
    from hypergraphdb_tpu_torch.core.graph import HyperGraph

    return hg.HyperGraph(), HyperGraph()


def packed(build):
    """The same graph built in both packages and packed: (reference
    snapshot, port snapshot, what ``build`` returned)."""
    from hypergraphdb_tpu.ops.snapshot import CSRSnapshot as RefSnap
    from hypergraphdb_tpu_torch.ops.snapshot import CSRSnapshot as PortSnap

    rg, pg = graphs()
    try:
        out = build(rg), build(pg)
        assert out[0] == out[1]
        rs, ps = RefSnap.pack(rg), PortSnap.pack(pg)
    finally:
        rg.close()
        pg.close()
    np.testing.assert_array_equal(rs.inc_links, ps.inc_links)
    return rs, ps, out[0]


def sharded(meshes, rs, ps):
    from hypergraphdb_tpu.parallel import ShardedSnapshot as RefSharded
    from hypergraphdb_tpu_torch.parallel import ShardedSnapshot

    return (RefSharded.from_host(rs, meshes[0]),
            ShardedSnapshot.from_host(ps, meshes[1]))


def test_sharded_bfs_matches_reference_and_single_device(meshes):
    from hypergraphdb_tpu.parallel import bfs_levels_sharded as ref_levels
    from hypergraphdb_tpu.parallel.sharded import (
        bfs_packed_sharded as ref_packed,
    )
    from hypergraphdb_tpu_torch.ops.frontier import bfs_levels
    from hypergraphdb_tpu_torch.parallel import (
        bfs_levels_sharded,
        bfs_packed_sharded,
    )

    rs, ps, (nodes, _) = packed(lambda g: make_random_hypergraph(
        g, n_nodes=150, n_links=300, seed=3))
    rsd, psd = sharded(meshes, rs, ps)
    assert psd.n_loc == rsd.n_loc and psd.n_dev == 8
    seeds = np.asarray([int(nodes[i]) for i in (0, 7, 42, 99)], np.int32)
    lv_r, vis_r = ref_levels(rsd, jnp.asarray(seeds), max_hops=3)
    lv_p, vis_p = bfs_levels_sharded(psd, torch.from_numpy(seeds), 3)
    np.testing.assert_array_equal(np.asarray(vis_r), vis_p.numpy())
    np.testing.assert_array_equal(np.asarray(lv_r), lv_p.numpy())
    lv_1, vis_1 = bfs_levels(ps.device("cpu"), torch.from_numpy(seeds), 3)
    assert torch.equal(vis_1, vis_p) and torch.equal(lv_1, lv_p)
    wr, cr, _ = ref_packed(rsd, jnp.asarray(seeds), 3)
    res = bfs_packed_sharded(psd, seeds, 3)
    np.testing.assert_array_equal(np.asarray(wr), u32(res.visited))
    np.testing.assert_array_equal(np.asarray(cr).astype(np.int64),
                                  res.edges_touched.numpy())


def test_sharded_pattern_matches_reference_and_host(meshes):
    from hypergraphdb_tpu.parallel import (
        and_incident_pattern_sharded as ref_pattern,
    )
    from hypergraphdb_tpu_torch.parallel import and_incident_pattern_sharded

    def build(g):
        nodes, links = make_random_hypergraph(g, n_nodes=120, n_links=400,
                                              seed=5)
        a1 = int(nodes[0])
        lk = int(g.get_incidence_set(a1).array()[0])
        others = [int(t) for t in g.get_targets(lk) if int(t) != a1]
        a2 = others[0] if others else int(nodes[1])
        th = int(g.get_type_handle_of(links[0]))
        from importlib import import_module

        q = import_module(type(g).__module__.split(".")[0] + ".query.dsl")
        want = sorted(g.find_all(q.and_(q.type_(th), q.incident(a1),
                                        q.incident(a2))))
        return th, a1, a2, want

    rs, ps, (th, a1, a2, want) = packed(build)
    rsd, psd = sharded(meshes, rs, ps)
    got = and_incident_pattern_sharded(ps, psd, th, [a1, a2])
    assert sorted(got.tolist()) == want
    assert sorted(ref_pattern(rs, rsd, th, [a1, a2]).tolist()) == want
    assert len(want)


def test_sharded_bfs_empty_frontier_stops(meshes):
    from hypergraphdb_tpu_torch.parallel import bfs_levels_sharded

    def build(g):
        h = g.add("loner")
        g.add("other")
        return int(h)

    rs, ps, h = packed(build)
    _, psd = sharded(meshes, rs, ps)
    lv, vis = bfs_levels_sharded(psd, torch.tensor([h], dtype=torch.int32),
                                 4)
    assert int(vis[0].sum()) == 1 and bool(vis[0, h])
    assert int(lv[0, h]) == 0


def test_blocked_sharded_bfs_matches_unblocked(meshes):
    from hypergraphdb_tpu.parallel.sharded import (
        bfs_packed_sharded_blocked as ref_blocked,
    )
    from hypergraphdb_tpu_torch.parallel.sharded import (
        bfs_packed_sharded,
        bfs_packed_sharded_blocked,
    )

    rs, ps, (nodes, _) = packed(lambda g: make_random_hypergraph(
        g, n_nodes=200, n_links=350, seed=8))
    rsd, psd = sharded(meshes, rs, ps)
    rng = np.random.default_rng(4)
    seeds = np.asarray([int(nodes[i]) for i in
                        rng.integers(0, len(nodes), size=96)], np.int32)
    one = bfs_packed_sharded(psd, seeds, 3)
    vis, cnt, report = bfs_packed_sharded_blocked(psd, seeds, 3, k_block=32)
    assert torch.equal(one.visited, vis)
    np.testing.assert_array_equal(one.edges_touched.numpy(), cnt)
    assert report == {}  # no allocator stats on the CPU
    wr, cr, _ = ref_blocked(rsd, seeds, 3, k_block=32)
    np.testing.assert_array_equal(np.asarray(wr), u32(vis))
    np.testing.assert_array_equal(cr, cnt)


def test_blocked_sharded_bfs_validates_k_block(meshes):
    from hypergraphdb_tpu_torch.parallel.sharded import (
        bfs_packed_sharded_blocked,
    )

    rs, ps, (nodes, _) = packed(lambda g: make_random_hypergraph(
        g, n_nodes=40, n_links=60, seed=2))
    _, psd = sharded(meshes, rs, ps)
    with pytest.raises(ValueError, match="k_block"):
        bfs_packed_sharded_blocked(psd, np.asarray([int(nodes[0])]), 2,
                                   k_block=48)
    vis, cnt, _ = bfs_packed_sharded_blocked(psd, np.zeros(0, np.int32), 2)
    assert vis.shape == (0, psd.n_dev * psd.n_loc // 32) and len(cnt) == 0


# ------------------------------------------------ the sharded (base, delta)


def with_delta(g, seed=11):
    """A manager over a random graph, then post-base links, a new node
    with a bridge link and a removal, all in the memtable."""
    nodes, links = make_random_hypergraph(g, n_nodes=120, n_links=200,
                                          seed=seed)
    kw = ({"device": "cpu"} if type(g).__module__.startswith(PKGS[1])
          else {})
    mgr = g.enable_incremental(headroom=2.0, compact_ratio=50.0, **kw)
    epoch = mgr.compactions
    r = np.random.default_rng(seed + 1)
    for _ in range(40):
        a, b = (int(x) for x in r.choice(nodes, size=2, replace=False))
        g.add_link([a, b], value="post-base")
    nn = g.add("post-base-node")
    g.add_link([int(nn), int(nodes[0])], value="post-base-bridge")
    g.remove(int(links[3]))
    assert mgr.compactions == epoch and mgr.delta_edges > 0
    return mgr, nodes, int(nn)


def test_sharded_delta_bfs_matches_reference_and_oracle(meshes):
    from hypergraphdb_tpu.parallel import ShardedSnapshot as RefSharded
    from hypergraphdb_tpu.parallel import (
        bfs_levels_sharded_delta as ref_delta_levels,
    )
    from hypergraphdb_tpu.parallel import shard_host_delta as ref_shard
    from hypergraphdb_tpu_torch.ops.incremental import bfs_levels_delta
    from hypergraphdb_tpu_torch.parallel import (
        ShardedSnapshot,
        bfs_levels_sharded_delta,
        shard_host_delta,
    )

    rg, pg = graphs()
    try:
        rmgr, nodes, nn = with_delta(rg)
        pmgr, pnodes, pnn = with_delta(pg)
        assert pnodes == nodes and pnn == nn
        seeds = np.asarray([int(nodes[0]), int(nodes[7]), nn], np.int32)
        rsd = RefSharded.from_host(rmgr.base, meshes[0])
        lv_r, vis_r = ref_delta_levels(rsd, ref_shard(rsd, rmgr.host_delta()),
                                       jnp.asarray(seeds), 3)
        psd = ShardedSnapshot.from_host(pmgr.base, meshes[1],
                                        epoch=pmgr.compactions)
        sdelta = shard_host_delta(psd, pmgr.host_delta())
        assert sdelta.epoch == psd.epoch == pmgr.compactions
        lv_p, vis_p = bfs_levels_sharded_delta(psd, sdelta,
                                               torch.from_numpy(seeds), 3)
        np.testing.assert_array_equal(np.asarray(vis_r), vis_p.numpy())
        np.testing.assert_array_equal(np.asarray(lv_r), lv_p.numpy())
        dev, delta = pmgr.device()
        lv_1, vis_1 = bfs_levels_delta(dev, delta, torch.from_numpy(seeds), 3)
        assert torch.equal(vis_1, vis_p) and torch.equal(lv_1, lv_p)
        assert bool(vis_p[0, nn])  # through the bridge
        rmgr.close()
        pmgr.close()
    finally:
        rg.close()
        pg.close()


def test_sharded_delta_sees_post_base_links(meshes):
    from hypergraphdb_tpu_torch.core.graph import HyperGraph
    from hypergraphdb_tpu_torch.ops.bitfrontier import unpack_visited
    from hypergraphdb_tpu_torch.parallel import (
        ShardedSnapshot,
        bfs_packed_sharded_delta,
        shard_host_delta,
    )

    g = HyperGraph()
    try:
        a, b = int(g.add("a")), int(g.add("b"))
        mgr = g.enable_incremental(headroom=4.0, compact_ratio=50.0,
                                   device="cpu")
        sdev = ShardedSnapshot.from_host(mgr.base, meshes[1],
                                         epoch=mgr.compactions)
        seed = torch.tensor([a], dtype=torch.int32)
        vis0, _, _ = bfs_packed_sharded_delta(
            sdev, shard_host_delta(sdev, mgr.host_delta()), seed, 2)
        assert not bool(unpack_visited(vis0, sdev.num_atoms)[0, b])
        g.add_link([a, b], value="bridge")
        vis1, counts, _ = bfs_packed_sharded_delta(
            sdev, shard_host_delta(sdev, mgr.host_delta()), seed, 2)
        assert bool(unpack_visited(vis1, sdev.num_atoms)[0, b])
        assert int(counts[0]) >= 1
        mgr.close()
    finally:
        g.close()


def test_sharded_delta_tombstones_and_epoch_guard(meshes):
    """A removed link is invisible through the overlay; a delta of
    another epoch is refused by its epoch even where padding keeps the
    capacity equal (the reference's check compares the capacity only),
    and by its capacity."""
    from hypergraphdb_tpu_torch.core.graph import HyperGraph
    from hypergraphdb_tpu_torch.ops.bitfrontier import unpack_visited
    from hypergraphdb_tpu_torch.parallel import (
        ShardedSnapshot,
        bfs_packed_sharded_delta,
        shard_host_delta,
    )

    g = HyperGraph()
    try:
        a, b, c = (int(g.add(x)) for x in "abc")
        g.add_link([a, b], value=1)
        lk = g.add_link([b, c], value=2)
        mgr = g.enable_incremental(headroom=4.0, compact_ratio=50.0,
                                   device="cpu")
        sdev = ShardedSnapshot.from_host(mgr.base, meshes[1],
                                         epoch=mgr.compactions)
        g.remove(int(lk))
        vis, _, _ = bfs_packed_sharded_delta(
            sdev, shard_host_delta(sdev, mgr.host_delta()),
            torch.tensor([a], dtype=torch.int32), 4)
        row = unpack_visited(vis, sdev.num_atoms)[0]
        assert bool(row[b]) and not bool(row[c])
        cap = mgr.base.num_atoms
        mgr._compact_sync()   # a new epoch, the capacity padded equal
        hd = mgr.host_delta()
        assert hd["capacity"] == cap and hd["epoch"] == sdev.epoch + 1
        with pytest.raises(ValueError, match="epoch"):
            shard_host_delta(sdev, hd)
        hd["capacity"] += 128
        with pytest.raises(ValueError, match="epochs diverged"):
            shard_host_delta(sdev, hd)
        mgr.close()
    finally:
        g.close()


def test_sharded_delta_pattern_merges_memtable(meshes):
    from hypergraphdb_tpu.parallel import ShardedSnapshot as RefSharded
    from hypergraphdb_tpu.parallel import (
        and_incident_pattern_sharded_delta as ref_pattern,
    )
    from hypergraphdb_tpu_torch.parallel import (
        ShardedSnapshot,
        and_incident_pattern_sharded_delta,
    )

    def scenario(g):
        from importlib import import_module

        q = import_module(type(g).__module__.split(".")[0] + ".query.dsl")
        nodes, links = make_random_hypergraph(g, n_nodes=80, n_links=150,
                                              seed=13)
        kw = ({"device": "cpu"} if type(g).__module__.startswith(PKGS[1])
              else {})
        mgr = g.enable_incremental(headroom=2.0, compact_ratio=50.0, **kw)
        a1, a2 = int(nodes[0]), int(nodes[1])
        th = int(g.get_type_handle_of(links[0]))
        fresh = int(g.add_link([a1, a2], value=999_999))
        pre = g.find_all(q.and_(q.type_(th), q.incident(a1), q.incident(a2)))
        doomed = next((int(h) for h in pre if int(h) != fresh), None)
        if doomed is not None:
            g.remove(doomed)
        want = sorted(g.find_all(q.and_(q.type_(th), q.incident(a1),
                                         q.incident(a2))))
        return mgr, th, [a1, a2], want, fresh, doomed

    rg, pg = graphs()
    try:
        rmgr, th, anchors, want, fresh, doomed = scenario(rg)
        pmgr, *rest = scenario(pg)
        assert rest == [th, anchors, want, fresh, doomed]
        ref = sorted(int(x) for x in ref_pattern(
            rmgr, RefSharded.from_host(rmgr.base, meshes[0]), th, anchors))
        psd = ShardedSnapshot.from_host(pmgr.base, meshes[1],
                                        epoch=pmgr.compactions)
        got = sorted(int(x) for x in and_incident_pattern_sharded_delta(
            pmgr, psd, th, anchors))
        assert got == ref == want and fresh in got and doomed not in got
        pmgr._compact_sync()
        with pytest.raises(ValueError, match="re-shard"):
            and_incident_pattern_sharded_delta(pmgr, psd, th, anchors)
        rmgr.close()
        pmgr.close()
    finally:
        rg.close()
        pg.close()


def test_sharded_delta_pattern_handles_revalued_and_anchorless(meshes):
    from hypergraphdb_tpu_torch.core.graph import HyperGraph
    from hypergraphdb_tpu_torch.parallel import (
        ShardedSnapshot,
        and_incident_pattern_sharded_delta,
    )
    from hypergraphdb_tpu_torch.query import dsl as q

    g = HyperGraph()
    try:
        a, b = int(g.add("a")), int(g.add("b"))
        l_int = g.add_link((a, b), value=7)
        l_str = g.add_link((a, b), value="s")
        mgr = g.enable_incremental(headroom=3.0, compact_ratio=50.0,
                                   device="cpu")
        sdev = ShardedSnapshot.from_host(mgr.base, meshes[1],
                                         epoch=mgr.compactions)
        th_int = int(g.get_type_handle_of(l_int))
        g.replace(int(l_int), "now-a-string")
        g.replace(int(l_str), 42)
        got = sorted(int(x) for x in and_incident_pattern_sharded_delta(
            mgr, sdev, th_int, [a, b]))
        want = sorted(g.find_all(q.and_(q.type_(th_int), q.incident(a),
                                         q.incident(b))))
        assert got == want == [int(l_str)]
        with pytest.raises(ValueError, match="anchor"):
            and_incident_pattern_sharded_delta(mgr, sdev, th_int, [])
        mgr.close()
    finally:
        g.close()
