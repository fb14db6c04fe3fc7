"""The port's sharded serving (``serve/sharded.ShardedExecutor`` over
``ops/sharded_serving``) after ``tests/test_sharded_serving.py``: sharded
BFS, pattern and join results equal the reference's runtime on the same
graph and seeds, the port's single-device runtime and the host
(``find_all``, ``join.host_join``) for each bucket, with deltas and
tombstones mid-ingest and truncated prefixes. Then the compaction case
(against a host BFS), the executor pick (forced and AUTO), the prewarm,
the health payload's mesh and partition map (the map against the
reference's ``PartitionMap``), the EXPLAIN placement, the perf
sentinel's shard skew, and the front door's placement by the shard
ownership a health payload advertises (both packages' doors, equal).

The port meshes the CPU eight times (``make_mesh(["cpu"] * 8)``) and
passes the executor to ``ServeRuntime``. Every runtime is manual (no
dispatch thread). The reference runs its single-device runtime: the
sharded lanes keep its ``(counts, first_r)`` and join-execution
contracts, so its answers are the sharded ones. Its own sharded runtime
is not the oracle: on jax 0.9 its BFS and pattern serving programs fail
``shard_map``'s replication check (8 of the 11 cases of its file fail
when that file runs alone).

Tolerance: exact equality."""

from __future__ import annotations

import numpy as np
import pytest

from conftest import make_random_hypergraph
from test_torch_query import PKGS, mod, new_graph

#: 16 and 64 both divide by the 8-shard mesh (the join lane split)
BUCKETS = (16, 64)


def cfg(pkg, **kw):
    base = dict(buckets=BUCKETS, max_linger_s=0.0, top_r=16,
                use_pallas_bfs=False, prewarm_aot=False, manual=True)
    if pkg == PKGS[1]:
        base["device"] = "cpu"
    base.update(kw)
    return mod(pkg, "serve").ServeConfig(**base)


def sharded_runtime(g, **kw):
    """The port's runtime over an 8-shard CPU mesh."""
    from hypergraphdb_tpu_torch.parallel import make_mesh
    from hypergraphdb_tpu_torch.serve import ServeRuntime, ShardedExecutor

    c = cfg(PKGS[1], sharded=True, **kw)
    ex = ShardedExecutor(g, c, mesh=make_mesh(["cpu"] * 8))
    return ServeRuntime(g, c, executor=ex)


def build(pkg, seed=3, n_nodes=150, n_links=300):
    g = new_graph(pkg)
    return g, make_random_hypergraph(g, n_nodes=n_nodes, n_links=n_links,
                                     seed=seed)


def ints(xs):
    return [int(x) for x in xs]


class Trio:
    """The port's sharded and single-device runtimes and the reference's
    single-device runtime, each on its own copy of one graph."""

    def __init__(self, seed=3, n_links=300, **kw):
        from hypergraphdb_tpu_torch.serve import DeviceExecutor

        self.g_sh, (self.nodes, self.links) = build(PKGS[1], seed,
                                                    n_links=n_links)
        self.g_one, aux = build(PKGS[1], seed, n_links=n_links)
        self.g_ref, aux_ref = build(PKGS[0], seed, n_links=n_links)
        for nodes, links in (aux, aux_ref):
            assert ints(nodes) == ints(self.nodes)
            assert ints(links) == ints(self.links)
        self.sh = sharded_runtime(self.g_sh, **kw)
        self.one = mod(PKGS[1], "serve").ServeRuntime(
            self.g_one, cfg(PKGS[1], sharded=False, **kw))
        self.ref = mod(PKGS[0], "serve").ServeRuntime(
            self.g_ref, cfg(PKGS[0], sharded=False, **kw))
        assert type(self.one.executor) is DeviceExecutor
        assert type(self.ref.executor).__name__ == "DeviceExecutor"

    def runtimes(self):
        return [self.sh, self.one, self.ref]

    def graphs(self):
        return [self.g_sh, self.g_one, self.g_ref]

    def serve(self, submit):
        """``submit(rt, pkg)`` on every runtime, drained: the results,
        sharded first, the reference's last."""
        pkgs = (PKGS[1], PKGS[1], PKGS[0])
        futs = [submit(rt, pkg) for rt, pkg in zip(self.runtimes(), pkgs)]
        for rt in self.runtimes():
            while rt.step(drain=True):
                pass
        return [[f.result(timeout=0) for f in fs] for fs in futs]

    def close(self):
        for rt in self.runtimes():
            rt.close()
        for g in self.graphs():
            g.close()


@pytest.fixture
def trio(request):
    t = Trio(**getattr(request, "param", {}))
    yield t
    t.close()


def same(a, b):
    assert a.count == b.count and a.truncated == b.truncated
    np.testing.assert_array_equal(np.asarray(a.matches, dtype=np.int64),
                                  np.asarray(b.matches, dtype=np.int64))


def bfs_truth(g, seed, hops):
    from hypergraphdb_tpu_torch.query import conditions as c

    return sorted(set(int(h) for h in g.find_all(
        c.BFS(int(seed), max_distance=hops))) | {int(seed)})


# ------------------------------------------------------------------ BFS


def test_sharded_bfs_matches_single_device_and_host(trio):
    t = trio
    seeds = [int(t.nodes[i]) for i in range(24)]
    sh, one, ref = t.serve(lambda rt, _: [rt.submit_bfs(x, max_hops=3)
                                          for x in seeds])
    for x, a, b, r in zip(seeds, sh, one, ref):
        assert a.served_by == "device" == r.served_by
        same(a, r)
        same(a, b)
        want = bfs_truth(t.g_sh, x, 3)
        assert a.count == len(want) and a.matches.tolist() == want[:16]
    assert t.sh.stats.sharded_dispatches > 0
    assert t.sh.executor.routes == {"fused": 0, "dense": 1}


@pytest.mark.parametrize("trio", [{"seed": 5}], indirect=True)
def test_sharded_bfs_sees_delta_and_tombstones_mid_ingest(trio):
    t = trio
    for _ in t.serve(lambda rt, _: [rt.submit_bfs(int(t.nodes[0]),
                                                     max_hops=1)]):
        pass  # every runtime pinned once
    for g in t.graphs():
        for i in range(6):
            g.add_link([int(t.nodes[i]), int(t.nodes[i + 40])])
        g.remove(int(t.links[7]))
        g.remove(int(t.links[9]))
    seeds = [int(t.nodes[i]) for i in list(range(8)) + [40, 41]]
    sh, one, ref = t.serve(lambda rt, _: [rt.submit_bfs(x, max_hops=2)
                                          for x in seeds])
    for x, a, b, r in zip(seeds, sh, one, ref):
        same(a, r)
        same(a, b)
        want = bfs_truth(t.g_sh, x, 2)
        assert a.count == len(want) and a.matches.tolist() == want[:16]
    mgr = t.sh.executor.mgr
    assert mgr._sharded_delta is not None and mgr._sharded_delta.epoch == \
        mgr.compactions


@pytest.mark.parametrize("trio", [{"seed": 9, "top_r": 4}], indirect=True)
def test_sharded_bfs_truncation_prefix_exact(trio):
    t = trio
    x = int(t.nodes[0])
    (a,), (b,), (r,) = t.serve(lambda rt, _: [rt.submit_bfs(x, max_hops=3)])
    assert a.truncated and a.count > 4 and len(a.matches) == 4
    same(a, r)
    same(a, b)
    assert a.matches.tolist() == bfs_truth(t.g_sh, x, 3)[:4]


# ------------------------------------------------------------- patterns


@pytest.mark.parametrize("trio", [{"seed": 7, "n_links": 400}],
                         indirect=True)
def test_sharded_pattern_matches_single_device_and_host(trio):
    t = trio
    from hypergraphdb_tpu_torch.query import conditions as c

    g = t.g_sh
    lt = int(g.get_type_handle_of(t.links[0]))
    assert int(t.g_ref.get_type_handle_of(int(t.links[0]))) == lt
    pairs = []
    for lk in t.links[:24]:
        ts = [int(x) for x in g.get_targets(lk)]
        if len(ts) >= 2 and ts[0] != ts[1]:
            pairs.append((ts[0], ts[1]))
    assert len(pairs) >= 4
    reqs = [(a, b, th) for th in (None, lt) for a, b in pairs[:6]]
    sh, one, ref = t.serve(lambda rt, _: [
        rt.submit_pattern([a, b], type_handle=th) for a, b, th in reqs])
    for (a_, b_, th), a, b, r in zip(reqs, sh, one, ref):
        same(a, r)
        same(a, b)
        clauses = [c.Incident(a_), c.Incident(b_)]
        if th is not None:
            clauses.append(c.AtomType(th))
        want = sorted(int(h) for h in g.find_all(c.And(*clauses)))
        assert a.count == len(want) and a.matches.tolist() == want[:16]
    assert t.sh.stats.sharded_dispatches > 0


@pytest.mark.parametrize("trio", [{"seed": 11}], indirect=True)
def test_sharded_pattern_memtable_correction_mid_ingest(trio):
    t = trio
    from hypergraphdb_tpu_torch.query import conditions as c

    a, b = int(t.nodes[2]), int(t.nodes[3])
    fresh = []
    for g in t.graphs():
        fresh.append([int(g.add_link([a, b])) for _ in range(3)])
        g.remove(fresh[-1][0])
    assert fresh[0] == fresh[1] == fresh[2]
    (x,), (y,), (r,) = t.serve(lambda rt, _: [rt.submit_pattern([a, b])])
    same(x, r)
    same(x, y)
    want = sorted(int(h) for h in t.g_sh.find_all(
        c.And(c.Incident(a), c.Incident(b))))
    assert x.count == len(want) and x.matches.tolist() == want[:16]
    assert fresh[0][0] not in x.matches.tolist()


# ---------------------------------------------------------------- joins


@pytest.mark.parametrize("trio", [{"seed": 13, "n_links": 400}],
                         indirect=True)
def test_sharded_join_matches_single_device_and_host(trio):
    t = trio
    from hypergraphdb_tpu_torch.join.host import host_join
    from hypergraphdb_tpu_torch.join.ir import extract_pattern

    def spec(pkg, a):
        c = mod(pkg, "query.conditions")
        var = mod(pkg, "query.variables").var
        return {"y": c.CoIncident(a), "z": c.CoIncident(var("y"))}

    anchors = [int(t.nodes[i]) for i in range(6)]
    sh, one, ref = t.serve(lambda rt, pkg: [rt.submit_join(spec(pkg, a))
                                            for a in anchors])
    for a, x, y, r in zip(anchors, sh, one, ref):
        for other in (r, y):
            assert x.count == other.count
            assert x.truncated == other.truncated
            assert tuple(x.vars) == tuple(other.vars)
            np.testing.assert_array_equal(
                np.asarray(x.tuples, dtype=np.int64),
                np.asarray(other.tuples, dtype=np.int64))
        want = host_join(t.g_sh, extract_pattern(t.g_sh, spec(PKGS[1], a)))
        assert x.count == len(want)
        assert [tuple(int(v) for v in row) for row in x.tuples] == want[:16]
    assert t.sh.stats.sharded_dispatches > 0
    assert t.sh.executor.join_routes["device"] == len(anchors)


# -------------------------------------------------------------- routing


def test_executor_pick_forced_and_auto(monkeypatch):
    import torch

    from hypergraphdb_tpu_torch.serve import (
        DeviceExecutor,
        ServeRuntime,
        ShardedExecutor,
    )
    from hypergraphdb_tpu_torch.serve import sharded as sharded_mod

    g, _ = build(PKGS[1], seed=1, n_nodes=40, n_links=60)
    try:
        rt = ServeRuntime(g, cfg(PKGS[1], sharded=False))
        assert type(rt.executor) is DeviceExecutor
        rt.close()
        rt = ServeRuntime(g, cfg(PKGS[1], sharded=True))
        assert isinstance(rt.executor, ShardedExecutor)
        assert rt.executor.mesh.devices == (torch.device("cpu"),)
        rt.close()
        # AUTO on one visible device stays on one device, whatever the
        # budget
        rt = ServeRuntime(g, cfg(PKGS[1], hbm_budget_bytes=1))
        assert type(rt.executor) is DeviceExecutor
        rt.close()
        # with eight visible devices a 1-byte budget shards, a huge one
        # does not, and mesh_devices caps the visible ones
        monkeypatch.setattr(sharded_mod, "visible_devices",
                            lambda config: [torch.device("cpu")] * min(
                                8, config.mesh_devices or 8))
        rt = ServeRuntime(g, cfg(PKGS[1], hbm_budget_bytes=1))
        assert isinstance(rt.executor, ShardedExecutor)
        assert rt.executor.n_dev == 8
        rt.close()
        rt = ServeRuntime(g, cfg(PKGS[1], hbm_budget_bytes=1 << 40))
        assert type(rt.executor) is DeviceExecutor
        rt.close()
        rt = ServeRuntime(g, cfg(PKGS[1], hbm_budget_bytes=1,
                                 mesh_devices=1))
        assert type(rt.executor) is DeviceExecutor
        rt.close()
    finally:
        g.close()


def test_sharded_prewarm_runs_the_pattern_lane_with_a_plan_cache(tmp_path):
    """With a plan cache open, ``prewarm_pattern_arities`` runs the sharded
    pattern lane once per (bucket, arity) beside the BFS runs (nothing is
    built: its rows are assembled a batch), and the first pattern request
    answers as a runtime that prewarmed no pattern; without a cache the
    pattern lane is not prewarmed."""
    g, (nodes, links) = build(PKGS[1], seed=2, n_nodes=80, n_links=160)
    pair = next([int(t) for t in g.get(int(h)).targets[:2]] for h in links
                if len(set(g.get(int(h)).targets[:2])) == 2)
    got = []
    try:
        for arities, cache in (((1, 2), True), ((), True), ((1, 2), False)):
            kw = {"aot_cache_dir": str(tmp_path)} if cache else {}
            rt = sharded_runtime(g, prewarm_aot=True, prewarm_hops=(1, 2),
                                 prewarm_pattern_arities=arities, **kw)
            runs = rt.executor.prewarm_counts["runs"]
            f = rt.submit_pattern(pair)
            while rt.step(drain=True):
                pass
            res = f.result(timeout=0)
            got.append((runs, res.count, np.asarray(res.matches).tolist(),
                        res.served_by))
            rt.close()
    finally:
        g.close()
    bfs_runs = len(BUCKETS) * 2
    assert [r[0] for r in got] == [bfs_runs + len(BUCKETS) * 2, bfs_runs,
                                   bfs_runs]
    assert got[0][1:] == got[1][1:] == got[2][1:]
    assert got[0][1] > 0 and got[0][3] == "device"


def test_sharded_prewarm_shards_the_base_and_runs_each_bucket():
    g, (nodes, _) = build(PKGS[1], seed=2, n_nodes=80, n_links=160)
    try:
        rt = sharded_runtime(g, prewarm_aot=True, prewarm_hops=(1, 2))
        ex = rt.executor
        assert ex.prewarm_counts == {"built": 1, "from_cache": 0,
                                     "runs": len(BUCKETS) * 2}
        assert ex.mgr._sharded_epoch == ex.mgr.compactions
        sbase = ex.mgr._sharded_base
        f = rt.submit_bfs(int(nodes[0]), max_hops=2)
        while rt.step(drain=True):
            pass
        assert f.result(timeout=0).served_by == "device"
        assert ex.mgr._sharded_base is sbase  # the first batch re-shards
        rt.close()                            # nothing
    finally:
        g.close()


def test_healthz_advertises_mesh_and_partition_map():
    from hypergraphdb_tpu.storage.partitioned import PartitionMap as RefMap
    from hypergraphdb_tpu_torch.obs.http import runtime_health

    g, _ = build(PKGS[1], seed=4, n_nodes=60, n_links=100)
    rt = sharded_runtime(g)
    try:
        f = rt.submit_bfs(3, max_hops=1)  # shards the base
        while rt.step(drain=True):
            pass
        f.result(timeout=0)
        healthy, payload = runtime_health(rt)()
        assert healthy and "degraded" not in payload
        mesh = payload["mesh"]
        assert set(mesh) == {"axis", "devices", "partition_map",
                             "sharded_epoch", "shards"}
        assert mesh["devices"] == 8 and mesh["axis"] == "shard"
        want = RefMap.for_mesh(rt.executor.mgr.base.num_atoms + 1, 8)
        assert mesh["partition_map"] == want.to_dict()
        assert [[s["gid_lo"], s["gid_hi"]] for s in mesh["shards"]] == \
            want.to_dict()["ranges"]
        assert all(s["device"] == "cpu" and "hbm_bytes_in_use" not in s
                   for s in mesh["shards"])
        assert mesh["sharded_epoch"] == rt.executor.mgr.compactions
    finally:
        rt.close()
        g.close()


def test_explain_placement_and_the_sentinels_shard_skew():
    from types import SimpleNamespace

    from hypergraphdb_tpu_torch import obs
    from hypergraphdb_tpu_torch.obs.perf import shard_skew

    g, (nodes, _) = build(PKGS[1], seed=6, n_nodes=80, n_links=150)
    sen = obs.PerfSentinel(flight=obs.FlightRecorder())
    rt = sharded_runtime(g, perf=sen)
    try:
        assert rt._shard_owner(SimpleNamespace(seed=int(nodes[0]))) is None
        f = rt.submit_bfs(int(nodes[0]), max_hops=1)
        while rt.step(drain=True):
            pass
        f.result(timeout=0)
        pm = rt.executor.mgr._sharded_base.partition_map
        for x in list(range(0, pm.capacity + 300, 37)):
            assert rt._shard_owner(SimpleNamespace(seed=x)) == pm.owner_of(x)
        assert rt._shard_owner(SimpleNamespace(seed=None,
                                               anchors=(5, 300))) == \
            pm.owner_of(300)
        assert rt._shard_owner(SimpleNamespace(seed=None, anchors=())) \
            is None
        assert sen.mesh_source == rt.executor.mesh_report
        skew = sen.tick()["skew"]
        want = shard_skew(rt.executor.mesh_report())
        assert {k: v for k, v in skew.items()
                if k not in ("violating", "alerts_total")} == want
        assert skew["gid_span"]["ratio"] == 1.0 and not skew["violating"]
    finally:
        rt.close()
        sen.close()
        g.close()


def test_sharded_view_refreshes_across_compaction():
    """A compaction re-shards the base (the epochs compare, not the
    capacities, which padding keeps equal); the answer after it equals a
    host BFS over the live graph."""
    g, (nodes, _) = build(PKGS[1], seed=6, n_nodes=80, n_links=150)
    # a coarse pad multiple keeps the capacity equal across the compaction
    g.enable_incremental(pack_pad_multiple=4096, device="cpu")
    rt = sharded_runtime(g)
    try:
        def bfs(x):
            f = rt.submit_bfs(x, max_hops=2)
            while rt.step(drain=True):
                pass
            return f.result(timeout=0)

        before = bfs(int(nodes[1]))
        mgr = rt.executor.mgr
        sbase = mgr._sharded_base
        cap = mgr.base.num_atoms
        for i in range(40):
            g.add_link([nodes[i % 20], nodes[(i + 1) % 20]])
        mgr._request_compact()
        assert mgr.wait_compacted(timeout=30)
        after = bfs(int(nodes[1]))
        assert after.epoch > before.epoch
        assert mgr.base.num_atoms == cap and mgr._sharded_base is not sbase
        assert mgr._sharded_epoch == mgr.compactions
        want = bfs_truth(g, int(nodes[1]), 2)
        assert after.count == len(want) and after.matches.tolist() == \
            want[:16]
        assert after.served_by == "device"
    finally:
        rt.close()
        g.close()


class _ShardPod:
    """A backend advertising a partition map's capacity in its health
    payload (a multi-chip pod's ``mesh`` section)."""

    def __init__(self, bid, capacity, lag):
        self.id = bid
        self.capacity = capacity
        self.lag = lag
        self.served = 0

    def submit(self, payload, timeout):
        self.served += 1
        return {"kind": payload["kind"], "count": 0, "matches": [],
                "truncated": False, "epoch": 0, "served_by": "device"}

    def health(self):
        return True, {
            "replication_lag": self.lag, "queue_depth": 0,
            "breaker_worst": 0,
            "mesh": {"partition_map": {"capacity": self.capacity}},
        }


def shard_placement(pkg) -> dict:
    """The reference's case on ``pkg``'s front door, with its assertions:
    a backend whose advertised partition map covers the request's ids
    wins placement over a fresher one that does not."""
    router = mod(pkg, "replica.router")
    small = _ShardPod("small-pod", capacity=100, lag=0)
    big = _ShardPod("big-pod", capacity=10_000, lag=5)
    primary = _ShardPod("primary", capacity=None, lag=0)
    door = router.FrontDoor(primary, [small, big],
                            router.RouterConfig(poll_interval_s=0))
    try:
        beyond = door.submit({"kind": "bfs", "seed": 5000, "max_hops": 1})
        assert beyond["routed_to"] == "big-pod"
        inside = door.submit({"kind": "bfs", "seed": 7, "max_hops": 1})
        assert inside["routed_to"] == "small-pod"
        _, payload = door.health_probe()()
        assert payload["backends"]["small-pod"]["gid_capacity"] == 100
        assert payload["backends"]["big-pod"]["gid_capacity"] == 10_000
    finally:
        door.stop()
    return {"routed": [beyond["routed_to"], inside["routed_to"]],
            "health": payload,
            "served": [small.served, big.served, primary.served]}


def test_front_door_places_by_shard_ownership():
    """The door reads shard ownership from the health payload's ``mesh``
    exactly as the reference's does."""
    assert shard_placement(PKGS[1]) == shard_placement(PKGS[0])
