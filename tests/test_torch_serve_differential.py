"""The port's ``ServeRuntime`` on its real executor against the reference's,
on the same graphs: each scenario builds one graph in both packages by the
same calls (handle numbering is equal), switches both to incremental mode
where it needs a memtable, and submits the same requests through
``ServeConfig(manual=True)`` — the port with ``device="cpu"``, so its
lanes run their plain versions. Every answer's ``count``, ``matches``,
``served_by`` and ``truncated`` must be equal, and so must the runtime's
``host_fallbacks``, batches and device dispatches. The cases of
``tests/test_serve_differential.py``: BFS at each bucket and with
``include_seed=False``, delta and tombstones on both of the port's routes,
seeds outside the base, typed and untyped patterns, rows over
``pattern_pad``, truncation, the pinned-state memtable correction; and the
bridge (``to_request`` / ``to_range_request``, ``Unservable`` outside the
subset; ``CoIncident`` conditions through the join lane). The port also
reports its BFS route (``DeviceExecutor.routes``),
checked where it is the point: a 1-lane bucket pads to one 32-lane word
and rides the fused route, a pending tombstone sends a batch to the dense
sweep. Counts: the port's lanes count exactly in int64, the reference's
BFS sums in float32; these graphs are far below 2^24, where the two agree.
Tolerance: exact equality."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from tests.conftest import make_random_hypergraph
from tests.test_torch_graph import PKGS, mod, new_graph

PORT = PKGS[1]


def graph_of(pkg):
    """A fresh graph; the port's query plans pinned to the CPU."""
    if pkg == PORT:
        return new_graph(pkg, query=mod(pkg, "core.config").QueryConfig(
            device="cpu"))
    return new_graph(pkg)


def incremental(pkg, g, **kw):
    kw.setdefault("background", False)
    kw.setdefault("compact_ratio", 100.0)
    if pkg == PORT:
        kw["device"] = "cpu"
    return g.enable_incremental(**kw)


def runtime(pkg, g, bucket=64, **kw):
    kw.setdefault("top_r", 512)
    kw.setdefault("buckets", (bucket,))
    if pkg == PORT:
        kw["device"] = "cpu"
    cfg = mod(pkg, "serve").ServeConfig(manual=True, max_linger_s=0.0, **kw)
    return mod(pkg, "serve").ServeRuntime(g, cfg)


def drain(rt):
    while rt.step(drain=True):
        pass


def answers(futs):
    out = []
    for f in futs:
        r = f.result(timeout=0)
        out.append((r.kind, int(r.count), r.matches.tolist(), r.served_by,
                    bool(r.truncated)))
    return out


def counters(rt) -> dict:
    st = rt.stats_snapshot()
    return {k: st[k] for k in ("host_fallbacks", "batches",
                               "device_dispatches", "range_dispatches",
                               "completed", "errors")}


def both(scenario):
    """``scenario(pkg) -> (record, extra)`` on both packages; the records
    must be equal. Returns the port's (record, extra): ``extra`` carries
    what only the port has (its routes)."""
    got = {pkg: scenario(pkg) for pkg in PKGS}
    assert got[PORT][0] == got[PKGS[0]][0]
    return got[PORT]


def build(g, seed=3):
    nodes, links = make_random_hypergraph(g, n_nodes=100, n_links=200,
                                          max_arity=4, seed=seed)
    iso = [int(g.add(f"iso{i}")) for i in range(3)]
    return [int(n) for n in nodes], [int(x) for x in links], iso


def routes(rt):
    return dict(getattr(rt.executor, "routes", {}))


def bfs_truth(g, seed, hops):
    """The live graph's reach, from its incidence sets and targets."""
    seen, frontier = {seed}, [seed]
    for _ in range(hops):
        nxt = set()
        for a in frontier:
            for link in g.get_incidence_set(a).array().tolist():
                nxt.update(int(t) for t in g.get_targets(link))
        frontier = [x for x in nxt if x not in seen]
        seen.update(frontier)
    return sorted(seen)


# ---------------------------------------------------------------- BFS


@pytest.mark.parametrize("bucket", [64, 256, 1024])
def test_bfs_batch_matches_reference(bucket):
    """A bucket-minus-one batch (the last lane against the padding):
    first/last atoms, isolated atoms, a link as seed, a duplicate seed."""
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, links, iso = build(g)
        probes = [nodes[0], nodes[1], nodes[-1], iso[0], iso[1], links[0],
                  nodes[7], nodes[7]]
        reqs = [probes[i % len(probes)] for i in range(bucket - 1)]
        rt = runtime(pkg, g, bucket)
        futs = [rt.submit_bfs(s, max_hops=2, include_seed=False)
                for s in reqs]
        drain(rt)
        rt.close()
        truth = [bfs_truth(g, s, 2) for s in probes]
        g.close()
        return (answers(futs), counters(rt)), (routes(rt), truth, probes)

    (res, cnt), (rts, truth, probes) = both(scenario)
    assert cnt["batches"] == 1 and rts == {"fused": 1, "dense": 0}
    for i, r in enumerate(res[: len(probes)]):
        want = [x for x in truth[i] if x != probes[i]]
        assert r[1:3] == (len(want), want) and r[3] == "device"


def test_include_seed_variants_match_reference():
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, links, iso = build(g)
        rt = runtime(pkg, g, 64)
        futs = [rt.submit_bfs(nodes[0], max_hops=2, include_seed=True),
                rt.submit_bfs(nodes[0], max_hops=2, include_seed=False),
                rt.submit_bfs(iso[0], max_hops=2, include_seed=False),
                rt.submit_bfs(iso[0], max_hops=2, include_seed=True)]
        drain(rt)
        rt.close()
        g.close()
        return (answers(futs), counters(rt)), None

    (res, _), _ = both(scenario)
    assert res[0][1] == res[1][1] + 1 and res[2][1] == 0
    assert res[3][1:3] == (1, [res[3][2][0]])


def test_include_seed_false_keeps_a_full_window():
    """``include_seed=False`` drops the seed from a window that was one
    slot wider, so a truncated answer still carries ``top_r`` ids."""
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, links, iso = build(g)
        rt = runtime(pkg, g, 64, top_r=4)
        futs = [rt.submit_bfs(n, max_hops=2, include_seed=False)
                for n in nodes[:8]]
        drain(rt)
        rt.close()
        g.close()
        return (answers(futs), counters(rt)), None

    (res, _), _ = both(scenario)
    assert all(len(r[2]) == 4 and r[4] for r in res)


def test_one_lane_bucket_pads_to_a_word_and_rides_the_fused_route():
    """c6's one-request baseline: ``buckets=(1,)``. The reference's fused
    plan pads any K; the port pads the bucket to 32 lanes (dummy seeds)
    and slices, so every batch takes the fused route too."""
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, links, iso = build(g)
        rt = runtime(pkg, g, 1, top_r=16)
        futs = []
        for s in nodes[:6] + iso[:1]:
            futs.append(rt.submit_bfs(s, max_hops=2))
            drain(rt)
        rt.close()
        g.close()
        return (answers(futs), counters(rt)), routes(rt)

    (res, cnt), rts = both(scenario)
    assert cnt["batches"] == cnt["device_dispatches"] == 7
    assert rts == {"fused": 7, "dense": 0}


def test_delta_and_tombstones_on_both_routes_match_reference():
    """Post-pack ingest stays exact: a fresh link reaches through the
    delta (the port's fused route, overlay through K1's plain version);
    a removed link's tombstone sends the batch to the dense sweep."""
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, links, iso = build(g)
        mgr = incremental(pkg, g)
        a, b = nodes[2], nodes[9]
        fresh = int(g.add_link([a, b], value="fresh"))
        rt = runtime(pkg, g, 64)
        seeds = [a, b, nodes[5], iso[0], links[0]]
        f1 = [rt.submit_bfs(s, max_hops=h) for s in seeds for h in (1, 2)]
        drain(rt)
        r1 = routes(rt)
        g.remove(links[0])
        g.remove(links[1])
        f2 = [rt.submit_bfs(s, max_hops=h) for s in seeds for h in (1, 2)]
        drain(rt)
        rt.close()
        # a removed seed reaches nothing, itself included
        truth = [bfs_truth(g, s, h) if g.contains(s) else []
                 for s in seeds for h in (1, 2)]
        out = (answers(f1), answers(f2), counters(rt), mgr.delta_edges > 0)
        g.close()
        return out, (r1, routes(rt), truth, fresh, a, b)

    (res1, res2, cnt, pending), (r1, r2, truth, fresh, a, b) = both(
        scenario)
    assert pending
    assert b in res1[0][2]                      # through the delta edge
    assert r1 == {"fused": 2, "dense": 0}       # one batch per hop count
    assert r2 == {"fused": 2, "dense": 2}
    assert [r[2] for r in res2] == truth        # tombstones honoured


def test_seeds_outside_the_base_serve_on_the_host():
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, links, iso = build(g)
        mgr = incremental(pkg, g)
        far = mgr.base.num_atoms + 5
        rt = runtime(pkg, g, 64)
        futs = [rt.submit_bfs(nodes[0]), rt.submit_bfs(far),
                rt.submit_bfs(far, include_seed=False)]
        drain(rt)
        rt.close()
        g.close()
        return (answers(futs), counters(rt)), None

    (res, cnt), _ = both(scenario)
    assert [r[3] for r in res] == ["device", "host", "host"]
    assert cnt["host_fallbacks"] == 2


# ---------------------------------------------------------------- patterns


@pytest.mark.parametrize("bucket", [64, 256])
def test_pattern_batch_matches_reference(bucket):
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, links, iso = build(g)
        pairs = []
        for lk in links[:6]:
            ts = [int(t) for t in g.get_targets(lk)]
            if len(ts) >= 2 and ts[0] != ts[1]:
                pairs.append((ts[0], ts[1]))
        pairs += [(iso[0], iso[1]), (nodes[3], nodes[3]), pairs[0],
                  (nodes[4],), (links[0],)]
        th = int(g.get_type_handle_of(links[0]))
        reqs = [pairs[i % len(pairs)] for i in range(min(bucket, 40))]
        rt = runtime(pkg, g, bucket)
        futs = [rt.submit_pattern(p, type_handle=th if i % 3 == 0 else None)
                for i, p in enumerate(reqs)]
        drain(rt)
        rt.close()
        g.close()
        return (answers(futs), counters(rt)), None

    (res, cnt), _ = both(scenario)
    assert cnt["batches"] >= 1 and any(r[1] > 0 for r in res)
    assert {r[3] for r in res} == {"device"}


def test_patterns_over_the_pad_and_truncated_match_reference():
    """Anchors whose base row is wider than ``pattern_pad`` serve on the
    host; a window wider than ``top_r`` comes back truncated with its
    exact count."""
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, links, iso = build(g)
        hub = int(g.add("hub"))
        for i in range(9):
            g.add_link([hub, nodes[i]], value=f"h{i}")
        rt = runtime(pkg, g, 64, pattern_pad=4, top_r=2)
        futs = [rt.submit_pattern((hub, nodes[0])),
                rt.submit_pattern((hub,)),
                rt.submit_pattern((nodes[1],)),
                rt.submit_pattern((nodes[2], nodes[3]))]
        drain(rt)
        rt.close()
        g.close()
        return (answers(futs), counters(rt)), None

    (res, cnt), _ = both(scenario)
    assert [r[3] for r in res[:2]] == ["host", "host"]
    assert res[1][1] == 9 and res[1][4] is True and len(res[1][2]) == 2
    assert cnt["host_fallbacks"] >= 2


def test_memtable_corrections_match_reference():
    """Under pending ingest: a fresh link merged from the memtable, a
    removed link dropped, a truncated window under a dirty memtable
    re-served on the host, a merge that overflows ``top_r`` truncated."""
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, links, iso = build(g)
        a, b = nodes[2], nodes[9]
        base = [int(g.add_link([a, b], value=f"m{i}")) for i in range(5)]
        incremental(pkg, g)
        g.remove(base[-1])
        fresh = [int(g.add_link([a, b], value=f"f{i}")) for i in range(2)]
        c, d = nodes[20], nodes[21]
        g.add_link([c, d], value="c0")
        g.add_link([c, d], value="c1")
        out = []
        for top_r in (3, 16):
            rt = runtime(pkg, g, 64, top_r=top_r)
            th = int(g.get_type_handle_of(fresh[0]))
            futs = [rt.submit_pattern((a, b)), rt.submit_pattern((c, d)),
                    rt.submit_pattern((a,)), rt.submit_pattern((nodes[40],)),
                    rt.submit_pattern((b, a), type_handle=th),
                    rt.submit_pattern((a, b), type_handle=th + 2),
                    rt.submit_pattern((d, c, d))]
            drain(rt)
            rt.close()
            out.append((answers(futs), counters(rt)))
        g.close()
        return out, (fresh, base)

    out, (fresh, base) = both(scenario)
    (small, cnt_small), (wide, _) = out
    assert small[0][3] == "host" and cnt_small["host_fallbacks"] >= 1
    assert set(fresh) <= set(wide[0][2]) and base[-1] not in wide[0][2]
    assert wide[0][1] == 6 and wide[0][3] == "device"
    assert wide[4][2] == wide[0][2] and wide[5][1] == 0
    assert wide[6][2] == wide[1][2]


def test_pattern_correction_uses_pinned_state():
    """The memtable candidates are captured at launch: a removal landing
    between launch and collect does not leak into the batch, and pinning a
    pattern batch uploads no device delta."""
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, links, iso = build(g)
        a, b = nodes[2], nodes[9]
        mgr = incremental(pkg, g)
        fresh = int(g.add_link([a, b], value="fresh"))
        # the port's prewarm uploads the delta at construction (the
        # reference's has nothing to warm on the CPU): count from after it
        rt = runtime(pkg, g, 64)
        up0 = (mgr.full_uploads, mgr.tail_uploads)
        fut = rt.submit_pattern((a, b))
        launched = rt.pump(drain=True)
        g.remove(fresh)
        rt.close(drain=True)
        up1 = (mgr.full_uploads, mgr.tail_uploads)
        g.close()
        return (answers([fut]), launched, up0 == up1, counters(rt)), fresh

    (res, launched, no_upload, _), fresh = both(scenario)
    assert launched and no_upload
    assert res[0][3] == "device" and fresh in res[0][2]


def test_all_host_batch_dispatches_nothing():
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, links, iso = build(g)
        hub = int(g.add("hub"))
        for i in range(9):
            g.add_link([hub, nodes[i]], value=f"h{i}")
        rt = runtime(pkg, g, 64, pattern_pad=2)
        futs = [rt.submit_pattern((hub, nodes[0])),
                rt.submit_pattern((hub, nodes[1]))]
        drain(rt)
        rt.close()
        g.close()
        return (answers(futs), counters(rt)), None

    (res, cnt), _ = both(scenario)
    assert cnt["batches"] == 1 and cnt["device_dispatches"] == 0
    assert {r[3] for r in res} == {"host"}


def test_mixed_kinds_and_submit_query_match_reference():
    def scenario(pkg):
        q = mod(pkg, "query.dsl")
        g = graph_of(pkg)
        nodes, links, iso = build(g)
        th = int(g.get_type_handle_of(links[0]))
        ts = [int(t) for t in g.get_targets(links[0])][:2]
        rt = runtime(pkg, g, 64)
        futs = [rt.submit_bfs(nodes[0], max_hops=2, include_seed=False),
                rt.submit_pattern(ts), rt.submit_pattern(ts, type_handle=th),
                rt.submit_query(q.bfs(nodes[5], max_distance=2)),
                rt.submit_query(q.incident(nodes[2])),
                rt.submit_query(q.and_(q.type_(th), *[q.incident(t)
                                                      for t in ts])),
                rt.submit_query(q.link(*ts)),
                rt.submit_query(q.value(3, op="lte"))]
        drain(rt)
        rt.close()
        g.close()
        return (answers(futs), counters(rt)), None

    (res, cnt), _ = both(scenario)
    assert [r[0] for r in res] == ["bfs", "pattern", "pattern", "bfs",
                                   "pattern", "pattern", "pattern", "range"]


class PerfTap:
    """A recording perf sentinel (``ServeConfig.perf`` is duck-typed)."""

    def __init__(self):
        self.calls = []

    def observe(self, kind, latency_s, path="device", t=None):
        self.calls.append(("observe", kind, path))

    def observe_batch(self, kind, device_s, n_real=0, n_total=0, t=None):
        self.calls.append(("observe_batch", kind, n_real, n_total))

    def maybe_tick(self):
        self.calls.append(("tick",))


def test_traced_request_spans_and_perf_feed_match_reference():
    """With an enabled tracer and ``device_timing`` every request carries
    the reference's span chain (submit → queue_wait → batch_form → launch
    → device → collect → resolve; ``block_timed`` waits on the staged
    batch), and the perf sentinel sees the same calls."""
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, links, iso = build(g)
        tracer = mod(pkg, "obs").Tracer().enable()
        tap = PerfTap()
        rt = runtime(pkg, g, 64, tracer=tracer, device_timing=True,
                     perf=tap)
        futs = [rt.submit_bfs(nodes[0]), rt.submit_pattern((nodes[1],)),
                rt.submit_bfs(10 ** 6)]
        drain(rt)
        rt.close()
        names = sorted(tuple(sp.name for sp in t.spans())
                       for t in tracer.drain())
        g.close()
        n_dev = rt.stats.registry.snapshot()["serve.device_seconds"]
        return (answers(futs), names, tap.calls, n_dev["count"]), None

    (res, names, calls, n_dev), _ = both(scenario)
    assert all({"submit", "queue_wait", "batch_form", "launch",
                "collect"} <= set(n) for n in names)
    assert sum("device" in n for n in names) == 2 and n_dev == 2
    assert ("observe_batch", "bfs", 1, 64) in calls
    assert ("observe", "bfs", "host") in calls


# ---------------------------------------------------------------- bridge


def request_fields(req):
    return (type(req).__name__, dataclasses.asdict(req))


def test_bridge_requests_match_reference():
    def scenario(pkg):
        c = mod(pkg, "query.conditions")
        q = mod(pkg, "query.dsl")
        bridge = mod(pkg, "query.bridge")
        g = graph_of(pkg)
        nodes, links, iso = build(g)
        lt = int(g.get_type_handle_of(links[0]))
        conds = [
            q.bfs(nodes[0], max_distance=3),
            c.BFS(nodes[1], max_distance=1),
            q.incident(nodes[2]),
            c.TypedIncident(nodes[2], lt),
            q.link(nodes[3], nodes[4]),
            q.and_(q.incident(nodes[3]), q.incident(nodes[4]), q.type_(lt)),
            q.value(7, op="gt"),
            c.TypedValue(7, lt, "lte"),
            c.AtomValue(5, "eq"),
            c.And(c.AtomValue(3, "gte"), c.AtomValue(9, "lt")),
            c.And(c.AtomValue(3, "gte"), c.AtomValue(9, "lt"),
                  c.AtomType(lt), c.Incident(nodes[5])),
            c.AtomValue("abc", "gte"),
            c.AtomValue("a value of more than sixteen bytes", "lte"),
        ]
        out = [request_fields(bridge.to_request(g, x)) for x in conds]
        out.append(request_fields(bridge.to_range_request(
            g, 2.5, 9.5, lo_op="gt", type_handle=lt, anchor=nodes[6],
            desc=True, limit=3)))
        g.close()
        return out, None

    res, _ = both(scenario)
    assert res[0] == ("BFSRequest", {"seed": res[0][1]["seed"],
                                     "max_hops": 3, "include_seed": False})
    assert res[-2][1]["exact"] is False and res[-3][1]["exact"] is True


@pytest.mark.parametrize("case", ["unbounded_bfs", "regex", "or", "mixed",
                                  "no_anchor", "no_bound"])
def test_bridge_unservable_conditions_match_reference(case):
    def scenario(pkg):
        c = mod(pkg, "query.conditions")
        q = mod(pkg, "query.dsl")
        bridge = mod(pkg, "query.bridge")
        Unservable = mod(pkg, "serve.types").Unservable
        g = graph_of(pkg)
        nodes, links, iso = build(g)
        make = {
            "unbounded_bfs": lambda: bridge.to_request(g, q.bfs(nodes[0])),
            "regex": lambda: bridge.to_request(g, q.value_regex("x.*")),
            "or": lambda: bridge.to_request(g, q.or_(q.incident(1),
                                                     q.incident(2))),
            "mixed": lambda: bridge.to_request(g, c.And(
                c.AtomValue(3, "gte"), c.AtomValue("z", "lt"))),
            "no_anchor": lambda: bridge.to_request(g, c.And(
                c.AtomType(int(g.get_type_handle_of(links[0]))))),
            "no_bound": lambda: bridge.to_range_request(g),
        }
        try:
            make[case]()
            out = "served"
        except Unservable:
            out = "Unservable"
        g.close()
        return out, None

    res, _ = both(scenario)
    assert res == "Unservable"


def test_join_conditions_wait_for_the_join_lane():
    """``CoIncident`` conditions go to the join lane: the bridge turns
    them into the reference's ``JoinRequest`` (signature atoms, constants,
    ``distinct=False``), and ``submit_query`` serves them through the
    device lane with the reference's counts, tuples and ``served_by``,
    each equal to ``find_all``."""
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, links, iso = build(g)
        c = mod(pkg, "query.conditions")
        bridge = mod(pkg, "query.bridge")
        conds = [c.CoIncident(nodes[0]),
                 c.And(c.CoIncident(nodes[0]), c.Incident(nodes[1])),
                 c.And(c.CoIncident(nodes[2]), c.CoIncident(nodes[3]))]
        reqs = [bridge.to_request(g, cond) for cond in conds]
        rt = runtime(pkg, g, 64)
        futs = [rt.submit_query(cond) for cond in conds]
        drain(rt)
        rt.close()
        res = [f.result(timeout=0) for f in futs]
        truth = [sorted(int(h) for h in g.find_all(cond)) for cond in conds]
        g.close()
        return ([(type(q).__name__, q.sig.atoms, q.consts, q.sig.distinct)
                 for q in reqs],
                [(r.kind, int(r.count), r.tuples.tolist(), r.served_by,
                  bool(r.truncated)) for r in res],
                counters(rt)), truth

    (reqs, res, cnt), truth = both(scenario)
    assert [q[0] for q in reqs] == ["JoinRequest"] * 3
    assert not any(q[3] for q in reqs)
    for (kind, count, tuples, by, trunc), want in zip(res, truth):
        assert kind == "join" and by == "device" and not trunc
        assert [t[0] for t in tuples] == want and count == len(want)
    assert cnt["host_fallbacks"] == 0


# ------------------------------------------------ the no-fallback guarantees


def test_a_failing_prewarm_raises_from_the_constructor(monkeypatch):
    """The reference logs and swallows a failing prewarm; the port's
    construction fails with it."""
    from hypergraphdb_tpu_torch.ops import serving

    def boom(*a, **k):
        raise RuntimeError("kernel failed to launch")

    g = graph_of(PORT)
    try:
        build(g)
        incremental(PORT, g)
        monkeypatch.setattr(serving, "bfs_serve_batch_fused", boom)
        with pytest.raises(RuntimeError, match="failed to launch"):
            runtime(PORT, g, 64)
        monkeypatch.undo()
        rt = runtime(PORT, g, 64, prewarm_range_dims=(ord("i"),))
        assert (ord("i"), "cpu") in g.incremental.base._value_index_cols
        rt.close()
    finally:
        g.close()


def test_an_exception_in_the_fused_gate_propagates(monkeypatch):
    """``fused_bfs.serve_fused_kwargs`` failing is an error on the batch
    (the retry/breaker ladder sees it); a reason string sends the batch to
    the dense sweep, counted."""
    from hypergraphdb_tpu_torch.ops import fused_bfs

    g = graph_of(PORT)
    try:
        nodes, links, iso = build(g)
        incremental(PORT, g)
        rt = runtime(PORT, g, 64, max_retries=0, breaker_threshold=99)
        calls = {"n": 0}

        def boom(*a, **k):
            calls["n"] += 1
            raise ValueError("overlay: a surprise")

        monkeypatch.setattr(fused_bfs, "serve_fused_kwargs", boom)
        fut = rt.submit_bfs(nodes[0])
        drain(rt)
        with pytest.raises(ValueError, match="a surprise"):
            fut.result(timeout=0)
        assert calls["n"] == 1 and rt.stats.errors == 1
        monkeypatch.setattr(fused_bfs, "serve_fused_kwargs",
                            lambda *a, **k: "declined for the test")
        fut = rt.submit_bfs(nodes[0])
        drain(rt)
        assert fut.result(timeout=0).matches.tolist() == bfs_truth(
            g, nodes[0], 2)
        assert rt.executor.routes == {"fused": 0, "dense": 1}
        assert rt.executor.declined == {"declined for the test": 1}
        rt.close()
    finally:
        g.close()


def test_collect_waits_on_its_own_batch_and_keeps_the_pipeline_order():
    """The real executor under ``pump``: batch N+1 launches before batch N
    is collected, and each batch's results are its own."""
    g = graph_of(PORT)
    try:
        nodes, links, iso = build(g)
        rt = runtime(PORT, g, 64)
        events = []
        ex = rt.executor
        launch, collect = ex.launch, ex.collect

        def traced_launch(batch):
            events.append(("launch", batch.key))
            return launch(batch)

        def traced_collect(token):
            events.append(("collect", token.batch.key))
            assert token.dev_out.event is None   # the CPU stages nothing
            return collect(token)

        ex.launch, ex.collect = traced_launch, traced_collect
        f1 = rt.submit_bfs(nodes[0], max_hops=1)
        rt.pump()
        f2 = rt.submit_bfs(nodes[0], max_hops=2)
        rt.pump()
        rt.pump()
        assert events == [("launch", ("bfs", 1)), ("launch", ("bfs", 2)),
                          ("collect", ("bfs", 1)), ("collect", ("bfs", 2))]
        assert f1.result(timeout=0).matches.tolist() == bfs_truth(
            g, nodes[0], 1)
        assert f2.result(timeout=0).matches.tolist() == bfs_truth(
            g, nodes[0], 2)
        assert ex.timing["bfs"]["batches"] == 2
        rt.close()
    finally:
        g.close()


def test_threaded_runtime_under_concurrent_ingest_stays_exact():
    """The dispatch thread, a background-compacting manager and a writer:
    every future resolves within its wait, the drain completes, the stats
    add up, and answers after the writer stops equal the live graph."""
    import threading

    g = graph_of(PORT)
    rt = None
    try:
        nodes, links, iso = build(g)
        incremental(PORT, g, background=True, compact_ratio=0.05)
        cfg = mod(PORT, "serve").ServeConfig(
            buckets=(16, 64), max_linger_s=0.002, max_queue=512, top_r=512,
            device="cpu")
        rt = mod(PORT, "serve").ServeRuntime(g, cfg)
        stop = threading.Event()

        def writer():
            i = 0
            while not stop.is_set() and i < 30:
                g.bulk_import(values=[f"w{i}_{j}" for j in range(10)],
                              target_lists=[[nodes[(i + j) % 100],
                                             nodes[(i * 7 + j) % 100]]
                                            for j in range(10)])
                i += 1

        wt = threading.Thread(target=writer, daemon=True)
        wt.start()
        r = np.random.default_rng(5)
        futs = [rt.submit_bfs(nodes[int(r.integers(0, 100))], max_hops=2,
                              deadline_s=30.0) if i % 3 else
                rt.submit_pattern((nodes[int(r.integers(0, 100))],),
                                  deadline_s=30.0)
                for i in range(60)]
        stop.set()
        wt.join(30)
        assert not wt.is_alive()
        for f in futs:
            assert f.result(timeout=60).count >= 0
        assert g.incremental.wait_compacted(30)
        fut = rt.submit_bfs(nodes[0], max_hops=2)
        assert fut.result(timeout=60).matches.tolist() == bfs_truth(
            g, nodes[0], 2)
        rt.close(drain=True, timeout=60)
        st = rt.stats_snapshot()
        assert st["submitted"] == st["completed"] == 61
    finally:
        if rt is not None:
            rt.close(drain=False, timeout=60)
        g.close()
