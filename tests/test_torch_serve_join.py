"""The join lane of the port's ``ServeRuntime`` against the reference's, on
the same graphs: each scenario builds one graph in both packages by the
same calls (handle numbering is equal), and submits the same join requests
through ``ServeConfig(manual=True)`` — the port with ``device="cpu"``, so
``execute_join`` runs its plain PyTorch operations. Every answer's
``count``, ``tuples``, ``vars``, ``truncated`` and ``served_by`` must be
equal, and so must the runtime's host fallbacks, device dispatches, partial
memtable corrections and hub dispatches; each answer is also held against
its package's exact host enumerator (``join.host_join``).

The cases of ``tests/test_join.py``'s serving suite: a batch of triangles
(and each shape), the mid-ingest partial correction, a dirty set past
``join_dirty_max``, a tombstone, the result window's truncation, a stale
anchor, a factorized build over its pair budget, a co relation over its
pair budget, the hub counter, a bushy signature and the bridge; plus
anchors outside the base, which go to the host before the executor.
Then the port's own rule: an error in the collect-time correction reaches
the caller instead of the host fallback. Tolerance: exact equality."""

from __future__ import annotations

import pytest

from tests.conftest import make_random_hypergraph
from tests.test_torch_graph import PKGS, mod, new_graph

PORT = PKGS[1]


def graph_of(pkg):
    if pkg == PORT:
        return new_graph(pkg, query=mod(pkg, "core.config").QueryConfig(
            device="cpu"))
    return new_graph(pkg)


def build(g, seed=0, n_nodes=80, n_links=160):
    nodes, links = make_random_hypergraph(
        g, n_nodes=n_nodes, n_links=n_links, max_arity=4, seed=seed)
    return [int(n) for n in nodes], [int(x) for x in links]


def build_hub(g, seed=0, hub_links=70):
    """A random graph plus one hub sharing a link with most atoms."""
    nodes, links = build(g, seed=seed)
    hub = nodes[0]
    for i in range(hub_links):
        g.add_link([hub, nodes[1 + i % (len(nodes) - 1)]], value=f"hub-{i}")
    return hub, nodes


def runtime(pkg, g, **kw):
    kw.setdefault("buckets", (4, 16))
    kw.setdefault("top_r", 128)
    if pkg == PORT:
        kw["device"] = "cpu"
    S = mod(pkg, "serve")
    return S.ServeRuntime(g, S.ServeConfig(manual=True, max_linger_s=0.0,
                                           **kw))


def drain(rt):
    while rt.step(drain=True):
        pass


def shapes(pkg):
    c = mod(pkg, "query.conditions")
    var = mod(pkg, "query.variables").var
    return {
        "triangle": lambda a: {
            "y": c.And(c.CoIncident(a), c.CoIncident(var("z"))),
            "z": c.CoIncident(a),
        },
        "path2": lambda a: {
            "y": c.CoIncident(a),
            "z": c.CoIncident(var("y")),
        },
        "star3": lambda a: {
            "y": c.CoIncident(a),
            "z": c.CoIncident(a),
            "w": c.CoIncident(a),
        },
        "link_var": lambda a: {
            "l": c.Incident(a),
            "y": c.Target(var("l")),
        },
    }


def truth(pkg, g, spec):
    join = mod(pkg, "join")
    return join.host_join(g, join.extract_pattern(g, spec))


def record(res) -> tuple:
    return (res.kind, int(res.count),
            [tuple(int(v) for v in row) for row in res.tuples],
            tuple(res.vars), bool(res.truncated), res.served_by)


def counters(rt) -> dict:
    st = rt.stats_snapshot()
    out = {k: st[k] for k in ("host_fallbacks", "device_dispatches",
                               "batches", "completed", "errors")}
    out["partials"] = rt.stats.join_partial_corrections
    out["hubs"] = rt.stats.join_hub_dispatches
    return out


def serve(pkg, g, specs, **kw):
    """Submit every spec in one drained runtime; each answer with its
    host truth."""
    rt = runtime(pkg, g, **kw)
    futs = [rt.submit_join(spec) for spec in specs]
    drain(rt)
    rt.close()
    res = [f.result(timeout=0) for f in futs]
    return [record(r) for r in res], counters(rt), \
        [truth(pkg, g, spec) for spec in specs]


def both(scenario):
    got = {pkg: scenario(pkg) for pkg in PKGS}
    assert got[PORT] == got[PKGS[0]]
    return got[PORT]


def exact(rec, want, top_r=128) -> bool:
    """One answer equal to its sorted host truth: the count, and the
    tuples (the first ``top_r`` when truncated)."""
    _, count, tuples, _, trunc, _ = rec
    return count == len(want) and tuples == (want[:top_r] if trunc
                                             else want)


# ---------------------------------------------------------------- batches


def test_serve_join_batch_differential():
    """A same-signature batch of anchored triangles: every lane equals its
    host truth, device-served, on both runtimes."""
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, _ = build(g, seed=16)
        out = serve(pkg, g, [shapes(pkg)["triangle"](x) for x in nodes[:8]])
        g.close()
        return out

    recs, cnt, truths = both(scenario)
    assert all(exact(r, t) for r, t in zip(recs, truths))
    assert {r[5] for r in recs} == {"device"} and cnt["host_fallbacks"] == 0


@pytest.mark.parametrize("shape", ["path2", "star3", "link_var"])
def test_serve_join_shapes(shape):
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, _ = build(g, seed=7)
        out = serve(pkg, g, [shapes(pkg)[shape](x) for x in nodes[3:7]])
        g.close()
        return out

    recs, cnt, truths = both(scenario)
    assert all(exact(r, t) for r, t in zip(recs, truths))
    assert cnt["errors"] == 0


def test_serve_join_result_window_truncation():
    """count exact + ascending prefix when the binding set outgrows
    top_r."""
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, _ = build(g, seed=18)
        out = serve(pkg, g, [shapes(pkg)["star3"](nodes[1])], top_r=4)
        g.close()
        return out

    (rec,), cnt, (want,) = both(scenario)
    assert len(want) > 4 and rec[4] and exact(rec, want, top_r=4)


def test_serve_join_bushy_signature_batch():
    """Star-of-stars requests (bushy plans under the hood)."""
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, _ = build(g, seed=39)
        c = mod(pkg, "query.conditions")
        var = mod(pkg, "query.variables").var
        specs = [{"p": c.CoIncident(x), "q": c.CoIncident(var("p")),
                  "r": c.CoIncident(y), "s": c.CoIncident(var("r"))}
                 for x, y in [(nodes[i], nodes[i + 4]) for i in range(4)]]
        out = serve(pkg, g, specs)
        g.close()
        return out

    recs, cnt, truths = both(scenario)
    assert all(exact(r, t) for r, t in zip(recs, truths))


def test_serve_join_hub_dispatch_counter():
    """A hub-anchored join dispatches its hub lane on the device through
    the degree split (``serve.join.hub_dispatches`` moves)."""
    def scenario(pkg):
        g = graph_of(pkg)
        hub, _ = build_hub(g, seed=38)
        out = serve(pkg, g, [shapes(pkg)["path2"](hub)],
                    join_hub_threshold=8)
        g.close()
        return out

    (rec,), cnt, (want,) = both(scenario)
    assert rec[5] == "device" and exact(rec, want)
    assert cnt["hubs"] > 0


# ---------------------------------------------------------------- memtable


def pinned_then(pkg, g, a, edit, **kw):
    """Pin a base with one request, apply ``edit``, then serve
    ``{"y": CoIncident(a)}``: (record, counters, truth)."""
    c = mod(pkg, "query.conditions")
    rt = runtime(pkg, g, **kw)
    f0 = rt.submit_join(shapes(pkg)["path2"](a))
    drain(rt)
    f0.result(timeout=0)
    extra = edit()
    spec = {"y": c.CoIncident(a)}
    f = rt.submit_join(spec)
    drain(rt)
    rt.close()
    return record(f.result(timeout=0)), counters(rt), truth(pkg, g, spec), \
        extra, rt.executor.mgr.compactions


@pytest.mark.parametrize("dirty_max,path", [(16, "device"), (0, "host")])
def test_serve_join_mid_ingest(dirty_max, path):
    """A link added after the base pack is visible. A small pure-add dirty
    set keeps the lane on the device and collect merges the tuples
    touching it (a partial correction); past ``join_dirty_max`` (0: the
    partial path off) the whole batch goes to the host."""
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, _ = build(g, seed=17)
        a = nodes[5]

        def edit():
            far = int(g.add_node("far"))
            g.add_link([a, far], value="mid-ingest")
            return far

        out = pinned_then(pkg, g, a, edit, join_dirty_max=dirty_max)
        g.close()
        return out

    rec, cnt, want, far, _ = both(scenario)
    assert rec[5] == path and exact(rec, want)
    assert far in {r[0] for r in rec[2]}
    assert cnt["partials"] == (1 if path == "device" else 0)


def test_serve_join_mid_ingest_tombstone_serves_host():
    """Tombstones are never partially correctable: the batch takes the
    exact host path even under a tiny dirty set."""
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, links = build(g, seed=22)
        out = pinned_then(pkg, g, nodes[4], lambda: g.remove(links[0]))
        g.close()
        return out

    rec, cnt, want, _, _ = both(scenario)
    assert rec[5] == "host" and exact(rec, want)
    assert cnt["partials"] == 0 and cnt["host_fallbacks"] == 1


@pytest.mark.parametrize("dirty_max,path", [(16, "device"), (0, "host")])
def test_serve_join_stale_anchor_exact(dirty_max, path):
    """An anchor newer than the pinned base, inside its padded id space:
    its base rows are empty and the partial correction supplies every
    memtable tuple (device); with the partial path off, the host."""
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, _ = build(g, seed=19)
        c = mod(pkg, "query.conditions")
        rt = runtime(pkg, g, join_dirty_max=dirty_max)
        f0 = rt.submit_join(shapes(pkg)["path2"](nodes[0]))
        drain(rt)
        f0.result(timeout=0)
        fresh = int(g.add_node("fresh-anchor"))
        g.add_link([fresh, nodes[2]], value="fresh-link")
        spec = {"y": c.CoIncident(fresh)}
        f = rt.submit_join(spec)
        drain(rt)
        rt.close()
        out = (record(f.result(timeout=0)), counters(rt),
               truth(pkg, g, spec), rt.executor.mgr.compactions,
               fresh < rt.executor.mgr.base.num_atoms)
        g.close()
        return out

    rec, cnt, want, compactions, inside = both(scenario)
    assert compactions == 1 and inside
    assert len(want) > 0 and exact(rec, want) and rec[5] == path


def test_serve_join_anchors_outside_the_base_go_to_the_host():
    """Constants outside ``[0, num_atoms)`` of the pinned base never reach
    the executor (which refuses them): those lanes take the exact host
    path, the rest of the batch stays on the device."""
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, _ = build(g, seed=19)
        c = mod(pkg, "query.conditions")
        bridge = mod(pkg, "query.bridge")
        rt = runtime(pkg, g)
        n = rt.executor.mgr.base.num_atoms
        req = bridge.to_join_request(g, {"y": c.CoIncident(nodes[0])})
        JoinRequest = type(req)
        futs = [rt.submit(req), rt.submit(JoinRequest(req.sig, (n + 5,))),
                rt.submit(JoinRequest(req.sig, (-1,)))]
        drain(rt)
        rt.close()
        out = [record(f.result(timeout=0)) for f in futs], counters(rt)
        g.close()
        return out

    recs, cnt = both(scenario)
    assert [r[5] for r in recs] == ["device", "host", "host"]
    assert [r[1] for r in recs[1:]] == [0, 0]
    assert cnt["host_fallbacks"] == 2 and cnt["errors"] == 0


# ---------------------------------------------------------------- budgets


def test_factorize_failure_never_poisons_plan_cache(monkeypatch):
    """A co relation over its pair budget makes the factorized build fail;
    a co-FREE signature still plans and serves on the device over the flat
    CSRs. The port counts the build's reason in ``executor.declined``."""
    def scenario(pkg):
        monkeypatch.setattr(mod(pkg, "ops.join"), "NBR_MAX_PAIRS", 1)
        g = graph_of(pkg)
        nodes, _ = build(g, seed=40)
        c = mod(pkg, "query.conditions")
        var = mod(pkg, "query.variables").var
        spec = {"l": c.Incident(nodes[2]), "y": c.Target(var("l"))}
        rt = runtime(pkg, g)
        f = rt.submit_join(spec)
        drain(rt)
        rt.close()
        out = (record(f.result(timeout=0)), counters(rt),
               truth(pkg, g, spec))
        g.close()
        return out, getattr(rt.executor, "declined", None)

    got = {pkg: scenario(pkg) for pkg in PKGS}
    assert got[PORT][0] == got[PKGS[0]][0]
    (rec, cnt, want), declined = got[PORT]
    assert want and rec[5] == "device" and exact(rec, want)
    assert [k.split(":")[0] for k in declined] == ["join factorize"]


def test_nbr_pair_budget_declines_to_host(monkeypatch):
    """A co relation over the pair budget is never built: the lane
    declines before launch and the host answers."""
    def scenario(pkg):
        monkeypatch.setattr(mod(pkg, "ops.join"), "NBR_MAX_PAIRS", 1)
        g = graph_of(pkg)
        nodes, _ = build(g, seed=21)
        c = mod(pkg, "query.conditions")
        out = serve(pkg, g, [{"y": c.CoIncident(nodes[3])}])
        g.close()
        return out

    (rec,), cnt, (want,) = both(scenario)
    assert rec[5] == "host" and exact(rec, want)
    assert cnt["device_dispatches"] == 0


# ---------------------------------------------------------------- bridge


def test_bridge_routes_coincident_conditions_to_join():
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, _ = build(g, seed=20)
        c = mod(pkg, "query.conditions")
        var = mod(pkg, "query.variables").var
        bridge = mod(pkg, "query.bridge")
        Unservable = mod(pkg, "serve.types").Unservable
        a, b = nodes[0], nodes[1]
        req = bridge.to_request(g, c.And(c.CoIncident(a), c.CoIncident(b)))
        req2 = bridge.to_request(g, c.CoIncident(a))
        same = (bridge.to_request(g, c.CoIncident(b)).batch_key
                == req2.batch_key)
        try:
            bridge.to_join_request(g, {"x": c.CoIncident(var("y")),
                                       "y": c.CoIncident(var("x"))})
            refused = None
        except Unservable as e:
            refused = type(e).__name__
        g.close()
        return ((type(req).__name__, req.consts, req.sig.distinct,
                 req.sig.atoms, req2.sig.atoms, same, refused),)

    (rec,) = both(scenario)
    assert rec[0] == "JoinRequest" and rec[2] is False and rec[5]
    assert rec[6] == "Unservable"


# ---------------------------------------------------------------- no masking


def test_correction_error_reaches_the_caller(monkeypatch):
    """The port catches only ``JoinUnsupported`` around the collect-time
    correction (the reference catches every exception and re-serves on
    the host): any other failure surfaces on the request."""
    import hypergraphdb_tpu_torch.join.host as jh

    def broken(*a, **k):
        raise RuntimeError("correction failed")

    monkeypatch.setattr(jh, "host_join_touching", broken)
    g = graph_of(PORT)
    nodes, _ = build(g, seed=17)
    a = nodes[5]
    rt = runtime(PORT, g)
    try:
        f0 = rt.submit_join(shapes(PORT)["path2"](a))
        drain(rt)
        f0.result(timeout=0)
        far = int(g.add_node("far"))
        g.add_link([a, far], value="mid-ingest")
        f = rt.submit_join({"y": mod(PORT, "query.conditions").CoIncident(a)})
        drain(rt)
        with pytest.raises(RuntimeError, match="correction failed"):
            f.result(timeout=0)
        assert rt.stats.host_fallbacks == 0
    finally:
        rt.close()
        g.close()


def test_executor_error_reaches_the_caller(monkeypatch):
    """A failing join launch is not answered by the host enumerator: it
    goes up the runtime's retry/breaker ladder and fails the request."""
    import hypergraphdb_tpu_torch.ops.join as oj

    def broken(*a, **k):
        raise RuntimeError("executor failed")

    monkeypatch.setattr(oj, "execute_join", broken)
    g = graph_of(PORT)
    nodes, _ = build(g, seed=16)
    rt = runtime(PORT, g, max_retries=0)
    try:
        f = rt.submit_join(shapes(PORT)["triangle"](nodes[0]))
        drain(rt)
        with pytest.raises(RuntimeError, match="executor failed"):
            f.result(timeout=0)
    finally:
        rt.close()
        g.close()


def test_join_routes_count_each_rule(monkeypatch):
    """``executor.join_routes`` counts every lane by the rule that routed
    it: the device, anchors outside the base, a dirty memtable past
    ``join_dirty_max``, a window the executor's row cap truncated, a
    declined plan."""
    g = graph_of(PORT)
    nodes, _ = build(g, seed=18)
    c = mod(PORT, "query.conditions")
    bridge = mod(PORT, "query.bridge")
    req = bridge.to_join_request(g, {"y": c.CoIncident(nodes[1])})

    def routes_of(reqs, edit=None, **kw):
        rt = runtime(PORT, g, **kw)
        try:
            futs = [rt.submit(r) for r in reqs]
            drain(rt)
            if edit is not None:
                edit()
                futs.append(rt.submit(req))
                drain(rt)
            for f in futs:
                f.result(timeout=0)
        finally:
            rt.close()
        return ({k: v for k, v in rt.executor.join_routes.items() if v},
                rt.stats.host_fallbacks)

    star = bridge.to_join_request(g, shapes(PORT)["star3"](nodes[1]))
    assert routes_of([star], join_row_cap=2, join_hub_split=False) == (
        {"truncated": 1}, 1)
    n = g.incremental.base.num_atoms
    assert routes_of(
        [req, type(req)(req.sig, (n,))], join_dirty_max=0,
        edit=lambda: g.add_link([nodes[1], nodes[2]], value="dirty"),
    ) == ({"device": 1, "beyond_base": 1, "dirty": 1}, 2)
    # a signature not planned on this base yet (plans are cached per base)
    monkeypatch.setattr(mod(PORT, "ops.join"), "NBR_MAX_PAIRS", 1)
    req2 = bridge.to_join_request(g, {"y": c.And(c.CoIncident(nodes[1]),
                                                 c.CoIncident(nodes[2]))})
    assert routes_of([req2]) == ({"declined": 1}, 1)
    g.close()
