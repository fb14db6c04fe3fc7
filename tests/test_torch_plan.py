"""The port's cost-based planner (``hypergraphdb_tpu_torch.plan``) against the
reference's (``hypergraphdb_tpu.plan``), on the same graphs.

The cases of ``tests/test_planner.py``, ``tests/test_plan_stats.py`` and
``tests/test_plan_feedback.py``: each builds one graph in both packages by
the same calls (handle numbering is equal) and runs the same conditions,
the port's runtime with ``device="cpu"`` so its lanes run their plain
PyTorch versions. Every forced shape of every corpus condition equals
``graph.find_all`` in both packages; the unforced ``PlanChoice`` fields
(shape, est_rows, cost, correction, alternatives, exact_est) and the
estimator's values are equal between the packages for the same graph,
baseline and feedback stream; then the port's recorded differences: the
baseline path, the narrowed ``_type_handle`` and the planner guard's
counted perf fault. Tolerance: exact equality (both packages compute
estimates and costs in float64 on the host)."""

from __future__ import annotations

import json

import numpy as np
import pytest

from tests.test_torch_graph import PKGS, mod, new_graph

PORT = PKGS[1]


def graph_of(pkg):
    if pkg == PORT:
        return new_graph(pkg, query=mod(pkg, "core.config").QueryConfig(
            device="cpu"))
    return new_graph(pkg)


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


def runtime(pkg, g, planner=None, **kw):
    kw.setdefault("top_r", 256)
    if pkg == PORT:
        kw["device"] = "cpu"
    S = mod(pkg, "serve")
    rt = S.ServeRuntime(g, S.ServeConfig(buckets=(64,), manual=True,
                                         max_linger_s=0.0, **kw))
    rt.attach_planner(planner or mod(pkg, "plan").QueryPlanner(g))
    return rt


def drain(rt):
    while rt.step(drain=True):
        pass


def skewed_graph(g, seed=42, n=40):
    """``test_planner.py``'s graph: a hub soaking most links, typed links
    with int values, a sparse corner of two links."""
    rng = np.random.default_rng(seed)
    nodes = [int(g.add(i)) for i in range(n)]
    hub = nodes[0]
    links = []
    for i in range(3 * n):
        other = nodes[1 + int(rng.integers(n - 1))]
        links.append(int(g.add_link([hub, other], value=100 + i)))
    rare = nodes[-1]
    links.append(int(g.add_link([rare, nodes[1]], value=500)))
    links.append(int(g.add_link([rare, nodes[2]], value=501)))
    return nodes, links, hub, rare


def corpus(pkg, g, nodes, links, hub, rare):
    c = mod(pkg, "query.conditions")
    lt = int(g.get_type_handle_of(links[0]))
    return [
        c.And(c.AtomValue(105, "gte"), c.AtomValue(130, "lte")),
        c.And(c.AtomValue(105, "gte"), c.AtomValue(130, "lte"),
              c.AtomType(lt)),
        c.And(c.AtomValue(100, "gte"), c.AtomValue(520, "lte"),
              c.Incident(rare)),
        c.And(c.Incident(hub), c.AtomType(lt)),
        c.And(c.Incident(rare), c.Incident(nodes[1])),
        c.And(c.CoIncident(rare)),
        c.And(c.CoIncident(rare), c.AtomValue(0, "gte")),
        c.And(c.BFS(rare, 2), c.AtomType(lt)),
        c.AtomValue(110, "eq"),
    ]


def built(pkg):
    g = graph_of(pkg)
    nodes, links, hub, rare = skewed_graph(g)
    return g, nodes, links, hub, rare, corpus(pkg, g, nodes, links, hub,
                                              rare)


def truth(g, cond):
    return sorted(int(h) for h in g.find_all(cond))


def choice_fields(ch) -> tuple:
    return (ch.shape, ch.est_rows, ch.exact_est, ch.cost, ch.correction,
            ch.guard_vetoed, ch.epoch, ch.alternatives)


# ------------------------------------------------- test_planner.py's cases


def test_every_candidate_shape_is_result_identical(pkg):
    g, nodes, links, hub, rare, conds = built(pkg)
    rt = runtime(pkg, g)
    futs = []
    for cond in conds:
        want = truth(g, cond)
        shapes = rt.planner.shapes_for(cond)
        assert "host" in shapes
        for shape in shapes:
            futs.append((cond, shape, want,
                         rt.submit_planned(cond, force_shape=shape)))
    drain(rt)
    rt.close()
    for cond, shape, want, fut in futs:
        res = fut.result(timeout=0)
        assert list(res.matches) == want, (cond, shape)
        assert res.count == len(want)
        assert not res.truncated
        assert res.plan["shape"] == shape
    g.close()


def test_shapes_and_forced_answers_equal_the_reference():
    """Per condition, the enumerable shapes and each forced answer (rows,
    served_by, the lane that answered, the plan record) are equal."""
    out = {}
    for pkg in PKGS:
        g, nodes, links, hub, rare, conds = built(pkg)
        rt = runtime(pkg, g)
        futs = [(rt.planner.shapes_for(cond), shape,
                 rt.submit_planned(cond, force_shape=shape))
                for cond in conds for shape in rt.planner.shapes_for(cond)]
        drain(rt)
        rt.close()
        out[pkg] = []
        for shapes, shape, fut in futs:
            res = fut.result(timeout=0)
            out[pkg].append((shapes, shape, res.matches, res.served_by,
                             res.lane_kind, res.plan))
        g.close()
    assert out[PKGS[1]] == out[PKGS[0]]


def test_planner_default_choice_matches_oracle(pkg):
    g, nodes, links, hub, rare, conds = built(pkg)
    obs = mod(pkg, "obs")
    rt = runtime(pkg, g, tracer=obs.Tracer().enable())
    futs = [(cond, truth(g, cond), rt.submit_planned(cond, explain=True))
            for cond in conds]
    drain(rt)
    rt.close()
    for cond, want, fut in futs:
        res = fut.result(timeout=0)
        assert list(res.matches) == want, cond
        assert "est_rows" in res.plan and "actual_rows" in res.plan
        assert res.plan["actual_rows"] >= 0
        ex = getattr(fut, "explain", None)
        assert ex is not None and ex["plan"]["shape"] == res.plan["shape"]
    assert rt.stats.plan_requests == len(conds)
    assert sum(rt.stats.plan_choice_counts().values()) == len(conds)
    g.close()


def test_unforced_choices_equal_the_reference():
    """The same graph, baseline and feedback stream: every unforced
    ``PlanChoice`` field equal, before and after the feedback warms up,
    and the stats each package's runtime recorded."""
    baseline = {"schema_version": 1, "backend": "cuda", "lanes": {
        "bfs": {"p50_s": 0.0185}, "range": {"p50_s": 0.031},
        "pattern": {"p50_s": 0.0402}, "join": {"p50_s": 0.0169}}}
    out = {}
    for pkg in PKGS:
        P = mod(pkg, "plan")
        g, nodes, links, hub, rare, conds = built(pkg)
        planner = P.QueryPlanner(g, baseline=baseline,
                                 feedback=P.PlanFeedback(min_samples=4))
        rt = runtime(pkg, g, planner=planner)
        first = [choice_fields(planner.plan(cond)) for cond in conds]
        # the feedback stream: each condition's every forced shape, three
        # times, through the runtime (actual rows close the loop)
        for _ in range(3):
            futs = [rt.submit_planned(cond, force_shape=shape)
                    for cond in conds for shape in planner.shapes_for(cond)]
            drain(rt)
            for f in futs:
                f.result(timeout=0)
        after = [choice_fields(planner.plan(cond)) for cond in conds]
        rt.close()
        health = planner.health_summary()
        health.pop("priors", None)
        out[pkg] = (first, after, planner.feedback.snapshot(), health,
                    rt.stats.plan_choice_counts(), rt.stats.plan_requests,
                    rt.stats.plan_feedback_updates)
        g.close()
    assert out[PKGS[1]] == out[PKGS[0]]
    first, after = out[PORT][0], out[PORT][1]
    assert first != after  # the stream moved some correction


def test_planner_prefers_cheap_anchor_on_skewed_graph(pkg):
    c = mod(pkg, "query.conditions")
    g, nodes, links, hub, rare, conds = built(pkg)
    rt = runtime(pkg, g)
    cond = c.And(c.Incident(hub), c.Incident(rare))
    choice = rt.planner.plan(cond)
    est = rt.planner.estimator
    assert choice.est_rows <= est.degree(rare)
    assert choice.est_rows < est.degree(hub)
    fut = rt.submit_planned(cond)
    drain(rt)
    rt.close()
    assert list(fut.result(timeout=0).matches) == truth(g, cond)
    g.close()


def test_truncated_lane_windows_reserve_exactly(pkg):
    c = mod(pkg, "query.conditions")
    g, nodes, links, hub, rare, conds = built(pkg)
    rt = runtime(pkg, g, top_r=4)
    cond = c.And(c.AtomValue(100, "gte"), c.AtomValue(400, "lte"))
    want = truth(g, cond)
    assert len(want) > 4
    fut = rt.submit_planned(cond, force_shape="range_first")
    drain(rt)
    rt.close()
    res = fut.result(timeout=0)
    assert list(res.matches) == want
    assert res.served_by == "host"
    assert not res.truncated
    g.close()


def test_submit_planned_requires_attached_planner(pkg):
    S = mod(pkg, "serve")
    c = mod(pkg, "query.conditions")
    g = graph_of(pkg)
    kw = {"device": "cpu"} if pkg == PORT else {}
    rt = S.ServeRuntime(g, S.ServeConfig(buckets=(64,), manual=True,
                                         max_linger_s=0.0, **kw))
    with pytest.raises(mod(pkg, "serve.types").Unservable):
        rt.submit_planned(c.AtomValue(1, "eq"))
    rt.close()
    g.close()


def test_force_shape_rejects_non_candidates(pkg):
    c = mod(pkg, "query.conditions")
    g = graph_of(pkg)
    g.add(1)
    rt = runtime(pkg, g)
    with pytest.raises(ValueError):
        rt.planner.plan(c.AtomValue(1, "eq"), force_shape="bfs")
    rt.close()
    g.close()


def test_plan_metrics_reach_the_registry(pkg):
    g, nodes, links, hub, rare, conds = built(pkg)
    rt = runtime(pkg, g)
    futs = [rt.submit_planned(cond) for cond in conds]
    drain(rt)
    for f in futs:
        f.result(timeout=0)
    names = rt.stats.registry.names()
    for name in ("plan.requests", "plan.est_rows", "plan.actual_rows",
                 "plan.abs_rel_error", "plan.guard_vetoes"):
        assert name in names
    assert rt.stats.plan_requests == len(futs)
    rt.close()
    g.close()


# --------------------------------------------- the baseline: port's rules


def test_planner_priors_read_the_named_baseline(tmp_path, monkeypatch):
    """``HG_PERF_BASELINE`` names the record and the priors come from it;
    a missing file plans on the default table and ``health_summary``
    says so; an unreadable file or a wrong schema raises."""
    P = mod(PORT, "plan")
    from hypergraphdb_tpu_torch.plan.planner import DEFAULT_LANE_PRIOR_S

    g = graph_of(PORT)
    path = tmp_path / "PERF_BASELINE.json"
    path.write_text(json.dumps({
        "schema_version": 1, "backend": "cuda",
        "lanes": {"join": {"p50_s": 0.123, "qps": 10.0},
                  "range": {"p50_s": 0.004}},
    }))
    monkeypatch.setenv("HG_PERF_BASELINE", str(path))
    p = P.QueryPlanner.from_committed_baseline(g)
    assert p._priors["join"] == 0.123 and p._priors["range"] == 0.004
    assert p._priors["pattern"] == DEFAULT_LANE_PRIOR_S["pattern"]
    pri = p.health_summary()["priors"]
    assert pri["source"] == str(path) and pri["backend"] == "cuda"
    assert pri["lanes"]["join"] == {"p50_s": 0.123, "from": "baseline"}
    assert pri["lanes"]["pattern"]["from"] == "default"

    missing = tmp_path / "absent.json"
    monkeypatch.setenv("HG_PERF_BASELINE", str(missing))
    p2 = P.QueryPlanner.from_committed_baseline(g)
    assert p2._priors == DEFAULT_LANE_PRIOR_S
    assert p2.health_summary()["priors"]["source"] == (
        f"none (no file at {missing})")

    path.write_text(json.dumps({"schema_version": 2, "lanes": {}}))
    monkeypatch.setenv("HG_PERF_BASELINE", str(path))
    with pytest.raises(ValueError):
        P.QueryPlanner.from_committed_baseline(g)
    path.write_text("{not json")
    with pytest.raises(ValueError):
        P.QueryPlanner.from_committed_baseline(g)
    with pytest.raises(IsADirectoryError):
        P.QueryPlanner.from_committed_baseline(g, path=str(tmp_path))
    g.close()


def test_default_baseline_is_never_the_repository_record(monkeypatch):
    """Without ``HG_PERF_BASELINE`` the port names no file (the
    reference falls back to the repository root's CPU record) and the
    planner plans on the default table."""
    perf = mod(PORT, "obs.perf")
    P = mod(PORT, "plan")
    monkeypatch.delenv("HG_PERF_BASELINE", raising=False)
    assert perf.default_baseline_path() is None
    ref = mod(PKGS[0], "obs.perf").default_baseline_path()
    assert ref.endswith("PERF_BASELINE.json")
    g = graph_of(PORT)
    p = P.QueryPlanner.from_committed_baseline(g)
    assert p._priors == P.planner.DEFAULT_LANE_PRIOR_S
    assert p.health_summary()["priors"]["source"] == (
        "none (HG_PERF_BASELINE unset)")
    g.close()


# --------------------------------------------- swallowed errors not copied


def test_unknown_type_is_no_estimate_other_errors_raise():
    """``_type_handle``: an unknown type name gives no estimate (both
    packages); any other error of the type system reaches the caller in
    the port (the reference swallows it)."""
    for pkg in PKGS:
        c = mod(pkg, "query.conditions")
        g = graph_of(pkg)
        g.add(1)
        p = mod(pkg, "plan").QueryPlanner(g)
        assert p._type_handle(c.AtomType("no-such-type")) is None
        g.close()
    c = mod(PORT, "query.conditions")
    g = graph_of(PORT)
    p = mod(PORT, "plan").QueryPlanner(g)

    def broken(name):
        raise RuntimeError("type store unavailable")

    g.typesystem.handle_of = broken
    with pytest.raises(RuntimeError):
        p._type_handle(c.AtomType("int"))
    g.close()


def test_guard_counts_a_failing_sentinel():
    """``attach_planner``'s guard: a sentinel whose summary raises is
    counted (``serve.perf_observe_errors``) and vetoes nothing."""

    class BrokenSentinel:
        def health_summary(self):
            raise RuntimeError("boom")

        def observe(self, *a, **k):
            pass

        def observe_batch(self, *a, **k):
            pass

        def maybe_tick(self):
            return None

    P = mod(PORT, "plan")
    g = graph_of(PORT)
    planner = P.QueryPlanner(g)
    rt = runtime(PORT, g, planner=planner, perf=BrokenSentinel())
    assert planner.lane_degraded("bfs") is False
    assert planner.lane_degraded("join") is False
    assert rt.stats.perf_observe_errors == 2
    rt.close()
    g.close()


# --------------------------------------------- test_plan_stats.py's cases


def uniform_graph(g, seed=42, n=80):
    rng = np.random.default_rng(seed)
    nodes = [int(g.add(i)) for i in range(n)]
    links = []
    for i in range(n):
        a, b = rng.choice(n, size=2, replace=False)
        links.append(int(g.add_link([nodes[a], nodes[b]], value=1000 + i)))
    return nodes, links


def hub_heavy_graph(g, seed=42, n=80, n_hubs=3):
    rng = np.random.default_rng(seed)
    nodes = [int(g.add(i)) for i in range(n)]
    hubs = nodes[:n_hubs]
    links = []
    for i in range(4 * n):
        hub = hubs[int(rng.integers(n_hubs))]
        other = nodes[int(rng.integers(n_hubs, n))]
        links.append(int(g.add_link([hub, other], value=1000 + i)))
    return nodes, links


FAMILIES = {"uniform": uniform_graph, "hub_heavy": hub_heavy_graph}


def estimates(pkg, family, seed=7) -> dict:
    """Every estimator read over one family graph, as plain data, and
    each exact one's oracle count."""
    c = mod(pkg, "query.conditions")
    g = graph_of(pkg)
    nodes, links = FAMILIES[family](g)
    est = mod(pkg, "plan").CardinalityEstimator(g)
    rng = np.random.default_rng(seed)
    out = {"n_atoms": est.n_atoms(), "epoch": est.epoch,
           "stats": [tuple(vars(est.degree_stats(t)).values())
                     for t in (None, int(g.get_type_handle_of(nodes[0])),
                               int(g.get_type_handle_of(links[0])))],
           "windows": [], "incident": [], "co": [], "bfs": [], "types": []}
    oracle = []
    for _ in range(12):
        lo, hi = sorted(int(v) for v in rng.integers(-5, 1400, size=2))
        for lo_op, hi_op in (("gte", "lte"), ("gt", "lt")):
            e = est.range_window(lo=lo, hi=hi, lo_op=lo_op, hi_op=hi_op)
            out["windows"].append((e.rows, e.exact))
            oracle.append((e, c.And(c.AtomValue(lo, lo_op),
                                    c.AtomValue(hi, hi_op))))
    for h in nodes[:8]:
        e = est.incident_count(h)
        out["incident"].append((e.rows, e.exact))
        oracle.append((e, c.Incident(h)))
        e = est.coincident_count(h)
        out["co"].append((e.rows, e.exact))
        out["bfs"].append([tuple(vars(est.bfs_frontier(h, k)).values())
                           for k in (1, 2, 3)])
    for h in (nodes[0], links[0]):
        th = int(g.get_type_handle_of(h))
        out["types"].append(est.type_count(th))
        oracle.append((mod(pkg, "plan").Estimate(
            float(est.type_count(th)), True), c.AtomType(th)))
    counts = [(e.rows, sum(1 for _ in g.find_all(cond)))
              for e, cond in oracle if e.exact]
    g.close()
    return out, counts


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_estimator_values_equal_the_reference(family):
    ref, _ = estimates(PKGS[0], family)
    got, counts = estimates(PORT, family)
    assert got == ref
    assert counts and all(rows == n for rows, n in counts)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_range_window_open_bounds_exact(family):
    c = mod(PORT, "query.conditions")
    g = graph_of(PORT)
    FAMILIES[family](g)
    est = mod(PORT, "plan").CardinalityEstimator(g)
    for kw in (dict(lo=20), dict(hi=20), dict(lo=1005, lo_op="gt")):
        e = est.range_window(**kw)
        cl = (c.AtomValue(kw["lo"], kw.get("lo_op", "gte")) if "lo" in kw
              else c.AtomValue(kw["hi"], "lte"))
        assert e.exact
        assert e.rows == sum(1 for _ in g.find_all(cl))
    g.close()


def test_str_windows_exact_only_when_clean():
    c = mod(PORT, "query.conditions")
    g = graph_of(PORT)
    for s in ("ant", "bee", "cat", "dog", "elk"):
        g.add(s)
    est = mod(PORT, "plan").CardinalityEstimator(g)
    e = est.range_window(lo="b", hi="d")
    assert e.exact
    assert e.rows == sum(1 for _ in g.find_all(
        c.And(c.AtomValue("b", "gte"), c.AtomValue("d", "lte"))))
    g.add("a string well past the sixteen-byte rank prefix")
    est2 = mod(PORT, "plan").CardinalityEstimator(g)
    assert not est2.range_window(lo="b", hi="d").exact
    g.close()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_degree_stats_and_models(family):
    """Degree stats against a numpy oracle; the co-incidence model an
    upper bound within 4×; the BFS model capped and inexact."""
    c = mod(PORT, "query.conditions")
    g = graph_of(PORT)
    nodes, links = FAMILIES[family](g)
    est = mod(PORT, "plan").CardinalityEstimator(g)
    st = est.degree_stats()
    deg = np.asarray([sum(1 for _ in g.find_all(c.Incident(int(h))))
                      for h in g.atoms()], dtype=np.int64)
    assert st.n == len(deg) and st.max == deg.max()
    assert abs(st.mean - deg.mean()) <= 0.01 * max(1.0, deg.mean())
    assert (st.hubs == 0) if family == "uniform" else (st.hubs >= 3)
    for h in nodes[:6]:
        n = sum(1 for _ in g.find_all(c.CoIncident(h)))
        e = est.coincident_count(h)
        assert e.rows >= n and (not n or e.rows <= 4.0 * n)
        for hops in (1, 2, 3):
            b = est.bfs_frontier(h, hops)
            assert not b.exact and 0.0 <= b.rows <= est.n_atoms()
    g.close()


def test_refresh_tracks_mutations(pkg):
    g = graph_of(pkg)
    g.add(1)
    est = mod(pkg, "plan").CardinalityEstimator(g)
    assert est.range_window(lo=0, hi=10).rows == 1
    g.add(2)
    g.add(3)
    assert est.range_window(lo=0, hi=10).rows == 3
    g.close()


# ------------------------------------------ test_plan_feedback.py's cases


def feedback_trace(pkg, seed=42):
    fb = mod(pkg, "plan").PlanFeedback(min_samples=8)
    rng = np.random.default_rng(seed)
    raw_err, corr_err, stored = [], [], []
    for _ in range(120):
        est = float(rng.uniform(50, 5000))
        actual = est * 0.3 * float(rng.uniform(0.8, 1.2))
        corrected = est * fb.correction("join")
        raw_err.append(abs(est - actual) / actual)
        corr_err.append(abs(corrected - actual) / actual)
        stored.append(fb.observe("join", est, actual))
    return fb, raw_err, corr_err, stored


def test_replayed_trace_shrinks_median_relative_error():
    ref = feedback_trace(PKGS[0])
    fb, raw_err, corr_err, stored = feedback_trace(PORT)
    assert (raw_err, corr_err, stored) == ref[1:]
    assert fb.snapshot() == ref[0].snapshot()
    assert np.median(corr_err) < 0.5 * np.median(raw_err)
    assert 0.25 <= fb.snapshot()["shapes"]["join"]["correction"] <= 0.4


def test_feedback_bounds_and_gates(pkg):
    """Warm-up and disabled identity, ratio clamps, the LRU bound, bad
    clamps rejected — each package the same."""
    PF = mod(pkg, "plan").PlanFeedback
    fb = PF(min_samples=4)
    assert fb.correction("join") == 1.0
    for _ in range(3):
        fb.observe("join", 100.0, 50.0)
    assert fb.correction("join") == 1.0
    fb.observe("join", 100.0, 50.0)
    assert fb.correction("join") == 0.5
    fb.enabled = False
    assert fb.correction("join") == 1.0 and fb.corrections_active() == 0
    fb = PF(min_samples=1, clamp=(0.25, 4.0))
    assert fb.observe("s", 1000.0, 1.0) == 0.25
    assert fb.observe("s", 1.0, 1000.0) == 4.0
    assert fb.observe("s", 10.0, 20.0) == 2.0
    assert fb.snapshot()["clamped"] == 2
    assert fb.observe("s", 0.0, 5.0) is None
    assert fb.observe("s", float("nan"), 5.0) is None
    fb = PF(max_shapes=3, min_samples=1)
    for name in ("a", "b", "c", "a", "d"):
        fb.observe(name, 10.0, 20.0)
    assert set(fb.snapshot()["shapes"]) == {"a", "c", "d"}
    assert fb.correction("b") == 1.0
    for kw in (dict(clamp=(1.5, 4.0)), dict(clamp=(0.5, 0.9)),
               dict(max_shapes=0)):
        with pytest.raises(ValueError):
            PF(**kw)


def overcount_graph(g, n_links=1500):
    sats = [int(g.add(1000 + i)) for i in range(10)]
    anchor = int(g.add(999))
    for i in range(n_links):
        g.add_link([anchor, sats[i % 10], sats[(i + 1) % 10]], value=i)
    return anchor


def guard_drill(pkg) -> list:
    """``test_correction_flips_argmin_and_sentinel_guard_vetoes`` as a
    record: raw choice, the warmed correction's flip onto the join lane,
    the veto when the join lane is degraded, no veto for another lane."""
    c = mod(pkg, "query.conditions")
    P = mod(pkg, "plan")
    g = graph_of(pkg)
    anchor = overcount_graph(g)
    cond = c.And(c.CoIncident(anchor), c.AtomValue(0, "gte"))
    n = len(truth(g, cond))
    planner = P.QueryPlanner(g, feedback=P.PlanFeedback(min_samples=8))
    out = [n, choice_fields(planner.plan(cond))]
    for _ in range(10):
        forced = planner.plan(cond, force_shape="join")
        planner.observe(forced, n)
    out.append(planner.feedback.correction("join"))
    out.append(choice_fields(planner.plan(cond)))
    planner.lane_degraded = lambda kind: kind == "join"
    out.append(choice_fields(planner.plan(cond)))
    planner.lane_degraded = lambda kind: kind == "bfs"
    out.append(choice_fields(planner.plan(cond)))
    h = planner.health_summary()
    out.append({k: v for k, v in h.items() if k != "priors"})
    g.close()
    return out


def test_correction_flips_argmin_and_sentinel_guard_vetoes():
    ref = guard_drill(PKGS[0])
    got = guard_drill(PORT)
    assert got == ref
    n, raw, corr, flipped, vetoed, other, health = got
    assert n == 10 and raw[0] == "host" and corr == 0.25
    assert flipped[0] == "join" and not flipped[5]
    assert vetoed[0] == "host" and vetoed[5]
    assert not other[5]
    assert health["guard_vetoes"] == 1


def test_planner_health_summary_shape(pkg):
    g = graph_of(pkg)
    planner = mod(pkg, "plan").QueryPlanner(g)
    g.add(1)
    h = planner.health_summary()
    want = {"enabled", "corrections_active", "guard_vetoes", "shapes",
            "updates"}
    assert set(h) == (want | {"priors"} if pkg == PORT else want)
    assert h["enabled"] is True and h["guard_vetoes"] == 0
    g.close()
