"""The query compiler's join pushdown in the port against the reference:
``find_all(And(CoIncident+, [Incident*], [AtomType], [AtomValue{1,2}]))``
plans as a ``DeviceJoinPlan`` carrying the classic host plan, and both
packages answer each query with the same handles and take the same arm
(the ``query.join.device`` / ``query.join.host`` counters) at equal
``QueryConfig`` s — the port on ``device="cpu"``, with ``device_min_batch``
set equal on both sides (the port's default is 16,384, the reference's
262,144). Covered: the cost model at its default, the device arm forced
open (``host_cost_bytes`` patched to infinity on both sides, as the
reference's own tests do), typed and value-constrained conjunctions, the
memtable's exact corrections and fallbacks, the co relation's pair budget,
and the port's own rules: an executor error reaches the caller, a
variable-width value window declines to the host (the reference answers
it from tied ranks), and without CUDA the default query device raises.
Graphs come from one seed in both packages (equal handles). Tolerance:
exact equality."""

from __future__ import annotations

import numpy as np
import pytest

from tests.conftest import make_random_hypergraph
from tests.test_torch_graph import PKGS, mod, new_graph

PORT = PKGS[1]


def graph_of(pkg, device="cpu"):
    if pkg == PORT:
        return new_graph(pkg, query=mod(pkg, "core.config").QueryConfig(
            device=device))
    return new_graph(pkg)


def build(g, seed=0, n_nodes=80, n_links=160):
    nodes, links = make_random_hypergraph(
        g, n_nodes=n_nodes, n_links=n_links, max_arity=4, seed=seed)
    return [int(n) for n in nodes], [int(x) for x in links]


def arms(g) -> dict:
    return {k: v for k, v in g.metrics.counters.items()
            if k.startswith("query.join.")}


def both(scenario):
    got = {pkg: scenario(pkg) for pkg in PKGS}
    assert got[PORT] == got[PKGS[0]]
    return got[PORT]


def open_device_arm(monkeypatch, pkg, g):
    """The reference's own way to reach the device arm on a toy graph:
    both gates pinned open."""
    monkeypatch.setattr(g.config.query, "device_min_batch", 0)
    monkeypatch.setattr(mod(pkg, "join.planner"), "host_cost_bytes",
                        lambda *_: float("inf"))


def queries(pkg, nodes, th=None):
    c = mod(pkg, "query.conditions")
    out = [c.And(c.CoIncident(nodes[3]), c.CoIncident(nodes[8])),
           c.And(c.CoIncident(nodes[1]), c.Incident(nodes[2])),
           c.And(c.CoIncident(nodes[4]), c.CoIncident(nodes[5]),
                 c.CoIncident(nodes[6]))]
    if th is not None:
        out.append(c.And(c.CoIncident(nodes[2]), c.AtomType(th)))
    return out


def answers(g, conds) -> list:
    return [sorted(int(h) for h in g.find_all(cond)) for cond in conds]


def truth(pkg, g, conds) -> list:
    """Each conjunction by direct ``satisfies`` over every atom."""
    return [sorted(int(h) for h in g.atoms()
                   if all(cl.satisfies(g, h) for cl in cond.clauses))
            for cond in conds]


# ---------------------------------------------------------------- plans


def test_pushdown_plans_a_device_join_plan():
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, _ = build(g, seed=14)
        c = mod(pkg, "query.conditions")
        cq = mod(pkg, "query.compiler").compile_query
        plans = [cq(g, cond).plan for cond in (
            c.And(c.CoIncident(nodes[3]), c.CoIncident(nodes[8])),
            c.And(c.CoIncident(nodes[3]), c.Incident(nodes[8]),
                  c.AtomValue(5, "gte")),
            c.And(c.Incident(nodes[3]), c.Incident(nodes[8])),
        )]
        out = [(type(p).__name__, getattr(p, "sig", None) and p.sig.atoms,
                len(getattr(p, "value_conds", ())),
                type(getattr(p, "fallback", None)).__name__,
                p.estimate(g)) for p in plans]
        g.close()
        return out

    recs = both(scenario)
    assert [r[0] for r in recs[:2]] == ["DeviceJoinPlan"] * 2
    assert recs[1][2] == 1 and recs[2][0] != "DeviceJoinPlan"


@pytest.mark.parametrize("dmb", [0, 1 << 14, 1 << 18])
def test_pushdown_arms_match_reference_at_equal_config(dmb):
    """The cost model's own decision (no gate patched): same answers, same
    arm counters at equal ``device_min_batch``."""
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, _ = build(g, seed=14)
        g.config.query.device_min_batch = dmb
        th = int(g.get_type_handle_of(
            g.add_link([nodes[2], nodes[9]], value="typed-probe")))
        conds = queries(pkg, nodes, th)
        out = answers(g, conds), arms(g), truth(pkg, g, conds)
        g.close()
        return out

    got, counters, want = both(scenario)
    assert got == want


@pytest.mark.parametrize("seed", [14, 15, 16])
def test_single_var_pushdown_equals_host(monkeypatch, seed):
    """With the device arm pinned open, every conjunction answers as the
    host plan does, through the executor on both packages."""
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, _ = build(g, seed=seed)
        th = int(g.get_type_handle_of(
            g.add_link([nodes[2], nodes[9]], value="typed-probe")))
        conds = queries(pkg, nodes, th)
        host = answers(g, conds)
        open_device_arm(monkeypatch, pkg, g)
        out = answers(g, conds), host, arms(g)
        g.close()
        return out

    dev, host, counters = both(scenario)
    assert dev == host
    assert counters.get("query.join.device", 0) == 4


def test_pushdown_with_memtable_falls_back_exact(monkeypatch):
    """A link added after the snapshot was packed is visible whichever arm
    answers."""
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, _ = build(g, seed=15)
        c = mod(pkg, "query.conditions")
        a, b = nodes[2], nodes[6]
        g.snapshot()
        fresh = int(g.add_link([a, b], value="fresh"))
        cond = c.And(c.CoIncident(a), c.CoIncident(b))
        monkeypatch.setattr(g.config.query, "device_min_batch", 0)
        got = answers(g, [cond])
        out = got, truth(pkg, g, [cond]), fresh, arms(g)
        g.close()
        return out

    got, want, fresh, _ = both(scenario)
    assert got == want and fresh not in got[0]


@pytest.mark.parametrize("edit", ["add", "remove", "revalue"])
def test_pushdown_under_incremental_mode(monkeypatch, edit):
    """Incremental mode with the device arm open: fresh links are merged
    from the memtable on the device arm; a tombstone or a revalue sends
    the query to the host plan."""
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, links = build(g, seed=23)
        c = mod(pkg, "query.conditions")
        kw = {"background": False, "compact_ratio": 100.0}
        if pkg == PORT:
            kw["device"] = "cpu"
        g.enable_incremental(**kw)
        a, b = nodes[2], nodes[6]
        if edit == "add":
            g.add_link([a, b, nodes[11]], value="fresh")
            g.add_link([a, nodes[12]], value="fresh2")
        elif edit == "remove":
            g.remove(int(g.get_incidence_set(a).array()[0]))
        else:
            g.replace(links[0], 12345)
        open_device_arm(monkeypatch, pkg, g)
        conds = [c.And(c.CoIncident(a), c.CoIncident(b)),
                 c.And(c.CoIncident(a), c.Incident(nodes[12]))]
        out = answers(g, conds), truth(pkg, g, conds), arms(g)
        g.incremental.close()
        g.close()
        return out

    got, want, counters = both(scenario)
    assert got == want
    arm = "query.join.device" if edit == "add" else "query.join.host"
    assert counters.get(arm, 0) == 2


def test_nbr_pair_budget_declines_to_host(monkeypatch):
    """Over the co relation's pair budget the executor refuses
    (``JoinUnsupported``) and the host plan answers."""
    def scenario(pkg):
        monkeypatch.setattr(mod(pkg, "ops.join"), "NBR_MAX_PAIRS", 1)
        g = graph_of(pkg)
        nodes, _ = build(g, seed=21)
        open_device_arm(monkeypatch, pkg, g)
        conds = queries(pkg, nodes)
        out = answers(g, conds), truth(pkg, g, conds), arms(g)
        g.close()
        return out

    got, want, counters = both(scenario)
    assert got == want and counters == {"query.join.host": 3}


# ---------------------------------------------------------------- values


def value_graph(pkg):
    g = graph_of(pkg)
    vn = [int(g.add(100 + i)) for i in range(12)]
    anchor = vn[0]
    for i in range(1, 12):
        g.add_link([anchor, vn[i]], value=f"l{i}")
    return g, vn, anchor


def test_join_value_window_filters_candidates():
    """The executor hook: a rank window through ``execute_join``
    (``value_windows``) filters the intersection candidates inside the
    step — counts and bindings equal to the host plan's answer."""
    def scenario(pkg):
        g, vn, anchor = value_graph(pkg)
        c = mod(pkg, "query.conditions")
        planner = mod(pkg, "join.planner")
        ob = mod(pkg, "utils.ordered_bytes")
        cond = c.And(c.CoIncident(anchor), c.AtomValue(103, "gte"),
                     c.AtomValue(108, "lt"))
        want = sorted(int(h) for h in g.find_all(cond))
        plan_obj = planner.try_single_var_join(
            g, [c.CoIncident(anchor)], fallback=None,
            value_conds=[c.AtomValue(103, "gte"), c.AtomValue(108, "lt")])
        snap = g.snapshot()
        jp = planner.plan_join(snap, plan_obj.pattern, plan_obj.sig,
                               plan_obj.consts)
        win = {jp.order[0]: (ord("i"), ob.rank64(ob.encode_int(103)), "gte",
                             ob.rank64(ob.encode_int(108)), "lt")}
        consts = np.asarray([plan_obj.consts], dtype=np.int32)
        kw = {"device": "cpu"} if pkg == PORT else {}
        ex = mod(pkg, "ops.join").execute_join
        out = ex(snap, jp, consts, top_r=16, value_windows=win, **kw)
        nf = ex(snap, jp, consts, top_r=16, **kw)
        rows = np.asarray(out.tuples)[0]
        res = (want, bool(np.asarray(out.trunc)[0]),
               int(np.asarray(out.counts)[0]),
               sorted(int(x) for x in rows[rows[:, 0] >= 0][:, 0]),
               int(np.asarray(nf.counts)[0]))
        g.close()
        return res

    want, trunc, count, got, unfiltered = both(scenario)
    assert len(want) == 5 and not trunc
    assert count == len(want) and got == want and unfiltered == 11


def test_join_pushdown_plan_carries_value_conds(monkeypatch):
    """Through ``find_all``: the value-constrained co-incidence conjunction
    plans as a ``DeviceJoinPlan`` carrying the value conditions, exact on
    either arm; memtable candidates respect the window."""
    def scenario(pkg, forced):
        g, vn, anchor = value_graph(pkg)
        c = mod(pkg, "query.conditions")
        cq = mod(pkg, "query.compiler").compile_query(g, c.And(
            c.CoIncident(anchor), c.AtomValue(103, "gte"),
            c.AtomValue(108, "lt")))
        cond = c.And(c.CoIncident(anchor), c.AtomValue(103, "gte"),
                     c.AtomValue(108, "lt"))
        if forced:
            open_device_arm(monkeypatch, pkg, g)
        got = sorted(int(h) for h in g.find_all(cond))
        kw = {"background": False, "compact_ratio": 100.0}
        if pkg == PORT:
            kw["device"] = "cpu"
        g.enable_incremental(**kw)
        inwin = int(g.add(105))
        outwin = int(g.add(150))
        g.add_link([anchor, inwin], value="f1")
        g.add_link([anchor, outwin], value="f2")
        got2 = sorted(int(h) for h in g.find_all(cond))
        out = (type(cq.plan).__name__, len(cq.plan.value_conds), got, got2,
               inwin, outwin, arms(g))
        g.incremental.close()
        g.close()
        return out

    for forced in (False, True):
        name, n_vc, got, got2, inwin, outwin, counters = both(
            lambda pkg: scenario(pkg, forced))
        assert name == "DeviceJoinPlan" and n_vc == 2 and len(got) == 5
        assert inwin in got2 and outwin not in got2
        if forced:
            assert counters == {"query.join.device": 2}


def test_variable_width_window_declines_to_the_host(monkeypatch):
    """A string window: the executor compares one 64-bit rank a value, so
    strings sharing their first 8 bytes tie there. The port's plan sends
    the query to the host plan and answers exactly; the reference runs it
    on the device and admits tied strings below the bound."""
    got = {}
    for pkg in PKGS:
        g = graph_of(pkg)
        c = mod(pkg, "query.conditions")
        vals = ["abcdefghA", "abcdefghM", "abcdefghZ", "abcdefgh", "b",
                "abcdefghMM"]
        vn = [int(g.add(v)) for v in vals]
        anchor = int(g.add("anchor-x"))
        for h in vn:
            g.add_link([anchor, h], value=f"l{h}")
        cond = c.And(c.CoIncident(anchor), c.AtomValue("abcdefghM", "gte"))
        host = sorted(int(h) for h in g.find_all(cond))
        open_device_arm(monkeypatch, pkg, g)
        got[pkg] = (host, sorted(int(h) for h in g.find_all(cond)),
                    arms(g), vn)
        g.close()
    host, dev, counters, vn = got[PORT]
    want = sorted(vn[i] for i in (1, 2, 4, 5))
    assert host == dev == want and counters == {"query.join.host": 1}
    ref_host, ref_dev, ref_counters, _ = got[PKGS[0]]
    assert ref_host == want and ref_counters == {"query.join.device": 1}
    # "abcdefghA" and "abcdefgh" tie with the bound in their first 8 bytes
    assert set(ref_dev) - set(want) == {vn[0], vn[3]}


# ---------------------------------------------------------------- no masking


def test_executor_error_reaches_the_caller(monkeypatch):
    """The port catches only ``JoinUnsupported`` on the device arm (the
    reference sends any exception to the host plan): a failing executor
    raises out of ``find_all``."""
    g = graph_of(PORT)
    nodes, _ = build(g, seed=14)
    c = mod(PORT, "query.conditions")

    def broken(*a, **k):
        raise RuntimeError("executor failed")

    monkeypatch.setattr(mod(PORT, "ops.join"), "execute_join", broken)
    open_device_arm(monkeypatch, PORT, g)
    try:
        with pytest.raises(RuntimeError, match="executor failed"):
            g.find_all(c.And(c.CoIncident(nodes[3]), c.CoIncident(nodes[8])))
        assert arms(g) == {}
    finally:
        g.close()


def test_default_query_device_asks_for_the_card(monkeypatch):
    """``QueryConfig.device`` is "cuda" by default: the device arm resolves
    it when it runs, and without CUDA raises instead of running on the
    CPU; the host arm needs no card."""
    import torch

    g = graph_of(PORT, device="cuda")
    nodes, _ = build(g, seed=14)
    c = mod(PORT, "query.conditions")
    cond = c.And(c.CoIncident(nodes[3]), c.CoIncident(nodes[8]))
    try:
        host = sorted(int(h) for h in g.find_all(cond))
        assert arms(g) in ({}, {"query.join.host": 1})
        open_device_arm(monkeypatch, PORT, g)
        if torch.cuda.is_available():
            assert sorted(int(h) for h in g.find_all(cond)) == host
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                g.find_all(cond)
    finally:
        g.close()
