"""The range lane through the port's ``ServeRuntime`` against the
reference's: the runtime cases of ``tests/test_value_index.py`` on the same
graphs built by the same calls in both packages, the port on
``device="cpu"`` (``ops/value_index.serve_range_batch`` on its plain
path, the dummy incidence CSR for anchor-free batches). Every answer's
``count``, ``matches`` (in value order), ``served_by`` and ``truncated``
must be equal, and so must ``host_fallbacks`` and ``range_dispatches``:
pad-adjacent batches with duplicate values, ascending, descending and
top-k, truncated prefixes (and their host re-serve under a dirty
memtable), fresh, dead and revalued atoms against the delta column and the
host residual, type and anchor filters under churn, clean and ambiguous
variable-width bounds, one batch per dimension, the bridge's value
conditions, and the descending tie rule: an uncovered descending lane
gathers the last ``win_pad`` entries of its window, so a rank tie across
that edge keeps the largest gids of the tie. The answers are also held
against a host oracle where the reference suite holds them. Tolerance:
exact equality."""

from __future__ import annotations

import pytest

from tests.test_torch_graph import mod
from tests.test_torch_serve_differential import (
    answers,
    both,
    counters,
    drain,
    graph_of,
    incremental,
    runtime,
)


def int_graph(g, n=40, dup_every=0):
    """Nodes with int values 0..n-1 (``dup_every`` > 0 repeats every k-th
    value) plus typed links with int values 100..; returns (nodes, links,
    link type handle)."""
    nodes = []
    for i in range(n):
        v = i - (i % dup_every) if dup_every else i
        nodes.append(int(g.add(v)))
    links = [int(g.add_link([nodes[i], nodes[(i + 1) % n]], value=100 + i))
             for i in range(n // 2)]
    return nodes, links, int(g.get_type_handle_of(links[0]))


def host_truth(pkg, g, lo=None, hi=None, lo_op="gte", hi_op="lte",
               type_handle=None, anchor=None, desc=False):
    """Every live atom satisfying the predicate, in value order (gid
    ascending within ties, either direction)."""
    c = mod(pkg, "query.conditions")
    key_of = mod(pkg, "storage.value_index").value_key_of
    clauses = []
    if lo is not None:
        clauses.append(c.AtomValue(lo, lo_op))
    if hi is not None:
        clauses.append(c.AtomValue(hi, hi_op))
    if type_handle is not None:
        clauses.append(c.AtomType(int(type_handle)))
    if anchor is not None:
        clauses.append(c.Incident(int(anchor)))
    cond = clauses[0] if len(clauses) == 1 else c.And(*clauses)
    keyed = sorted(((key_of(g, int(h))[1:], int(h)) for h in g.find_all(cond)),
                   key=lambda kv: (kv[0], kv[1]))
    if desc:
        keyed.sort(key=lambda kv: kv[1])
        keyed.sort(key=lambda kv: kv[0], reverse=True)
    return [h for _, h in keyed]


def serve(pkg, g, reqs, bucket=64, **kw):
    rt = runtime(pkg, g, bucket, **kw)
    futs = [rt.submit_range(**p) for p in reqs]
    drain(rt)
    rt.close()
    return answers(futs), counters(rt)


def test_pad_adjacent_batch_matches_reference():
    """A bucket-minus-one batch: duplicate requests, duplicate values, an
    eq window over a repeated value, empty windows, open bounds."""
    probes = [dict(lo=5, hi=17), dict(lo=8, hi=8), dict(lo=0, hi=39),
              dict(lo=500, hi=900),
              dict(lo=12, hi=12, lo_op="gt", hi_op="lt"),
              dict(lo=10, hi=None), dict(lo=None, hi=6, hi_op="lt"),
              dict(lo=5, hi=17)]
    reqs = [probes[i % len(probes)] for i in range(63)]

    def scenario(pkg):
        g = graph_of(pkg)
        int_graph(g, n=40, dup_every=4)
        out = serve(pkg, g, reqs)
        truths = [host_truth(pkg, g, **p) for p in probes]
        g.close()
        return out, truths

    (res, cnt), truths = both(scenario)
    assert cnt["batches"] == cnt["range_dispatches"] == 1
    for i, r in enumerate(res[: len(probes)]):
        assert r[1] == len(truths[i]) and r[3] == "device"
        assert r[2] == truths[i][: len(r[2])]


def test_ordered_and_topk_shapes_match_reference():
    reqs = [dict(lo=3, hi=25), dict(lo=3, hi=25, desc=True),
            dict(lo=3, hi=25, limit=4), dict(lo=3, hi=25, desc=True, limit=4)]

    def scenario(pkg):
        g = graph_of(pkg)
        int_graph(g, n=30)
        out = serve(pkg, g, reqs)
        truth = (host_truth(pkg, g, lo=3, hi=25),
                 host_truth(pkg, g, lo=3, hi=25, desc=True))
        g.close()
        return out, truth

    (res, _), (asc, desc) = both(scenario)
    assert [r[2] for r in res] == [asc, desc, asc[:4], desc[:4]]
    assert res[2][1] == len(asc) and res[2][4] is True


def test_truncated_prefix_and_dirty_memtable_match_reference():
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, links, lt = int_graph(g, n=40)
        clean = serve(pkg, g, [dict(lo=0, hi=39)], top_r=5)
        incremental(pkg, g)
        g.remove(nodes[2])
        dirty = serve(pkg, g, [dict(lo=0, hi=39)], top_r=5)
        truth = host_truth(pkg, g, lo=0, hi=39)
        g.close()
        return (clean, dirty), truth

    ((clean, _), (dirty, cnt)), truth = both(scenario)
    assert clean[0][3:] == ("device", True) and clean[0][1] > 5
    assert dirty[0][1:4] == (len(truth), truth[:5], "host")
    assert cnt["host_fallbacks"] == 1


def test_fresh_dead_and_revalued_atoms_match_reference():
    """Post-pack mutations against one pinned view: fresh atoms through
    the delta column, a tombstone dropped, a revalued atom moved."""
    reqs = [dict(lo=10, hi=20), dict(lo=999, hi=1002),
            dict(lo=9000, hi=10000), dict(lo=10, hi=20, desc=True, limit=3)]

    def scenario(pkg):
        g = graph_of(pkg)
        nodes, links, lt = int_graph(g, n=30)
        incremental(pkg, g)
        fresh = [int(g.add(1000 + i)) for i in range(4)]
        g.remove(nodes[12])
        g.replace(nodes[13], 9999)
        out = serve(pkg, g, reqs)
        truths = [host_truth(pkg, g, **p) for p in reqs[:3]]
        g.close()
        return out, (truths, fresh, nodes)

    (res, _), (truths, fresh, nodes) = both(scenario)
    assert [r[2] for r in res[:3]] == truths
    assert fresh[0] in res[1][2] and nodes[12] not in res[0][2]
    assert nodes[13] in res[2][2]


def test_delta_column_reuse_under_lag_matches_reference():
    """Within ``max_lag_edges`` the cached delta column serves and the
    uncovered residual is corrected on the host."""
    def scenario(pkg):
        g = graph_of(pkg)
        int_graph(g, n=20)
        incremental(pkg, g)
        g.add(500)
        rt = runtime(pkg, g, 64, max_lag_edges=1_000_000)
        f1 = rt.submit_range(lo=400, hi=600)
        drain(rt)
        h2 = int(g.add(501))
        f2 = rt.submit_range(lo=400, hi=600)
        drain(rt)
        rt.close()
        out = (answers([f1, f2]), counters(rt))
        g.close()
        return out, h2

    ((r1, r2), _), h2 = both(scenario)
    assert r1[1] == 1 and r2[1] == 2 and h2 in r2[2]


def test_type_and_anchor_filters_under_churn_match_reference():
    """Typed and anchored lanes ride the device through the memtable
    menu: fresh incident links in and out of the window, a fresh
    non-incident link, a removed incident link, a revalued one."""
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, links, lt = int_graph(g, n=20)
        incremental(pkg, g)
        anchor = nodes[3]
        inwin = int(g.add_link([anchor, nodes[9]], value=350))
        g.add_link([anchor, nodes[11]], value=9000)
        g.add_link([nodes[5], nodes[6]], value=360)
        g.remove(links[2])
        g.replace(links[3], 370)
        reqs = [dict(lo=100, hi=800, anchor=anchor), dict(lo=100, hi=800),
                dict(lo=100, hi=800, type_handle=lt),
                dict(lo=100, hi=110, type_handle=lt),
                dict(lo=100, hi=800, anchor=anchor, desc=True, limit=2)]
        out = serve(pkg, g, reqs)
        truths = [host_truth(pkg, g, lo=100, hi=800, anchor=anchor),
                  host_truth(pkg, g, lo=100, hi=800),
                  host_truth(pkg, g, lo=100, hi=800, type_handle=lt)]
        g.close()
        return out, (truths, inwin)

    (res, cnt), (truths, inwin) = both(scenario)
    assert [r[2] for r in res[:3]] == truths and inwin in res[0][2]
    assert {r[3] for r in res} == {"device"}
    assert cnt["range_dispatches"] == 1


def test_variable_width_bounds_match_reference():
    """Clean str bounds ride the device through the rank pair (a first-word
    rank tie included); an ambiguous bound, or a column holding an
    ambiguous key, serves on the host."""
    words = ("apple", "alphabetic", "alphabetical", "banana", "blueberry",
             "cherry", "cherrystone", "date")

    def scenario(pkg):
        g = graph_of(pkg)
        for w in words:
            g.add(w)
        clean = serve(pkg, g, [
            dict(lo="alphabetical", hi="cherry"),
            dict(lo="b", hi="an unambiguously long upper bound")])
        g.close()
        g2 = graph_of(pkg)
        g2.add("a long string past the sixteen-byte rank pair")
        g2.add("brief")
        dirty = serve(pkg, g2, [dict(lo="a", hi="z")])
        g2.close()
        return (clean, dirty), None

    ((clean, cnt), (dirty, cnt2)), _ = both(scenario)
    assert [r[3] for r in clean] == ["device", "host"]
    assert dirty[0][3] == "host" and cnt2["range_dispatches"] == 0


def test_one_batch_per_dimension_matches_reference():
    def scenario(pkg):
        g = graph_of(pkg)
        g.add(5)
        g.add(5.0)
        out = serve(pkg, g, [dict(lo=0, hi=10), dict(lo=0.0, hi=10.0)])
        g.close()
        return out, None

    (res, cnt), _ = both(scenario)
    assert cnt["batches"] == 2 and [r[1] for r in res] == [1, 1]


def test_bridge_value_conditions_match_reference():
    def scenario(pkg):
        c = mod(pkg, "query.conditions")
        q = mod(pkg, "query.dsl")
        g = graph_of(pkg)
        nodes, links, lt = int_graph(g, n=20)
        rt = runtime(pkg, g, 64)
        futs = [rt.submit_query(q.value(7, "lte")),
                rt.submit_query(c.And(c.AtomValue(3, "gte"),
                                      c.AtomValue(9, "lt"))),
                rt.submit_query(c.And(c.AtomValue(100, "gte"),
                                      c.AtomValue(130, "lte"),
                                      c.AtomType(lt))),
                rt.submit_query(c.And(c.AtomValue(100, "gte"),
                                      c.AtomValue(130, "lte"),
                                      c.Incident(nodes[3]))),
                rt.submit_query(c.TypedValue(104, lt, "lt"))]
        drain(rt)
        rt.close()
        out = (answers(futs), counters(rt))
        truth = (host_truth(pkg, g, hi=7, hi_op="lte"),
                 host_truth(pkg, g, hi=104, hi_op="lt", type_handle=lt))
        g.close()
        return out, truth

    (res, _), (le7, typed) = both(scenario)
    assert res[0][2] == le7 and res[4][2] == typed


@pytest.mark.parametrize("window", [(0, 39), (4, 31), (9, 24)])
def test_descending_tie_rule_matches_reference(window):
    """``top_r`` 4 gathers 8 candidates a column: these windows hold 10
    atoms of each value (4 values, then 3), so every descending lane is
    uncovered and a tie straddles its gather edge: the lane gathers the
    window's last 8 entries in (value, gid) order, so of the largest
    value's 10 atoms it keeps the 8 largest gids and answers the smallest 4
    of those — not the host order's 4 smallest. The port keeps the
    reference's answer bit for bit; the ascending lane, whose gather edge
    cuts the smallest value's tie at its start, matches the host order."""
    lo, hi = window

    def scenario(pkg):
        g = graph_of(pkg)
        for i in range(40):
            g.add(i - (i % 10))
        reqs = [dict(lo=lo, hi=hi, desc=True), dict(lo=lo, hi=hi),
                dict(lo=lo, hi=hi, desc=True, limit=3)]
        out = serve(pkg, g, reqs, top_r=4)
        truth = (host_truth(pkg, g, lo=lo, hi=hi),
                 host_truth(pkg, g, lo=lo, hi=hi, desc=True))
        g.close()
        return out, truth

    (res, cnt), (asc, desc) = both(scenario)
    assert res[1][2] == asc[:4] and res[0][1] == len(desc)
    assert {r[3] for r in res} == {"device"} and res[0][4] is True
    tie = sorted(desc[:10])              # the largest value's 10 atoms
    assert res[0][2] == tie[-8:][:4] != desc[:4]
    assert res[2][2] == tie[-8:][:3]


def test_range_prewarm_builds_the_columns():
    """``prewarm_range_dims``: the sorted column is built when the runtime
    is, off the dispatch thread; its answers equal the reference's."""
    def scenario(pkg):
        g = graph_of(pkg)
        int_graph(g, n=30)
        incremental(pkg, g)
        out = serve(pkg, g, [dict(lo=3, hi=9)], buckets=(4,), top_r=8,
                    use_pallas_bfs=False, prewarm_range_dims=(ord("i"),))
        cols = getattr(g.incremental.base, "_value_index_cols", None)
        g.close()
        return out, cols

    (res, _), cols = both(scenario)
    assert res[0][1] == 7 and (ord("i"), "cpu") in cols
