"""The port's traversals against the reference's (``tests/
test_traversals.py``): BFS and DFS orders, the adjacency generators,
``HyperTraversal``, ``dijkstra``, ``has_cycles`` and the BFS query
condition, on graphs built by the same operations in both packages; then
every traversal of a WordNet-shaped graph (``wordnet_like``, cut to a few
hundred synsets) against the reference's and, for BFS, against the port's
pull BFS (``bfs_pull``, fused and staged, on the CPU). The yielded
``(link, atom)`` sequences are compared in order. Tolerance: exact
equality."""

import numpy as np
import pytest

from test_torch_query import PKGS, mod, new_graph


def chain(pkg):
    """a -> b -> c -> d by binary links."""
    g = new_graph(pkg)
    a, b, c, d = (g.add(x) for x in "abcd")
    links = tuple(g.add_link(p) for p in ((a, b), (b, c), (c, d)))
    return g, (a, b, c, d), links


def on_both(build):
    out = []
    for pkg in PKGS:
        out.append(build(pkg, mod(pkg, "algorithms.traversals")))
    assert out[1] == out[0]
    return out[1]


def test_bfs_chain_orders_links_and_distance():
    def build(pkg, t):
        g, (a, b, c, d), (ab, bc, cd) = chain(pkg)
        out = (list(t.HGBreadthFirstTraversal(g, a)),
               [x for _, x in t.HGBreadthFirstTraversal(g, a,
                                                        max_distance=2)],
               (a, b, c, d), (ab, bc, cd))
        g.close()
        return out

    pairs, near, (a, b, c, d), (ab, bc, cd) = on_both(build)
    assert pairs == [(ab, b), (bc, c), (cd, d)] and near == [b, c]


def test_dfs_order():
    def build(pkg, t):
        g = new_graph(pkg)
        root, k1, k2, k1a = (g.add(x) for x in ("root", "k1", "k2", "k1a"))
        g.add_link((root, k1))
        g.add_link((root, k2))
        g.add_link((k1, k1a))
        out = [x for _, x in t.HGDepthFirstTraversal(g, root)], (k1, k2, k1a)
        g.close()
        return out

    visited, (k1, k2, k1a) = on_both(build)
    assert (visited.index(k1a) < visited.index(k2)
            or visited.index(k2) < visited.index(k1))


def test_bfs_cycle_and_hyperedge():
    def build(pkg, t):
        g = new_graph(pkg)
        a, b, c = (g.add(x) for x in "abc")
        for p in ((a, b), (b, c), (c, a)):
            g.add_link(p)
        e, f, h = (g.add(x) for x in "efh")
        g.add_link((e, f, h))
        out = ([x for _, x in t.HGBreadthFirstTraversal(g, a)],
               [x for _, x in t.HGBreadthFirstTraversal(g, e,
                                                        max_distance=1)],
               (a, b, c, e, f, h))
        g.close()
        return out

    cyc, hyper, (a, b, c, e, f, h) = on_both(build)
    assert sorted(cyc) == sorted([b, c]) and set(hyper) == {f, h}


def test_generators():
    def build(pkg, t):
        g, (a, b, c, d), _ = chain(pkg)
        fwd = t.DefaultALGenerator(g, return_preceeding=False)
        back = t.DefaultALGenerator(g, return_succeeding=False)
        x, y = g.add("x"), g.add(1)
        follow = g.add_link((a, x), value="follow")
        g.add_link((a, y), value="skip")
        by_link = t.DefaultALGenerator(
            g, link_predicate=lambda gr, l: gr.get(l).value == "follow")
        by_sib = t.DefaultALGenerator(
            g, sibling_predicate=lambda gr, s: isinstance(gr.get(s), int))
        out = (list(fwd.generate(b)), list(back.generate(b)),
               list(by_link.generate(a)), list(by_sib.generate(a)),
               list(t.SimpleALGenerator(g).generate(a)),
               list(t.DefaultALGenerator(g, reverse_order=True).generate(b)),
               (a, b, c, d, x, y, follow))
        g.close()
        return out

    fwd, back, by_link, by_sib, simple, rev, (a, b, c, d, x, y, follow) = (
        on_both(build))
    assert {n for _, n in fwd} == {c} and {n for _, n in back} == {a}
    assert by_link == [(follow, x)] and {n for _, n in by_sib} == {y}


def test_hyper_traversal_dijkstra_and_cycles():
    def build(pkg, t):
        g, (a, b, c, d), (ab, bc, cd) = chain(pkg)
        hyper = list(t.HyperTraversal(g, a))
        path = t.dijkstra(g, a, d)
        e = g.add("e")
        none = t.dijkstra(g, a, e)
        g2 = new_graph(pkg)
        p, q, r = (g2.add(x) for x in "pqr")
        g2.add_link((p, q), value=1)
        g2.add_link((q, r), value=1)
        g2.add_link((p, r), value=10)
        weighted = t.dijkstra(g2, p, r, weight=lambda l: g2.get(l).value)
        acyclic = t.has_cycles(g2, p, t.DefaultALGenerator(
            g2, return_preceeding=False))
        g2.add_link((r, p))
        cyclic = t.has_cycles(g2, p, t.DefaultALGenerator(
            g2, return_preceeding=False))
        out = (hyper, path, none, weighted, acyclic, cyclic,
               (a, b, c, d, ab, bc, cd, p, q, r))
        g.close()
        g2.close()
        return out

    (hyper, path, none, weighted, acyclic, cyclic,
     (a, b, c, d, ab, bc, cd, p, q, r)) = on_both(build)
    assert {ab, b, bc, c, cd, d} <= {x for _, x in hyper}
    assert path == [a, b, c, d] and none is None and weighted == [p, q, r]
    assert not acyclic and cyclic


def test_bfs_query_condition():
    def build(pkg, t):
        g, (a, b, c, d), _ = chain(pkg)
        hg = mod(pkg, "query.dsl")
        out = (g.find_all(hg.bfs(a)), g.find_all(hg.bfs(a, max_distance=1)),
               g.find_all(hg.and_(hg.bfs(a), hg.eq("c"))),
               g.find_all(hg.dfs(a, include_start=True)), (a, b, c, d))
        g.close()
        return out

    full, near, inter, dfs, (a, b, c, d) = on_both(build)
    assert {b, c, d} <= set(full) and b in near and d not in near
    assert inter == [c] and dfs == [a, b, c, d]


@pytest.mark.parametrize("hops", [1, 2, 3, None])
def test_wordnet_traversals_match_the_reference_and_the_pull_bfs(hops):
    """``wordnet_like`` (400 synsets, 800 relations): BFS and DFS from 16
    seeds equal the reference's, in order; the BFS reach sets equal the
    port's pull BFS on the CPU, fused and staged."""
    def build(pkg, t):
        g = new_graph(pkg)
        syn, _ = mod(pkg, "models.generators").wordnet_like(
            g, n_synsets=400, n_relations=800, seed=11)
        seeds = [int(syn[i]) for i in
                 np.random.default_rng(17).integers(0, len(syn), size=16)]
        bfs = [list(t.HGBreadthFirstTraversal(g, x, max_distance=hops))
               for x in seeds]
        dfs = [list(t.HGDepthFirstTraversal(g, x, max_distance=hops))
               for x in seeds]
        snap = g.snapshot()
        g.close()
        return seeds, bfs, dfs, snap if pkg == PKGS[1] else None

    ref = build(PKGS[0], mod(PKGS[0], "algorithms.traversals"))
    seeds, bfs, dfs, snap = build(PKGS[1], mod(PKGS[1],
                                               "algorithms.traversals"))
    assert (seeds, bfs, dfs) == ref[:3]
    if hops is None:
        for b, d in zip(bfs, dfs):
            assert {x for _, x in b} == {x for _, x in d}
        return
    from hypergraphdb_tpu_torch.ops.ellbfs import bfs_pull, visited_rows

    for fused in (True, False):
        res = bfs_pull(snap, np.asarray(seeds, np.int32), hops,
                       fused=fused, device="cpu")
        rows = visited_rows(res, snap.num_atoms, list(range(len(seeds))))
        for x, row, b in zip(seeds, rows, bfs):
            assert row[row != x].tolist() == sorted(a for _, a in b)
