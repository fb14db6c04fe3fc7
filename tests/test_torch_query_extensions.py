"""The port's query surface beyond the basics against the reference's
(``tests/test_query_extensions.py``): the link indexer, regex predicates,
result mappings, pipes and ``MapCondition``; and ``tests/
test_query_fuzz.py``'s seeded random condition trees (12 seeds, and 4 with
the device gate open: ``device_min_batch = 0``, the port's device plans on
the CPU) against the reference's answers and a brute-force ``satisfies``
scan. The reference case over its partitioned backend has no counterpart:
the port's graph refuses that backend (``test_torch_graph.py``).
Tolerance: exact equality."""

from dataclasses import dataclass

import numpy as np
import pytest

from conftest import make_random_hypergraph
from test_torch_query import PKGS, mod, new_graph


def on_both(build):
    """``build(pkg, g, dsl)`` on a fresh graph of each package: equal, and
    the port's result returned."""
    out = []
    for pkg in PKGS:
        g = new_graph(pkg)
        out.append(build(pkg, g, mod(pkg, "query.dsl")))
        g.close()
    assert out[1] == out[0]
    return out[1]


def test_link_indexer_exact_tuple_lookup():
    def build(pkg, g, q):
        im = mod(pkg, "indexing.manager")
        nodes = [g.add(f"n{i}") for i in range(6)]
        th = int(g.typesystem.handle_of("string"))
        links = [g.add_link((nodes[i], nodes[(i + 1) % 6]), value=f"l{i}")
                 for i in range(6)]
        im.register(g, im.LinkIndexer("by-tuple", th))
        idx = im.get_index(g, "by-tuple")
        key = im.LinkIndexer.tuple_key((int(nodes[2]), int(nodes[3])))
        rkey = im.LinkIndexer.tuple_key((int(nodes[3]), int(nodes[2])))
        return (idx.find(key).array().tolist(),
                idx.find(rkey).array().tolist(), int(links[2]))

    hits, reverse, l2 = on_both(build)
    assert hits == [l2] and reverse == []


def test_value_regex_predicate():
    def build(pkg, g, q):
        a, b = g.add("alpha-1"), g.add("beta-2")
        g.add(42)
        return (sorted(q.find_all(g, q.and_(q.type_("string"),
                                            q.value_regex(r"^alpha")))),
                sorted(q.find_all(g, q.and_(q.type_("string"),
                                            q.value_regex(r"-\d$")))),
                int(a), int(b))

    got, got2, a, b = on_both(build)
    assert got == [a] and got2 == sorted([a, b])


@dataclass(frozen=True)
class City:
    name: str = ""
    country: str = ""


def test_part_regex_predicate():
    def build(pkg, g, q):
        ams, ber = g.add(City("Amsterdam", "NL")), g.add(City("Berlin", "DE"))
        tname = g.typesystem.infer(City()).name
        return (q.find_all(g, q.and_(q.type_(tname),
                                     q.part_regex("name", r"^Ber"))),
                int(ams), int(ber))

    got, ams, ber = on_both(build)
    assert got == [ber] and ams not in got


def test_link_projection_mapping():
    def build(pkg, g, q):
        nodes = [g.add(f"n{i}") for i in range(5)]
        for i in range(4):
            g.add_link((nodes[i], nodes[4]), value=i)
        return (sorted(q.target_at(g, q.incident(nodes[4]), 0).tolist()),
                sorted(int(n) for n in nodes[:4]))

    got, want = on_both(build)
    assert got == want


def test_deref_mapping():
    def build(pkg, g, q):
        for i in range(3):
            g.add(f"v{i}")
        return q.deref(g, q.type_("string"))

    assert set(on_both(build)) >= {"v0", "v1", "v2"}


def test_pipe_query():
    def build(pkg, g, q):
        n = g.add("root")
        l1 = g.add_link((n,), value="inner")
        l2 = g.add_link((l1,), value="outer")  # a link pointing at a link
        return (q.pipe(g, q.incident(n), lambda k: q.incident(k)).tolist(),
                int(l2))

    got, l2 = on_both(build)
    assert got == [l2]


def test_map_condition_composes_inside_and():
    def build(pkg, g, q):
        a, n1, s1 = g.add("a"), g.add(1), g.add("s1")
        g.add_link((a, n1), value="to-int")
        g.add_link((a, s1), value="to-str")
        cond = q.and_(q.mapped(q.incident(a), position=1), q.type_("int"))
        return sorted(q.find_all(g, cond)), int(n1)

    got, n1 = on_both(build)
    assert got == [n1]


def test_map_condition_inside_or():
    def build(pkg, g, q):
        a, b, x, y = g.add("a"), g.add("b"), g.add(10), g.add(20)
        g.add_link((a, x))
        g.add_link((b, y))
        cond = q.or_(q.mapped(q.incident(a), position=1),
                     q.mapped(q.incident(b), position=1))
        return sorted(q.find_all(g, cond)), sorted([int(x), int(y)])

    got, want = on_both(build)
    assert got == want


def test_map_condition_standalone_matches_result_map():
    def build(pkg, g, q):
        a = g.add("a")
        outs = [g.add(f"t{i}") for i in range(4)]
        for o in outs:
            g.add_link((a, o))
        return (sorted(q.find_all(g, q.mapped(q.incident(a),
                                              position=1))),
                sorted(int(x) for x in q.target_at(g, q.incident(a), 1)),
                sorted(int(o) for o in outs))

    got, via_map, outs = on_both(build)
    assert got == via_map == outs


def test_map_condition_has_no_satisfies_and_rejects_value_mappings():
    for pkg in PKGS:
        g = new_graph(pkg)
        c = mod(pkg, "query.conditions")
        qc = mod(pkg, "query.compiler")
        err = mod(pkg, "core.errors").QueryError
        with pytest.raises(err):
            c.MapCondition(qc.LinkProjectionMapping(0),
                           c.AnyAtom()).satisfies(g, 0)
        g.add("x")
        with pytest.raises(err, match="handles"):
            qc.compile_query(g, mod(pkg, "query.dsl").and_(
                c.MapCondition(qc.DerefMapping(), c.AnyAtom()),
                mod(pkg, "query.dsl").type_("string")))
        g.close()


# ------------------------------------------------------------- the fuzz


def fuzz_graph(pkg, **query):
    """``tests/test_query_fuzz.py``'s graph."""
    g = new_graph(pkg, **query)
    nodes, links = make_random_hypergraph(g, n_nodes=120, n_links=260,
                                          max_arity=3, seed=77)
    extra = [g.add(int(i)) for i in range(40)]
    for i in range(0, 20, 3):
        g.remove(int(extra[i]))
    return g, nodes, links


def _leaf_pool(pkg, nodes, r):
    hg, c = mod(pkg, "query.dsl"), mod(pkg, "query.conditions")
    anchors = [int(nodes[i]) for i in r.integers(0, len(nodes), size=4)]
    return [
        lambda: hg.type_("int"),
        lambda: hg.type_("string"),
        lambda: hg.value(int(r.integers(0, 260)), str(r.choice(
            ["eq", "lt", "lte", "gt", "gte"]))),
        lambda: hg.incident(int(r.choice(anchors))),
        lambda: hg.typed_incident(int(r.choice(anchors)), "int"),
        lambda: hg.arity(int(r.integers(1, 4)),
                         str(r.choice(["eq", "gte"]))),
        lambda: c.IsLink(),
        lambda: c.IsNode(),
        lambda: hg.is_(int(r.choice(anchors))),
    ]


def _random_condition(pkg, nodes, r, depth=2):
    """The reference fuzz's generator, for either package's vocabulary."""
    hg = mod(pkg, "query.dsl")
    leaves = _leaf_pool(pkg, nodes, r)
    if depth == 0 or r.random() < 0.35:
        return leaves[int(r.integers(0, len(leaves)))]()
    kind = r.random()
    n = int(r.integers(2, 4))
    subs = [_random_condition(pkg, nodes, r, depth - 1) for _ in range(n)]
    if kind < 0.45:
        return hg.and_(*subs)
    if kind < 0.9:
        return hg.or_(*subs)
    return hg.not_(leaves[int(r.integers(0, len(leaves)))]())


def _brute(g, cond):
    out = []
    for h in g.atoms():
        try:
            if cond.satisfies(g, int(h)):
                out.append(int(h))
        except Exception:  # noqa: BLE001 - the reference fuzz's rule
            pass
    return sorted(out)


@pytest.fixture(scope="module")
def fuzz_graphs():
    graphs = {pkg: fuzz_graph(pkg) for pkg in PKGS}
    yield graphs
    for g, *_ in graphs.values():
        g.close()


def fuzz_answers(graphs, seed: int, rounds: int):
    out = {}
    for pkg, (g, nodes, _) in graphs.items():
        r = np.random.default_rng(seed)
        res = []
        for _ in range(rounds):
            cond = _random_condition(pkg, nodes, r)
            res.append((repr(cond), sorted(int(h) for h in g.find_all(cond)),
                        _brute(g, cond)))
        out[pkg] = res
    assert out[PKGS[1]] == out[PKGS[0]]
    for cond, got, want in out[PKGS[1]]:
        assert got == want, f"divergence on {cond}"


@pytest.mark.parametrize("seed", range(12))
def test_random_condition_trees_match_the_reference(fuzz_graphs, seed):
    fuzz_answers(fuzz_graphs, 1000 + seed, 6)


@pytest.mark.parametrize("seed", range(4))
def test_random_trees_on_device_thresholds(fuzz_graphs, seed):
    """The gate open (``device_min_batch = 0``): the device plans (K3's
    plain version and the value pushdown's CPU twin in the port) change
    no answer."""
    olds = {pkg: g.config.query.device_min_batch
            for pkg, (g, *_) in fuzz_graphs.items()}
    for g, *_ in fuzz_graphs.values():
        g.config.query.device_min_batch = 0
    try:
        fuzz_answers(fuzz_graphs, 2000 + seed, 4)
    finally:
        for pkg, (g, *_) in fuzz_graphs.items():
            g.config.query.device_min_batch = olds[pkg]
