"""The join's graph half in the port against the reference, on the same
graphs: ``extract_pattern`` (each package's pattern, the reference's
carried over with ``pattern_from_reference``, must be equal), its
inverse ``pattern_to_conditions`` and ``PatternSignature.to_conditions``
(condition trees compared field by field), the extraction's refusals and
its dedupe of mirrored atoms; then the exact host enumerator
``host_join``, ``host_join_count`` and the memtable correction's
``host_join_touching`` over the reference's shapes, typed variants,
link variables and awkward declaration orders. Graphs come from
``make_random_hypergraph`` with one seed in both packages (equal handles).
Tolerance: exact equality."""

from __future__ import annotations

import dataclasses

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
        "two_anchor_4path": lambda a: {
            "y": c.CoIncident(a), "z": c.CoIncident(var("y")),
            "u": c.CoIncident(a + 7), "w": c.CoIncident(var("u")),
        },
    }


def tree(x):
    """A condition tree as plain data: class name and fields, ``Var`` by
    name — comparable across the two packages."""
    if type(x).__name__ == "Var":
        return ("Var", x.name)
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            tree(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return {k: tree(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(tree(v) for v in x)
    return x


def port_pattern(p):
    """Any package's pattern as the port's (the reference's carried over)."""
    return mod(PORT, "join.ir").pattern_from_reference(p)


def both(scenario):
    got = {pkg: scenario(pkg) for pkg in PKGS}
    assert got[PORT] == got[PKGS[0]]
    return got[PORT]


# ---------------------------------------------------------------- extraction


@pytest.mark.parametrize("shape", ["triangle", "path2", "star3", "link_var",
                                   "two_anchor_4path"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_extract_pattern_and_its_inverse_match_reference(shape, seed):
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, _ = build(g, seed=seed)
        join = mod(pkg, "join")
        spec = shapes(pkg)[shape](nodes[3 + seed])
        p = join.extract_pattern(g, spec)
        sig, consts = join.split_constants(p)
        out = (port_pattern(p), tree(join.pattern_to_conditions(p)),
               tree(sig.to_conditions(consts)), consts)
        g.close()
        return out

    p, conds, sig_conds, consts = both(scenario)
    assert conds == sig_conds and len(consts) >= 1
    assert p.vars == tuple(shapes(PORT)[shape](0))


def test_extraction_normalizes_sugar_and_types():
    """``TypedIncident`` and ``Link`` sugar go through the compiler's own
    normalization; ``AtomType`` becomes the variable's type."""
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, _ = build(g, seed=4)
        c = mod(pkg, "query.conditions")
        join = mod(pkg, "join")
        var = mod(pkg, "query.variables").var
        th = int(g.get_type_handle_of(
            g.add_link([nodes[2], nodes[9]], value="typed-probe")))
        specs = [
            {"y": c.And(c.CoIncident(nodes[2]), c.AtomType(th))},
            {"y": c.CoIncident(nodes[2]),
             "z": c.And(c.CoIncident(var("y")), c.AtomType(th))},
            {"l": c.Link(nodes[2], nodes[9])},
        ]
        out = [port_pattern(join.extract_pattern(g, s)) for s in specs]
        g.close()
        return out

    typed, typed2, link = both(scenario)
    assert typed.types and typed2.type_of("z") is not None
    assert {a.rel for a in link.atoms} == {"inc"}


@pytest.mark.parametrize("case", ["or", "bfs", "value", "nothing",
                                  "bad_ref"])
def test_extraction_refuses_out_of_vocabulary(case):
    def scenario(pkg):
        g = graph_of(pkg)
        build(g, seed=12)
        c = mod(pkg, "query.conditions")
        join = mod(pkg, "join")
        spec = {
            "or": {"x": c.Or(c.CoIncident(3), c.CoIncident(4))},
            "bfs": {"x": c.BFS(3, max_distance=2)},
            "value": {"x": c.And(c.CoIncident(3), c.AtomValue(5, "eq"))},
            "nothing": {"x": c.Nothing()},
            "bad_ref": {"x": c.CoIncident("three")},
        }[case]
        try:
            join.extract_pattern(g, spec)
            out = None
        except join.JoinUnsupported as e:
            out = type(e).__name__
        g.close()
        return out

    assert both(scenario) == "JoinUnsupported"


def test_extraction_dedupes_mirrored_atoms():
    def scenario(pkg):
        g = graph_of(pkg)
        build(g, seed=13)
        c = mod(pkg, "query.conditions")
        join = mod(pkg, "join")
        var = mod(pkg, "query.variables").var
        p = join.extract_pattern(g, {
            "x": c.And(c.CoIncident(var("y")), c.Incident(var("y"))),
            "y": c.And(c.CoIncident(var("x")), c.CoIncident(7),
                       c.Target(var("x"))),
        })
        g.close()
        return port_pattern(p)

    p = both(scenario)
    # co(x, y) and co(y, x) are one constraint; inc(x, y) ≡ tgt(y, x)
    assert len([a for a in p.atoms if a.key_is_var]) == 2


# ---------------------------------------------------------------- host join


@pytest.mark.parametrize("shape", ["triangle", "path2", "star3", "link_var",
                                   "two_anchor_4path"])
@pytest.mark.parametrize("seed", [0, 3])
def test_host_join_matches_reference(shape, seed):
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, _ = build(g, seed=seed)
        join = mod(pkg, "join")
        p = join.extract_pattern(g, shapes(pkg)[shape](nodes[5]))
        out = join.host_join(g, p), join.host_join_count(g, p)
        g.close()
        return out

    tuples, count = both(scenario)
    assert count == len(tuples) and tuples == sorted(tuples)


@pytest.mark.parametrize("distinct", [True, False])
def test_host_join_distinct_and_typed(distinct):
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, _ = build(g, seed=8)
        c = mod(pkg, "query.conditions")
        join = mod(pkg, "join")
        var = mod(pkg, "query.variables").var
        th = int(g.get_type_handle_of(
            g.add_link([nodes[1], nodes[4]], value="typed")))
        specs = [
            {"y": c.CoIncident(nodes[1]), "z": c.CoIncident(var("y"))},
            {"l": c.And(c.Incident(nodes[1]), c.AtomType(th)),
             "y": c.Target(var("l"))},
        ]
        out = [join.host_join(g, join.extract_pattern(g, s,
                                                      distinct=distinct))
               for s in specs]
        g.close()
        return out

    both(scenario)


def test_host_join_reorders_spec_declaration_order():
    """The spec declares y before its generator z is bound: the host
    enumerator finds a feasible binding order, and tuples still read in
    declared variable order."""
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, _ = build(g, seed=3)
        c = mod(pkg, "query.conditions")
        join = mod(pkg, "join")
        var = mod(pkg, "query.variables").var
        a = nodes[6]
        fwd = {"z": c.CoIncident(a), "y": c.CoIncident(var("z"))}
        rev = {"y": c.CoIncident(var("z")), "z": c.CoIncident(a)}
        out = (join.host_join(g, join.extract_pattern(g, fwd)),
               join.host_join(g, join.extract_pattern(g, rev)))
        g.close()
        return out

    t_fwd, t_rev = both(scenario)
    assert t_fwd and {(y, z) for z, y in t_fwd} == set(t_rev)


def test_host_join_refuses_unanchored_variables():
    def scenario(pkg):
        g = graph_of(pkg)
        build(g, seed=11)
        ir = mod(pkg, "join.ir")
        join = mod(pkg, "join")
        # each variable generated only by the other: no feasible order
        floating = ir.ConjunctivePattern(
            vars=("x", "y"), atoms=(ir.JoinAtom("co", "x", "y"),
                                    ir.JoinAtom("co", "y", "x")))
        try:
            join.host_join(g, floating)
            out = None
        except join.JoinUnsupported as e:
            out = type(e).__name__
        g.close()
        return out

    assert both(scenario) == "JoinUnsupported"


@pytest.mark.parametrize("shape", ["triangle", "path2", "link_var",
                                   "two_anchor_4path"])
def test_host_join_touching_matches_reference(shape):
    """With every atom touched it reproduces ``host_join``; with a few
    atoms it returns exactly the truth tuples containing one of them —
    the per-lane correction's contract — and the reference's tuples."""
    def scenario(pkg):
        g = graph_of(pkg)
        nodes, links = build(g, seed=37)
        join = mod(pkg, "join")
        p = join.extract_pattern(g, shapes(pkg)[shape](nodes[2]))
        truth = join.host_join(g, p)
        everything = [int(h) for h in g.atoms()]
        probes = [set(truth[0][:1]) if truth else set(),
                  {nodes[2], nodes[9], links[4]}, set(links[:6])]
        out = (truth, join.host_join_touching(g, p, everything),
               [join.host_join_touching(g, p, pr) for pr in probes],
               [sorted(pr) for pr in probes])
        g.close()
        return out

    truth, full, touched, probes = both(scenario)
    assert full == truth
    for got, pr in zip(touched, probes):
        assert got == sorted(t for t in truth if set(pr) & set(t))
