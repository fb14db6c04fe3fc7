"""The port's query front door against the reference's: ``tests/
test_query.py``'s ``populated`` graph and its 21 cases, and its
differential random graph, built by the same operations in both packages
(the port's device plans on the CPU). Every case compares the handle lists
(and counts, plan ``describe()`` where the case looks at the plan) of the
two packages exactly, and keeps the reference test's own assertions on the
port's answer. Tolerance: exact equality."""

import dataclasses
import importlib

import numpy as np
import pytest

from conftest import make_random_hypergraph

PKGS = ("hypergraphdb_tpu", "hypergraphdb_tpu_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def new_graph(pkg, **query):
    """A memory graph of ``pkg``; the port's device plans run on the
    CPU."""
    cfg = mod(pkg, "core.config").HGConfiguration()
    for k, v in query.items():
        setattr(cfg.query, k, v)
    if pkg == PKGS[1]:
        cfg.query.device = "cpu"
    return mod(pkg, "core.graph").HyperGraph(cfg)


def both(fn, *args):
    """``fn(pkg, *args)`` in both packages: equal, and the port's
    returned."""
    ref = fn(PKGS[0], *args)
    port = fn(PKGS[1], *args)
    assert port == ref
    return port


@dataclasses.dataclass
class Person:
    name: str
    age: int


def populated(pkg):
    """``tests/test_query.py``'s fixture graph; returns ``(graph, dsl,
    strings, ints, people, links)``."""
    g = new_graph(pkg)
    strings = [g.add(s) for s in ("apple", "banana", "cherry")]
    ints = [g.add(i) for i in (1, 2, 3, 42)]
    people = [g.add(Person("ada", 36)), g.add(Person("bob", 25))]
    l1 = g.add_link((strings[0], ints[0]), value="l1")
    l2 = g.add_link((strings[0], ints[1]), value="l2")
    l3 = g.add_link((strings[1], ints[0], ints[1]), value="l3")
    return g, mod(pkg, "query.dsl"), strings, ints, people, (l1, l2, l3)


def run_case(build):
    """``build(g, hg, strings, ints, people, links)`` on the populated
    graph of each package; the port's result (equal to the reference's)
    and the port's handles."""
    out = {}
    for pkg in PKGS:
        g, hg, *handles = populated(pkg)
        out[pkg] = (build(g, hg, *handles), handles)
        g.close()
    assert out[PKGS[1]][0] == out[PKGS[0]][0]
    assert out[PKGS[1]][1] == out[PKGS[0]][1]
    return out[PKGS[1]]


def test_find_by_type():
    res, (strings, ints, people, links) = run_case(
        lambda g, hg, *h: g.find_all(hg.type_("string")))
    assert set(strings) | set(links) >= set(res)
    assert set(strings) <= set(res)


def test_find_by_value():
    res, (strings, ints, *_) = run_case(lambda g, hg, *h: [
        g.find_all(hg.eq("banana")), g.find_all(hg.eq(42)),
        g.find_all(hg.eq("nope"))])
    assert res == [[strings[1]], [ints[3]], []]


def test_value_type_strict():
    def build(g, hg, strings, ints, *_):
        fh, bh = g.add(1.0), g.add(True)
        return g.find_all(hg.eq(1)), fh, bh

    (res, fh, bh), (strings, ints, *_) = run_case(build)
    assert ints[0] in res and fh not in res and bh not in res


def test_value_ranges():
    res, (strings, ints, *_) = run_case(lambda g, hg, *h: [
        g.find_all(hg.lt(3)), g.find_all(hg.gte(3)),
        g.find_all(hg.and_(hg.gt(1), hg.lt(42)))])
    assert [set(r) for r in res] == [{ints[0], ints[1]}, {ints[2], ints[3]},
                                     {ints[1], ints[2]}]


def test_typed_value():
    res, (strings, *_) = run_case(lambda g, hg, *h: [
        g.find_all(hg.typed_value("string", "apple")),
        g.find_all(hg.typed_value("int", "apple"))])
    assert res == [[strings[0]], []]


def test_incident():
    res, (strings, ints, people, (l1, l2, l3)) = run_case(
        lambda g, hg, strings, ints, *_: [
            g.find_all(hg.incident(strings[0])),
            g.find_all(hg.incident(ints[0])),
            g.find_all(hg.and_(hg.incident(strings[0]),
                               hg.incident(ints[0])))])
    assert res == [[l1, l2], [l1, l3], [l1]]


def test_incident_at_position():
    res, (strings, ints, people, (l1, l2, l3)) = run_case(
        lambda g, hg, strings, ints, *_: [
            g.find_all(hg.incident_at(ints[0], 1)),
            g.find_all(hg.incident_at(ints[0], 0))])
    assert [set(r) for r in res] == [{l1, l3}, set()]


def test_link_condition():
    res, (strings, ints, people, (l1, l2, l3)) = run_case(
        lambda g, hg, strings, ints, *_: [
            g.find_all(hg.link(strings[0])),
            g.find_all(hg.link(ints[0], ints[1]))])
    assert res == [[l1, l2], [l3]]


def test_ordered_link():
    res, (strings, ints, people, (l1, l2, l3)) = run_case(
        lambda g, hg, strings, ints, *_: [
            g.find_all(hg.ordered_link(strings[1], ints[0])),
            g.find_all(hg.ordered_link(ints[0], strings[1]))])
    assert res == [[l3], []]


def test_target():
    res, (strings, ints, people, (l1, l2, l3)) = run_case(
        lambda g, hg, strings, ints, people, links: g.find_all(
            hg.target(links[2])))
    assert set(res) == {strings[1], ints[0], ints[1]}


def test_arity_and_islink():
    res, (strings, ints, people, (l1, l2, l3)) = run_case(
        lambda g, hg, *h: [
            g.find_all(hg.and_(hg.is_link(), hg.arity(3))),
            g.find_all(hg.and_(hg.type_("int"), hg.is_node()))])
    assert res[0] == [l3] and set(res[1]) == set(ints)


def test_or_and_not():
    res, (strings, *_) = run_case(lambda g, hg, *h: [
        g.find_all(hg.or_(hg.eq("apple"), hg.eq("banana"))),
        g.find_all(hg.and_(hg.type_("string"), hg.not_(hg.eq("apple")),
                           hg.is_node()))])
    assert [set(r) for r in res] == [{strings[0], strings[1]},
                                     {strings[1], strings[2]}]


def test_nothing_and_any():
    def build(g, hg, *h):
        q = mod(type(g).__module__.split(".")[0], "query.compiler"
                ).compile_query(g, hg.and_(hg.type_("int"),
                                           hg.type_("string")))
        return (g.find_all(hg.nothing()), g.count(hg.all_atoms()),
                g.atom_count(), type(q.simplified).__name__)

    nothing, count, atoms, simplified = run_case(build)[0]
    assert nothing == [] and count == atoms and simplified == "Nothing"


def test_is_identity():
    res, (strings, *_) = run_case(lambda g, hg, strings, *h: [
        g.find_all(hg.is_(strings[0])),
        g.find_all(hg.and_(hg.is_(strings[0]), hg.type_("int")))])
    assert res == [[strings[0]], []]


def test_part_condition():
    res, (strings, ints, people, links) = run_case(lambda g, hg, *h: [
        g.find_all(hg.part("name", "ada")),
        g.find_all(hg.part("age", 26, "lt"))])
    assert res == [[people[0]], [people[1]]]


@dataclasses.dataclass
class Base:
    x: int


@dataclasses.dataclass
class Derived(Base):
    y: int = 0


def test_type_plus():
    def build(g, hg, *h):
        b, d = g.add(Base(1)), g.add(Derived(2, 3))
        base_t = g.typesystem.infer(Base(0)).name
        return (b, d, g.find_all(hg.type_plus(base_t)),
                g.find_all(hg.type_(base_t)))

    (b, d, plus, exact), _ = run_case(build)
    assert set(plus) == {b, d} and exact == [b]


def test_predicate_condition():
    res, (strings, ints, *_) = run_case(lambda g, hg, *h: g.find_all(
        hg.and_(hg.type_("int"),
                hg.predicate(lambda gr, x: gr.get(x) % 2 == 1))))
    assert set(res) == {ints[0], ints[2]}


def test_plan_shapes():
    """The plans' ``describe()`` is equal in both packages."""
    def build(g, hg, strings, ints, *_):
        cq = mod(type(g).__module__.split(".")[0],
                 "query.compiler").compile_query
        return [cq(g, c).plan.describe() for c in (
            hg.and_(hg.type_("string"), hg.incident(ints[0])),
            hg.eq("apple"), hg.predicate(lambda gr, h: True))]

    typed, value, scan = run_case(build)[0]
    assert "typed-incident" in typed and "type" in typed
    assert "value" in value and "scan" in scan


def test_query_count():
    assert run_case(lambda g, hg, *h: g.count(hg.type_("int")))[0] == 4


def test_parallel_or():
    def build(g, hg, strings, ints, *_):
        g.config.query.parallel_or = True
        return g.find_all(hg.or_(hg.eq("apple"), hg.eq(42), hg.eq(1)))

    res, (strings, ints, *_) = run_case(build)
    assert set(res) == {strings[0], ints[3], ints[0]}


def test_find_one_get_one_and_analyze():
    """The graph's other entry points: ``find_one``, ``get_one`` and
    ``CompiledQuery.analyze``."""
    def build(g, hg, strings, ints, people, links):
        cq = mod(type(g).__module__.split(".")[0],
                 "query.compiler").compile_query
        return (g.find_one(hg.type_("int")), g.find_one(hg.eq("nope")),
                g.get_one(hg.part("name", "bob")), g.get_one(hg.eq(-1)),
                cq(g, hg.incident(strings[0])).analyze())

    one, none, bob, no_value, text = run_case(build)[0]
    assert none is None and no_value is None and bob == Person("bob", 25)
    assert "plan:" in text and one is not None


def random_answers(pkg):
    """The reference's differential case: planner answers and brute-force
    ``satisfies`` answers over a random graph."""
    g = new_graph(pkg)
    hg = mod(pkg, "query.dsl")
    nodes, links = make_random_hypergraph(g, n_nodes=60, n_links=120,
                                          seed=7)
    conds = [
        hg.type_("string"), hg.type_("int"), hg.incident(nodes[0]),
        hg.incident(nodes[1]), hg.and_(hg.type_("int"),
                                       hg.incident(nodes[0])),
        hg.and_(hg.incident(nodes[0]), hg.incident(nodes[1])),
        hg.or_(hg.incident(nodes[2]), hg.incident(nodes[3])),
        hg.and_(hg.is_link(), hg.arity(2)),
        hg.and_(hg.type_("int"), hg.not_(hg.incident(nodes[0]))),
        hg.lt(50), hg.and_(hg.gte(10), hg.lt(20)),
    ]
    all_atoms = list(g.atoms())
    out = [(sorted(g.find_all(c)),
            sorted(h for h in all_atoms if c.satisfies(g, h)))
           for c in conds]
    g.close()
    return out


def test_differential_random_graph():
    for got, expected in both(random_answers):
        assert got == expected


def test_conditions_carry_across_as_json():
    """A reference condition's wire form (``serialize.to_json``) is the same
    condition in the port (``serialize.from_json`` of the JSON dict), with
    the same answers."""
    ref_hg, port_hg = (mod(p, "query.dsl") for p in PKGS)
    ref_ser, port_ser = (mod(p, "query.serialize") for p in PKGS)
    g_ref, _, strings, ints, people, links = populated(PKGS[0])
    g_port = populated(PKGS[1])[0]
    conds = [
        ref_hg.and_(ref_hg.type_("string"), ref_hg.incident(ints[0])),
        ref_hg.or_(ref_hg.eq("apple"), ref_hg.eq(b"raw"), ref_hg.gte(3)),
        ref_hg.and_(ref_hg.incident_at(ints[0], 1),
                    ref_hg.not_(ref_hg.is_(links[0]))),
        ref_hg.part("name", "ada"), ref_hg.bfs(strings[0], 2),
        ref_hg.ordered_link(strings[1], ints[0]),
        ref_hg.and_(ref_hg.type_plus("int"), ref_hg.arity(0)),
    ]
    for c in conds:
        wire = ref_ser.to_json(c)
        port_c = port_ser.from_json(wire)
        assert port_ser.to_json(port_c) == wire
        assert type(port_c).__name__ == type(c).__name__
        assert g_port.find_all(port_c) == g_ref.find_all(c)
    # the reference cannot read back a Link or OrderedLink (its codec
    # calls their variadic constructors with keywords); the port can
    for c in (ref_hg.ordered_link(strings[1], ints[0]),
              ref_hg.link(ints[0], ints[1])):
        with pytest.raises(TypeError):
            ref_ser.from_json(ref_ser.to_json(c))
    with pytest.raises(mod(PKGS[1], "core.errors").QueryError):
        port_ser.to_json(port_hg.predicate(lambda g, h: True))
    g_ref.close()
    g_port.close()
