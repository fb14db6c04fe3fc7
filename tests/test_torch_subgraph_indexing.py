"""The port's subgraphs and user indexers against the reference's
(``tests/test_subgraph_indexing.py``): membership, removal purging it,
every indexer kind kept through adds, replaces, removals (cascading and
keeping incident links), ``bulk_import`` and a transaction that aborts,
registration carried across through ``_to_config`` / the port's
``indexer_from_config``, and the by-part index substitution in the
planner. Store tables (records, payloads, incidence, every index) are
compared exactly, the package's name in its own record types' names read
as the reference's."""

import dataclasses

import numpy as np
import pytest

from test_torch_graph import dump
from test_torch_query import PKGS, mod, new_graph


@dataclasses.dataclass
class Person:
    name: str
    age: int


@dataclasses.dataclass
class Robot:
    name: str


@dataclasses.dataclass
class Employee(Person):
    company: str = ""


def on_both(build):
    out = []
    for pkg in PKGS:
        g = new_graph(pkg)
        out.append(build(pkg, g, mod(pkg, "query.dsl")))
        g.close()
    assert out[1] == out[0]
    return out[1]


def _same_names(x):
    """``x`` with the port's package name written as the reference's: the
    names of the package's own record types (the subgraph value, the
    subsumption marker) name their module."""
    if isinstance(x, (bytes, str)):
        old, new = "hypergraphdb_tpu_torch.", "hypergraphdb_tpu."
        if isinstance(x, bytes):
            old, new = old.encode(), new.encode()
        return x.replace(old, new)
    if isinstance(x, dict):
        return {_same_names(k): _same_names(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_same_names(v) for v in x)
    return x


def tables(g) -> dict:
    """``dump(g)``, the package names in type names made the same."""
    return _same_names(dump(g))


def test_subgraph_membership_contains_and_find_by_name():
    def build(pkg, g, hg):
        sub = mod(pkg, "atom.subgraph").HGSubgraph
        sg = sub.create(g, "mine")
        a, b = sg.add("a"), g.add("b")
        sg.add_member(b)
        members = (sg.is_member(a), sg.is_member(b), sorted(sg), len(sg),
                   g.find_all(hg.member_of(sg.handle)),
                   g.find_all(hg.contains(a)))
        sg.remove_member(b)
        sub.create(g, "one")
        found = sub.find_by_name(g, "mine")
        return (members, sg.is_member(b), found.handle, sg.handle,
                tables(g), (a, b))

    members, b_after, found, sg, _, (a, b) = on_both(build)
    assert members == (True, True, sorted([a, b]), 2, sorted([a, b]), [sg])
    assert not b_after and found == sg


def test_removal_purges_membership():
    def build(pkg, g, hg):
        sub = mod(pkg, "atom.subgraph").HGSubgraph
        sg = sub.create(g, "s")
        x = sg.add("x")
        y = sg.add("y")
        g.remove(x)
        gone = (sg.is_member(x), g.find_all(hg.member_of(sg.handle)))
        g.remove(sg.handle, keep_incident_links=True)
        return gone, len(sub.of(g, sg.handle)), tables(g), y

    (x_member, left), n_after, _, y = on_both(build)
    assert not x_member and left == [y] and n_after == 0


def indexer_scenario(pkg, g, hg):
    """Every indexer kind registered, then the store mutated every way
    the hooks see."""
    im = mod(pkg, "indexing.manager")
    people = [g.add(Person(f"p{i}", i)) for i in range(8)]
    emp = g.add(Employee("e", 40, "acme"))
    th = g.get_type_handle_of(people[0])
    int_t = g.typesystem.handle_of("int")
    a, b, c = g.add("a"), g.add("b"), g.add("c")
    links = [g.add_link((a, b), value=1), g.add_link((a, c), value=2),
             g.add_link((b, c, a), value=3)]
    im.register(g, im.ByPartIndexer("person.name", th, "name"))
    im.register(g, im.DirectValueIndexer("person.value", th))
    im.register(g, im.ByTargetIndexer("bytarget0", int_t, 0))
    im.register(g, im.TargetToTargetIndexer("t2t", int_t, 0, 1))
    im.register(g, im.LinkIndexer("tuple", int_t))
    im.register(g, im.CompositeIndexer("composite", int_t, [
        im.ByTargetIndexer("c0", int_t, 0),
        im.ByTargetIndexer("c1", int_t, 1)]))
    g.add(Person("late", 99))
    g.add(Employee("f", 41, "acme"))
    g.replace(people[3], Person("renamed", 3))
    g.replace(links[0], 7)
    g.remove(people[5])
    g.remove(c, keep_incident_links=True)   # links re-indexed, shifted
    g.bulk_import(values=[10, 11], target_lists=[[a, b], [b, a]])
    g.bulk_import(values=[Person("bulk", 1), Person("bulk2", 2)])
    tx = g.txman.begin()
    g.add_link((b, a), value=12)
    g.add(Person("aborted", 0))
    g.txman.abort(tx)
    idx = im.get_index(g, "person.name")
    st = g.typesystem.get_type("string")
    return (idx.find(st.to_key("renamed")).array().tolist(),
            idx.find(st.to_key("p5")).array().tolist(),
            [x.name for x in im.indexers_of(g, g.get_type_handle_of(emp))],
            tables(g))


def test_every_indexer_kind_is_kept_as_in_the_reference():
    renamed, removed, emp_indexers, _ = on_both(indexer_scenario)
    assert len(renamed) == 1 and removed == []
    # Employee's atoms are indexed by Person's indexers (its supertype)
    assert emp_indexers == ["person.name", "person.value"]


def test_registrations_carry_across_through_their_config():
    """The reference's ``_to_config`` of each indexer, read by the port's
    ``indexer_from_config``, registers indexers that fill the same
    indexes as the reference's own."""
    ref_im = mod(PKGS[0], "indexing.manager")
    port_im = mod(PKGS[1], "indexing.manager")
    th, int_t = 20, 6
    ref_ixs = [
        ref_im.ByPartIndexer("pn", th, "name"),
        ref_im.DirectValueIndexer("pv", th),
        ref_im.ByTargetIndexer("bt", int_t, 1),
        ref_im.TargetToTargetIndexer("tt", int_t, 1, 0),
        ref_im.LinkIndexer("lt", int_t),
        ref_im.CompositeIndexer("cx", int_t, [
            ref_im.ByTargetIndexer("x0", int_t, 0),
            ref_im.LinkIndexer("x1", int_t)]),
    ]
    cfgs = [ref_im._to_config(ix) for ix in ref_ixs]
    port_ixs = [port_im.indexer_from_config(c) for c in cfgs]
    assert [port_im._to_config(ix) for ix in port_ixs] == cfgs

    def build(pkg, g, hg, ixs):
        im = mod(pkg, "indexing.manager")
        p = g.add(Person("ada", 1))
        assert int(g.get_type_handle_of(p)) == th
        a, b = g.add("a"), g.add("b")
        g.add_link((a, b), value=5)
        for ix in ixs:
            im.register(g, ix)
        g.add(Person("bob", 2))
        g.add_link((b, a, p), value=6)
        out = tables(g)
        g.close()
        return out

    assert (build(PKGS[1], new_graph(PKGS[1]), None, port_ixs)
            == build(PKGS[0], new_graph(PKGS[0]), None, ref_ixs))


def test_by_part_indexer_used_when_type_pinned():
    def build(pkg, g, hg):
        im = mod(pkg, "indexing.manager")
        cq = mod(pkg, "query.compiler").compile_query
        people = [g.add(Person(f"p{i}", i)) for i in range(20)]
        r = g.add(Robot("p7"))
        th = g.get_type_handle_of(people[0])
        tname = g.typesystem.name_of(th)
        before = sorted(g.find_all(hg.part("name", "p7")))
        im.register(g, im.ByPartIndexer("person.name", th, "name"))
        cond = hg.and_(hg.type_(tname), hg.part("name", "p7"))
        return (g.find_all(cond), cq(g, cond).plan.describe(), before,
                sorted(g.find_all(hg.part("name", "p7"))), people[7], r)

    got, plan, before, after, p7, r = on_both(build)
    assert got == [p7] and "index(person.name)" in plan
    assert before == after == sorted([p7, r])


def test_unregister_removes_index():
    def build(pkg, g, hg):
        im = mod(pkg, "indexing.manager")
        p = g.add(Person("x", 1))
        im.register(g, im.ByPartIndexer("tmp", g.get_type_handle_of(p),
                                        "name"))
        had = "hg.user.tmp" in g.store.index_names()
        im.unregister(g, "tmp")
        return had, "hg.user.tmp" in g.store.index_names(), tables(g)

    had, has, _ = on_both(build)
    assert had and not has


def test_indexers_are_restored_when_a_graph_opens():
    """``load_indexers`` (run at open) reads the persisted registrations
    back into an empty registry: the same indexers in both packages."""
    def build(pkg, g, hg):
        im = mod(pkg, "indexing.manager")
        p = g.add(Person("x", 1))
        th = g.get_type_handle_of(p)
        im.register(g, im.ByPartIndexer("n", th, "name"))
        im.register(g, im.ByTargetIndexer("t", 6, 0))
        g._indexer_registry = {}
        n = im.load_indexers(g)
        return n, sorted((t, [im._to_config(ix) for ix in ixs])
                         for t, ixs in im._registry(g).items())

    n, reg = on_both(build)
    assert n == 2 and len(reg) == 2


def test_pattern_lane_asymmetric_incidence():
    """The reference's pad regression on the port's pattern lane: the
    shared link sorts late in the hub's row."""
    from hypergraphdb_tpu_torch.ops.setops import and_incident_pattern

    g = new_graph(PKGS[1])
    a, b = g.add("rare"), g.add("hub")
    for o in g.add_nodes_bulk([f"o{i}" for i in range(300)]):
        g.add_link((o, b))
    shared = g.add_link((a, b))
    got = and_incident_pattern(g.snapshot(), [(a, b)], device="cpu")[0]
    assert got.tolist() == [shared]
    g.close()
