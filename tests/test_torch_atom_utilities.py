"""The port's atom utilities and maintenance operations against the
reference's.

The reference's ``tests/test_atom_utilities.py`` cases, each run on a
fresh in-memory graph of both packages with the same operations: hard
refs pin their referent (cascades and replaces included), symbolic refs
dangle, Berge links split head and tail, relation types check arity and
are found not duplicated, persisted subsumptions reload, offline indexer
builds resume from their cursor and cover subtypes, and a pending
operation whose indexer is not registered is deferred. Each case asserts
what the reference's test asserts and returns what it saw; the two
packages' results must be equal. Tolerance: exact equality.
"""

from dataclasses import dataclass

import pytest

from test_torch_storage import PKGS, mod


@dataclass(frozen=True)
class Animal:
    name: str = ""


@dataclass(frozen=True)
class Dog:
    name: str = ""


@dataclass(frozen=True)
class Person:
    name: str = ""
    age: int = 0


@dataclass(frozen=True)
class WidgetSpec:
    name: str = ""
    arity: int = 0


def on_both(case):
    """``case(pkg, graph, utilities)`` on a fresh graph of each package."""
    out = []
    for pkg in PKGS:
        g = mod(pkg, "core.graph").HyperGraph()
        try:
            out.append(case(pkg, g, mod(pkg, "atom.utilities")))
        finally:
            g.close()
    assert out[1] == out[0]
    return out[1]


def raises(pkg, fn):
    with pytest.raises(mod(pkg, "core.errors").HGException) as e:
        fn()
    return type(e.value).__name__


# ---------------------------------------------------------------- atom refs


def test_hard_ref_pins_referent():
    def case(pkg, g, u):
        u.install_ref_maintenance(g)
        target = g.add("pinned")
        holder = g.add(u.HGAtomRef(int(target), u.HARD))
        got = [g.remove(int(target)), g.contains(int(target)),
               g.remove(int(holder)), g.remove(int(target))]
        assert got == [False, True, True, True]
        return int(target), int(holder), got

    on_both(case)


def test_symbolic_ref_dangles():
    def case(pkg, g, u):
        u.install_ref_maintenance(g)
        target = g.add("temp")
        holder = g.add(u.HGAtomRef(int(target), u.SYMBOLIC))
        removed = g.remove(int(target))
        ref = g.get(int(holder))
        assert removed and ref.deref(g) is None
        return removed, ref.target, ref.mode

    on_both(case)


def test_hard_ref_to_missing_atom_rejected():
    def case(pkg, g, u):
        u.install_ref_maintenance(g)
        return raises(pkg, lambda: g.add(u.HGAtomRef(999_999, u.HARD)))

    assert on_both(case) == "HGException"


# ---------------------------------------------------------------- berge links


def test_berge_link_head_tail():
    def case(pkg, g, u):
        a, b, c, d = (g.add(x) for x in "abcd")
        bl = u.HGBergeLink.add(g, head=[a, b], tail=[c, d], payload="flow")
        got = (bl.head, bl.tail, bl.payload, g.arity(bl.handle),
               g.get_incidence_set(a).array().tolist())
        assert got[:4] == ((int(a), int(b)), (int(c), int(d)), "flow", 4)
        assert bl.handle in got[4]
        return got

    on_both(case)


# ---------------------------------------------------------------- relations


def test_rel_type_and_instances():
    def case(pkg, g, u):
        works_at = u.define_rel_type(g, "works-at", 2)
        alice, acme = g.add("alice"), g.add("acme")
        r = u.add_rel(g, works_at, int(alice), int(acme))
        assert g.get_targets(r) == (int(alice), int(acme))
        err = raises(pkg, lambda: u.add_rel(g, works_at, int(alice)))
        again = int(u.define_rel_type(g, "works-at", 2))
        assert again == int(works_at)
        return int(works_at), int(r), g.get(int(r)).value.name, err, again

    on_both(case)


# ---------------------------------------------------------------- subsumption


def test_subsumes_persisted_and_reloaded():
    def case(pkg, g, u):
        q = mod(pkg, "query.dsl")
        g.add(Animal("generic"))
        rex = g.add(Dog("rex"))
        at = g.typesystem.infer(Animal("x")).name
        dt = g.typesystem.infer(Dog("x")).name
        u.declare_subsumes(g, at, dt)
        res = q.find_all(g, q.type_plus(at))
        assert int(rex) in res
        g.typesystem._supertypes.clear()
        n = u.load_subsumptions(g)
        assert n == 1 and dt in g.typesystem.subtypes_closure(at)
        return res, n, sorted(g.typesystem.subtypes_closure(at))

    res, _, closure = on_both(case)
    assert len(closure) == 2


# ---------------------------------------------------------------- maintenance


def test_apply_new_indexer_resumable():
    def case(pkg, g, u):
        ixm = mod(pkg, "indexing.manager")
        mt = mod(pkg, "maintenance")
        people = [g.add(Person(f"p{i}", i)) for i in range(25)]
        th = g.typesystem.handle_of(g.typesystem.infer(Person("x")).name)
        ixm.register(g, ixm.ByPartIndexer("person-by-name", int(th), "name"),
                     populate=False)
        oph = mt.schedule(g, mt.ApplyNewIndexer(
            indexer_name="person-by-name", type_handle=int(th),
            batch_size=7))
        cur = g.get(oph)
        cur = getattr(cur, "value", cur)
        nxt = cur.execute_batch(g)        # captures the frozen scan bound
        assert nxt.end_bound > 0
        nxt = nxt.execute_batch(g)        # the first real batch
        g.replace(oph, nxt)
        assert nxt.last_processed >= 0
        done = mt.run_pending(g)
        idx = ixm.get_index(g, "person-by-name")
        pt = g.typesystem.infer("p3")
        hits = idx.find(pt.to_key("p3")).array().tolist()
        assert done == 1 and hits == [int(people[3])]
        return (nxt.end_bound, nxt.last_processed, done, hits,
                [(k, v.tolist()) for k, v in idx.bulk_items()])

    on_both(case)


def test_offline_indexer_covers_subtypes():
    def case(pkg, g, u):
        ixm = mod(pkg, "indexing.manager")
        mt = mod(pkg, "maintenance")
        g.add(Animal("generic"))
        rex = g.add(Dog("rex"))
        at = g.typesystem.infer(Animal("x")).name
        dt = g.typesystem.infer(Dog("x")).name
        u.declare_subsumes(g, at, dt)
        th = g.typesystem.handle_of(at)
        ixm.register(g, ixm.ByPartIndexer("animal-by-name", int(th), "name"),
                     populate=False)
        mt.schedule(g, mt.ApplyNewIndexer(indexer_name="animal-by-name",
                                          type_handle=int(th),
                                          batch_size=50))
        done = mt.run_pending(g)
        kt = g.typesystem.infer("rex")
        hits = ixm.get_index(g, "animal-by-name").find(
            kt.to_key("rex")).array().tolist()
        assert done == 1 and int(rex) in hits
        return done, hits

    on_both(case)


def test_run_pending_skips_unregistered_indexer():
    """Deferred, not crashed; the port also counts the deferral."""
    def case(pkg, g, u):
        mt = mod(pkg, "maintenance")
        mt.schedule(g, mt.ApplyNewIndexer(indexer_name="ghost-indexer",
                                          type_handle=1, batch_size=10))
        return mt.run_pending(g)

    assert on_both(case) == 0
    g = mod(PKGS[1], "core.graph").HyperGraph()
    mt = mod(PKGS[1], "maintenance")
    mt.schedule(g, mt.ApplyNewIndexer(indexer_name="ghost-indexer",
                                      type_handle=1, batch_size=10))
    assert mt.run_pending(g) == 0
    assert g.metrics.counters["maintenance.deferred"] == 1
    g.close()


# ---------------------------------------------------------------- metrics


def metric_view(pkg, g) -> dict:
    """The counters, gauges and timer counts of a graph's metrics."""
    m = g.metrics
    if hasattr(m, "snapshot"):
        snap = m.snapshot()
        return {"counters": snap["counters"], "gauges": snap["gauges"],
                "timings": {k: v["count"] for k, v in snap["timings"].items()}}
    return {"counters": dict(m.counters), "gauges": dict(m.gauges),
            "timings": {k: v[0] for k, v in m.timings.items()}}


def test_metrics_surface():
    def case(pkg, g, u):
        q = mod(pkg, "query.dsl")
        g.add("m1")
        g.add("m2")
        g.snapshot()
        g.find_all(q.value("m1"))
        v = metric_view(pkg, g)
        got = (v["counters"]["graph.mutations"], v["counters"]["query.executed"],
               v["timings"]["snapshot.pack"], v["gauges"]["snapshot.num_atoms"])
        assert got[0] >= 2 and got[1] >= 1 and got[2] >= 1 and got[3] > 0
        return got

    on_both(case)


def test_query_analyze_plan_dump():
    def case(pkg, g, u):
        q = mod(pkg, "query.dsl")
        g.add("x")
        cq = mod(pkg, "query.compiler").compile_query(
            g, q.and_(q.type_("string"), q.incident(0)))
        text = cq.analyze()
        assert "condition:" in text and "plan:" in text
        return [line.split(":")[0] for line in text.splitlines()]

    on_both(case)


# ------------------------------------------------- the pins under change


def test_invalid_hard_ref_not_persisted():
    def case(pkg, g, u):
        u.install_ref_maintenance(g)
        before = g.atom_count()
        err = raises(pkg, lambda: g.add(u.HGAtomRef(999_999, u.HARD)))
        assert g.atom_count() == before
        return before, err, g.handles.peek

    on_both(case)


def test_cascade_remove_respects_pin():
    def case(pkg, g, u):
        u.install_ref_maintenance(g)
        n = g.add("node")
        other = g.add("other")
        link = g.add_link((n, other), value="pinned-link")
        g.add(u.HGAtomRef(int(link), u.HARD))
        err = raises(pkg, lambda: g.remove(int(n)))
        assert g.contains(int(link)) and g.contains(int(n))
        return err, int(link)

    on_both(case)


def test_replace_maintains_pins():
    def case(pkg, g, u):
        u.install_ref_maintenance(g)
        t1, t2 = g.add("t1"), g.add("t2")
        holder = g.add(u.HGAtomRef(int(t1), u.HARD))
        g.replace(int(holder), u.HGAtomRef(int(t2), u.HARD))
        got = [g.remove(int(t1)), g.remove(int(t2))]
        g.replace(int(holder), "plain")
        got.append(g.remove(int(t2)))
        assert got == [True, False, True]
        return got

    on_both(case)


def test_rel_type_not_confused_by_lookalike():
    def case(pkg, g, u):
        g.add(WidgetSpec(name="ships-to", arity=2))
        rt = u.define_rel_type(g, "ships-to", 2)
        v = g.get(int(rt))
        v = getattr(v, "value", v)
        assert isinstance(v, u.RelTypeValue)
        return int(rt), v.name, v.arity

    on_both(case)
