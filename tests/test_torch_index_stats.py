"""The port's index statistics and range estimates against the
reference's (``tests/test_index_stats.py``): cost-capped real counts,
narrow ranges ordered before wide type sets, the capped fallback, the
id high-water estimate, and a user index's persisted statistics (reused,
recounted after drift or on request). The two cases over the native
backend's reopen are in ``test_torch_reopen_persistence.py``.
Tolerance: exact equality."""

from test_torch_graph import dump
from test_torch_query import PKGS, mod, new_graph


def valued(pkg):
    g = new_graph(pkg)
    for i in range(500):
        g.add(i)
    return g, mod(pkg, "query.dsl"), mod(pkg, "query.compiler")


def on_both(build):
    out = []
    for pkg in PKGS:
        g, hg, qc = valued(pkg)
        out.append(build(pkg, g, hg, qc))
        g.close()
    assert out[1] == out[0]
    return out[1]


def test_range_estimate_is_real_count():
    def build(pkg, g, hg, qc):
        q = qc.compile_query(g, hg.value(495, "gt"))
        return type(q.plan).__name__, q.plan.estimate(g), len(q.plan.run(g))

    assert on_both(build) == ("ValueSetPlan", 4.0, 4)


def test_range_plus_type_orders_narrow_range_first():
    def build(pkg, g, hg, qc):
        cond = hg.and_(hg.type_("int"), hg.value(495, "gt"))
        q = qc.compile_query(g, cond)
        ests = {type(ch).__name__: ch.estimate(g) for ch in q.plan.children}
        first = sorted(q.plan.children, key=lambda p: p.estimate(g))[0]
        return (type(q.plan).__name__, ests, type(first).__name__,
                sorted(g.get(h) for h in g.find_all(cond)))

    kind, ests, first, vals = on_both(build)
    assert kind == "IntersectPlan" and first == "ValueSetPlan"
    assert ests["ValueSetPlan"] < ests["TypeSetPlan"]
    assert vals == [496, 497, 498, 499]


def test_wide_range_estimate_caps_and_all_atoms_tracks_the_highwater():
    def build(pkg, g, hg, qc):
        g.config.query.range_estimate_cap = 64
        est = qc.compile_query(g, hg.value(-1, "gt")).plan.estimate(g)
        return est, qc.AllAtomsPlan().estimate(g)

    capped, everything = on_both(build)
    assert 64 <= capped < 1e6 and 500 <= everything <= 10_000


def test_user_index_stats_persist_and_recount():
    def build(pkg, g, hg, qc):
        im = mod(pkg, "indexing.manager")
        im.register(g, im.DirectValueIndexer(
            "by-int", g.typesystem.handle_of("int")))
        first = im.index_stats(g, "by-int")
        again = im.index_stats(g, "by-int")
        for i in range(2000):                  # past the drift window
            g.add(10_000 + i)
        drifted = im.index_stats(g, "by-int")
        forced = im.index_stats(g, "by-int", refresh=True)
        by_value = im.index_stats(g, "hg.byvalue")
        missing = im.index_stats(g, "no-such-index")
        return (first, again, drifted, forced, by_value, missing, dump(g))

    first, again, drifted, forced, by_value, missing, _ = on_both(build)
    assert first["entries"] == 500 == first["keys"] and again == first
    assert drifted["entries"] == 2500 and forced["entries"] == 2500
    assert by_value["entries"] >= 2500 and missing["entries"] == 0


def test_query_time_counts_are_kept_in_memory():
    """The planner's whole-index count, made inside ``find_all``'s
    read-only transaction, cannot persist there (the transaction drops
    its writes; the reference recounts on every query). The port keeps
    it in the graph's memory under the same validity rules: the second
    query scans no index, and the answers and estimates equal the
    reference's."""
    from hypergraphdb_tpu_torch.storage import api

    def build(pkg, g, hg, qc):
        g.config.query.range_estimate_cap = 64
        cond = hg.and_(hg.value(-1, "gt"), hg.value(400, "lt"))
        return (sorted(g.get(h) for h in g.find_all(cond)),
                qc.compile_query(g, hg.value(-1, "gt")).plan.estimate(g))

    assert on_both(build)[0] == list(range(400))
    g, hg, qc = valued(PKGS[1])
    g.config.query.range_estimate_cap = 64
    cond = hg.and_(hg.value(-1, "gt"), hg.value(400, "lt"))
    scans = []
    real = api.HGIndex.bulk_items

    def counted(self, lo=None):
        scans.append(self.name)
        return real(self, lo)

    api.HGIndex.bulk_items = counted
    try:
        first = sorted(g.find_all(cond))
        n_first = len(scans)
        assert sorted(g.find_all(cond)) == first
        assert n_first >= 1 and len(scans) == n_first
        assert "hg.byvalue" in g._index_stats_memo
    finally:
        api.HGIndex.bulk_items = real
        g.close()


def test_range_count_in_a_transaction_reads_its_own_writes():
    """``count_range`` through the transactional view: the backend's
    ordered count where the transaction touched nothing in the range, the
    merged range where it did; both equal ``len(find_range)`` clamped to
    the cap."""
    from hypergraphdb_tpu_torch.core.graph import IDX_BY_VALUE

    g, hg, qc = valued(PKGS[1])
    try:
        idx = g.store.get_index(IDX_BY_VALUE)
        lo = g.typesystem.infer(100).to_key(100)
        hi = g.typesystem.infer(200).to_key(200)
        assert idx.count_range(lo, hi) == len(idx.find_range(lo, hi)) == 100
        assert idx.count_range(lo, hi, cap=10) == 10

        def inside():
            g.add(150)
            g.add(150)
            got = idx.count_range(lo, hi)
            assert got == len(idx.find_range(lo, hi)) == 102
            assert idx.count_range(lo, hi, cap=101) == 101
            return got

        assert g.txman.transact(inside) == 102
        assert idx.count_range(lo, hi) == 102
    finally:
        g.close()
