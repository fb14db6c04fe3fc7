"""The port's MVCC transactions against the reference's: the commit, abort,
nesting, conflict, retry, overlay and snapshot-read cases of
``tests/test_tx.py`` that need no fault registry, each run in both
packages. Every case returns what it observed (values, raised classes,
counters, the final store), and the two packages must observe the same.
Tolerance: exact equality."""

import importlib
import threading

import pytest

from tests.test_torch_graph import PKGS, dump, new_graph


def raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class is the observation
        return type(e).__name__
    return None


def run_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "thread did not finish"


def transact_commits(g, pkg):
    h = g.txman.transact(lambda: g.add("v"))
    return g.get(h)


def abort_discards_writes(g, pkg):
    tx = g.txman.begin()
    h = g.add("temp")
    inside = g.get(h)
    g.txman.abort(tx)
    g._atom_cache.clear()
    return inside, g.contains(h)


def exception_rolls_back(g, pkg):
    before = g.atom_count()

    def work():
        g.add("doomed")
        raise RuntimeError("boom")

    kind = raised(lambda: g.txman.transact(work))
    g._atom_cache.clear()
    return kind, before, g.atom_count()


def nested_commit_merges(g, pkg):
    outer = g.txman.begin()
    h1 = g.add("outer")
    inner = g.txman.begin()
    h2 = g.add("inner")
    g.txman.commit(inner)
    in_parent = g.get(h2)
    g.txman.commit(outer)
    return in_parent, g.get(h1), g.get(h2)


def nested_abort_discards_inner(g, pkg):
    outer = g.txman.begin()
    h1 = g.add("outer")
    inner = g.txman.begin()
    h2 = g.add("inner")
    g.txman.abort(inner)
    g.txman.commit(outer)
    g._atom_cache.clear()
    return g.contains(h1), g.contains(h2)


def commit_wrong_order(g, pkg):
    outer = g.txman.begin()
    g.txman.begin()
    kind = raised(lambda: g.txman.commit(outer))
    g.txman.abort(g.txman.current())
    g.txman.abort(outer)
    return kind


def conflict_detected(g, pkg):
    h = g.add("initial")
    t1 = g.txman.begin()
    g.store.get_link(h)
    g.replace(h, "t1")
    run_thread(lambda: g.txman.transact(lambda: g.replace(h, "other")))
    kind = raised(lambda: g.txman.commit(t1))
    g._atom_cache.clear()
    return kind, g.get(h), g.txman.conflicted


def retries_on_conflict(g, pkg):
    h = g.add(0)
    attempts = []

    def bump():
        attempts.append(1)
        v = g.get(h)
        if len(attempts) == 1:
            run_thread(lambda: g.txman.transact(lambda: g.replace(h, 100)))
            g._atom_cache.clear()
        g.replace(h, v + 1)

    g.txman.transact(bump)
    g._atom_cache.clear()
    return len(attempts), g.get(h)


def concurrent_increments(g, pkg):
    h = g.add(0)

    def worker():
        for _ in range(10):
            def inc():
                g._atom_cache.clear()
                g.replace(h, g.get(h) + 1)

            g.txman.transact(inc, retries=200)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    g._atom_cache.clear()
    return g.get(h)


def incidence_overlay(g, pkg):
    a = g.add("a")
    tx = g.txman.begin()
    link = g.add_link((a,))
    inside = link in g.get_incidence_set(a)
    g.txman.abort(tx)
    return inside, link in g.get_incidence_set(a)


def index_overlay(g, pkg):
    idx = g.store.get_index("t")
    tx = g.txman.begin()
    idx.add_entry(b"k", 5)
    inside = idx.find(b"k").array().tolist()
    g.txman.abort(tx)
    return inside, len(g.store.get_index("t").find(b"k"))


def readonly_records_no_reads(g, pkg):
    h = g.add("x")
    tx = g.txman.begin(readonly=True)
    g.store.get_link(h)
    reads = dict(tx.read_set)
    g.txman.commit(tx)
    return reads


def stats_counters(g, pkg):
    # counted from here: each graph's open also commits its format stamp
    before = g.txman.committed
    g.txman.transact(lambda: g.add("x"))
    return g.txman.committed - before, g.txman.aborted


def snapshot_read_begin_time(g, pkg):
    a = g.add("original")
    link = g.add_link((a,), value="before")
    tx = g.txman.begin(readonly=True)
    first = g.get(link).value
    inc_before = g.get_incidence_set(a).array().tolist()

    def writer():
        g.replace(link, "after")
        g.add_link((a,), value="late-link")

    run_thread(writer)
    inside = g.get(link).value, g.get_incidence_set(a).array().tolist()
    g.txman.commit(tx)
    after = g.get(link).value, g.get_incidence_set(a).array().tolist()
    return first, inc_before, inside, after


def snapshot_read_by_value_index(g, pkg):
    """The by-value index read under an open snapshot (the value query of
    the reference's case, through the index the query reads)."""
    from hypergraphdb_tpu_torch.utils.ordered_bytes import encode_int

    idx = importlib.import_module(f"{pkg}.core.graph").IDX_BY_VALUE
    g.add(111)
    tx = g.txman.begin(readonly=True)

    def find(v):
        return g.store.get_index(idx).find(b"i" + encode_int(v)).array() \
            .tolist()

    seen = find(111), find(222)
    run_thread(lambda: g.add(222))
    inside = find(222)
    g.txman.commit(tx)
    return seen, inside, find(222)


def stale_snapshot_conflicts(g, pkg):
    a = g.add("cell")
    tx = g.txman.begin()
    run_thread(lambda: g.replace(a, "moved"))
    stale = g.get(a)
    g.add("marker")
    return stale, raised(lambda: g.txman.commit(tx))


def history_gc(g, pkg):
    a = g.add("x")
    tx = g.txman.begin(readonly=True)
    run_thread(lambda: g.replace(a, "y"))
    captured = sorted(g.txman._history)
    g.txman.commit(tx)
    g.add("tick")
    return captured, g.txman._history


CASES = [transact_commits, abort_discards_writes, exception_rolls_back,
         nested_commit_merges, nested_abort_discards_inner,
         commit_wrong_order, conflict_detected, retries_on_conflict,
         concurrent_increments, incidence_overlay, index_overlay,
         readonly_records_no_reads, stats_counters, snapshot_read_begin_time,
         snapshot_read_by_value_index, stale_snapshot_conflicts, history_gc]

#: what test_tx.py asserts of each case, checked on the port's result
EXPECT = {
    "transact_commits": "v",
    "abort_discards_writes": ("temp", False),
    "exception_rolls_back": ("RuntimeError", 10, 10),
    "nested_commit_merges": ("inner", "outer", "inner"),
    "nested_abort_discards_inner": (True, False),
    "commit_wrong_order": "TransactionAborted",
    "conflict_detected": ("TransactionConflict", "other", 1),
    "retries_on_conflict": (2, 101),
    "concurrent_increments": 80,
    "incidence_overlay": (True, False),
    "index_overlay": ([5], 0),
    "readonly_records_no_reads": {},
    "stats_counters": (1, 0),
    "stale_snapshot_conflicts": ("cell", "TransactionConflict"),
}


#: cases whose store depends on the threads' interleaving (a retried
#: replace takes a fresh value handle): their outcome alone is compared
INTERLEAVED = {"concurrent_increments"}


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_transaction_case_matches_reference(case):
    got = {}
    for pkg in PKGS:
        g = new_graph(pkg)
        got[pkg] = case(g, pkg), (None if case.__name__ in INTERLEAVED
                                  else dump(g))
        g.close()
    assert got[PKGS[1]] == got[PKGS[0]]
    if case.__name__ in EXPECT:
        assert got[PKGS[1]][0] == EXPECT[case.__name__]


def test_snapshot_reads_see_begin_time_state():
    first, inc_before, inside, after = snapshot_read_begin_time(
        new_graph(PKGS[1]), PKGS[1])
    assert inside == ("before", inc_before)
    assert after[0] == "after" and len(after[1]) == len(inc_before) + 1
    seen, inside, later = snapshot_read_by_value_index(new_graph(PKGS[1]),
                                                       PKGS[1])
    assert seen[0] and not seen[1] and not inside and later
    captured, history = history_gc(new_graph(PKGS[1]), PKGS[1])
    assert captured and history == {}


def test_non_transactional_mode():
    got = {}
    for pkg in PKGS:
        g = new_graph(pkg, transactional=False)
        h = g.add("direct")
        got[pkg] = g.get(h), g.txman.transact(lambda: 42), dump(g)
        g.close()
    assert got[PKGS[1]] == got[PKGS[0]]
    assert got[PKGS[1]][:2] == ("direct", 42)
