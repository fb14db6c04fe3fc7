"""The reference's transaction and cache regressions
(``tests/test_tx_regressions.py``) run on both packages: each scenario
runs on a fresh graph of each package and returns what a caller can see,
and the two records must be equal. The environment case waits for the
port's storage backends (ROADMAP queue 1, item 2).

Tolerance: exact equality."""

import threading
from importlib import import_module

import pytest

from test_torch_query import PKGS, new_graph


def on_both(scenario):
    out = []
    for pkg in PKGS:
        g = new_graph(pkg)
        try:
            out.append(scenario(pkg, g))
        finally:
            g.close()
    assert out[1] == out[0]
    return out[1]


def errors(pkg):
    return import_module(f"{pkg}.core.errors")


def test_aborted_tx_does_not_pollute_atom_cache():
    def scenario(pkg, g):
        holder = {}

        def work():
            h = holder["h"] = g.add("hello")
            assert g.get(h) == "hello"
            raise RuntimeError("abort")

        with pytest.raises(RuntimeError):
            g.txman.transact(work)
        with pytest.raises(errors(pkg).NotFoundError):
            g.get(holder["h"])
        return g.contains(holder["h"]), int(holder["h"])

    assert on_both(scenario)[0] is False


def test_keep_incident_links_invalidates_link_cache():
    def scenario(pkg, g):
        a, b = g.add("a"), g.add("b")
        lk = g.add_link((a, b))
        warm = g.get(lk).targets
        g.remove(a, keep_incident_links=True)
        return warm, g.get(lk).targets, int(b)

    warm, after, b = on_both(scenario)
    assert after == (b,) and len(warm) == 2


def test_events_deferred_until_commit():
    def scenario(pkg, g):
        ev = import_module(f"{pkg}.core.events")
        seen = []
        g.events.add_listener(ev.HGAtomAddedEvent,
                              lambda gr, e: seen.append(e.handle) or 0)

        def work():
            g.add("ghost")
            assert seen == []
            raise RuntimeError("abort")

        with pytest.raises(RuntimeError):
            g.txman.transact(work)
        before = list(seen)
        h = g.txman.transact(lambda: g.add("real"))
        return before, seen, h

    before, seen, h = on_both(scenario)
    assert before == [] and seen == [h]


def test_mutation_counter_not_bumped_on_abort():
    def scenario(pkg, g):
        before = g._mutations

        def work():
            g.add("ghost")
            raise RuntimeError("abort")

        with pytest.raises(RuntimeError):
            g.txman.transact(work)
        return g._mutations - before

    assert on_both(scenario) == 0


def test_atoms_sees_parent_tx_writes():
    def scenario(pkg, g):
        outer = g.txman.begin()
        h = g.add("outer-atom")
        inner = g.txman.begin()
        seen = h in set(g.atoms())
        g.txman.abort(inner)
        g.txman.abort(outer)
        return seen, h in set(g.atoms())

    assert on_both(scenario) == (True, False)


def test_scan_keys_consistent_after_tx_removal():
    def scenario(pkg, g):
        g.store.get_index("sk").add_entry(b"only", 7)
        tx = g.txman.begin()
        idx2 = g.store.get_index("sk")
        idx2.remove_entry(b"only", 7)
        inside = (len(idx2.find(b"only")), list(idx2.scan_keys()))
        g.txman.abort(tx)
        return inside, list(g.store.get_index("sk").scan_keys())

    inside, after = on_both(scenario)
    assert inside[0] == 0 and b"only" not in inside[1] and b"only" in after


def test_bulk_import_preserves_open_snapshots():
    """A transaction begun before a concurrent ``bulk_import`` keeps its
    begin-time view of every cell the load touches."""

    def scenario(pkg, g):
        IDX_BY_VALUE = import_module(f"{pkg}.core.graph").IDX_BY_VALUE
        target = g.add("target")
        l0 = g.add_link((target,), value="pre")
        tx = g.txman.begin()
        pre_inc = g.get_incidence_set(target).array().tolist()
        pre_vals = g.store.get_index(IDX_BY_VALUE, create=True)
        t = threading.Thread(target=lambda: g.bulk_import(
            values=[f"bulk{i}" for i in range(8)],
            target_lists=[[int(target)]] * 8))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        inside = g.get_incidence_set(target).array().tolist()
        th = g._resolve_type_handle("bulk0", None)
        key = g.typesystem.get_type(int(th)).to_key("bulk0")
        hidden = len(pre_vals.find(key))
        g.txman.abort(tx)
        return pre_inc, inside, int(l0), hidden, len(
            g.get_incidence_set(target))

    pre, inside, l0, hidden, n_after = on_both(scenario)
    assert pre == inside == [l0] and hidden == 0 and n_after == 9


def test_bulk_import_abort_keeps_snapshot_isolation():
    """A ``bulk_import`` that fails mid-batch still serves open snapshots
    their begin-time view and dooms transactions that read it."""

    def scenario(pkg, g):
        target = g.add("t")
        l0 = g.add_link((target,), value="pre")
        tx = g.txman.begin()
        pre = g.get_incidence_set(target).array().tolist()
        err = {}

        def load():
            try:
                g.bulk_import(values=["a", "b", "c", "d"],
                              target_lists=[[int(target)], [int(target)],
                                            ["not-a-handle"], [int(target)]])
            except Exception as e:  # noqa: BLE001 - the failure under test
                err["e"] = type(e).__name__

        t = threading.Thread(target=load)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        inside = g.get_incidence_set(target).array().tolist()
        g.add("unrelated-write")
        with pytest.raises(errors(pkg).TransactionConflict):
            g.txman.commit(tx)
        return err.get("e"), pre, inside, int(l0)

    e, pre, inside, l0 = on_both(scenario)
    assert e is not None and pre == inside == [l0]
