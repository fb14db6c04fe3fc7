"""The reference's review regressions (``tests/test_review_regressions.py``)
run on both packages, each scenario on a fresh graph of each, the records
equal. The ``value_rank_hi`` case compares the port's one rank word
through ``reference_words`` (the reference keeps two uint32 words); the
peer case waits for the port's ``peer/`` (ROADMAP queue 1, item 3).

Tolerance: exact equality."""

import json
import threading
from dataclasses import dataclass
from importlib import import_module

import numpy as np
import pytest

from test_torch_query import PKGS, new_graph


@dataclass
class MutablePerson:  # eq=True, frozen=False: __hash__ is None
    name: str = ""
    age: int = 0


def on_both(scenario):
    out = []
    for pkg in PKGS:
        g = new_graph(pkg)
        try:
            out.append(scenario(pkg, g, import_module(f"{pkg}.query.dsl")))
        finally:
            g.close()
    assert out[1] == out[0]
    return out[1]


def test_query_on_unhashable_record_value():
    def scenario(pkg, g, q):
        h = g.add(MutablePerson("ada", 36))
        g.add(MutablePerson("bob", 9))
        p = MutablePerson("ada", 36)
        return (int(h), q.find_all(g, q.and_(q.eq(p), q.eq(p))),
                q.find_all(g, q.or_(q.eq(p), q.eq(p))))

    h, a, o = on_both(scenario)
    assert a == o == [h]


def test_parallel_union_sees_tx_writes():
    def scenario(pkg, g, q):
        g.config.query.parallel_or = True
        pre = g.add("pre-existing")

        def inside():
            fresh = g.add("fresh-in-tx")
            res = q.find_all(g, q.or_(q.value("pre-existing"),
                                      q.value("fresh-in-tx")))
            return int(pre), int(fresh), sorted(res)

        return g.txman.transact(inside)

    pre, fresh, res = on_both(scenario)
    assert res == sorted([pre, fresh])


def test_device_value_rank_not_truncated():
    """The 64-bit rank survives the device twin: the reference's two
    words and the port's one word (through ``reference_words``) hold the
    same ranks, ordered alike."""
    from hypergraphdb_tpu_torch.ops.snapshot import reference_words

    def scenario(pkg, g, q):
        a, b = g.add("aaaa-low"), g.add("zzzz-high")
        snap = g.snapshot()
        if pkg == PKGS[0]:
            dev = snap.device
            hi = np.asarray(dev.value_rank_hi)
            lo = np.asarray(dev.value_rank_lo)
        else:
            words = snap.device("cpu").value_rank.numpy()
            hi, lo = reference_words(words)
        full = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
        np.testing.assert_array_equal(full, snap.value_rank)
        ra, rb = snap.value_rank[int(a)], snap.value_rank[int(b)]
        return (bool(ra < rb), (int(hi[int(a)]), int(lo[int(a)])),
                (int(hi[int(b)]), int(lo[int(b)])))

    lower, wa, wb = on_both(scenario)
    assert lower == (wa < wb)


def test_remove_veto_runs_inside_tx():
    def scenario(pkg, g, q):
        ev = import_module(f"{pkg}.core.events")
        a = g.add("pinned")
        seen = []

        def veto(gr, event):
            seen.append(gr.txman.current() is not None)
            return ev.HGListener.CANCEL

        g.events.add_listener(ev.HGAtomRemoveRequestEvent, veto)
        return g.remove(a), g.contains(a), seen

    assert on_both(scenario) == (False, True, [True])


def test_bulk_import_invalidates_readers():
    def scenario(pkg, g, q):
        tx = g.txman.begin()
        absent = q.find_all(g, q.value(123456))
        t = threading.Thread(
            target=lambda: g.bulk_import(values=[123456, 123457]))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        g.add("marker")
        errors = import_module(f"{pkg}.core.errors")
        with pytest.raises(errors.TransactionConflict):
            g.txman.commit(tx)
        return absent

    assert on_both(scenario) == []


def test_import_graph_rolls_back_on_failure(tmp_path):
    def scenario(pkg, g, q):
        ck = import_module(f"{pkg}.ops.checkpoint")
        for i in range(5):
            g.add(f"v{i}")
        path = str(tmp_path / f"{pkg}.jsonl")
        ck.export_graph(g, path)
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps({"h": 999999, "type": "int", "v": None,
                                "link": True, "t": [424242]}) + "\n")
        dst = new_graph(pkg)
        try:
            before = sorted(dst.atoms())
            with pytest.raises(Exception):
                ck.import_graph(dst, path)
            return before, sorted(dst.atoms())
        finally:
            dst.close()

    before, after = on_both(scenario)
    assert after == before


def test_keep_incident_links_rewrite_fires_replaced_event():
    def scenario(pkg, g, q):
        c = import_module(f"{pkg}.query.conditions")
        filt = import_module(f"{pkg}.query.compiler").filter_predicates
        a, b, x = g.add("a"), g.add("b"), g.add("x")
        lk = g.add_link((a, b, x), value="rel")
        kw = {"device": "cpu"} if pkg == PKGS[1] else {}
        g.enable_incremental(headroom=10.0, background=False, **kw)
        g.snapshot()
        g.remove(x, keep_incident_links=True)
        arr = np.asarray([int(lk)], dtype=np.int64)
        return (int(lk), filt(g, arr, [c.Arity(3, "eq")]).tolist(),
                filt(g, arr, [c.Arity(2, "eq")]).tolist())

    lk, got3, got2 = on_both(scenario)
    assert got3 == [] and got2 == [lk]


def test_bulk_import_invalidates_user_index_readers():
    def scenario(pkg, g, q):
        im = import_module(f"{pkg}.indexing.manager")
        errors = import_module(f"{pkg}.core.errors")
        th = int(g.typesystem.handle_of("int"))
        im.register(g, im.DirectValueIndexer("myidx", th))
        tx = g.txman.begin()
        key = g.typesystem.infer(777).to_key(777)
        seen = im.get_index(g, "myidx").find(key).array().tolist()
        t = threading.Thread(target=lambda: g.bulk_import(values=[777]))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        g.add("marker")
        with pytest.raises(errors.TransactionConflict):
            g.txman.commit(tx)
        return seen

    assert on_both(scenario) == []
