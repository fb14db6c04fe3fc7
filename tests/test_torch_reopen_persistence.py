"""A durable database keeps its self-knowledge across a reopen, in the port
as in the reference.

The reference's ``tests/test_reopen_persistence.py`` cases on both
packages over the native backend: an indexer's registration and its
removal survive, and so does the declared type hierarchy; a serving peer's
op log and a client peer's seen map (its vector clock) survive a restart,
so a catch-up from the restarted peer asks only past what was applied. The two reopen cases of
``tests/test_index_stats.py``: a user index's persisted statistics come
back, and are recounted when the index changed across the reopen. Then
what a reopen restores on the native and the partitioned backend: type
names, the handle counter, the format stamp, records and indexes, equal
in both packages. Tolerance: exact equality.
"""

from dataclasses import dataclass

import pytest

from test_torch_storage import PKGS, mod


@dataclass(frozen=True)
class Person:
    name: str = ""
    age: int = 0


@dataclass(frozen=True)
class Thing:
    tag: str = ""


def open_graph(pkg, loc, backend="native"):
    cfg = mod(pkg, "core.config").HGConfiguration(store_backend=backend,
                                                  location=str(loc))
    return mod(pkg, "core.graph").HyperGraph(cfg)


def test_oplog_and_vector_clock_survive_reopen(tmp_path):
    """Catch-up works after the serving peer restarts: its op log, and the
    client's seen map, come back from the store."""
    import time

    got = []
    for pkg in PKGS:
        peer = mod(pkg, "peer")
        q = mod(pkg, "query.dsl")
        loc1, loc2 = tmp_path / pkg / "p1", tmp_path / pkg / "p2"
        net = peer.LoopbackNetwork()
        g1 = open_graph(pkg, loc1)
        p1 = peer.HyperGraphPeer.loopback(g1, net, identity="peer-1")
        p1.start()
        g1.add("replicated-1")
        g1.add("replicated-2")
        assert p1.replication.flush()
        head_before = p1.replication.log.head
        assert head_before >= 2
        log_before = p1.replication.log.since(0)
        p1.stop()
        g1.close()

        # restart peer-1 on the same store: the log is still there
        net2 = peer.LoopbackNetwork()
        g1b = open_graph(pkg, loc1)
        p1b = peer.HyperGraphPeer.loopback(g1b, net2, identity="peer-1")
        p1b.start()
        assert p1b.replication.log.head == head_before
        assert p1b.replication.log.since(0) == log_before

        # a fresh peer-2 catches up from the restarted peer-1
        g2 = open_graph(pkg, loc2)
        p2 = peer.HyperGraphPeer.loopback(g2, net2, identity="peer-2")
        p2.start()
        p2.replication.catch_up("peer-1")
        t0 = time.monotonic()
        while time.monotonic() - t0 < 5.0:
            if p2.replication.last_seen.get("peer-1") >= head_before:
                break
            time.sleep(0.01)
        assert p2.replication.last_seen.get("peer-1") >= head_before
        assert q.find_all(g2, q.value("replicated-1"))
        assert p2.replication.flush()
        digest = mod(pkg, "peer.transfer").content_digest(g2)
        p2.stop()
        g2.close()

        # restart peer-2: its seen map survived
        g2b = open_graph(pkg, loc2)
        p2b = peer.HyperGraphPeer.loopback(g2b, net2, identity="peer-2b")
        seen = p2b.replication.last_seen.get("peer-1")
        assert seen >= head_before
        got.append((head_before, log_before, seen,
                    p2b.replication.last_seen.intervals("peer-1"), digest,
                    mod(pkg, "peer.transfer").content_digest(g2b)))
        g2b.close()
        p1b.stop()
        g1b.close()
    assert got[1] == got[0]


def test_indexer_registration_survives_reopen(tmp_path):
    got = []
    for pkg in PKGS:
        ixm = mod(pkg, "indexing.manager")
        loc = tmp_path / pkg
        g = open_graph(pkg, loc)
        th = int(g.typesystem.handle_of(g.typesystem.infer(Person()).name))
        ixm.register(g, ixm.ByPartIndexer("person-by-name", th, "name"))
        g.add(Person("ada", 36))
        g.close()

        g2 = open_graph(pkg, loc)
        restored = [ix.name for ix in ixm.indexers_of(g2, th)]
        pt = g2.typesystem.infer("ada")
        hits = ixm.get_index(g2, "person-by-name").find(
            pt.to_key("ada")).array().tolist()
        g2.typesystem.infer(Person())
        name = g2.get(int(hits[0])).name
        g2.add(Person("bob", 9))
        bob = ixm.get_index(g2, "person-by-name").find(
            pt.to_key("bob")).array().tolist()
        got.append((th, restored, hits, name, bob))
        g2.close()
    assert got[1] == got[0]
    _, restored, hits, name, bob = got[1]
    assert restored == ["person-by-name"] and len(hits) == 1
    assert name == "ada" and len(bob) == 1


def test_unregister_survives_reopen(tmp_path):
    got = []
    for pkg in PKGS:
        ixm = mod(pkg, "indexing.manager")
        loc = tmp_path / pkg
        g = open_graph(pkg, loc)
        th = int(g.typesystem.handle_of(g.typesystem.infer(Thing()).name))
        ixm.register(g, ixm.ByPartIndexer("thing-by-tag", th, "tag"))
        ixm.unregister(g, "thing-by-tag")
        g.close()
        g2 = open_graph(pkg, loc)
        got.append(ixm.indexers_of(g2, th))
        g2.close()
    assert got == [[], []]


def named_type(pkg, name):
    class T(mod(pkg, "types.primitive").StringType):
        pass

    t = T()
    t.name = name
    return t


def test_subtype_hierarchy_survives_reopen(tmp_path):
    got = []
    for pkg in PKGS:
        q = mod(pkg, "query.dsl")
        declare_subsumes = mod(pkg, "atom.utilities").declare_subsumes
        loc = tmp_path / pkg
        g = open_graph(pkg, loc)
        g.typesystem.register(named_type(pkg, "animal"))
        g.typesystem.register(named_type(pkg, "dog"))
        declare_subsumes(g, "animal", "dog")
        d = int(g.add_node("rex", type="dog"))
        g.close()
        g2 = open_graph(pkg, loc)
        closure = sorted(g2.typesystem.subtypes_closure("animal"))
        res = q.find_all(g2, q.type_plus("animal"))
        got.append((d, closure, res))
        g2.close()
    assert got[1] == got[0]
    d, closure, res = got[1]
    assert "dog" in closure and d in res


# ------------------------------------ index statistics across a reopen


def test_index_stats_persist_across_reopen(tmp_path):
    got = []
    for pkg in PKGS:
        ixm = mod(pkg, "indexing.manager")
        by_value = mod(pkg, "core.graph").IDX_BY_VALUE
        loc = tmp_path / pkg
        g = open_graph(pkg, loc)
        for i in range(50):
            g.add(i)
        s1 = ixm.index_stats(g, by_value)
        assert s1["entries"] >= 50
        g.close()
        g2 = open_graph(pkg, loc)
        s2 = ixm.index_stats(g2, by_value)
        assert s2["entries"] == s1["entries"]
        assert s2["version"] == s1["version"]
        s3 = ixm.index_stats(g2, by_value, refresh=True)
        assert s3["entries"] >= 50
        got.append((s1, s2, s3))
        g2.close()
    assert got[1] == got[0]


def test_stats_recount_when_index_changed_across_reopen(tmp_path):
    got = []
    for pkg in PKGS:
        ixm = mod(pkg, "indexing.manager")
        by_value = mod(pkg, "core.graph").IDX_BY_VALUE
        loc = tmp_path / pkg
        g = open_graph(pkg, loc)
        for i in range(40):
            g.add(i)
        s1 = ixm.index_stats(g, by_value)
        g.close()
        g2 = open_graph(pkg, loc)
        for i in range(4000):
            g2.add(10_000 + i)
        s2 = ixm.index_stats(g2, by_value)
        assert s2["entries"] > s1["entries"], (s1, s2)
        got.append((s1, s2))
        g2.close()
    assert got[1] == got[0]


# ------------------------------------------------- what a reopen restores


def store_tables(g):
    b = g.backend
    ids, offs, flat = b.bulk_links()
    return {
        "links": [ids.tolist(), offs.tolist(), flat.tolist()],
        "data": {int(h): b.get_data(int(h)) for h in ids.tolist()
                 + [int(r[1]) for r in map(b.get_link, ids.tolist())
                    if len(r) > 1 and r[1] >= 0]},
        "idx": {name: [(k, v.tolist())
                       for k, v in b.get_index(name).bulk_items()]
                for name in b.index_names()},
    }


@pytest.mark.parametrize("backend", ["native", "partitioned"])
def test_reopen_restores_type_names_handles_and_stamp(tmp_path, backend):
    got = []
    for pkg in PKGS:
        mig = mod(pkg, "maintenance.migration")
        loc = tmp_path / pkg
        g = open_graph(pkg, loc, backend)
        people = [int(g.add(Person(f"p{i}", i))) for i in range(5)]
        link = int(g.add_link(people[:3], value="knows"))
        g.add(3.5)
        before = (g.handles.peek, dict(g.typesystem._handle_by_name),
                  store_tables(g))
        commits = g.txman.committed
        g.close()

        g2 = open_graph(pkg, loc, backend)
        ts = g2.typesystem
        th = int(g2.get_type_handle_of(people[0]))
        # a stored type atom: named from the store, decodable once its
        # class is bound again (as the first use of the class does)
        with pytest.raises(mod(pkg, "core.errors").TypeError_):
            ts.get_type(th)
        stored_name = ts._type_atom_name(th)
        assert ts.is_type_handle(th)
        ts.infer(Person())
        person_t = ts.get_type(th)
        assert person_t.name == stored_name
        after = (g2.handles.peek, dict(g2.typesystem._handle_by_name),
                 store_tables(g2))
        nxt = int(g2.add("next"))
        got.append((before, after, person_t.name, nxt, commits,
                    g2.txman.committed, mig.stored_format_version(g2),
                    [g2.get(h).name for h in people], g2.get(link).targets))
        g2.close()
    assert got[1] == got[0]
    before, after, tname, nxt, _, reopened_commits, stamp, names, tg = got[1]
    assert after == before and nxt == before[0]
    assert tname.endswith("test_torch_reopen_persistence.Person")
    # the reopen commits nothing (the stamp is current): one commit, the add
    assert reopened_commits == 1 and stamp == 1
    assert names == [f"p{i}" for i in range(5)] and len(tg) == 3
