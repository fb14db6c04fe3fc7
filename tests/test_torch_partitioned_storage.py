"""The port's partitioned storage against the reference's.

The routing cases of the reference's ``tests/test_partitioned_storage.py``
(its map cases are in ``test_torch_partition_map.py``), run on both
packages with the same records: placement by ``h % n`` with every read
equal; placement by gid range (``partition_map=``), ``repartition`` to a
re-cut map (the count moved, every read unchanged, a second call moving
nothing, its three refusals), a child count the map does not cover, and
``MemStorage.iter_record_handles``; a grid of native children, which
cannot enumerate its records, refused alike; and a graph over a range
grid, grown and repartitioned. Then the partition
marker of a durable grid (the cases of ``tests/test_wire_fixes.py``):
stamped on the first open, a legacy marker read as version 1, an unknown
version refused, and the marker's count, not the configuration's,
deciding a reopened grid.
Tolerance: exact equality.
"""

import json

import numpy as np
import pytest

from test_torch_storage import PKGS, mod


def part(pkg):
    return mod(pkg, "storage.partitioned")


def seed(store, n=300, cap=4096):
    """Links with spread-out handles and a bidirectional index."""
    rng = np.random.default_rng(7)
    handles = sorted(rng.choice(cap, size=n, replace=False).tolist())
    for h in handles:
        store.store_link(int(h), (int(h) % 17, int(h) % 5))
        store.store_data(int(h), f"payload-{h}".encode())
        store.add_incidence_link(int(h), int(h) % 29)
    idx = store.get_index("by-mod")
    for h in handles:
        idx.add_entry(str(int(h) % 13).encode(), int(h))
    return handles


def reads(store, handles):
    idx = store.get_index("by-mod", create=False)
    return {
        "links": {h: store.get_link(h) for h in handles},
        "data": {h: store.get_data(h) for h in handles},
        "inc": {h: list(store.get_incidence_set(h)) for h in handles},
        "finds": {m: list(idx.find(str(m).encode())) for m in range(13)},
        "counts": {m: idx.count(str(m).encode()) for m in range(13)},
        "key_count": idx.key_count(),
        "keys": list(idx.scan_keys()),
        "bulk": [a.tolist() for a in store.bulk_links()],
    }


def placement(store, handles):
    return {h: [i for i, c in enumerate(store._parts)
                if c.get_link(h) is not None] for h in handles}


@pytest.mark.parametrize("n", [1, 3, 4])
def test_modulo_routing_places_by_owner(n):
    """Every record lands on child ``h % n`` alone, and every read through
    the front (records, payloads, incidence, index finds, counts, key
    scans, the bulk export) equals the reference's on the same records."""
    got = []
    for pkg in PKGS:
        store = part(pkg).PartitionedStorage(n_partitions=n)
        handles = seed(store)
        where = placement(store, handles)
        assert all(where[h] == [h % n] for h in handles)
        got.append((where, reads(store, handles)))
    assert got[1] == got[0]


def test_key_part_and_modulo_routing_match_reference():
    """Index keys hash to the same child and handles to the same
    ``h % n`` owner in both packages, so a grid written by one is read by
    the other."""
    keys = [bytes([i]) * (i % 5 + 1) for i in range(64)] + [b"", b"hg.k"]
    assert ([part(PKGS[1])._key_part(k, 5) for k in keys]
            == [part(PKGS[0])._key_part(k, 5) for k in keys])
    got = []
    for pkg in PKGS:
        store = part(pkg).PartitionedStorage(n_partitions=3)
        handles = seed(store, n=50, cap=500)
        got.append((placement(store, handles),
                    [[k for k, _ in c.get_index("by-mod").bulk_items()]
                     for c in store._parts]))
    assert got[1] == got[0]


# ------------------------------------------------------ range routing


def pmap(pkg, capacity, n):
    return part(pkg).PartitionMap.for_mesh(capacity, n)


def test_gid_range_routing_places_by_owner():
    """With a map every record lands on the child whose gid range holds
    it (ids past the capacity on the last), the map is kept, and every
    read equals the reference's on the same records."""
    got = []
    for pkg in PKGS:
        pm = pmap(pkg, 4096, 4)
        store = part(pkg).PartitionedStorage(partition_map=pm)
        assert store.partition_map is pm and len(store._parts) == 4
        handles = seed(store, cap=5000)
        where = placement(store, handles)
        assert all(where[h] == [pm.owner_of(h)] for h in handles)
        got.append((where, reads(store, handles)))
    assert got[1] == got[0]


def test_repartition_moves_ranges_and_stays_exact():
    """A map re-cut for a grown id space: the same handles move in both
    packages (the count is equal and above 0), every read answers as
    before, placement follows the new map, and a second call moves
    nothing."""
    got = []
    for pkg in PKGS:
        pm = pmap(pkg, 1024, 4)
        store = part(pkg).PartitionedStorage(partition_map=pm)
        handles = seed(store, cap=4000)  # most ids clamp into range 3
        before = reads(store, handles)
        new = pm.repartitioned(4096)
        assert new.part_size != pm.part_size
        moved = store.repartition(new)
        assert moved > 0
        assert store.partition_map == new
        assert reads(store, handles) == before
        where = placement(store, handles)
        assert all(where[h] == [new.owner_of(h)] for h in handles)
        assert store.repartition(new) == 0
        assert reads(store, handles) == before
        got.append((moved, where, [sorted(c.iter_record_handles())
                                   for c in store._parts]))
    assert got[1] == got[0]


def test_repartition_requires_range_routing_and_same_owner_count():
    got = []
    for pkg in PKGS:
        P = part(pkg)
        with pytest.raises(ValueError, match="modulo") as e1:
            P.PartitionedStorage(n_partitions=3).repartition(
                pmap(pkg, 100, 3))
        ranged = P.PartitionedStorage(partition_map=pmap(pkg, 100, 3))
        with pytest.raises(ValueError, match="partition count") as e2:
            ranged.repartition(pmap(pkg, 100, 4))
        got.append((type(e1.value).__name__, type(e2.value).__name__))
    assert got[1] == got[0] == ("ValueError", "ValueError")


def test_partition_map_mismatched_children_rejected():
    got = []
    for pkg in PKGS:
        Mem = mod(pkg, "storage.memstore").MemStorage
        with pytest.raises(ValueError, match="owners") as e:
            part(pkg).PartitionedStorage(partitions=[Mem(), Mem()],
                                         partition_map=pmap(pkg, 100, 3))
        got.append(type(e.value).__name__)
    assert got == ["ValueError"] * 2


def test_iter_record_handles_enumerates_every_record_kind():
    got = []
    for pkg in PKGS:
        m = mod(pkg, "storage.memstore").MemStorage()
        m.store_link(1, (2,))
        m.store_data(9, b"x")
        m.add_incidence_link(5, 1)
        m.store_link(5, (9, 1))
        got.append(m.iter_record_handles())
        m.remove_link(1)
        got.append(m.iter_record_handles())
    assert got == [{1, 9, 5}, {9, 5}] * 2


def test_repartition_refuses_children_that_cannot_enumerate(tmp_path):
    """Native children keep no enumeration in either package: a grid of
    them routes by range but refuses to move, before touching a record."""
    from test_torch_storage import make_backend

    got = []
    for pkg in PKGS:
        kids = [make_backend(pkg, "native", tmp_path / pkg / str(i))
                for i in range(2)]
        try:
            assert not hasattr(kids[0], "iter_record_handles")
            store = part(pkg).PartitionedStorage(
                partitions=kids, partition_map=pmap(pkg, 256, 2))
            for h in (3, 200, 300):
                store.store_link(h, (1, 2))
            with pytest.raises(TypeError, match="iter_record_handles") as e:
                store.repartition(pmap(pkg, 1024, 2))
            got.append((type(e.value).__name__,
                        placement(store, [3, 200, 300])))
        finally:
            for k in kids:
                k.shutdown()
    assert got[1] == got[0]
    assert got[1][1] == {3: [0], 200: [1], 300: [1]}


def test_graph_over_a_range_grid_grows_and_repartitions():
    """The slice as a whole: a graph over a 4-owner range grid cut for
    its first atoms, grown past the cut, repartitioned to the map of the
    grown id space; the same atoms move in both packages, and the graph
    reads (values, targets, incidence sets, the bulk export) are equal
    before and after and between the packages."""
    got = []
    for pkg in PKGS:
        g0 = mod(pkg, "core.graph").HyperGraph()
        boot = g0.handles.peek
        g0.close()
        n0 = 120
        pm = pmap(pkg, boot + n0 + 1, 4)
        grid = part(pkg).PartitionedStorage(partition_map=pm)
        g = mod(pkg, "core.graph").HyperGraph(backend=grid)
        rng = np.random.default_rng(5)
        nodes = g.bulk_import(values=list(range(n0 // 3)))
        nodes = [int(h) for h in nodes]
        for i in range(n0 - len(nodes) + 200):
            a, b = rng.choice(nodes, size=2, replace=False)
            g.add_link((int(a), int(b)), value=i)
        ids = list(range(g.handles.peek))

        def view():
            return ([repr(g.get(h)) if g.contains(h) else None
                     for h in ids],
                    [g.get_incidence_set(h).array().tolist() for h in ids],
                    [a.tolist() for a in grid.bulk_links()])

        before = view()
        assert g.handles.peek > pm.capacity
        new = pm.repartitioned(g.handles.peek)
        moved = grid.repartition(new)
        assert moved > 0 and view() == before
        assert all(grid._parts[new.owner_of(h)].iter_record_handles()
                   >= {h} for h in ids if g.contains(h))
        got.append((moved, before))
        g.close()
    assert got[1] == got[0]


# ------------------------------------------------- the partition marker


def grid(pkg, loc, n):
    cfg = mod(pkg, "core.config").HGConfiguration(
        store_backend="partitioned", location=str(loc), n_partitions=n)
    return mod(pkg, "core.graph").HyperGraph(cfg)


def test_partition_marker_is_stamped_on_first_open(tmp_path):
    got = []
    for pkg in PKGS:
        loc = tmp_path / pkg / "grid"
        grid(pkg, loc, 3).close()
        got.append(json.loads((loc / "partitions.json").read_text()))
    assert got[1] == got[0] == {"schema_version": 1, "n_partitions": 3}


def test_partition_marker_legacy_unstamped_is_accepted(tmp_path):
    got = []
    for pkg in PKGS:
        loc = tmp_path / pkg / "grid"
        loc.mkdir(parents=True)
        (loc / "partitions.json").write_text(json.dumps({"n_partitions": 3}))
        g = grid(pkg, loc, 5)
        got.append(len(g.backend._parts))
        g.close()
    assert got == [3, 3]


def test_partition_marker_future_version_hard_fails(tmp_path):
    got = []
    for pkg in PKGS:
        loc = tmp_path / pkg / "grid"
        loc.mkdir(parents=True)
        (loc / "partitions.json").write_text(
            json.dumps({"schema_version": 99, "n_partitions": 3}))
        with pytest.raises(mod(pkg, "core.errors").HGException,
                           match="partition-marker schema") as e:
            grid(pkg, loc, 3)
        got.append(str(e.value).replace(str(tmp_path / pkg), ""))
    assert got[1] == got[0]


def test_reopened_grid_uses_the_markers_count(tmp_path):
    """A grid written with 4 partitions and reopened asking for 2 keeps 4:
    every atom, value and incidence set reads back, and the next handle
    follows the stored ones, in both packages."""
    got = []
    for pkg in PKGS:
        loc = tmp_path / pkg / "grid"
        g = grid(pkg, loc, 4)
        hs = [int(g.add(f"v{i}")) for i in range(40)]
        ls = [int(g.add_link((hs[i], hs[i + 1]), value=i))
              for i in range(0, 39, 3)]
        g.close()
        g2 = grid(pkg, loc, 2)
        got.append((len(g2.backend._parts),
                    [g2.get(h) for h in hs], [g2.get(h).targets for h in ls],
                    [g2.get_incidence_set(h).array().tolist() for h in hs],
                    g2.handles.peek, int(g2.add("after"))))
        g2.close()
    assert got[1] == got[0]
    assert got[1][0] == 4
