"""The port's partitioned storage against the reference's.

The routing cases of the reference's ``tests/test_partitioned_storage.py``
(its map cases are in ``test_torch_partition_map.py``; its range routing
and ``repartition`` are not ported), run on both packages with the same
records: placement by ``h % n`` with every read equal. Then the partition
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
