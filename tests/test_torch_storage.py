"""The storage contract, on the port's backends against the reference's.

The reference's conformance suite (``tests/test_storage.py``) as cases run
on a fresh backend of each package: memory, native (the C++ engine, each
package building its own copy), partitioned over memory and partitioned
over native stores. Each case asserts what the reference's test asserts
and returns what it read; the port's answers must equal the reference's on
the same operations. Tolerance: exact equality.
"""

import importlib

import numpy as np
import pytest

PKGS = ("hypergraphdb_tpu", "hypergraphdb_tpu_torch")
BACKENDS = ("memory", "native", "partitioned", "partitioned-native")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def make_backend(pkg, kind, where):
    """A fresh, started backend of ``pkg``; ``where`` holds its files."""
    if kind == "memory":
        b = mod(pkg, "storage.memstore").MemStorage()
    elif kind == "native":
        b = mod(pkg, "storage.native").NativeStorage(str(where / "db"))
    else:
        Part = mod(pkg, "storage.partitioned").PartitionedStorage
        if kind == "partitioned":
            b = Part(n_partitions=3)
        else:
            Native = mod(pkg, "storage.native").NativeStorage
            b = Part(n_partitions=3,
                     factory=lambda i: Native(str(where / f"part{i}")))
    b.startup()
    return b


def on_both(kind, tmp_path, case):
    """``case(backend)`` on each package's backend; their results."""
    out = []
    for pkg in PKGS:
        b = make_backend(pkg, kind, tmp_path / pkg)
        try:
            out.append(case(b))
        finally:
            b.shutdown()
    return out


# ---------------------------------------------------------------- links


def link_roundtrip(store):
    store.store_link(1, (10, 20, 30))
    assert store.get_link(1) == (10, 20, 30)
    assert store.contains_link(1)
    assert store.get_link(2) is None
    assert not store.contains_link(2)
    return store.get_link(1), store.max_handle()


def link_empty_targets(store):
    store.store_link(5, ())
    assert store.get_link(5) == ()
    assert store.contains_link(5)
    return store.get_link(5), store.max_handle()


def link_overwrite_and_remove(store):
    store.store_link(1, (1, 2))
    store.store_link(1, (3,))
    assert store.get_link(1) == (3,)
    store.remove_link(1)
    assert store.get_link(1) is None
    store.remove_link(1)  # idempotent
    return store.get_link(1), store.max_handle()


# ---------------------------------------------------------------- data


def data_roundtrip(store):
    store.store_data(7, b"hello")
    seen = [store.get_data(7)]
    store.store_data(7, b"")
    seen.append(store.get_data(7))
    assert store.contains_data(7)
    store.remove_data(7)
    seen.append(store.get_data(7))
    assert seen == [b"hello", b"", None]
    assert not store.contains_data(7)
    return seen


def data_large(store):
    blob = bytes(range(256)) * 1000
    store.store_data(8, blob)
    assert store.get_data(8) == blob
    return len(store.get_data(8))


# ---------------------------------------------------------------- incidence


def incidence_sorted_and_deduped(store):
    for link in (5, 3, 9, 3, 7):
        store.add_incidence_link(100, link)
    rs = store.get_incidence_set(100)
    assert rs.array().tolist() == [3, 5, 7, 9]
    assert store.incidence_count(100) == 4
    assert 5 in rs
    assert 4 not in rs
    return rs.array().tolist(), store.incidence_count(100)


def incidence_remove(store):
    for link in (1, 2, 3):
        store.add_incidence_link(100, link)
    store.remove_incidence_link(100, 2)
    mid = store.get_incidence_set(100).array().tolist()
    assert mid == [1, 3]
    store.remove_incidence_set(100)
    assert len(store.get_incidence_set(100)) == 0
    return mid, store.incidence_count(100)


def incidence_goto(store):
    for link in (10, 20, 30):
        store.add_incidence_link(1, link)
    rs = store.get_incidence_set(1)
    got = [rs.go_to(20), rs.go_to(15), rs.go_to(15, exact=False),
           rs.go_to(31, exact=False)]
    assert got == [1, -1, 1, -1]
    return got


# ---------------------------------------------------------------- indexes


def index_basic(store):
    idx = store.get_index("test")
    idx.add_entry(b"a", 1)
    idx.add_entry(b"a", 2)
    idx.add_entry(b"b", 3)
    got = (idx.find(b"a").array().tolist(), idx.find_first(b"a"),
           idx.count(b"a"), idx.key_count(), list(idx.scan_keys()),
           sorted(idx.scan_values()))
    assert got == ([1, 2], 1, 2, 2, [b"a", b"b"], [1, 2, 3])
    return got


def index_remove(store):
    idx = store.get_index("test")
    idx.add_entry(b"k", 1)
    idx.add_entry(b"k", 2)
    idx.remove_entry(b"k", 1)
    mid = idx.find(b"k").array().tolist()
    assert mid == [2]
    idx.remove_all_entries(b"k")
    assert len(idx.find(b"k")) == 0
    assert idx.key_count() == 0
    return mid, idx.key_count()


def index_range(store):
    idx = store.get_index("rng")
    for i, k in enumerate([b"a", b"c", b"e", b"g"]):
        idx.add_entry(k, i)
    got = [idx.find_lt(b"e").array().tolist(),
           idx.find_lte(b"e").array().tolist(),
           idx.find_gt(b"c").array().tolist(),
           idx.find_gte(b"c").array().tolist(),
           idx.find_range(lo=b"c", hi=b"g").array().tolist()]
    assert got == [[0, 1], [0, 1, 2], [2, 3], [1, 2, 3], [1, 2]]
    return got


def index_bidirectional(store):
    idx = store.get_index("bi")
    idx.add_entry(b"x", 1)
    idx.add_entry(b"y", 1)
    idx.add_entry(b"x", 2)
    got = [idx.find_by_value(1), idx.count_keys(1)]
    idx.remove_entry(b"x", 1)
    got.append(idx.find_by_value(1))
    assert got == [[b"x", b"y"], 2, [b"y"]]
    return got


def index_namespace(store):
    a = store.get_index("a")
    b = store.get_index("b")
    a.add_entry(b"k", 1)
    assert len(b.find(b"k")) == 0
    names = sorted(store.index_names())
    assert set(names) >= {"a", "b"}
    store.remove_index("a")
    assert "a" not in store.index_names()
    return names, sorted(store.index_names())


def index_empty(store):
    idx = store.get_index("empty")
    got = (len(idx.find(b"nope")), idx.find_first(b"nope"),
           idx.count(b"nope"), idx.key_count(), list(idx.scan_keys()))
    assert got == (0, None, 0, 0, [])
    assert store.get_index("absent", create=False) is None
    return got


# ---------------------------------------------------------------- bulk


def bulk_links(store):
    store.store_link(0, (1, 2))
    store.store_link(2, (3,))
    store.store_link(1, ())
    ids, offsets, flat = store.bulk_links()
    got = (ids.tolist(), offsets.tolist(), flat.tolist())
    assert got == ([0, 1, 2], [0, 2, 2, 3], [1, 2, 3])
    assert ids.dtype == offsets.dtype == flat.dtype == np.int64
    return got


def max_handle(store):
    assert store.max_handle() == 0
    store.store_link(41, ())
    store.store_data(7, b"x")
    assert store.max_handle() == 42
    return store.max_handle()


def index_count_range(store):
    idx = store.get_index("cr")
    for i in range(20):
        key = bytes([i])
        for v in range(i % 3 + 1):  # 1..3 entries per key
            idx.add_entry(key, 100 * i + v)
    total = sum(i % 3 + 1 for i in range(20))
    got = [idx.count_range(),
           idx.count_range(lo=bytes([5]), hi=bytes([10])),
           idx.count_range(lo=bytes([5]), hi=bytes([10]), lo_inclusive=False,
                           hi_inclusive=True),
           idx.count_range(cap=4),
           idx.count_range(lo=bytes([19]), hi=None),
           idx.count_range(lo=bytes([50]))]
    assert got == [total, sum(i % 3 + 1 for i in range(5, 10)),
                   sum(i % 3 + 1 for i in range(6, 11)), 4, 19 % 3 + 1, 0]
    return got


CASES = (link_roundtrip, link_empty_targets, link_overwrite_and_remove,
         data_roundtrip, data_large, incidence_sorted_and_deduped,
         incidence_remove, incidence_goto, index_basic, index_remove,
         index_range, index_bidirectional, index_namespace, index_empty,
         bulk_links, max_handle, index_count_range)


@pytest.mark.parametrize("kind", BACKENDS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_conformance_matches_reference(case, kind, tmp_path):
    ref, port = on_both(kind, tmp_path, case)
    assert port == ref


def test_port_backends_implement_the_bidirectional_contract(tmp_path):
    """Each port backend's index is an ``HGBidirectionalIndex`` and each
    backend answers ``checkpoint`` (a no-op in memory)."""
    api = mod(PKGS[1], "storage.api")
    for kind in BACKENDS:
        b = make_backend(PKGS[1], kind, tmp_path / kind)
        try:
            assert isinstance(b.get_index("x"), api.HGBidirectionalIndex)
            b.store_link(3, (1,))
            b.checkpoint()
            assert b.get_link(3) == (1,)
        finally:
            b.shutdown()
