"""The port's ``extract_tables`` and ``pack`` against the reference's on
graphs built by the same operations in both packages: every field of
``REFERENCE_FIELDS`` and the by-type index, for values of every primitive
kind (int, float, str short, long and with NUL, bytes, bool, timestamp,
list, dict, None), after removals and replaces, with capacity headroom and
a coarse pad. The device rank words go back to the reference's (hi, lo)
pair through ``reference_words``. The port's MessagePack subset is held
byte for byte against ``msgpack`` where that package imports. Tolerance:
exact equality."""

import datetime

import numpy as np
import pytest

from hypergraphdb_tpu_torch.ops.snapshot import (
    CSRSnapshot,
    reference_words,
)
from tests.test_torch_graph import PKGS, VALUES, mod, new_graph
from tests.test_torch_snapshot import assert_same_topology


def kinds_graph(pkg, seed=4, mutate=True):
    """Nodes of every kind and random links between them; with
    ``mutate``, a cascade removal, a kept-links removal and replaces."""
    r = np.random.default_rng(seed)
    g = new_graph(pkg)
    nodes = [g.add(v) for v in VALUES]
    nodes += [g.add(float(x)) for x in r.normal(size=6)]
    nodes += [g.add(int(x)) for x in r.integers(-2**62, 2**62, size=6)]
    nodes += [g.add("s" * int(n) + "\x00" * int(n % 3))
              for n in r.integers(0, 30, size=6)]
    links = [g.add_link([int(t) for t in r.choice(nodes, size=int(k),
                                                  replace=False)],
                        value=[int(k), "v"] if k % 2 else {"k": int(k)})
             for k in r.integers(1, 5, size=25)]
    links.append(g.add_link((links[0], links[1]), value=b"\x00" * 20))
    if mutate:
        g.remove(nodes[2])
        g.remove(nodes[3], keep_incident_links=True)
        g.replace(links[4], 3.25)
        g.replace(nodes[7], datetime.date(2020, 2, 29))
    return g


def ref_fields(snap) -> dict:
    return {k: getattr(snap, k) for k in CSRSnapshot.REFERENCE_FIELDS}


@pytest.mark.parametrize("mutate", [False, True])
def test_extract_tables_match(mutate):
    got = {}
    for pkg in PKGS:
        g = kinds_graph(pkg, mutate=mutate)
        t = mod(pkg, "ops.snapshot").CSRSnapshot.extract_tables(g)
        got[pkg] = t
        g.close()
    a, b = got[PKGS[0]], got[PKGS[1]]
    for k in ("ids", "offsets", "flat"):
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert a["peek"] == b["peek"]
    assert [k for k, _ in a["value_items"]] == [k for k, _ in b["value_items"]]
    for (_, x), (_, y) in zip(a["value_items"], b["value_items"]):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("mutate", [False, True])
@pytest.mark.parametrize("kw", [{}, {"capacity": 700, "pad_multiple": 256},
                                {"value_ranks": False}])
def test_pack_matches_reference(mutate, kw):
    snaps = {}
    for pkg in PKGS:
        g = kinds_graph(pkg, mutate=mutate)
        snaps[pkg] = mod(pkg, "ops.snapshot").CSRSnapshot.pack(g, **kw)
        g.close()
    ref, port = snaps[PKGS[0]], snaps[PKGS[1]]
    assert_same_topology(ref, port)
    if kw.get("value_ranks", True):
        assert len(set(port.value_kind.tolist())) >= 9  # every kind packed
        assert port.value_ambig.any()
    twin = port.device("cpu")
    hi, lo = reference_words(twin.value_rank.numpy())
    assert np.array_equal(hi, np.asarray(ref.device.value_rank_hi))
    assert np.array_equal(lo, np.asarray(ref.device.value_rank_lo))
    assert np.array_equal(twin.value_kind.numpy(),
                          np.asarray(ref.device.value_kind))


def test_graph_snapshot_caches_until_a_mutation():
    got = {}
    for pkg in PKGS:
        g = kinds_graph(pkg, mutate=False)
        s1 = g.snapshot()
        same = g.snapshot() is s1
        g.add("one more")
        s2 = g.snapshot()
        got[pkg] = same, s2 is s1, s1.version, s2.version, s2.num_atoms
        g.close()
    assert got[PKGS[1]] == got[PKGS[0]]
    assert got[PKGS[1]][:2] == (True, False)


def test_bench_c5_graph_packs_equal():
    """bench c5's build loop at a small size, through bulk_import."""
    from tests.test_torch_graph import c5_batch

    snaps = {}
    for pkg in PKGS:
        g = new_graph(pkg)
        r = np.random.default_rng(11)
        e0 = int(g.bulk_import(values=list(range(500)))[0])
        for s in range(0, 1200, 400):
            g.bulk_import(values=list(range(s, s + 400)),
                          target_lists=[[e0 + a, e0 + b]
                                        for a, b in c5_batch(r, 500, 400)])
        snaps[pkg] = mod(pkg, "ops.snapshot").CSRSnapshot.pack(
            g, capacity=4096, pad_multiple=1024)
        g.close()
    assert_same_topology(snaps[PKGS[0]], snaps[PKGS[1]])


# ----------------------------------------------------- the MessagePack subset

MSGPACK_VALUES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
    2**32, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
    -2**31 - 1, -2**63, 0.0, -0.0, 1.5, float("inf"), -1e300, "", "a" * 31,
    "a" * 32, "é" * 200, "x" * 70_000, b"", b"\x00" * 300, bytearray(b"ab"),
    b"z" * 70_000, list(range(15)), list(range(16)), list(range(70_000)),
    (1, 2), {"a": 1}, {str(i): i for i in range(16)},
    {b"k": [1, {"x": None}]}, [[1, [2, [3, []]]], {}],
]


@pytest.mark.parametrize("i", range(len(MSGPACK_VALUES)))
def test_msgpack_subset_is_byte_equal(i):
    msgpack = pytest.importorskip("msgpack")
    from hypergraphdb_tpu_torch.utils import msgpack_lite

    v = MSGPACK_VALUES[i]
    data = msgpack.packb(v, use_bin_type=True)
    assert msgpack_lite.packb(v) == data
    assert msgpack_lite.unpackb(data) == msgpack.unpackb(data, raw=False)


def test_list_and_dict_keys_and_payloads_equal_msgpack():
    msgpack = pytest.importorskip("msgpack")
    from hypergraphdb_tpu_torch.types.primitive import DictType, ListType

    values = [[1, "two", 3.0, None, True, b"b", [4]], (), ("a",) * 20]
    for v in values:
        assert ListType().to_key(v) == b"l" + msgpack.packb(
            list(v), use_bin_type=True)
        assert ListType().store(v) == msgpack.packb(list(v),
                                                    use_bin_type=True)
        assert ListType().make(ListType().store(v)) == list(v)
    maps = [{"z": 1, "a": [1, 2], "m": {"n": None}}, {},
            {str(i): float(i) for i in range(20)}]
    for m in maps:
        assert DictType().to_key(m) == b"m" + msgpack.packb(
            sorted(m.items()), use_bin_type=True)
        assert DictType().store(m) == msgpack.packb(m, use_bin_type=True)
        assert DictType().make(DictType().store(m)) == m


def test_msgpack_subset_refuses_what_msgpack_refuses():
    from hypergraphdb_tpu_torch.utils import msgpack_lite

    with pytest.raises(TypeError):
        msgpack_lite.packb(object())
    with pytest.raises(OverflowError):
        msgpack_lite.packb(2**64)
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(b"\x81\x01\x02")  # an int map key
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(b"\x92\x01")      # truncated
