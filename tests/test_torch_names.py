"""The public names the port gained to match the reference's surface
(``tests/test_torch_surface.py`` holds it to them), each called on both
packages with the same inputs: the results must be equal. Randomized
cases run under hypothesis against a dict-and-sort oracle.

Tolerance: exact equality."""

from __future__ import annotations

import importlib
import struct
import uuid

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from conftest import make_random_hypergraph

PKGS = ("hypergraphdb_tpu", "hypergraphdb_tpu_torch")


def both(mod: str):
    return [importlib.import_module(f"{p}.{mod}") for p in PKGS]


# ------------------------------------------------------------------ ops


def test_ops_reexports_the_reference_names():
    ref, port = both("ops")
    missing = set(ref.__all__) - set(port.__all__)
    assert missing == {"pallas_bfs_ok"}  # the port's K2 is never gated
    from hypergraphdb_tpu_torch.ops import fused_bfs, incremental, snapshot

    assert port.bfs_pull_fused is fused_bfs.bfs_pull_fused
    assert port.SnapshotManager is incremental.SnapshotManager
    assert port.CSRSnapshot is snapshot.CSRSnapshot
    for name in port.__all__:
        assert getattr(port, name) is not None, name


@pytest.mark.parametrize("hops", [1, 2, 3])
def test_bfs_reachable_host_matches_the_traversal_and_reference(hops):
    """The oracle of ``tests/test_device.py``: draining
    ``HGBreadthFirstTraversal`` from each seed, on both packages' graphs."""
    import hypergraphdb_tpu as hg
    from hypergraphdb_tpu.ops import frontier as ref_frontier
    from hypergraphdb_tpu_torch.algorithms.traversals import (
        HGBreadthFirstTraversal,
    )
    from hypergraphdb_tpu_torch.core.graph import HyperGraph
    from hypergraphdb_tpu_torch.ops import frontier

    rg, pg = hg.HyperGraph(), HyperGraph()
    try:
        nodes, _ = make_random_hypergraph(pg, n_nodes=150, n_links=400,
                                          max_arity=4, seed=3)
        make_random_hypergraph(rg, n_nodes=150, n_links=400, max_arity=4,
                               seed=3)
        seeds = np.asarray(nodes[:32], dtype=np.int32)
        got = frontier.bfs_reachable_host(pg.snapshot(), seeds, hops,
                                          device="cpu")
        want = ref_frontier.bfs_reachable_host(rg.snapshot(), seeds, hops)
        for s, a, b in zip(seeds.tolist(), got, want):
            host = sorted(x for _, x in HGBreadthFirstTraversal(
                pg, s, max_distance=hops))
            assert a.dtype == np.int64
            assert a.tolist() == host == b.tolist(), s
    finally:
        rg.close()
        pg.close()


def test_constants_equal_the_reference():
    (rs, ps), (rj, pj) = both("ops.snapshot"), both("ops.join")
    assert ps.PAD.dtype == np.int32 and ps.PAD == rs.PAD == -1
    assert pj.EXEMPLAR_SLOTS == rj.EXEMPLAR_SLOTS == 64


def test_probe_bytes_is_the_reference_figure():
    """The port's probe cost is the constant the reference reads from its
    committed budgets, so both price a join plan alike."""
    ref, port = both("join.planner")
    assert port.probe_bytes() == port.PROBE_BYTES == ref.probe_bytes()


def test_mesh_carrier_is_built_once_per_mesh():
    from hypergraphdb_tpu_torch.ops import sharded_serving as ss
    from hypergraphdb_tpu_torch.parallel import make_mesh

    a = ss.mesh_carrier(make_mesh(["cpu"] * 4))
    assert ss.mesh_carrier(make_mesh(["cpu"] * 4)) is a  # a new Mesh object
    b = ss.mesh_carrier(make_mesh(["cpu"] * 2))
    assert b is not a and b.mesh.n_dev == 2
    assert (a.n_loc, a.num_atoms, a.edge_chunk) == (128, 4 * 128 - 1, 8)
    assert all(t.numel() == 0 for t in a.inc_src + a.tgt_dst)


def test_mesh_carrier_serves_the_pattern_lane():
    """The sharded pattern lane reads only the carrier's mesh: its answer
    equals the single-device lane's on the same anchors."""
    from hypergraphdb_tpu_torch import verify
    from hypergraphdb_tpu_torch.ops import serving
    from hypergraphdb_tpu_torch.ops.setops import ell_targets
    from hypergraphdb_tpu_torch.ops.sharded_serving import (
        pattern_serve_batch_sharded,
    )

    sdev, rows0, types0, tgt, anchors, type_vec = \
        verify.pattern_sharded_args("cpu")
    counts, first = pattern_serve_batch_sharded(sdev, rows0, types0, tgt,
                                                anchors, type_vec, 4)
    snap = verify.sharded_host_exemplar()
    c1, f1 = serving.pattern_serve_batch(
        snap.device("cpu"), ell_targets(snap, "cpu"),
        torch.from_numpy(anchors), torch.from_numpy(type_vec),
        rows0.shape[1], 4)
    assert torch.equal(counts, c1.to(torch.int64)) and torch.equal(first, f1)


# ------------------------------------------------------------------ core


def test_storage_error_and_events():
    (re_, pe), (rev, pev) = both("core.errors"), both("core.events")
    for errors in (re_, pe):
        assert issubclass(errors.StorageError, errors.HGException)
        assert str(errors.StorageError("disk")) == "disk"
    for ev in (rev, pev):
        assert issubclass(ev.HGAtomAccessedEvent, ev.HGAtomEvent)
    assert (vars(rev.HGAtomAccessedEvent(5, "a"))
            == vars(pev.HGAtomAccessedEvent(5, "a")))
    assert (vars(rev.HGTransactionStartedEvent())
            == vars(pev.HGTransactionStartedEvent()) == {"tx": None})
    assert (vars(rev.HGTransactionEndedEvent(tx=7, success=False))
            == vars(pev.HGTransactionEndedEvent(tx=7, success=False)))
    assert pev.HGTransactionEndedEvent().success is True


def test_event_manager_clear():
    out = []
    for ev in both("core.events"):
        seen = []
        m = ev.HGEventManager()
        m.add_listener(ev.HGAtomEvent, lambda g, e: seen.append(e.handle))
        m.dispatch(None, ev.HGAtomAccessedEvent(1))
        m.clear()
        code = m.dispatch(None, ev.HGAtomAccessedEvent(2))
        out.append((seen, code, m.has_listeners_for(ev.HGAtomEvent)
                    if hasattr(m, "has_listeners_for") else False))
    assert out[0] == out[1] == ([1], 0, False)


@pytest.mark.parametrize("h", [None, -1, -7, 0, 5])
def test_is_null(h):
    ref, port = both("core.handles")
    assert port.is_null(h) == ref.is_null(h) == (h is None or h < 0)


@settings(max_examples=50, deadline=None)
@given(st.lists(st.integers(-(2**63), 2**63 - 1), max_size=12))
def test_pack_handles_roundtrip(hs):
    ref, port = both("core.handles")
    data = port.pack_handles(hs)
    assert data == ref.pack_handles(hs) == struct.pack(f"<{len(hs)}q", *hs)
    assert port.unpack_handles(data) == ref.unpack_handles(data) == tuple(hs)


def test_uuid_factory_handle_of_and_bind():
    out = []
    for handles in both("core.handles"):
        f = handles.UUIDHandleFactory()
        h = f.make()
        u = f.uuid_of(h)
        foreign = uuid.UUID(int=12345)
        f.bind(40, foreign)
        out.append((f.handle_of(u) == h, f.handle_of(foreign),
                    f.uuid_of(40) == foreign,
                    f.handle_of(uuid.UUID(int=1))))
    assert out[0] == out[1] == (True, 40, True, None)


# ------------------------------------------------------------------ types


def test_int_type_subsumes_compares_as_integers():
    """``IntType().subsumes("7", 7)``: the reference compares integers; the
    port's type fell back to the base class's ``==``, which says False."""
    (rp, pp), (_, ps) = both("types.primitive"), both("types.system")
    assert pp.IntType().subsumes("7", 7) is True
    assert rp.IntType().subsumes("7", 7) is True
    assert ps.HGAtomType.subsumes(pp.IntType(), "7", 7) is False
    for g, s in (("7", 8), (3, 3), ("-2", -2)):
        assert pp.IntType().subsumes(g, s) == rp.IntType().subsumes(g, s)


def test_top_type_handles_no_value():
    ref, port = both("types.system")
    for v in ("int", 3, None):
        assert port.TopType().handles_value(v) is False
        assert ref.TopType().handles_value(v) is False


# --------------------------------------------------------------- tx


def test_transaction_manager_version_and_cell_changes():
    import hypergraphdb_tpu as hg
    from hypergraphdb_tpu_torch.core.graph import HyperGraph

    out = []
    for g in (hg.HyperGraph(), HyperGraph()):
        try:
            tm = g.txman
            v0 = tm.version
            a = g.add("a")
            v1 = tm.version
            b = g.add("b")
            g.add_link((a, b))
            out.append((v0, v1, tm.version,
                        tm.cell_changed_since(("inc", a), v1),
                        tm.cell_changed_since(("inc", a), tm.version),
                        tm.cell_changed_since(("data", b), v0),
                        tm.cell_changed_since(("data", a), v1)))
        finally:
            g.close()
    assert out[0] == out[1]
    assert out[1][1] > out[1][0] and out[1][3] and not out[1][4]


# ----------------------------------------------------------- utils


def test_encode_str_matches_and_orders():
    ref, port = both("utils.ordered_bytes")
    words = ["", "a", "ab", "b", "Z", "é", "日本", "\U0001f600", "a\x00"]
    for w in words:
        assert port.encode_str(w) == ref.encode_str(w) == w.encode("utf-8")
        assert port.decode_str(port.encode_str(w)) == w
    by_bytes = sorted(words, key=port.encode_str)
    assert by_bytes == sorted(words)  # byte order is code point order


@settings(max_examples=100, deadline=None)
@given(st.lists(st.text(max_size=6), max_size=10))
def test_encode_str_order_property(words):
    _, port = both("utils.ordered_bytes")
    assert sorted(words, key=port.encode_str) == sorted(words)


@settings(max_examples=100, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(["add", "discard"]),
                          st.integers(0, 20)), max_size=40))
def test_sorted_list_discard_against_an_oracle(ops):
    lists = [m.SortedList() for m in both("utils.sortedshim")]
    oracle: list = []
    for op, v in ops:
        for sl in lists:
            getattr(sl, op)(v)
        if op == "add":
            oracle.append(v)
        elif v in oracle:
            oracle.remove(v)
    for sl in lists:
        assert list(sl) == sorted(oracle)


@settings(max_examples=100, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(["set", "del", "setdefault"]),
                          st.integers(0, 15), st.integers()), max_size=40))
def test_sorted_dict_views_against_an_oracle(ops):
    dicts = [m.SortedDict() for m in both("utils.sortedshim")]
    oracle: dict = {}
    for op, k, v in ops:
        for d in dicts:
            if op == "set":
                d[k] = v
            elif op == "del":
                d.pop(k, None)
            else:
                assert d.setdefault(k, v) == oracle.get(k, v)
        if op == "set":
            oracle[k] = v
        elif op == "del":
            oracle.pop(k, None)
        else:
            oracle.setdefault(k, v)
    want = sorted(oracle.items())
    for d in dicts:
        assert list(d.keys()) == [k for k, _ in want]
        assert list(d.values()) == [v for _, v in want]
        assert list(d.items()) == want


def test_metrics_snapshot_and_reset():
    out = []
    for m in both("utils.metrics"):
        met = m.Metrics()
        met.incr("q.count", 3)
        met.gauge("q.depth", 2.5)
        met.observe("q.time", 0.25)
        met.observe("q.time", 0.75)
        snap = met.snapshot()
        met.reset()
        out.append((snap, met.snapshot()))
    assert out[0] == out[1]
    snap, after = out[1]
    assert snap["timings"]["q.time"] == {"count": 2, "total_s": 1.0,
                                         "mean_s": 0.5, "max_s": 0.75}
    assert after["counters"] == {"q.count": 0}


# ------------------------------------------------ parameters (the guard)

_bound = st.one_of(st.none(), st.integers(-2, 22))


@settings(max_examples=150, deadline=None)
@given(st.sets(st.integers(0, 20), max_size=15), _bound, _bound,
       st.tuples(st.booleans(), st.booleans()), st.booleans())
def test_sorted_dict_irange_reverse_against_the_reference(keys, lo, hi,
                                                          inclusive,
                                                          reverse):
    """``irange(..., reverse=)`` gives the reference's keys in the
    reference's order, and the forward keys reversed, over drawn keys and
    bounds."""
    dicts = [m.SortedDict() for m in both("utils.sortedshim")]
    for d in dicts:
        for k in keys:
            d[k] = -k
    got = [list(d.irange(lo, hi, inclusive, reverse=reverse))
           for d in dicts]
    assert got[1] == got[0]
    forward = list(dicts[1].irange(lo, hi, inclusive))
    assert got[1] == (forward[::-1] if reverse else forward)
    assert forward == sorted(
        k for k in keys
        if (lo is None or (k >= lo if inclusive[0] else k > lo))
        and (hi is None or (k <= hi if inclusive[1] else k < hi)))


@pytest.mark.parametrize("cls", [int, float, str, bool, bytes])
def test_type_handle_of_a_class_is_its_name_handle(cls):
    """``type_handle(<class>)`` resolves the class through the typesystem's
    inference (its default instance), as ``type_handle(<name>)`` does the
    name: the same handle in both packages."""
    got = []
    for g in (m.HyperGraph() for m in both("core.graph")):
        t = g.typesystem.infer(cls())
        got.append((g.type_handle(cls), g.type_handle(t.name), t.name))
        g.close()
    assert got[1] == got[0]
    assert got[1][0] == got[1][1]


def test_native_build_force_rebuilds_the_existing_library():
    """``native.build(force=True)`` compiles again over an existing build
    (the default returns it untouched), and the rebuilt library loads."""
    import ctypes

    from hypergraphdb_tpu_torch import native

    path = native.build()
    mtime = path.stat().st_mtime_ns
    assert native.build() == path and path.stat().st_mtime_ns == mtime
    native.last_build_seconds = 0.0
    assert native.build(force=True) == path
    assert native.last_build_seconds > 0.0
    assert path.stat().st_mtime_ns >= mtime
    ctypes.CDLL(str(path))
