"""Port value pushdown vs the reference: ``incident_value_pattern`` (each
op, exact and with rank ties) and ``incident_value_range`` (each
``(lo_op, hi_op)``) of ``hypergraphdb_tpu_torch.ops.setops`` against
``hypergraphdb_tpu.ops.setops`` on the scenarios of
``tests/test_value_pushdown.py``: int-valued links around 24 nodes, typed
and untyped, one and two anchors; strings sharing an 8-byte prefix (every
rank ties); the row pack ``vcols`` against the column gathers. The port
runs on the CPU. Tolerance: exact equality of candidate rows, definite and
tie masks, and counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypergraphdb_tpu import HyperGraph
from hypergraphdb_tpu.ops import setops as rs
from hypergraphdb_tpu.utils.ordered_bytes import rank64
from hypergraphdb_tpu_torch.ops import setops as ps
from tests.test_torch_snapshot import to_port

OPS = ("eq", "lt", "lte", "gt", "gte")
WINDOWS = (("gte", "lt"), ("gt", "lte"), ("gte", "lte"), ("gt", "lt"))


@pytest.fixture
def valued_db():
    """``tests/test_value_pushdown.py``'s graph: 24 nodes and 200 links
    with int values in [0, 50)."""
    g = HyperGraph()
    nodes = [int(g.add(f"n{i}")) for i in range(24)]
    rng = np.random.default_rng(5)
    for _ in range(200):
        a, b = rng.choice(24, size=2, replace=False)
        g.add_link((nodes[a], nodes[b]), value=int(rng.integers(0, 50)))
    yield g, nodes
    g.close()


@pytest.fixture
def string_db():
    """Links whose values share an 8-byte prefix, around one anchor, plus
    words of distinct ranks."""
    g = HyperGraph()
    a = int(g.add("anchor"))
    vals = ["prefix__a", "prefix__b", "prefix__c", "prefix__", "apple",
            "banana", "cherry", "damson", "elder", "fig"]
    for v in vals:
        g.add_link((a,), value=v)
    yield g, [a]
    g.close()


def key_of(g, value):
    key = g.typesystem.infer(value).to_key(value)
    return key[0], rank64(key[1:])


def both(g, anchor_rows):
    """``(reference snapshot, port snapshot, reference args, port args)``,
    the args being each side's leading ``(device snapshot, ELL, anchors,
    pad)``."""
    snap = g.snapshot()
    port = to_port(snap)
    anchors = np.asarray(anchor_rows, dtype=np.int32)
    off = snap.inc_offsets
    lens = off[anchors[:, 0] + 1] - off[anchors[:, 0]]
    pad = rs._bucket(int(lens.max()))
    ref = (snap.device, rs.ell_targets(snap), jnp.asarray(anchors), pad)
    got = (port.device("cpu"), ps.ell_targets(port, "cpu"),
           torch.from_numpy(anchors), pad)
    return snap, port, ref, got


def words(rank):
    return jnp.uint32(rank >> 32), jnp.uint32(rank & 0xFFFFFFFF)


def assert_same(ref_out, port_out):
    assert len(ref_out) == len(port_out)
    for a, b in zip(ref_out, port_out):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype
        assert np.array_equal(a, b.numpy())


def anchor_sets(nodes):
    single = [[n] for n in nodes[:6]]
    pairs = [[nodes[i], nodes[j]] for i, j in ((0, 1), (2, 5), (3, 7), (4, 9))]
    return {"single": single, "pairs": pairs}


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("op", OPS)
def test_int_value_pattern_matches_reference(valued_db, op, exact):
    g, nodes = valued_db
    kind, rank = key_of(g, 25)
    link_type = int(g.get_type_handle_of(
        int(g.get_incidence_set(nodes[0]).array()[0])))
    node_type = int(g.get_type_handle_of(nodes[0]))
    for rows in anchor_sets(nodes).values():
        snap, port, ref, got = both(g, rows)
        for th in (None, link_type, node_type):
            r = rs.incident_value_pattern(
                *ref, jnp.uint8(kind), *words(rank), op, exact,
                None if th is None else jnp.int32(th))
            t = ps.incident_value_pattern(*got, kind, rank, op, exact, th)
            assert_same(r, t)
            if exact:
                assert not t[2].any()
            if th == node_type:
                assert not t[1].any()


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("lo_op,hi_op", WINDOWS)
def test_int_value_range_matches_reference(valued_db, lo_op, hi_op, exact):
    g, nodes = valued_db
    kind, lo = key_of(g, 10)
    _, hi = key_of(g, 30)
    for rows in anchor_sets(nodes).values():
        snap, port, ref, got = both(g, rows)
        r = rs.incident_value_range(*ref, jnp.uint8(kind), *words(lo),
                                    *words(hi), lo_op, hi_op, exact, None)
        t = ps.incident_value_range(*got, kind, lo, hi, lo_op, hi_op, exact)
        assert_same(r, t)


def test_range_equals_two_single_probes(valued_db):
    g, nodes = valued_db
    kind, lo = key_of(g, 11)
    _, hi = key_of(g, 37)
    snap, port, ref, got = both(g, [[nodes[0]], [nodes[3]]])
    _, keep_lo, _ = ps.incident_value_pattern(*got, kind, lo, "gte", True)
    _, keep_hi, _ = ps.incident_value_pattern(*got, kind, hi, "lt", True)
    _, keep, tie, counts = ps.incident_value_range(*got, kind, lo, hi, "gte",
                                                   "lt", True)
    assert torch.equal(keep, keep_lo & keep_hi)
    assert torch.equal(counts, (keep_lo & keep_hi).sum(1, dtype=torch.int32))
    assert not tie.any()


@pytest.mark.parametrize("op", OPS)
def test_string_ties_go_to_the_tie_mask(string_db, op):
    g, anchors = string_db
    kind, rank = key_of(g, "prefix__b")
    snap, port, ref, got = both(g, [anchors])
    r = rs.incident_value_pattern(*ref, jnp.uint8(kind), *words(rank), op,
                                  False, None)
    t = ps.incident_value_pattern(*got, kind, rank, op, False)
    assert_same(r, t)
    rows, definite, tie = (x.numpy()[0] for x in t)
    vals = {int(h): g.get(int(h)).value for h in rows[definite | tie]}
    prefixed = {h for h, v in vals.items() if v.startswith("prefix__")}
    # every rank-tied link sits in the tie mask and never in the definite
    assert set(rows[tie].tolist()) == prefixed
    assert not prefixed & set(rows[definite].tolist())


@pytest.mark.parametrize("lo_op,hi_op", WINDOWS)
def test_string_range_ties_match_reference(string_db, lo_op, hi_op):
    g, anchors = string_db
    kind, lo = key_of(g, "banana")
    _, hi = key_of(g, "prefix__c")
    snap, port, ref, got = both(g, [anchors])
    r = rs.incident_value_range(*ref, jnp.uint8(kind), *words(lo),
                                *words(hi), lo_op, hi_op, False, None)
    t = ps.incident_value_range(*got, kind, lo, hi, lo_op, hi_op, False)
    assert_same(r, t)
    rows, keep, tie, _ = (x.numpy() for x in t)
    tied = {int(h) for h in rows[0][tie[0]]}
    assert tied and not tied & set(rows[0][keep[0]].tolist())


@pytest.mark.parametrize("exact", [True, False])
def test_row_pack_matches_column_gathers(valued_db, exact):
    g, nodes = valued_db
    kind, lo = key_of(g, 11)
    _, hi = key_of(g, 37)
    snap, port, ref, got = both(g, [[nodes[0]], [nodes[4]], [nodes[7]]])
    vcols = ps.value_columns(port, "cpu")
    plain = ps.incident_value_range(*got, kind, lo, hi, "gte", "lt", exact)
    packed = ps.incident_value_range(*got, kind, lo, hi, "gte", "lt", exact,
                                     None, vcols)
    r = rs.incident_value_range(*ref, jnp.uint8(kind), *words(lo),
                                *words(hi), "gte", "lt", exact, None,
                                rs.value_columns(snap))
    assert_same(r, packed)
    for a, b in zip(plain, packed):
        assert torch.equal(a, b)
    for op in OPS:
        a = ps.incident_value_pattern(*got, kind, lo, op, exact)
        b = ps.incident_value_pattern(*got, kind, lo, op, exact, None, vcols)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_cross_kind_candidates_never_match(valued_db):
    g, nodes = valued_db
    kind, rank = key_of(g, "n3")   # the links carry ints, not strings
    snap, port, ref, got = both(g, [[nodes[0]]])
    for op in OPS:
        _, definite, tie = ps.incident_value_pattern(*got, kind, rank, op,
                                                     False)
        assert not definite.any() and not tie.any()


def test_bad_ops_and_ranks_raise(valued_db):
    g, nodes = valued_db
    snap, port, ref, got = both(g, [[nodes[0]]])
    with pytest.raises(ValueError, match="value op"):
        ps.incident_value_pattern(*got, ord("i"), 3, "ne", True)
    with pytest.raises(ValueError, match="window ops"):
        ps.incident_value_range(*got, ord("i"), 3, 9, "lt", "lt", True)
    with pytest.raises(ValueError, match="64-bit"):
        ps.incident_value_pattern(*got, ord("i"), -1, "eq", True)
