"""Port join executor vs the reference: ``hypergraphdb_tpu_torch.ops.join``
against ``hypergraphdb_tpu.ops.join`` on the same snapshots, and both
against the reference's exact host enumerator ``join.host_join``.

Graphs come from ``make_random_hypergraph`` (80 nodes, 160 links, arity up
to 4, seeds 0–2, as ``tests/test_join.py``), snapshots are carried over
with ``to_port`` and patterns with ``pattern_from_reference``. The port
runs on the CPU. Tolerance: exact equality everywhere (integers) — the
co-incidence CSR and factorized encodings array for array; counts, trunc
flags, ``top_r`` tuples and the full binding tables (rows, lanes, valid
flags, padding included) of every execution.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hypergraphdb_tpu import join
from hypergraphdb_tpu.ops import join as rj
from hypergraphdb_tpu.query import conditions as c
from hypergraphdb_tpu.query.variables import var
from hypergraphdb_tpu_torch.join import (
    JoinUnsupported,
    pattern_from_reference,
    plan_join,
    split_constants,
)
from hypergraphdb_tpu_torch.ops import join as pj
from tests.conftest import make_random_hypergraph
from tests.test_torch_snapshot import to_port

SHAPES = {
    "triangle": lambda a: {
        "y": c.And(c.CoIncident(a), c.CoIncident(var("z"))),
        "z": c.CoIncident(a),
    },
    "path2": lambda a: {
        "y": c.CoIncident(a),
        "z": c.CoIncident(var("y")),
    },
    "star3": lambda a: {
        "y": c.CoIncident(a),
        "z": c.CoIncident(a),
        "w": c.CoIncident(a),
    },
    "link_var": lambda a: {
        "l": c.Incident(a),
        "y": c.Target(var("l")),
    },
}


STAR_OF_STARS = lambda a, b: {  # noqa: E731
    "y": c.CoIncident(a), "z": c.CoIncident(var("y")),
    "u": c.CoIncident(b), "w": c.CoIncident(var("u")),
}


def _build(g, seed=0, n_nodes=80, n_links=160):
    nodes, _ = make_random_hypergraph(
        g, n_nodes=n_nodes, n_links=n_links, max_arity=4, seed=seed)
    return [int(n) for n in nodes]


def _build_hub(g, seed=30, hub_links=70):
    """A random graph plus a hub node sharing a link with most others."""
    nodes = _build(g, seed=seed)
    hub = nodes[0]
    for i in range(hub_links):
        g.add_link([hub, nodes[1 + i % (len(nodes) - 1)]], value=f"hub-{i}")
    return hub, nodes


def _plans(g, spec_or_pattern, **plan_kw):
    """(reference snapshot, port snapshot, reference pattern, both plans)
    with equal ``describe()``."""
    p = (spec_or_pattern if isinstance(spec_or_pattern, join.ConjunctivePattern)
         else join.extract_pattern(g, spec_or_pattern))
    snap = g.snapshot()
    port = to_port(snap)
    q = pattern_from_reference(p)
    rplan = join.plan_join(snap, p, *join.split_constants(p), **plan_kw)
    pplan = plan_join(port, q, *split_constants(q), **plan_kw)
    assert pplan.describe() == rplan.describe()
    return snap, port, p, rplan, pplan


def _same(r, t):
    """Every field of two executions equal (the port's on the CPU)."""
    assert np.array_equal(np.asarray(r.counts), t.counts.numpy())
    assert np.array_equal(np.asarray(r.trunc), t.trunc.numpy())
    assert r.hub_lanes == t.hub_lanes
    assert r.order == t.order
    for f in ("tuples", "cols", "lanes", "valid"):
        a, b = getattr(r, f), getattr(t, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.asarray(a).dtype == b.numpy().dtype, f
            assert np.array_equal(np.asarray(a), b.numpy()), f


def _run_both(snap, port, rplan, pplan, consts, **kw):
    consts = np.asarray(consts, dtype=np.int32)
    r = rj.execute_join(snap, rplan, consts, **kw)
    t = pj.execute_join(port, pplan, consts, device="cpu", **kw)
    _same(r, t)
    return r, t


def _rows(ex, plan, p, lane):
    perm = [plan.order.index(v) for v in p.vars]
    return sorted(tuple(int(x) for x in row[perm])
                  for row in ex.full_bindings(lane))


def _consts(p, anchors):
    """One constant row per anchor: the pattern's constants with the
    first anchor replaced (every shape here repeats one anchor)."""
    sig, c0 = join.split_constants(p)
    return np.asarray([[a] * sig.n_consts for a in anchors], np.int32)


# ---------------------------------------------------------------- relations


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_relations_match_reference(graph, seed):
    _build(graph, seed=seed)
    snap = graph.snapshot()
    port = to_port(snap)
    for a, b in zip(rj.neighbor_csr(snap), pj.neighbor_csr(port, "cpu")):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    off_d, flat_d = pj.neighbor_csr_device(port, "cpu")
    assert np.array_equal(off_d.numpy(), rj.neighbor_csr(snap)[0])
    assert np.array_equal(flat_d.numpy(), rj.neighbor_csr(snap)[1])
    for a, b in zip(rj._closed_co_csr(snap), pj._closed_co_csr(port, "cpu")):
        assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy())
    ref, got = rj.factorized_relations(snap), pj.factorized_relations(
        port, "cpu")
    dev = pj.factorized_relations_device(port, "cpu")
    for rel in ("co", "tgt"):
        for f in ("group_of", "offsets", "flat"):
            a, b = getattr(ref[rel], f), getattr(got[rel], f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (rel, f)
        for f in ("n_groups", "entries", "entries_flat", "closed",
                  "max_width"):
            assert getattr(ref[rel], f) == getattr(got[rel], f), (rel, f)
        for a, b in zip(dev[rel], (got[rel].group_of, got[rel].offsets,
                                   got[rel].flat)):
            assert np.array_equal(a.numpy(), b)


def test_relations_of_empty_and_duplicate_target_links(graph):
    a, b, d = (int(graph.add_node(x)) for x in "abd")
    graph.add_link([a, b, a], value="dup")
    graph.add_link([d], value="unary")
    snap = graph.snapshot()
    port = to_port(snap)
    for x, y in zip(rj.neighbor_csr(snap), pj.neighbor_csr(port, "cpu")):
        assert np.array_equal(x, y)
    for rel in ("co", "tgt"):
        for f in ("group_of", "offsets", "flat"):
            assert np.array_equal(
                getattr(rj.factorized_relations(snap)[rel], f),
                getattr(pj.factorized_relations(port, "cpu")[rel], f))


def test_second_device_gets_the_host_copy_and_caches_release(graph):
    _build(graph, seed=1)
    port = to_port(graph.snapshot())
    off, flat = pj.neighbor_csr(port, "cpu")
    twin = pj.neighbor_csr_device(port, "cpu")
    assert pj.neighbor_csr_device(port, "cpu") is twin
    pj.factorized_relations(port, "cpu")
    pj.release_join_caches(port)
    for name in ("_nbr_csr", "_nbr_csr_dev", "_fact_rels", "_fact_rels_dev"):
        assert not hasattr(port, name)
    again = pj.neighbor_csr(port, "cpu")
    assert np.array_equal(again[0], off) and np.array_equal(again[1], flat)


# ---------------------------------------------------------------- shapes


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shapes_match_reference_and_host(graph, shape, seed):
    nodes = _build(graph, seed=seed)
    anchors = [nodes[3 + seed], nodes[10 + seed]]
    snap, port, p, rplan, pplan = _plans(graph, SHAPES[shape](anchors[0]))
    r, t = _run_both(snap, port, rplan, pplan, _consts(p, anchors),
                     top_r=16, full=True, var_pad_max=True)
    for lane, a in enumerate(anchors):
        truth = join.host_join(
            graph, join.extract_pattern(graph, SHAPES[shape](a)))
        assert not bool(t.trunc[lane])
        assert int(t.counts[lane]) == len(truth)
        assert _rows(t, pplan, p, lane) == truth
        assert _rows(r, rplan, p, lane) == truth
        perm = [pplan.order.index(v) for v in p.vars]
        head = [tuple(int(x) for x in row[perm])
                for row in t.tuples[lane].numpy() if row[0] >= 0]
        assert head == truth[:16]


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_truncation_matches_reference(graph, shape):
    nodes = _build(graph, seed=8)
    a = nodes[2]
    snap, port, p, rplan, pplan = _plans(graph, SHAPES[shape](a))
    truth = set(join.host_join(graph, p))
    _, t = _run_both(snap, port, rplan, pplan, _consts(p, [a]), top_r=4,
                     full=True, row_cap=16, pad_cap=8)
    assert int(t.counts[0]) <= len(truth)
    assert set(_rows(t, pplan, p, 0)) <= truth
    if len(truth) > 16:
        assert bool(t.trunc[0])


def test_typed_and_duplicate_target_patterns(graph):
    nodes = _build(graph, seed=4)
    a = nodes[2]
    th = int(graph.get_type_handle_of(
        graph.add_link([a, nodes[9]], value="typed-probe")))
    dup = int(graph.add_link([a, nodes[5], a], value="dup"))
    specs = [
        {"y": c.And(c.CoIncident(a), c.AtomType(th))},
        {"y": c.CoIncident(a), "z": c.And(c.CoIncident(var("y")),
                                          c.AtomType(th))},
        {"y": c.Target(dup)},
        {"l": c.Incident(a), "y": c.Target(var("l"))},
    ]
    for spec in specs:
        snap, port, p, rplan, pplan = _plans(graph, spec)
        _, t = _run_both(snap, port, rplan, pplan,
                         [join.split_constants(p)[1]], top_r=8, full=True,
                         var_pad_max=True)
        assert _rows(t, pplan, p, 0) == join.host_join(graph, p)


# ------------------------------------------------------------ value windows


def _rank_of(g, value):
    """``(kind byte, 64-bit rank)`` of a value's key in the graph."""
    from hypergraphdb_tpu.utils.ordered_bytes import rank64

    key = g.typesystem.infer(value).to_key(value)
    return key[0], rank64(key[1:])


def test_value_window_filters_candidates(graph):
    """``tests/test_value_index.py``'s join scenario: a co-incidence
    variable windowed to ints in [103, 108), lo only and hi only: full
    binding tables equal to the reference's, counts to the host's."""
    from hypergraphdb_tpu.join.planner import try_single_var_join

    vn = [int(graph.add(100 + i)) for i in range(12)]
    anchor = vn[0]
    for i in range(1, 12):
        graph.add_link([anchor, vn[i]], value=f"l{i}")
    cond = c.And(c.CoIncident(anchor), c.AtomValue(103, "gte"),
                 c.AtomValue(108, "lt"))
    plan_obj = try_single_var_join(
        graph, [c.CoIncident(anchor)], fallback=None,
        value_conds=[c.AtomValue(103, "gte"), c.AtomValue(108, "lt")])
    snap, port, p, rplan, pplan = _plans(graph, plan_obj.pattern)
    kind, lo = _rank_of(graph, 103)
    _, hi = _rank_of(graph, 108)
    var0 = pplan.order[0]
    consts = [plan_obj.consts]
    cases = {
        "both": ((kind, lo, "gte", hi, "lt"), 5),
        "lo": ((kind, lo, "gte", None, None), 9),
        "hi": ((kind, None, None, hi, "lt"), 7),
        "lo_gt_hi_lte": ((kind, lo, "gt", hi, "lte"), 5),
        "other_kind": ((ord("s"), lo, "gte", None, None), 0),
    }
    assert len(sorted(int(h) for h in graph.find_all(cond))) == 5
    for name, (win, want) in cases.items():
        _, t = _run_both(snap, port, rplan, pplan, consts, top_r=16,
                         full=True, value_windows={var0: win})
        assert int(t.counts[0]) == want, name
        assert not bool(t.trunc[0])
    _, t = _run_both(snap, port, rplan, pplan, consts, top_r=16, full=True)
    assert int(t.counts[0]) == 11


WINDOW_MODES = {
    "tail": dict(var_pad_max=True),
    "split": dict(hub_threshold=8, var_pad_max=True),
    "unsplit": dict(hub_split=False, pad_cap=40),
    "fact_split": dict(factorized=True, hub_threshold=8, pad_cap=40),
}


@pytest.mark.parametrize("mode", sorted(WINDOW_MODES))
@pytest.mark.parametrize("shape", ["link_var", "path2", "triangle"])
def test_value_windows_match_reference_by_mode(graph, shape, mode):
    """Windows on the first and the last bound variable, through the tail
    chain, the degree split (hub chain, row-split steps), the flat padded
    executor and the factorized relations; link ids carry int values,
    nodes strings. Full binding tables equal to the reference's."""
    hub, nodes = _build_hub(graph)
    anchors = [hub] + nodes[3:9]
    snap, port, p, rplan, pplan = _plans(graph, SHAPES[shape](hub))
    first, last = pplan.order[0], pplan.order[-1]
    s_kind, s_lo = _rank_of(graph, "n20")
    _, s_hi = _rank_of(graph, "n60")
    i_kind, i_lo = _rank_of(graph, 40)
    _, i_hi = _rank_of(graph, 120)
    win = {v: ((i_kind, i_lo, "gte", i_hi, "lt") if v == "l"
               else (s_kind, s_lo, "gt", s_hi, "lte"))
           for v in (first, last)}
    kw = dict(WINDOW_MODES[mode], top_r=16, full=True, row_cap=1 << 16)
    _, t = _run_both(snap, port, rplan, pplan, _consts(p, anchors),
                     value_windows=win, **kw)
    _, t0 = _run_both(snap, port, rplan, pplan, _consts(p, anchors), **kw)
    assert (t.counts <= t0.counts).all()
    assert int(t.counts.sum()) < int(t0.counts.sum())


def test_value_windows_on_a_bushy_plan(graph):
    nodes = _build(graph, seed=5)
    a, b = nodes[4], nodes[11]
    p = join.extract_pattern(graph, STAR_OF_STARS(a, b))
    snap, port, p, rplan, pplan = _plans(graph, p, bushy=True)
    assert pplan.describe().startswith("bushy[")
    kind, lo = _rank_of(graph, "n30")
    win = {"z": (kind, lo, "gte", None, None),
           "u": (kind, None, None, lo, "lt")}
    consts = [join.split_constants(p)[1]]
    _, t = _run_both(snap, port, rplan, pplan, consts, top_r=8, full=True,
                     var_pad_max=True, value_windows=win)
    _, t0 = _run_both(snap, port, rplan, pplan, consts, top_r=8, full=True,
                      var_pad_max=True)
    assert int(t.counts[0]) < int(t0.counts[0])


# ---------------------------------------------------------------- declines


def test_pair_budget_raises_join_unsupported(graph, monkeypatch):
    nodes = _build(graph, seed=21)
    port = to_port(graph.snapshot())
    pairs = pj.nbr_pair_count(port)
    assert pairs == rj.nbr_pair_count(graph.snapshot())
    monkeypatch.setenv("HG_JOIN_MAX_NBR_PAIRS", str(pairs - 1))
    assert pj.nbr_max_pairs() == pairs - 1
    with pytest.raises(JoinUnsupported, match="HG_JOIN_MAX_NBR_PAIRS"):
        pj.neighbor_csr(port, "cpu")
    with pytest.raises(JoinUnsupported):
        pj.factorized_relations(port, "cpu")
    q = pattern_from_reference(
        join.extract_pattern(graph, SHAPES["path2"](nodes[3])))
    with pytest.raises(JoinUnsupported):
        plan = plan_join(port, q)
        pj.execute_join(port, plan, np.asarray([[nodes[3]]], np.int32),
                        device="cpu")
    monkeypatch.setenv("HG_JOIN_MAX_NBR_PAIRS", str(pairs))
    assert len(pj.neighbor_csr(port, "cpu")[0]) == port.num_atoms + 2
    monkeypatch.setenv("HG_JOIN_MAX_NBR_PAIRS", str(1 << 40))
    assert pj.nbr_max_pairs() == pj.NBR_PAIRS_CEILING
    monkeypatch.delenv("HG_JOIN_MAX_NBR_PAIRS")
    assert pj.nbr_max_pairs() == pj.NBR_MAX_PAIRS == 1 << 28


def test_value_windows_and_bad_constants_raise(graph):
    nodes = _build(graph, seed=2)
    snap, port, p, rplan, pplan = _plans(graph, SHAPES["path2"](nodes[3]))
    cv = _consts(p, [nodes[3]])
    kind, lo = _rank_of(graph, "n10")
    for win in ({"y": (kind, lo, "gte", None, None)}, {}):
        _run_both(snap, port, rplan, pplan, cv, top_r=16, full=True,
                  var_pad_max=True, value_windows=win)
    for bad in ((256, 0, "gte", None, None), (kind, 0, "lt", None, None),
                (kind, None, None, 5, "gte")):
        with pytest.raises(ValueError, match="value window"):
            pj.execute_join(port, pplan, cv, device="cpu",
                            value_windows={"y": bad})
    for bad in (-1, port.num_atoms + 1):
        with pytest.raises(ValueError, match="atom ids"):
            pj.execute_join(port, pplan, np.asarray([[bad]], np.int32),
                            device="cpu")
    with pytest.raises(ValueError, match="seeds"):
        pj.execute_join(port, pplan, np.zeros((2, 0), np.int32),
                        seeds=np.arange(3), device="cpu")


def test_execute_join_raises_without_cuda(graph, monkeypatch):
    nodes = _build(graph, seed=2)
    snap, port, p, rplan, pplan = _plans(graph, SHAPES["path2"](nodes[3]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pj.execute_join(port, pplan, _consts(p, [nodes[3]]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pj.neighbor_csr(port)


# ---------------------------------------------------------------- compaction


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("density", [0.0, 0.05, 0.5, 1.0])
def test_survivors_first_is_the_stable_argsort(seed, density):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 5000))
    mask = rng.random(n) < density
    want = np.argsort(~mask, kind="stable")
    order = pj.survivors_first(torch.from_numpy(mask)).numpy()
    assert np.array_equal(order, want)
    n_true = int(mask.sum())
    for keep in sorted({0, max(n_true - 1, 0), n_true // 2, n_true, n}):
        assert np.array_equal(order[:keep], want[:keep])


def test_survivors_first_of_an_empty_mask():
    assert len(pj.survivors_first(torch.zeros(0, dtype=torch.bool))) == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_bucket_spills_flag_the_reference_drops(seed):
    """A lane loses survivors to a full bucket exactly when the
    reference's per-slot drop count into that lane is positive: from row
    prefix sums (row-major compactions) and from survivors against kept
    rows (any order)."""
    rng = np.random.default_rng(seed)
    n_lanes, R, pad = 6, 50, 8
    cmask = rng.random((R, pad)) < 0.4
    lanes = rng.integers(0, n_lanes + 1, size=R).astype(np.int32)
    cmask[lanes == n_lanes] = False
    mask = cmask.reshape(-1)
    row_lanes = np.repeat(lanes, pad)
    survivors = np.bincount(lanes, weights=cmask.sum(1),
                            minlength=n_lanes + 1)[:n_lanes].astype(np.int32)
    order = np.argsort(~mask, kind="stable")
    for rows_out in (0, 17, int(mask.sum()) - 1, int(mask.sum()), R * pad):
        kept, dropped = order[:rows_out], order[rows_out:]
        want = np.bincount(row_lanes[dropped][mask[dropped]],
                           minlength=n_lanes + 1)[:n_lanes] > 0
        spilled = pj._spilled_rows(torch.from_numpy(cmask.sum(1)), rows_out)
        got = pj._lane_add(n_lanes, torch.from_numpy(lanes), spilled) > 0
        assert np.array_equal(got.numpy(), want)
        got = pj._lost_lanes(n_lanes, torch.from_numpy(survivors),
                             torch.from_numpy(row_lanes[kept]),
                             torch.from_numpy(mask[kept]))
        assert np.array_equal(got.numpy(), want)
