"""Port join IR and planner vs the reference: ``hypergraphdb_tpu_torch.join``
against ``hypergraphdb_tpu.join`` on the same snapshots and patterns.

Patterns come from the reference's ``extract_pattern`` and are carried over
with ``pattern_from_reference``; snapshots with ``to_port``. Tolerance:
exact equality — signatures, elimination orders, every step's expansion,
filters, type and dedupe flags, width estimates (floats from the same
integer arithmetic), ``describe()`` strings, bags, and hub lane masks.
"""

from __future__ import annotations

import numpy as np
import pytest

from hypergraphdb_tpu import join
from hypergraphdb_tpu.join import ir as rir
from hypergraphdb_tpu.join import planner as rp
from hypergraphdb_tpu.query import conditions as c
from hypergraphdb_tpu.query.variables import var
from hypergraphdb_tpu_torch.join import ir as pir
from hypergraphdb_tpu_torch.join import planner as pp
from hypergraphdb_tpu_torch.serve.types import ServeError, Unservable
from tests.conftest import make_random_hypergraph
from tests.test_torch_join import SHAPES, STAR_OF_STARS, _build_hub
from tests.test_torch_snapshot import to_port


def _build(g, seed):
    nodes, _ = make_random_hypergraph(g, n_nodes=80, n_links=160,
                                      max_arity=4, seed=seed)
    return [int(n) for n in nodes]


def _steps(steps):
    return [(s.var, s.source_rel, (s.source_key.kind, s.source_key.index),
             tuple((f.rel, f.rev, (f.key.kind, f.key.index))
                   for f in s.filters),
             s.type_handle, s.dedupe, s.width_est) for s in steps]


def _assert_same_plan(r, t):
    assert type(r).__name__ == type(t).__name__
    assert r.describe() == t.describe()
    assert r.order == t.order
    assert r.distinct == t.distinct and r.n_consts == t.n_consts
    assert r.est_rows == t.est_rows
    assert _steps(r.steps) == _steps(t.steps)
    assert (r.sig.vars, r.sig.atoms, r.sig.types, r.sig.distinct,
            r.sig.n_consts) == (t.sig.vars, t.sig.atoms, t.sig.types,
                                t.sig.distinct, t.sig.n_consts)
    if hasattr(r, "bags"):
        assert _steps(r.spine) == _steps(t.spine)
        assert [(b.vars, _steps(b.steps), b.est_rows) for b in r.bags] == \
            [(b.vars, _steps(b.steps), b.est_rows) for b in t.bags]


def _plan_both(g, p, **kw):
    snap = g.snapshot()
    q = pir.pattern_from_reference(p)
    rs, rc = join.split_constants(p)
    ts, tc = pir.split_constants(q)
    assert tc == rc
    r = join.plan_join(snap, p, rs, rc, **kw)
    t = pp.plan_join(to_port(snap), q, ts, tc, **kw)
    _assert_same_plan(r, t)
    return r, t


# ---------------------------------------------------------------- IR


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_pattern_from_reference_keeps_every_field(graph, shape):
    nodes = _build(graph, seed=0)
    p = join.extract_pattern(graph, SHAPES[shape](nodes[3]))
    q = pir.pattern_from_reference(p)
    assert q.vars == p.vars and q.distinct == p.distinct
    assert q.types == p.types
    assert [(a.rel, a.var, a.key, a.key_is_var) for a in q.atoms] == \
        [(a.rel, a.var, a.key, a.key_is_var) for a in p.atoms]
    for v in q.vars:
        assert q.type_of(v) == p.type_of(v)
        assert [(a.rel, a.var, a.key) for a in q.atoms_of(v)] == \
            [(a.rel, a.var, a.key) for a in p.atoms_of(v)]
    sig_r, c_r = join.split_constants(p)
    sig_t, c_t = pir.split_constants(q)
    assert c_t == c_r and sig_t.atoms == sig_r.atoms
    assert pir.pattern_from_reference(sig_r.bind(c_r)) == sig_t.bind(c_t)


def test_ir_validation_matches_reference():
    cases = [
        lambda m: m.JoinAtom("nope", "x", 1),
        lambda m: m.ConjunctivePattern(("x", "x"), ()),
        lambda m: m.ConjunctivePattern(("x",), (m.JoinAtom("co", "y", 1),)),
        lambda m: m.ConjunctivePattern(("x",), (m.JoinAtom("co", "x", "z"),)),
        lambda m: m.ConjunctivePattern(("x",), (m.JoinAtom("co", "x", "x"),)),
        lambda m: m.ConjunctivePattern(("x",), (), types=(("q", 3),)),
        lambda m: m.split_constants(m.ConjunctivePattern(
            ("x",), (m.JoinAtom("co", "x", 4),)))[0].bind((1, 2)),
    ]
    for make in cases:
        with pytest.raises(rir.JoinUnsupported) as ref:
            make(rir)
        with pytest.raises(pir.JoinUnsupported) as got:
            make(pir)
        assert str(got.value) == str(ref.value)
    assert issubclass(pir.JoinUnsupported, Unservable)
    assert issubclass(Unservable, ServeError)
    assert pir.RELATIONS == rir.RELATIONS


# ---------------------------------------------------------------- plans


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_matches_reference(graph, shape, seed):
    nodes = _build(graph, seed=seed)
    p = join.extract_pattern(graph, SHAPES[shape](nodes[3 + seed]))
    _plan_both(graph, p)
    if shape == "star3":
        r, t = _plan_both(graph, p, bushy=True)
        assert t.describe().startswith("bushy[")


def test_plan_typed_and_two_anchor_patterns(graph):
    nodes = _build(graph, seed=4)
    a, b = nodes[2], nodes[7]
    th = int(graph.get_type_handle_of(
        graph.add_link([a, nodes[9]], value="typed-probe")))
    specs = [
        {"y": c.And(c.CoIncident(a), c.AtomType(th))},
        {"y": c.CoIncident(a), "z": c.And(c.CoIncident(var("y")),
                                          c.AtomType(th))},
        {"y": c.And(c.CoIncident(a), c.CoIncident(b))},
        {"l": c.And(c.Incident(a), c.Incident(b)), "y": c.Target(var("l"))},
        {"y": c.CoIncident(a), "l": c.And(c.Incident(var("y")),
                                          c.Incident(b))},
    ]
    for spec in specs:
        _plan_both(graph, join.extract_pattern(graph, spec))


@pytest.mark.parametrize("bushy", ["auto", True, False])
def test_bushy_plans_match_reference(graph, bushy):
    nodes = _build(graph, seed=32)
    p = join.extract_pattern(graph, STAR_OF_STARS(nodes[3], nodes[8]))
    r, t = _plan_both(graph, p, bushy=bushy)
    assert hasattr(t, "bags") == (bushy is not False)
    tri = join.extract_pattern(graph, SHAPES["triangle"](nodes[3]))
    _plan_both(graph, tri, bushy=bushy)   # one component: never bushy


def test_seed_var_plans_match_reference(graph):
    _build(graph, seed=9)
    p = join.extract_pattern(graph, {
        "x": c.CoIncident(var("y")),
        "y": c.And(c.CoIncident(var("x")), c.CoIncident(var("z"))),
        "z": c.CoIncident(var("x")),
    })
    for sv in ("x", "y", "z"):
        _plan_both(graph, p, seed_var=sv)


def test_planner_rejects_as_reference(graph):
    nodes = _build(graph, seed=11)
    snap = graph.snapshot()
    port = to_port(snap)
    patterns = [
        join.ConjunctivePattern(("x", "y"), (join.JoinAtom("co", "x", "y"),)),
        join.ConjunctivePattern(("x", "y"), (join.JoinAtom("co", "x", 3),)),
    ]
    for p in patterns:
        with pytest.raises(rir.JoinUnsupported) as ref:
            join.plan_join(snap, p)
        with pytest.raises(pir.JoinUnsupported) as got:
            pp.plan_join(port, pir.pattern_from_reference(p))
        assert str(got.value) == str(ref.value)
    seeded = join.ConjunctivePattern(
        ("x", "y"), (join.JoinAtom("co", "x", nodes[1]),
                     join.JoinAtom("co", "y", "x")))
    for kw in ({"seed_var": "q"}, {"seed_var": "x"}):
        with pytest.raises(rir.JoinUnsupported) as ref:
            join.plan_join(snap, seeded, **kw)
        with pytest.raises(pir.JoinUnsupported) as got:
            pp.plan_join(port, pir.pattern_from_reference(seeded), **kw)
        assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------- helpers


def test_direction_tables_match_reference():
    for rel in ("co", "inc", "tgt"):
        atom_r, atom_t = rir.JoinAtom(rel, "x", "y"), pir.JoinAtom(rel, "x", "y")
        for new in ("x", "y"):
            assert pp._expansion_of(atom_t, new) == rp._expansion_of(atom_r,
                                                                     new)
            fr = rp._filter_of(atom_r, new, rp.KeyRef("col", 1))
            ft = pp._filter_of(atom_t, new, pp.KeyRef("col", 1))
            assert (ft.rel, ft.rev, ft.key.kind, ft.key.index) == \
                (fr.rel, fr.rev, fr.key.kind, fr.key.index)


def test_var_components_match_reference(graph):
    nodes = _build(graph, seed=5)
    for spec in (STAR_OF_STARS(nodes[1], nodes[2]), SHAPES["star3"](nodes[1]),
                 SHAPES["triangle"](nodes[1])):
        p = join.extract_pattern(graph, spec)
        assert pp._var_components(pir.pattern_from_reference(p)) == \
            rp._var_components(p)


@pytest.mark.parametrize("threshold", [2, 8, 40])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_hub_lane_mask_matches_reference(graph, shape, threshold):
    hub, nodes = _build_hub(graph)
    snap = graph.snapshot()
    port = to_port(snap)
    p = join.extract_pattern(graph, SHAPES[shape](hub))
    r, t = _plan_both(graph, p)
    consts = np.asarray([[a] * r.n_consts for a in [hub] + nodes[2:12]],
                        dtype=np.int32)
    want = join.hub_lane_mask(snap, r.steps, consts, threshold)
    got = pp.hub_lane_mask(port, t.steps, consts, threshold, device="cpu")
    assert np.array_equal(got, want)
    empty = pp.hub_lane_mask(port, t.steps, consts[:0], threshold,
                             device="cpu")
    assert empty.shape == (0,)
