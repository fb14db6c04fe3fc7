"""Port join executor vs the reference, by execution mode: the degree
split (hub chains, row-split steps), the flat padded executor, the
factorized relations, bushy plans, seeds mode and pad lanes — on the same
snapshots, against ``hypergraphdb_tpu.ops.join`` and ``join.host_join``.
The port runs on the CPU. Tolerance: exact equality (integers), every
field of every execution (``tests/test_torch_join.py``'s ``_same``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypergraphdb_tpu import join
from hypergraphdb_tpu.ops import join as rj
from hypergraphdb_tpu.query import conditions as c
from hypergraphdb_tpu.query.variables import var
from hypergraphdb_tpu_torch.join import pattern_from_reference, plan_join
from hypergraphdb_tpu_torch.ops import join as pj
from tests.test_torch_join import (
    SHAPES,
    STAR_OF_STARS,
    _build,
    _build_hub,
    _consts,
    _plans,
    _rows,
    _run_both,
)
from tests.test_torch_snapshot import to_port


# ---------------------------------------------------------------- modes


HUB_MODES = {
    "split": dict(hub_threshold=8, var_pad_max=True),
    "unsplit": dict(hub_split=False, pad_cap=40),
    "fact": dict(factorized=True, var_pad_max=True),
    "fact_split": dict(factorized=True, hub_threshold=8, pad_cap=40),
}


@pytest.mark.parametrize("mode", sorted(HUB_MODES))
@pytest.mark.parametrize("shape", ["link_var", "path2", "triangle"])
def test_hub_batch_modes_match_reference(graph, shape, mode):
    """A hub lane, six tail lanes and one pad lane of garbage, through the
    degree split (hub chain, row-split steps), the flat padded executor
    and the factorized relations."""
    hub, nodes = _build_hub(graph)
    anchors = [hub] + nodes[3:9] + [nodes[-1]]
    snap, port, p, rplan, pplan = _plans(graph, SHAPES[shape](hub))
    kw = dict(HUB_MODES[mode], top_r=16, full=True, row_cap=1 << 16,
              n_real=len(anchors) - 1)
    r, t = _run_both(snap, port, rplan, pplan, _consts(p, anchors), **kw)
    r2, t2 = _run_both(snap, port, rplan, pplan, _consts(p, anchors),
                       **{**kw, "count_only": True, "full": False})
    assert int(t.counts[-1]) == 0 and not bool(t.trunc[-1])
    for lane, a in enumerate(anchors[:-1]):
        if bool(t.trunc[lane]):
            continue
        truth = join.host_join(
            graph, join.extract_pattern(graph, SHAPES[shape](a)))
        assert int(t.counts[lane]) == len(truth)
        assert _rows(t, pplan, p, lane) == truth
    if mode == "split" and shape in ("triangle", "path2"):
        assert t.hub_lanes >= 1 and not bool(t.trunc[0])
    if mode == "split" and shape == "path2":
        assert t.host_syncs >= 1      # the row-split step read its width


def test_factorized_matches_flat_counts(graph):
    nodes = _build(graph, seed=36)
    anchors = nodes[2:10]
    for shape in sorted(SHAPES):
        snap, port, p, rplan, pplan = _plans(graph, SHAPES[shape](anchors[0]))
        kw = dict(top_r=0, count_only=True, var_pad_max=True)
        flat = pj.execute_join(port, pplan, _consts(p, anchors),
                               factorized=False, device="cpu", **kw)
        fact = pj.execute_join(port, pplan, _consts(p, anchors),
                               factorized=True, device="cpu", **kw)
        assert torch.equal(flat.counts, fact.counts)


# ---------------------------------------------------------------- bushy


@pytest.mark.parametrize("case", ["auto", "forced_star3", "caps"])
def test_bushy_matches_reference_and_host(graph, case):
    nodes = _build(graph, seed=32)
    a, b = nodes[3], nodes[8]
    spec = STAR_OF_STARS(a, b) if case != "forced_star3" else \
        SHAPES["star3"](a)
    plan_kw = {} if case == "auto" else {"bushy": True}
    snap, port, p, rplan, pplan = _plans(graph, spec, **plan_kw)
    assert pplan.describe().startswith("bushy[")
    kw = (dict(row_cap=32, pad_cap=8) if case == "caps"
          else dict(row_cap=1 << 18, var_pad_max=True))
    _, t = _run_both(snap, port, rplan, pplan,
                     [join.split_constants(p)[1]], top_r=16, full=True, **kw)
    truth = join.host_join(graph, p)
    if case == "caps":
        assert bool(t.trunc[0])
        assert set(_rows(t, pplan, p, 0)) <= set(truth)
    else:
        assert not bool(t.trunc[0])
        assert _rows(t, pplan, p, 0) == truth


# ---------------------------------------------------------------- seeds, pads


def test_seeds_mode_matches_reference(graph):
    _build(graph, seed=9, n_nodes=50, n_links=110)
    p = join.extract_pattern(graph, {
        "x": c.CoIncident(var("y")),
        "y": c.And(c.CoIncident(var("x")), c.CoIncident(var("z"))),
        "z": c.CoIncident(var("x")),
    })
    snap = graph.snapshot()
    port = to_port(snap)
    rplan = join.plan_join(snap, p, seed_var="x")
    pplan = plan_join(port, pattern_from_reference(p), seed_var="x")
    assert pplan.describe() == rplan.describe()
    seeds = np.arange(snap.num_atoms, dtype=np.int32)
    _, t = _run_both(snap, port, rplan, pplan, np.zeros((1, 0)), top_r=4,
                     full=True, seeds=seeds, row_cap=1 << 18,
                     var_pad_max=True)
    off, flat = pj.neighbor_csr(port, "cpu")
    tri = sum(
        len(np.intersect1d(flat[off[y]: off[y + 1]], flat[off[x]: off[x + 1]]))
        for x in range(snap.num_atoms) for y in flat[off[x]: off[x + 1]])
    assert int(t.counts[0]) == tri and not bool(t.trunc[0])
    one = join.ConjunctivePattern(vars=("x",), atoms=())
    _run_both(snap, port, join.plan_join(snap, one, seed_var="x"),
              plan_join(port, pattern_from_reference(one), seed_var="x"),
              np.zeros((1, 0)), top_r=4, seeds=seeds[:7])


def test_pad_lane_garbage_is_inert(graph):
    nodes = _build(graph, seed=7)
    snap, port, p, rplan, pplan = _plans(graph, SHAPES["triangle"](nodes[5]))
    cv = np.full((8, 2), snap.num_atoms - 1, dtype=np.int32)
    cv[0] = join.split_constants(p)[1]
    _, t = _run_both(snap, port, rplan, pplan, cv, top_r=16, n_real=1,
                     full=True)
    assert int(t.counts[0]) == len(join.host_join(graph, p))
    assert (t.counts[1:] == 0).all() and not t.trunc.any()


@pytest.mark.parametrize("group_slots", [1, 100, 1 << 25])
@pytest.mark.parametrize("rows_out", [16, 4096])
def test_hub_expand_tile_groups_match_reference(graph, group_slots,
                                                rows_out):
    """The hub kernel alone against the reference's tile loop: any tile
    grouping (one tile a group, a few, all), with and without the row
    subsets that skip exhausted rows, into a bucket that overflows and
    one that does not — all five outputs equal."""
    hub, nodes = _build_hub(graph)
    snap = graph.snapshot()
    port = to_port(snap)
    off, flat = rj.neighbor_csr(snap)
    poff, pflat = pj.neighbor_csr_device(port, "cpu")
    rng = np.random.default_rng(3)
    keys = np.asarray([hub, nodes[4], hub, nodes[9], nodes[1], hub,
                       nodes[20], nodes[33], nodes[2], hub, nodes[50],
                       nodes[7]], dtype=np.int32)
    cols = np.stack([keys, rng.permutation(keys)], axis=1)
    lanes = rng.integers(0, 4, size=len(keys)).astype(np.int32)
    valid = rng.random(len(keys)) < 0.8
    consts = np.asarray([[hub], [nodes[4]], [nodes[5]], [hub]], np.int32)
    kw = dict(exp_sel=("col", 0), filt_sel=((False, "const", 0, False),),
              type_handle=-1, block=8, rows_out=rows_out, n_lanes=4,
              n_distinct_cols=2, distinct_consts=True)
    ref = rj.join_hub_expand(
        jnp.asarray(off), jnp.asarray(flat), jnp.asarray(cols),
        jnp.asarray(lanes), jnp.asarray(valid), jnp.asarray(consts),
        (jnp.asarray(off),), (jnp.asarray(flat),),
        jnp.asarray(snap.type_of), **kw)
    o64 = off.astype(np.int64)
    widths = np.where(valid, o64[keys + 1] - o64[keys], 0)
    n_chunks = -(-int(widths.max()) // 8)
    for row_widths in (None, widths):
        got = pj.join_hub_expand(
            poff, pflat, torch.from_numpy(cols), torch.from_numpy(lanes),
            torch.from_numpy(valid), torch.from_numpy(consts), (poff,),
            (pflat,), torch.from_numpy(port.type_of),
            n_chunks=n_chunks + 2, row_widths=row_widths,
            group_slots=group_slots, **kw)
        for a, b in zip(ref, got):
            assert np.array_equal(np.asarray(a), b.numpy())
    assert int(np.asarray(ref[3]).sum()) > 16      # the small bucket spills
