"""Every entry of the port's verification registry against the reference's
entry of the same name, on the same numpy exemplar: the port's exemplar
function makes the inputs on the CPU from ``default_rng(seed)``, and the
reference gets the same arrays (snapshots, deltas, columns and sharded
bases built by its own code from the same tables). The Pallas-backed
entries run in interpret mode, as the reference's own tests run them.

Tolerance: exact equality; bitmaps compared as uint32 words, counts as
int64."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypergraphdb_tpu import verify as ref_verify
from hypergraphdb_tpu.ops import bitfrontier as r_bitfrontier
from hypergraphdb_tpu.ops import ellbfs as r_ellbfs
from hypergraphdb_tpu.ops import frontier as r_frontier
from hypergraphdb_tpu.ops import incremental as r_incremental
from hypergraphdb_tpu.ops import join as r_join
from hypergraphdb_tpu.ops import pallas_bfs as r_pbfs
from hypergraphdb_tpu.ops import pallas_gather as r_gather
from hypergraphdb_tpu.ops import serving as r_serving
from hypergraphdb_tpu.ops import setops as r_setops
from hypergraphdb_tpu.ops import sharded_serving as r_sserving
from hypergraphdb_tpu.ops import value_index as r_value_index
from hypergraphdb_tpu.ops.snapshot import CSRSnapshot as RefSnapshot
from hypergraphdb_tpu.ops.snapshot import DeviceSnapshot as RefDevice
from hypergraphdb_tpu.parallel import sharded as r_sharded
from hypergraphdb_tpu_torch import verify
from hypergraphdb_tpu_torch.ops import linemask
from hypergraphdb_tpu_torch.ops.snapshot import reference_words
from tests.test_torch_value_index import ref_bounds

SEED = 0
NAMES = sorted(verify.PORT_OF)


def J(x):
    """A port tensor (or numpy array) as a JAX array of its dtype."""
    return jnp.asarray(x.numpy() if torch.is_tensor(x) else np.asarray(x))


def W(x):
    """Bit words as uint32 (the reference's type)."""
    return jnp.asarray(np.asarray(
        x.numpy() if torch.is_tensor(x) else x).view(np.uint32))


def N(x) -> np.ndarray:
    """A result of either package as numpy."""
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def same(port, ref, words: bool = False, what: str = "") -> None:
    p, r = N(port), N(ref)
    if words:
        p, r = p.view(np.uint32), r.view(np.uint32)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    assert np.array_equal(p.astype(np.int64), r.astype(np.int64)), what


def ref_snap(seed=SEED, **kw) -> RefSnapshot:
    return RefSnapshot.from_tables(**verify.snapshot_tables(seed, **kw),
                                   pad_multiple=verify.SNAPSHOT_PAD)


def ref_dev(seed=SEED) -> RefDevice:
    return RefDevice.from_host(ref_snap(seed))


def ref_delta(seed=SEED):
    return r_incremental.DeviceDelta(**{
        k: jnp.asarray(v) for k, v in verify.delta_arrays(seed).items()})


def ref_sharded_host(seed=SEED) -> RefSnapshot:
    return ref_snap(seed, n_nodes=verify.SHARDED_ATOMS - 84, n_links=84,
                    max_arity=4)


def ref_mesh():
    return jax.sharding.Mesh(np.asarray(jax.devices()[: verify.SHARDS]),
                             (r_sharded.AXIS,))


def ref_sdev(seed=SEED):
    return r_sharded.ShardedSnapshot.from_host(ref_sharded_host(seed),
                                               ref_mesh(), edge_chunk=64)


def port_run(name: str):
    """The port entry's exemplar (args, kwargs) and its result."""
    e = verify.load_entries().get(name)
    args, kwargs = verify.exemplar(e, "cpu", SEED)
    return args, kwargs, e.fn(*args, **kwargs)


def test_parity_covers_every_entry():
    assert sorted(CASES) == NAMES


# ------------------------------------------------------------------ cases


def frontier_bfs_levels():
    (_, seeds), _, (lv, vis) = port_run("ops.frontier.bfs_levels")
    lv_r, vis_r = r_frontier.bfs_levels(ref_dev(), J(seeds), 2)
    same(lv, lv_r, what="levels")
    same(vis, vis_r, what="visited")


def frontier_reachable():
    (_, seed), _, vis = port_run("ops.frontier.reachable")
    same(vis, r_frontier.reachable(ref_dev(), jnp.int32(int(seed)), 2))


def frontier_edge_counts():
    (_, seeds), _, got = port_run("ops.frontier.frontier_edge_counts")
    same(got, r_frontier.frontier_edge_counts(ref_dev(), J(seeds), 2))


def bitfrontier_block():
    (_, seeds), kw, res = port_run("ops.bitfrontier.bfs_packed_block")
    want = r_bitfrontier.bfs_packed_block(ref_dev(), J(seeds), 2,
                                          edge_chunk=64, with_levels=False)
    same(res[0], want[0], words=True, what="visited")
    same(res[1], want[1], what="edges")


def gather_or():
    (values, idx), _, got = port_run("ops.pallas_gather.gather_or")
    want = r_gather.gather_or(W(values), J(idx), 8, interpret=True)
    same(got, want, words=True)


def seed_bitmap():
    (seeds,), _, got = port_run("ops.ellbfs._seed_bitmap")
    same(got, r_ellbfs._seed_bitmap(J(seeds), jnp.int32(31), n_pad=64),
         words=True)


def deg_sum():
    (visited, deg), _, got = port_run("ops.ellbfs._deg_sum")
    same(got, r_ellbfs._deg_sum(W(visited), J(deg)))


def reach_counts():
    (visited,), _, got = port_run("ops.ellbfs._reach_counts")
    same(got, r_ellbfs._reach_counts(W(visited)))


def stage():
    e = verify.load_entries().get("ops.ellbfs._stage")
    args, kwargs = verify.exemplar(e, "cpu", SEED)
    values, levels, widths = args[0].clone(), args[2], args[3]
    buf = e.fn(*args, **kwargs)
    want = r_ellbfs._stage(W(values), tuple(J(x) for x in levels),
                           widths=widths, chunk=1 << 19, use_pallas=False)
    same(buf, want, words=True)
    assert torch.equal(args[5], linemask.line_mask(buf))


def visited_update():
    e = verify.load_entries().get("ops.ellbfs._visited_update")
    args, kwargs = verify.exemplar(e, "cpu", SEED)
    before = args[0].clone()
    got = e.fn(*args, **kwargs)
    want = r_ellbfs._visited_update(W(before), W(args[2]), J(args[4]),
                                    jnp.int32(args[5]))
    same(got, want, words=True)
    assert torch.equal(args[1], linemask.line_mask(got))


def member_mask():
    (ref, q), _, got = port_run("ops.setops.member_mask")
    same(got, r_setops.member_mask(J(ref), J(q)))


def segment_member_mask():
    args, _, got = port_run("ops.setops.segment_member_mask")
    same(got, r_setops.segment_member_mask(*(J(a) for a in args)))


def incident_intersection():
    (_, anchors), _, got = port_run("ops.setops.incident_intersection")
    want = r_setops.incident_intersection(ref_dev(), J(anchors), pad_len=8)
    for a, b in zip(got, want):
        same(a, b)


def ell():
    return jnp.asarray(r_setops.ell_targets(ref_snap()))


def incident_intersection_ell():
    (_, tgt_ell, anchors), _, got = port_run(
        "ops.setops.incident_intersection_ell")
    same(tgt_ell, ell(), what="ell")
    want = r_setops.incident_intersection_ell(ref_dev(), ell(), J(anchors),
                                              pad_len=8)
    for a, b in zip(got, want):
        same(a, b)


def incident_value_range():
    (_, _, anchors), kw, got = port_run("ops.setops.incident_value_range")
    want = r_setops.incident_value_range(
        ref_dev(), ell(), J(anchors), pad_len=8, kind=jnp.uint8(kw["kind"]),
        lo_hi=jnp.uint32(0), lo_lo=jnp.uint32(kw["lo"]), hi_hi=jnp.uint32(0),
        hi_lo=jnp.uint32(kw["hi"]), lo_op="gte", hi_op="lt", exact=True)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        same(a, b)
    assert int(got[-1].sum()) > 0  # a window with survivors


def bfs_levels_delta():
    (_, _, seeds), _, (lv, vis) = port_run("ops.incremental.bfs_levels_delta")
    lv_r, vis_r = r_incremental.bfs_levels_delta(ref_dev(), ref_delta(),
                                                 J(seeds), 2)
    same(lv, lv_r, what="levels")
    same(vis, vis_r, what="visited")


def ref_fused(seeds, hops=2, count_edges=True):
    plan, geom = r_pbfs.device_fused_plan(ref_snap())
    return r_pbfs._bfs_fused(plan, J(seeds), jnp.int32(geom.n_atoms), geom,
                             r_pbfs.KWP_MIN, hops, count_edges, True,
                             interpret=True)


def bfs_fused():
    (_, seeds, geom), _, (vis, s_ins, reach) = port_run(
        "ops.pallas_bfs._bfs_fused")
    K, kw, n1 = seeds.shape[0], seeds.shape[0] // 32, geom.n_atoms + 1
    vis_r, s_r, reach_r = ref_fused(seeds)
    same(vis[:n1], np.asarray(vis_r)[:n1, :kw], words=True, what="visited")
    assert len(s_ins) == len(s_r) == 2
    for a, b in zip(s_ins, s_r):
        same(a, np.asarray(b)[:K], what="s_in")
    same(reach, np.asarray(reach_r)[:K], what="reach")


def bfs_serve_batch():
    (_, _, seeds), _, got = port_run("ops.serving.bfs_serve_batch")
    want = r_serving.bfs_serve_batch(ref_dev(), ref_delta(), J(seeds),
                                     max_hops=2, top_r=4)
    for a, b in zip(got, want):
        same(a, b)


def bfs_serve_batch_fused():
    (_, seeds, _), _, got = port_run("ops.serving.bfs_serve_batch_fused")
    kw = r_pbfs.serve_fused_kwargs(ref_snap(), None, seeds.shape[0])
    want = r_serving.bfs_serve_batch_fused(
        kw["fused"], J(seeds), kw["n_atoms"], geom=kw["geom"],
        kwp=kw["kwp"], max_hops=2, top_r=4, interpret=True)
    for a, b in zip(got, want):
        same(a, b)


def pattern_serve_batch():
    (_, _, anchors, type_vec), _, got = port_run(
        "ops.serving.pattern_serve_batch")
    want = r_serving.pattern_serve_batch(ref_dev(), ell(), J(anchors),
                                         J(type_vec), pad_len=8, top_r=4)
    for a, b in zip(got, want):
        same(a, b)
    assert int(got[0].sum()) > 0


def ref_join_args(args):
    return tuple(tuple(J(x) for x in a) if isinstance(a, tuple) else J(a)
                 for a in args)


def join_case(name, drop=()):
    e = verify.load_entries().get(name)
    args, kwargs = verify.exemplar(e, "cpu", SEED)
    got = e.fn(*args, **kwargs)
    fn = getattr(r_join, name.rsplit(".", 1)[1])
    want = fn(*ref_join_args(args),
              **{k: v for k, v in kwargs.items() if k not in drop})
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        same(a, b, what=f"{name}[{i}]")
    return got


def join_expand_step():
    got = join_case("ops.join.join_expand_step")
    assert int(got[3].sum()) > 0  # survivors in some lane


def join_hub_expand():
    join_case("ops.join.join_hub_expand", drop=("n_chunks",))


def join_bag_join():
    join_case("ops.join.join_bag_join")


def join_finalize():
    e = verify.load_entries().get("ops.join.join_finalize")
    args, kwargs = verify.exemplar(e, "cpu", SEED)
    same(e.fn(*args, **kwargs),
         r_join.join_finalize(*(J(a) for a in args), **kwargs))


def ref_column(col):
    hi, lo = reference_words(col.rank.numpy())
    hi2, lo2 = reference_words(col.rank2.numpy())
    return (jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(hi2),
            jnp.asarray(lo2), J(col.gids), jnp.int32(col.n))


def range_probe_batch():
    (col, *_), _, got = port_run("ops.value_index.range_probe_batch")
    b = verify.range_bounds(SEED)
    want = r_value_index.range_probe_batch(*ref_column(col)[:4],
                                           jnp.int32(col.n),
                                           *ref_bounds(b)[:10])
    for a, c in zip(got, want):
        same(a, c)


def ordered_topk_batch():
    args, kw, got = port_run("ops.value_index.ordered_topk_batch")
    base, delta, type_of, inc_offsets, inc_links = args[:5]
    b = verify.range_bounds(SEED)
    want = r_value_index.ordered_topk_batch(
        *ref_column(base), *ref_column(delta), J(type_of), J(inc_offsets),
        J(inc_links), *ref_bounds(b), win_pad=8, top_r=4)
    assert len(got) == len(want) == 4
    for a, c in zip(got, want):
        same(a, c)
    assert int(got[0].sum()) > 0


def bfs_packed_sharded():
    (sdev, seeds), _, res = port_run("parallel.sharded.bfs_packed_sharded")
    assert sdev.n_loc == verify.N_LOC and sdev.n_dev == verify.SHARDS
    wr, cr, _ = r_sharded.bfs_packed_sharded(ref_sdev(), J(seeds), 2)
    same(res.visited, wr, words=True, what="visited")
    same(res.edges_touched, cr, what="edges")


def match_candidates_sharded():
    (_, cand, rows), _, got = port_run(
        "parallel.sharded.match_candidates_sharded")
    same(got, r_sharded.match_candidates_sharded(ref_sdev(), J(cand),
                                                 J(rows)))


def sharded_reference(entry, twin):
    """``(result, True)`` of the reference's sharded entry, or, where this
    JAX refuses its program (``shard_map``'s replication check fails on
    the mesh twins' merged outputs), ``(result, False)`` of its
    single-device twin on the same inputs: the contract the sharded lane
    keeps."""
    try:
        return entry(), True
    except ValueError as e:
        if "shard_map" not in str(e):
            raise
        return twin(), False


def bfs_serve_batch_sharded():
    (_, _, seeds), _, got = port_run(
        "ops.sharded_serving.bfs_serve_batch_sharded")
    hd = verify.sharded_delta_host(SEED)
    hd["dead"] = np.asarray(hd["dead"], dtype=np.int64)

    def sharded():
        sd = ref_sdev()
        return r_sserving.bfs_serve_batch_sharded(
            sd, r_sharded.shard_host_delta(sd, hd, edge_chunk=16), J(seeds),
            max_hops=2, top_r=4)

    def single():
        snap = ref_sharded_host()
        dead = np.zeros(snap.num_atoms + 1, dtype=bool)
        dead[hd["dead"]] = True
        delta = r_incremental.DeviceDelta(
            inc_links=jnp.asarray(hd["inc_links"]),
            inc_src=jnp.asarray(hd["inc_src"]),
            tgt_flat=jnp.asarray(hd["tgt_flat"]),
            tgt_src=jnp.asarray(hd["tgt_src"]), dead=jnp.asarray(dead))
        return r_serving.bfs_serve_batch(RefDevice.from_host(snap), delta,
                                         J(seeds), max_hops=2, top_r=4)

    want, is_sharded = sharded_reference(sharded, single)
    # the last lane is a pad lane: the sharded contract counts nothing
    # there (the dummy row lies outside every shard's live rows), the
    # single-device twin counts the dummy row itself
    lanes = slice(None) if is_sharded else slice(0, -1)
    for a, b in zip(got, want):
        same(a[lanes], np.asarray(b)[lanes])
    assert int(got[0][-1]) == 0
    assert int((got[0] > 1).sum()) >= 5  # most seeds reached a neighbour


def pattern_serve_batch_sharded():
    (_, rows0, types0, tgt, anchors, type_vec), _, got = port_run(
        "ops.sharded_serving.pattern_serve_batch_sharded")

    def sharded():
        return r_sserving.pattern_serve_batch_sharded(
            r_sserving.mesh_carrier(ref_mesh()), J(rows0), J(types0),
            J(tgt), J(anchors), J(type_vec), top_r=4)

    def single():
        snap = ref_sharded_host()
        return r_serving.pattern_serve_batch(
            RefDevice.from_host(snap), jnp.asarray(r_setops.ell_targets(snap)),
            J(anchors), J(type_vec), pad_len=rows0.shape[1], top_r=4)

    want, _ = sharded_reference(sharded, single)
    for a, b in zip(got, want):
        same(a, b)
    assert int(got[0].sum()) > 0


CASES = {
    "ops.frontier.bfs_levels": frontier_bfs_levels,
    "ops.frontier.reachable": frontier_reachable,
    "ops.frontier.frontier_edge_counts": frontier_edge_counts,
    "ops.bitfrontier.bfs_packed_block": bitfrontier_block,
    "ops.pallas_gather.gather_or": gather_or,
    "ops.ellbfs._seed_bitmap": seed_bitmap,
    "ops.ellbfs._deg_sum": deg_sum,
    "ops.ellbfs._stage": stage,
    "ops.ellbfs._visited_update": visited_update,
    "ops.ellbfs._reach_counts": reach_counts,
    "ops.setops.member_mask": member_mask,
    "ops.setops.segment_member_mask": segment_member_mask,
    "ops.setops.incident_intersection_ell": incident_intersection_ell,
    "ops.setops.incident_intersection": incident_intersection,
    "ops.setops.incident_value_range": incident_value_range,
    "ops.incremental.bfs_levels_delta": bfs_levels_delta,
    "ops.pallas_bfs._bfs_fused": bfs_fused,
    "ops.serving.bfs_serve_batch": bfs_serve_batch,
    "ops.serving.bfs_serve_batch_fused": bfs_serve_batch_fused,
    "ops.serving.pattern_serve_batch": pattern_serve_batch,
    "ops.join.join_expand_step": join_expand_step,
    "ops.join.join_hub_expand": join_hub_expand,
    "ops.join.join_bag_join": join_bag_join,
    "ops.join.join_finalize": join_finalize,
    "ops.value_index.range_probe_batch": range_probe_batch,
    "ops.value_index.ordered_topk_batch": ordered_topk_batch,
    "parallel.sharded.bfs_packed_sharded": bfs_packed_sharded,
    "parallel.sharded.match_candidates_sharded": match_candidates_sharded,
    "ops.sharded_serving.bfs_serve_batch_sharded": bfs_serve_batch_sharded,
    "ops.sharded_serving.pattern_serve_batch_sharded":
        pattern_serve_batch_sharded,
}


@pytest.mark.parametrize("name", NAMES)
def test_entry_matches_reference(name):
    """The reference's registry holds the same entry name, and its entry on
    the same numpy exemplar gives the port's result."""
    assert name in REF_NAMES
    CASES[name]()


def _reference_names() -> set:
    import importlib

    for m in ("ops.frontier", "ops.incremental", "ops.ellbfs",
              "ops.pallas_gather", "ops.serving", "ops.setops",
              "ops.bitfrontier", "ops.pallas_bfs", "ops.join",
              "ops.value_index", "parallel.sharded", "ops.sharded_serving"):
        importlib.import_module("hypergraphdb_tpu." + m)
    return set(ref_verify.REGISTRY.names())


REF_NAMES = _reference_names()
