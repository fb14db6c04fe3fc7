"""Served BFS and served patterns: the port's ``bfs_serve_batch_fused`` /
``serve_bfs`` against the reference ``bfs_serve_batch_fused(...,
interpret=True)``, and its ``pattern_serve_batch`` / ``serve_pattern``
against the reference ``pattern_serve_batch``, across the serve buckets, pad
lanes included. Tolerance: exact equality of counts and ``first_r``
windows."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from hypergraphdb_tpu.ops import pallas_bfs as ref_fused
from hypergraphdb_tpu.ops.serving import bfs_serve_batch_fused as ref_serve
from hypergraphdb_tpu_torch.ops import fused_bfs
from hypergraphdb_tpu_torch.ops.serving import (
    BUCKETS,
    NO_TYPE,
    PATTERN_PAD,
    bfs_serve_batch_fused,
    pattern_serve_batch,
    serve_bfs,
    serve_pattern,
)
from hypergraphdb_tpu_torch.ops.setops import (
    SENTINEL,
    and_incident_pattern,
    ell_targets,
)
from tests.test_ellbfs import random_snapshot
from tests.test_torch_setops import c3_pairs, smallest_first
from tests.test_torch_snapshot import to_port


def _reference(snap, seeds, hops, top_r):
    kw = ref_fused.serve_fused_kwargs(snap, None, len(seeds))
    counts, first_r = ref_serve(
        kw["fused"], jnp.asarray(seeds), kw["n_atoms"], geom=kw["geom"],
        kwp=kw["kwp"], max_hops=hops, top_r=top_r, interpret=True)
    return np.asarray(counts), np.asarray(first_r)


@pytest.fixture(scope="module")
def snaps():
    ref = random_snapshot(90, 180, 4, seed=8, zipf=True)
    return ref, to_port(ref)


@pytest.mark.parametrize("bucket", [64, 256])
def test_serve_batch_matches_reference_with_pad_lanes(snaps, bucket):
    ref_snap, port = snaps
    n = port.num_atoms
    seeds = np.full(bucket, n, np.int32)
    live = min(bucket - 3, 50)
    seeds[:live] = np.random.default_rng(5).integers(0, 90, size=live)
    top_r = 9
    c_ref, f_ref = _reference(ref_snap, seeds, 2, top_r)
    plan, geom = fused_bfs.device_fused_plan(port, "cpu")
    counts, first_r = bfs_serve_batch_fused(plan, torch.from_numpy(seeds),
                                            geom, 2, top_r)
    assert np.array_equal(counts.numpy(), c_ref)
    assert np.array_equal(first_r.numpy(), f_ref)
    assert (c_ref[:live] > top_r).any()  # truncated prefixes exercised
    assert (counts.numpy()[live:] == 1).all()  # pad lanes keep the dummy bit


@pytest.mark.parametrize("n_req", [5, 64, 65, 300])
def test_serve_bfs_pads_to_bucket(snaps, n_req):
    ref_snap, port = snaps
    seeds = np.random.default_rng(n_req).integers(0, 90, size=n_req).astype(
        np.int32)
    bucket = next(b for b in BUCKETS if b >= n_req)
    padded = np.full(bucket, port.num_atoms, np.int32)
    padded[:n_req] = seeds
    c_ref, f_ref = _reference(ref_snap, padded, 3, 16)
    counts, first_r = serve_bfs(port, seeds, 3, 16, device="cpu")
    assert counts.shape == (n_req,) and first_r.shape == (n_req, 16)
    assert np.array_equal(counts, c_ref[:n_req])
    assert np.array_equal(first_r, f_ref[:n_req])


def test_serve_bfs_rejects_oversized_batch(snaps):
    _, port = snaps
    with pytest.raises(ValueError, match="bucket"):
        serve_bfs(port, np.zeros(BUCKETS[-1] + 1, np.int32), 1, 4, device="cpu")


def test_first_r_top_r_beyond_row_block():
    """``top_r`` wider than one streamed row block still yields the global
    prefix, and rows at or past ``n1`` are masked."""
    R, K, top_r, n1 = 8200, 32, 4100, 8000
    r = np.random.default_rng(2)
    vis = np.zeros((R, 1), np.int32)
    rows0 = np.unique(r.integers(0, n1, size=7000))
    vis[rows0, 0] |= 1
    vis[[5, 4097, 8100], 0] |= 2
    want = np.asarray(ref_fused.first_r_from_bitmap(
        jnp.asarray(vis.view(np.uint32)), jnp.int32(n1), top_r, K))
    got = fused_bfs.first_r_from_bitmap(torch.from_numpy(vis), n1, top_r, K)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy()[0], rows0[:top_r])


# ------------------------------------------------------------ served pattern


@pytest.fixture(scope="module")
def dbp():
    from hypergraphdb_tpu.models.generators import dbpedia_snapshot

    ref, info = dbpedia_snapshot(n_entities=3000, n_links=12000)
    th = max(info["property_types"], key=lambda t: len(ref.type_set(t)))
    return ref, to_port(ref), int(th)


def _requests(port, th, n):
    """``n`` c3 anchor pairs and a type per request: ``th``, none, or a
    type that matches nothing."""
    pairs = c3_pairs(port, th, n, seed=3)
    types = [(th, None, th + 1)[i % 3] for i in range(n)]
    return pairs, types


@pytest.mark.parametrize("bucket,live", [(64, 40), (256, 200)])
def test_pattern_serve_batch_matches_reference(dbp, bucket, live):
    from hypergraphdb_tpu.ops.serving import pattern_serve_batch as ref_batch
    from hypergraphdb_tpu.ops.setops import ell_targets as ref_ell

    ref, port, th = dbp
    pairs, types = _requests(port, th, live)
    anchors = np.full((bucket, 2), port.num_atoms, np.int32)
    anchors[:live] = smallest_first(port, pairs)[0]
    type_vec = np.full(bucket, NO_TYPE, np.int32)
    type_vec[:live] = [NO_TYPE if t is None else t for t in types]
    top_r = 4
    c_ref, f_ref = ref_batch(ref.device, ref_ell(ref), jnp.asarray(anchors),
                             jnp.asarray(type_vec), pad_len=PATTERN_PAD,
                             top_r=top_r)
    counts, first_r = pattern_serve_batch(
        port.device("cpu"), ell_targets(port, "cpu"),
        torch.from_numpy(anchors), torch.from_numpy(type_vec), PATTERN_PAD,
        top_r)
    assert np.array_equal(counts.numpy(), np.asarray(c_ref))
    assert np.array_equal(first_r.numpy(), np.asarray(f_ref))
    assert (counts.numpy()[live:] == 0).all()  # pad lanes match nothing
    assert (counts.numpy()[:live] > 0).any()


@pytest.mark.parametrize("n_req", [5, 64, 65])
def test_serve_pattern_matches_pattern_path(dbp, n_req):
    _, port, th = dbp
    pairs, types = _requests(port, th, n_req)
    top_r = 4
    counts, first_r = serve_pattern(port, pairs, types, top_r, device="cpu")
    assert counts.shape == (n_req,) and first_r.shape == (n_req, top_r)
    for k, (pair, t) in enumerate(zip(pairs, types)):
        want = and_incident_pattern(port, [pair], t, device="cpu")[0]
        assert counts[k] == len(want)
        window = np.full(top_r, SENTINEL, np.int64)
        window[: min(len(want), top_r)] = want[:top_r]
        assert np.array_equal(first_r[k].astype(np.int64), window)


def test_serve_pattern_rejects_what_a_batch_cannot_hold(dbp):
    _, port, th = dbp
    deg = np.diff(port.inc_offsets[: port.num_atoms + 1])
    h1, h2 = np.argsort(-deg, kind="stable")[:2]
    assert min(deg[h1], deg[h2]) > PATTERN_PAD
    with pytest.raises(ValueError, match="over the pad"):
        serve_pattern(port, [(h1, h2)], [None], 4, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        serve_pattern(port, [(0, port.num_atoms)], [th], 4, device="cpu")
    with pytest.raises(ValueError, match="bucket"):
        serve_pattern(port, [(0, 1)] * (BUCKETS[-1] + 1),
                      [None] * (BUCKETS[-1] + 1), 4, device="cpu")
    with pytest.raises(ValueError, match="type handles"):
        serve_pattern(port, [(0, 1)], [], 4, device="cpu")


def test_served_bfs_masks_keep_pad_lanes_dummy_bit(snaps):
    """The 64 bucket through the masked fused hop: the pad lanes' dummy-row
    bit is in the seed mask and every hop's mask (clear_dummy=False), each
    mask entering a hop equals ``line_mask`` of its bitmap, and counts and
    ``first_r`` equal the reference's."""
    from hypergraphdb_tpu_torch.ops import linemask

    ref_snap, port = snaps
    n = port.num_atoms
    seeds = np.full(64, n, np.int32)
    seeds[:5] = np.random.default_rng(9).integers(0, 90, size=5)
    plan, geom = fused_bfs.device_fused_plan(port, "cpu")
    seen = []

    def hook(h, visited, mask):
        assert torch.equal(mask, linemask.line_mask(visited)), f"hop {h}"
        assert int(linemask.fields_at(mask, torch.tensor([n]), 2)) == 1
        seen.append(h)

    visited, _, reach = fused_bfs.bfs_fused(
        plan, torch.from_numpy(seeds), geom, 3, count_edges=False,
        clear_dummy=False, hop_hook=hook)
    assert seen == [0, 1, 2, 3]
    c_ref, f_ref = _reference(ref_snap, seeds, 3, 8)
    counts, first_r = bfs_serve_batch_fused(plan, torch.from_numpy(seeds),
                                            geom, 3, 8)
    assert np.array_equal(counts.numpy(), c_ref)
    assert np.array_equal(first_r.numpy(), f_ref)
    assert np.array_equal(reach.numpy(), c_ref.astype(np.int64))
    assert (counts.numpy()[5:] == 1).all()


# ------------------------------------------------- served BFS over a delta


@pytest.fixture(scope="module")
def delta_case():
    """The reference's overlay scenario: 100 nodes, 150 links, 40 delta
    links bridging the node halves; the (base, delta) pair before and after
    tombstones on a node, a base link and a delta link."""
    from hypergraphdb_tpu_torch.ops import incremental as inc
    from tests.test_torch_incremental import Recorder, ref_arrays

    rec = Recorder(n_nodes=100, n_links=150, seed=12)
    r = np.random.default_rng(9)
    new = [rec.add_link([rec.nodes[int(r.integers(0, 50))],
                         rec.nodes[int(r.integers(50, 100))]], f"delta{i}")
           for i in range(40)]
    dev, delta = rec.mgr.device()
    rec.remove(rec.nodes[7])
    rec.remove(rec.links[2])
    rec.remove(new[0])
    _, dead = rec.mgr.device()
    port = to_port(rec.mgr.base)
    yield {"rec": rec, "dev": dev, "delta": delta, "dead": dead,
           "port": port,
           "pd": inc.delta_from_reference(ref_arrays(delta), "cpu"),
           "pdead": inc.delta_from_reference(ref_arrays(dead), "cpu")}
    rec.close()


def _delta_seeds(case, bucket, live=48):
    n = case["port"].num_atoms
    seeds = np.full(bucket, n, np.int32)
    seeds[:live] = np.random.default_rng(bucket).integers(0, 100, size=live)
    seeds[1] = int(case["rec"].nodes[7])  # tombstoned in the dead pair
    return seeds


def _port_overlay(case, seeds, hops, top_r):
    kw = fused_bfs.serve_fused_kwargs(case["port"], case["pd"], len(seeds),
                                      "cpu")
    assert kw["overlay"] is not None
    counts, first_r = bfs_serve_batch_fused(
        kw["plan"], torch.from_numpy(seeds), kw["geom"], hops, top_r,
        overlay=kw["overlay"])
    return counts.numpy(), first_r.numpy()


@pytest.mark.parametrize("hops", [1, 3])
def test_overlay_route_matches_reference_fused_route(delta_case, hops):
    """The port's fused route with the delta overlay against the
    reference's ``bfs_serve_batch_fused`` with its overlay, in interpret
    mode, pad lanes included."""
    case = delta_case
    seeds = _delta_seeds(case, 64)
    kw = ref_fused.serve_fused_kwargs(case["rec"].mgr.base, case["delta"], 64)
    assert kw["overlay"] is not None
    c_ref, f_ref = ref_serve(
        kw["fused"], jnp.asarray(seeds), kw["n_atoms"], kw["overlay"],
        geom=kw["geom"], kwp=kw["kwp"], max_hops=hops, top_r=7,
        widths1=kw["widths1"], widths2=kw["widths2"], interpret=True)
    counts, first_r = _port_overlay(case, seeds, hops, 7)
    assert np.array_equal(counts, np.asarray(c_ref))
    assert np.array_equal(first_r, np.asarray(f_ref))


@pytest.mark.parametrize("hops", [1, 3])
@pytest.mark.parametrize("bucket", [64, 256])
def test_overlay_route_matches_dense_route(delta_case, bucket, hops,
                                           monkeypatch):
    """Fused with the overlay, the port's dense ``bfs_serve_batch`` and the
    reference's dense ``bfs_serve_batch`` agree lane for lane, pad lanes
    included; the overlay adds reach the base alone lacks."""
    from hypergraphdb_tpu.ops.serving import bfs_serve_batch as ref_dense
    from hypergraphdb_tpu_torch.ops.serving import bfs_serve_batch

    from hypergraphdb_tpu_torch.ops import incremental as inc

    case = delta_case
    monkeypatch.setattr(inc, "DENSE_LANE_BLOCK", 32)  # several blocks
    seeds = _delta_seeds(case, bucket)
    c_ref, f_ref = ref_dense(case["dev"], case["delta"], jnp.asarray(seeds),
                             hops, 7)
    counts, first_r = _port_overlay(case, seeds, hops, 7)
    d_counts, d_first = bfs_serve_batch(case["port"].device("cpu"),
                                        case["pd"], torch.from_numpy(seeds),
                                        hops, 7)
    for c, f in ((counts, first_r), (d_counts.numpy(), d_first.numpy())):
        assert np.array_equal(c, np.asarray(c_ref))
        assert np.array_equal(f, np.asarray(f_ref))
    assert (counts[48:] == 1).all()  # pad lanes keep the dummy bit
    base_only, _ = serve_bfs(case["port"], seeds[:48], hops, 7,
                             device="cpu")
    assert (counts[:48] >= base_only).all() and (counts[:48] > base_only).any()


@pytest.mark.parametrize("tombstones", [False, True])
def test_serve_bfs_routes_by_the_tombstone_gate(delta_case, tombstones):
    """A pending tombstone sends the batch to the dense sweep, none to the
    fused route; both answer as the reference's dense batch."""
    from hypergraphdb_tpu.ops.serving import bfs_serve_batch as ref_dense

    case = delta_case
    ref_delta = case["dead" if tombstones else "delta"]
    pd = case["pdead" if tombstones else "pd"]
    seeds = _delta_seeds(case, 64)[:48]
    padded = np.full(64, case["port"].num_atoms, np.int32)
    padded[:48] = seeds
    c_ref, f_ref = ref_dense(case["dev"], ref_delta, jnp.asarray(padded), 3, 9)
    serve_bfs.routes.update(fused=0, dense=0)
    counts, first_r = serve_bfs(case["port"], seeds, 3, 9, delta=pd,
                                device="cpu")
    want = {"fused": 0, "dense": 1} if tombstones else {"fused": 1, "dense": 0}
    assert serve_bfs.routes == want
    assert np.array_equal(counts, np.asarray(c_ref)[:48])
    assert np.array_equal(first_r, np.asarray(f_ref)[:48])
    assert (counts[1] == 0) == tombstones  # the tombstoned seed


def test_serve_bfs_declined_plan_takes_the_dense_route(delta_case,
                                                      monkeypatch):
    """A bucket the fused plan declines goes dense when there is a delta
    (and raises without one, as before)."""
    case = delta_case
    monkeypatch.setattr(fused_bfs, "FUSED_INDEX_BUDGET", 0)
    seeds = _delta_seeds(case, 64)[:20]
    assert fused_bfs.plan_supported(case["port"], 64) is not None
    serve_bfs.routes.update(fused=0, dense=0)
    counts, _ = serve_bfs(case["port"], seeds, 2, 5, delta=case["pd"],
                          device="cpu")
    assert serve_bfs.routes == {"fused": 0, "dense": 1}
    monkeypatch.undo()
    fused_counts, _ = serve_bfs(case["port"], seeds, 2, 5, delta=case["pd"],
                                device="cpu")
    assert np.array_equal(counts, fused_counts)
    monkeypatch.setattr(fused_bfs, "FUSED_INDEX_BUDGET", 0)
    with pytest.raises(ValueError, match="declined"):
        serve_bfs(case["port"], seeds, 2, 5, device="cpu")


def test_delta_without_edges_gives_no_overlay(delta_case):
    """A delta with no edges (all pad) plans no overlay and serves the
    plain fused result."""
    from hypergraphdb_tpu_torch.ops import incremental as inc

    case = delta_case
    port = case["port"]
    empty = inc.DeltaMemtable(port.num_atoms, device="cpu").device()
    kw = fused_bfs.serve_fused_kwargs(port, empty, 64, "cpu")
    assert kw["overlay"] is None
    seeds = _delta_seeds(case, 64)[:30]
    want = serve_bfs(port, seeds, 3, 8, device="cpu")
    serve_bfs.routes.update(fused=0, dense=0)
    got = serve_bfs(port, seeds, 3, 8, delta=empty, device="cpu")
    assert serve_bfs.routes == {"fused": 1, "dense": 0}
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_serve_bfs_rejects_a_delta_of_another_base(delta_case):
    from hypergraphdb_tpu_torch.ops import incremental as inc

    other = inc.DeltaMemtable(delta_case["port"].num_atoms + 1,
                              device="cpu").device()
    with pytest.raises(ValueError, match="delta covers"):
        serve_bfs(delta_case["port"], [0, 1], 1, 4, delta=other,
                  device="cpu")
