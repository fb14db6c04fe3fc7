"""K2 fused pull BFS: the port's fused plan against the reference's
``build_fused_plan``, its fused path (plain K2 on the CPU) against
``pallas_bfs.bfs_pull_fused(..., interpret=True)`` and against the port's
own staged chain, with zipf hubs, pad seeds and empty frontiers. Tolerance:
exact equality of bitmaps (uint32 view), edge counts and reach counts."""

import numpy as np
import pytest
import torch

from hypergraphdb_tpu.ops import ellbfs as ref_ellbfs
from hypergraphdb_tpu.ops import pallas_bfs as ref_fused
from hypergraphdb_tpu.ops.snapshot import CSRSnapshot as JaxSnapshot
from hypergraphdb_tpu_torch.ops import ellbfs, fused_bfs
from tests.test_ellbfs import random_snapshot
from tests.test_torch_snapshot import to_port


def _ref_fused(snap, seeds, hops, count_edges=True):
    vt, s_ins, reach = ref_fused.bfs_pull_fused(
        snap, seeds, hops, count_edges=count_edges, interpret=True)
    return np.asarray(vt), [np.asarray(s) for s in s_ins], np.asarray(reach)


def _port_fused(snap, seeds, hops, count_edges=True):
    vt, s_ins, reach = fused_bfs.bfs_pull_fused(
        snap, seeds, hops, count_edges=count_edges, device="cpu")
    return (vt.numpy().view(np.uint32), [s.numpy() for s in s_ins],
            reach.numpy())


def _hub_snapshot(hub_arity=500, n_nodes=520, n_links=200, seed=0):
    """Nodes, one hub link over the first ``hub_arity`` nodes, and random
    small links: the hub row's fused adjacency spans many chunks."""
    r = np.random.default_rng(seed)
    N = n_nodes + 1 + n_links
    is_link = np.zeros(N, dtype=bool)
    is_link[n_nodes:] = True
    arities = np.concatenate([[hub_arity], r.integers(2, 5, size=n_links)])
    offsets = np.zeros(N + 1, dtype=np.int64)
    offsets[n_nodes + 1 :] = np.cumsum(arities)
    flat = np.concatenate([np.arange(hub_arity),
                           r.integers(0, n_nodes, size=int(arities[1:].sum()))])
    return JaxSnapshot.from_tables(np.zeros(N, np.int32), is_link, offsets, flat)


def test_fused_plan_matches_reference_composition():
    ref_snap = random_snapshot(300, 260, 6, seed=4, zipf=True)
    port = to_port(ref_snap)
    ref = ref_fused.build_fused_plan(ref_snap)
    got = fused_bfs.build_fused_plan(port)
    g, rg = got.geom, ref.geom
    assert g.total_entries == rg.total_entries > 0
    # flatten the reference's per-segment windows into the row-major list
    n_c = ref.blk_off[:, -1]
    flat = np.concatenate([ref.idx[s, : n_c[s] * rg.w] for s in range(rg.n_seg)])
    rows = np.concatenate([ref.chunk_rows[s, : n_c[s]] + s * rg.nb * ref_fused.B
                           for s in range(rg.n_seg)])
    assert g.n_chunks == len(rows)
    flat = np.where(flat == rg.zero_row, g.zero_row, flat)
    assert np.array_equal(got.idx, flat)
    per_row = np.diff(got.row_chunk_starts)
    assert np.array_equal(np.repeat(np.arange(g.n_rows), per_row), rows)
    assert np.array_equal(got.inc_deg[: port.num_atoms + 1],
                          ref.inc_deg[: port.num_atoms + 1])


def test_fused_plan_work_items_split_hub_rows(monkeypatch):
    monkeypatch.setattr(fused_bfs, "ITEM_CHUNKS", 4)
    port = to_port(_hub_snapshot())
    plan = fused_bfs.build_fused_plan(port)
    g = plan.geom
    spans = np.diff(plan.item_off)
    assert (spans >= 0).all() and (spans <= 4).all()
    assert np.array_equal(np.unique(plan.item_row), np.arange(g.n_rows))
    assert (np.diff(plan.item_row) >= 0).all()
    # each row's items tile exactly its chunk range
    first = np.searchsorted(plan.item_row, np.arange(g.n_rows))
    assert np.array_equal(plan.item_off[first], plan.row_chunk_starts[:-1])
    assert np.bincount(plan.item_row).max() > 1  # the hub row is split
    assert plan.item_off[-1] == g.n_chunks


@pytest.mark.parametrize("hops", [1, 3])
@pytest.mark.parametrize("k", [32, 64])
def test_fused_matches_reference_and_staged(hops, k):
    ref_snap = random_snapshot(150, 300, 4, seed=7, zipf=True)
    port = to_port(ref_snap)
    seeds = np.random.default_rng(3).integers(
        0, port.num_atoms, size=k).astype(np.int32)
    rvt, rs, rreach = _ref_fused(ref_snap, seeds, hops)
    vt, s_ins, reach = _port_fused(port, seeds, hops)
    assert np.array_equal(vt, rvt)
    assert len(s_ins) == len(rs) == hops
    for a, b in zip(s_ins, rs):
        assert np.array_equal(a, b.astype(np.int64))
    assert np.array_equal(reach, rreach.astype(np.int64))
    staged = ellbfs.bfs_pull(port, seeds, hops, k_block=k, fused=False,
                             device="cpu")
    assert np.array_equal(staged.visited_t.numpy().view(np.uint32), vt)
    assert np.array_equal(staged.edges_touched, s_ins[-1])


def test_fused_hub_graph_matches_staged_reference():
    """The reference declines this hub (SMEM window) and serves it staged;
    the port's fused path splits it over work items instead."""
    ref_snap = _hub_snapshot()
    assert "SMEM" in ref_fused.plan_supported(ref_snap, 64)
    port = to_port(ref_snap)
    assert fused_bfs.plan_supported(port, 64) is None
    seeds = np.asarray([0, 3, 510, 519] + [7] * 28, dtype=np.int32)
    ref = ref_ellbfs.bfs_pull(ref_snap, seeds, 2)
    res = ellbfs.bfs_pull(port, seeds, 2, device="cpu")
    assert np.array_equal(res.visited_t.numpy().view(np.uint32),
                          np.asarray(ref.visited_t))
    assert np.array_equal(res.edges_touched, ref.edges_touched)
    assert np.array_equal(res.reach_counts.numpy(), np.asarray(ref.reach_counts))
    assert int(res.reach_counts[0]) >= 500


def test_fused_duplicate_pad_and_empty_seeds():
    ref_snap = random_snapshot(80, 160, 4, seed=1, zipf=True)
    port = to_port(ref_snap)
    n = port.num_atoms
    seeds = np.full(32, n, dtype=np.int32)
    seeds[:4] = [5, 5, 5, 17]
    rvt, rs, rreach = _ref_fused(ref_snap, seeds, 2)
    vt, s_ins, reach = _port_fused(port, seeds, 2)
    assert np.array_equal(vt, rvt)
    assert np.array_equal(reach, rreach)
    assert reach[0] == reach[1] == reach[2] and not reach[4:].any()
    # every seed the dummy row: nothing reached, nothing counted
    empty = np.full(32, n, dtype=np.int32)
    vt, s_ins, reach = _port_fused(port, empty, 2)
    assert not vt.any() and not reach.any() and not s_ins[-1].any()


def test_fused_count_edges_off():
    port = to_port(random_snapshot(50, 100, 3, seed=6))
    seeds = np.arange(32, dtype=np.int32)
    vt, s_ins, reach = _port_fused(port, seeds, 2, count_edges=False)
    assert s_ins == []
    ref = ellbfs.bfs_pull(port, seeds, 2, k_block=32, fused=False,
                          count_edges=False, device="cpu")
    assert np.array_equal(reach, ref.reach_counts.numpy())


def test_fused_hop_plain_small_blocks_and_out_buffer():
    """The plain hop streamed in tiny chunk blocks (rows crossing block
    edges) equals one block, and writes into the given second buffer."""
    port = to_port(_hub_snapshot(hub_arity=90, n_nodes=100, n_links=50))
    plan, geom = fused_bfs.device_fused_plan(port, "cpu")
    r = np.random.default_rng(0)
    old = torch.from_numpy(r.integers(0, 2**32, size=(geom.n_rows, 3),
                                      dtype=np.uint64).astype(np.uint32)
                           .view(np.int32))
    old[geom.zero_row] = 0
    whole = fused_bfs.fused_hop_plain(old, plan)
    out = torch.zeros_like(old)
    small = fused_bfs.fused_hop_plain(old, plan, out=out, chunk=3)
    assert small.data_ptr() == out.data_ptr()
    assert torch.equal(whole, small)
    assert torch.equal(fused_bfs.fused_hop(old, plan), whole)
    with pytest.raises(ValueError, match="second buffer"):
        fused_bfs.fused_hop(old, plan, out=old)


def test_budget_decline_falls_back_to_staged(monkeypatch):
    ref_snap = random_snapshot(100, 120, 5, seed=8, zipf=True)
    port = to_port(ref_snap)
    monkeypatch.setattr(fused_bfs, "FUSED_INDEX_BUDGET", 64)
    reason = fused_bfs.plan_supported(port, 64)
    assert reason is not None and "budget" in reason
    assert fused_bfs.fused_ready(port, 64) is False
    assert fused_bfs.plan_supported(port, 48) is not None  # not % 32
    with pytest.raises(ValueError, match="declined"):
        fused_bfs.fused_plans_for(port)
    seeds = np.arange(32, dtype=np.int32)
    res = ellbfs.bfs_pull(port, seeds, 2, device="cpu")
    ref = ref_ellbfs.bfs_pull(ref_snap, seeds, 2)
    assert np.array_equal(res.visited_t.numpy().view(np.uint32),
                          np.asarray(ref.visited_t))


def test_fused_traffic_model_counts_real_entries():
    port = to_port(random_snapshot(50, 100, 4, seed=0))
    geom = fused_bfs.fused_plans_for(port).geom
    per_hop = fused_bfs.fused_bytes_per_hop(geom, 4096)
    assert per_hop > geom.total_entries * 512  # gathered 512-byte rows
    assert geom.total_entries > 0
    assert fused_bfs.fused_index_bytes(port) == geom.n_chunks * geom.w * 4
