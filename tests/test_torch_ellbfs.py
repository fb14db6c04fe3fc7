"""Staged pull BFS: the port's host plans against ``build_pull_plans`` and
its ``bfs_pull`` (staged chain, plain K1 on the CPU) against the reference
``bfs_pull``, on the cases of ``test_ellbfs.py``. Tolerance: exact equality
of plans, bitmaps (uint32 view), edge counts and reach counts."""

import numpy as np
import pytest
import torch

from hypergraphdb_tpu.ops import ellbfs as ref_ellbfs
from hypergraphdb_tpu_torch.ops import ellbfs, linemask
from tests.test_ellbfs import host_bfs, random_snapshot
from tests.test_torch_snapshot import to_port


def assert_same_result(ref, res):
    rv = np.asarray(ref.visited_t)
    assert np.array_equal(res.visited_t.numpy().view(np.uint32), rv)
    assert res.edges_touched.dtype == np.int64
    assert np.array_equal(res.edges_touched, ref.edges_touched)
    assert np.array_equal(res.reach_counts.numpy(),
                          np.asarray(ref.reach_counts))


def test_pull_plans_match_reference():
    ref_snap = random_snapshot(300, 250, 12, seed=9, zipf=True)
    ref = ref_ellbfs.build_pull_plans(ref_snap)
    got = ellbfs.build_pull_plans(to_port(ref_snap))
    assert (got.n_atoms, got.n_pad) == (ref.n_atoms, ref.n_pad)
    for a, b in [(got.stage1.levels, ref.stage1.levels),
                 (got.stage2_levels, ref.stage2_levels)]:
        assert len(a) == len(b) > 1  # upper levels exercised
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    assert got.stage1.widths == ref.stage1.widths
    assert got.stage2_widths == ref.stage2_widths
    assert np.array_equal(got.stage1.out_map, ref.stage1.out_map)
    assert np.array_equal(got.out_map, ref.out_map)
    assert np.array_equal(got.inc_deg, ref.inc_deg)
    assert got.total_indices == ref.total_indices


def test_reduce_plan_matches_reference():
    offsets = np.asarray([0, 0, 3, 3, 20])  # empty, 3-row, empty, 17-row
    flat = np.arange(20, dtype=np.int64) % 7
    ref = ref_ellbfs.build_reduce_plan(offsets, flat, 4, zero_row=7, w=4,
                                       w_upper=4)
    got = ellbfs.build_reduce_plan(offsets, flat, 4, zero_row=7, w=4,
                                   w_upper=4)
    assert got.widths == ref.widths and got.concat_size == ref.concat_size
    assert all(np.array_equal(a, b) for a, b in zip(got.levels, ref.levels))
    assert np.array_equal(got.out_map, ref.out_map)


@pytest.mark.parametrize("zipf", [False, True])
@pytest.mark.parametrize("hops", [1, 3])
def test_staged_pull_matches_reference(zipf, hops):
    ref_snap = random_snapshot(400, 300, 4, seed=11 + hops, zipf=zipf)
    seeds = np.random.default_rng(5).integers(0, 400, size=48).astype(np.int32)
    ref = ref_ellbfs.bfs_pull(ref_snap, seeds, hops)
    res = ellbfs.bfs_pull(to_port(ref_snap), seeds, hops, fused=False,
                          device="cpu")
    assert_same_result(ref, res)


def test_duplicate_and_pad_seeds():
    ref_snap = random_snapshot(100, 80, 3, seed=3)
    seeds = np.asarray([5, 5, 5, 17, 100 + 80], dtype=np.int32)  # last = dummy
    ref = ref_ellbfs.bfs_pull(ref_snap, seeds, 2)
    res = ellbfs.bfs_pull(to_port(ref_snap), seeds, 2, fused=False,
                          device="cpu")
    assert_same_result(ref, res)
    reach = res.reach_counts.numpy()
    assert reach[0] == reach[1] == reach[2] and reach[4] == 0


def test_streamed_blocks_and_multiblock_match_host():
    """A tiny plain-version block and several seed blocks: the paths that
    otherwise only run at benchmark scale."""
    ref_snap = random_snapshot(500, 400, 5, seed=21, zipf=True)
    seeds = np.random.default_rng(17).integers(0, 500, size=96).astype(np.int32)
    ref = ref_ellbfs.bfs_pull(ref_snap, seeds, 2, chunk=4, k_block=32)
    port = to_port(ref_snap)
    res = ellbfs.bfs_pull(port, seeds, 2, chunk=4, k_block=32, fused=False,
                          device="cpu")
    assert_same_result(ref, res)
    rows = ellbfs.visited_rows(res, port.num_atoms, lanes=[0, 31, 32, 95])
    for k, row in zip([0, 31, 32, 95], rows):
        want, edges = host_bfs(ref_snap, int(seeds[k]), 2)
        assert set(row.tolist()) == want
        assert res.edges_touched[k] == edges


def test_zero_hops_and_counting_off():
    ref_snap = random_snapshot(60, 50, 3, seed=2)
    seeds = np.arange(3, dtype=np.int32)
    port = to_port(ref_snap)
    for hops, count in [(0, True), (2, False)]:
        ref = ref_ellbfs.bfs_pull(ref_snap, seeds, hops, count_edges=count)
        res = ellbfs.bfs_pull(port, seeds, hops, count_edges=count,
                              fused=False, device="cpu")
        assert_same_result(ref, res)


def test_k_block_validation():
    port = to_port(random_snapshot(50, 40, 3, seed=2))
    for bad in (48, 0):
        with pytest.raises(ValueError, match="k_block"):
            ellbfs.bfs_pull(port, np.arange(8, dtype=np.int32), 1,
                            k_block=bad, device="cpu")


def test_plans_cached():
    port = to_port(random_snapshot(50, 40, 3, seed=1))
    assert ellbfs.plans_for(port) is ellbfs.plans_for(port)


def test_bitdot_is_exact_past_float32():
    """Counts whose sums pass 2^24 stay exact (the reference's float32 sum
    would round)."""
    packed = torch.full((5, 1), -1, dtype=torch.int32)  # all 32 bits set
    weight = torch.tensor([2**24 + 1, 3, 2**24 + 7, 0, 1], dtype=torch.int32)
    got = ellbfs.bitdot(packed, weight)
    assert got.dtype == torch.int64
    assert (got == 2**25 + 12).all()
    rows = torch.tensor([0, 2], dtype=torch.int64)
    assert (ellbfs.bitdot(packed, weight, rows) == 2**25 + 8).all()
    assert (ellbfs.bitdot(packed) == 5).all()


# ------------------------------------------------ line masks through K1


@pytest.mark.parametrize("hops", [1, 2, 3])
@pytest.mark.parametrize("case", ["zipf", "pad_seeds", "sparse_seeds",
                                  "saturating"])
def test_masked_staged_pull_matches_reference(case, hops):
    """The staged chain with masks threaded through every level and the
    visited update equals the reference, and the visited mask entering
    every hop is exactly ``line_mask`` of the bitmap."""
    if case == "zipf":
        ref_snap = random_snapshot(300, 250, 6, seed=9, zipf=True)
        seeds = np.random.default_rng(2).integers(0, 300, size=64)
    elif case == "pad_seeds":
        ref_snap = random_snapshot(100, 80, 3, seed=3)
        seeds = np.asarray([5, 5, 17, 180])  # 180: the dummy row
    elif case == "sparse_seeds":
        ref_snap = random_snapshot(1500, 450, 3, seed=5)
        seeds = np.asarray([11])
    else:  # dense: every node row fills with ones within three hops
        ref_snap = random_snapshot(40, 300, 4, seed=12)
        seeds = np.arange(32)
    seeds = seeds.astype(np.int32)
    port = to_port(ref_snap)
    ref = ref_ellbfs.bfs_pull(ref_snap, seeds, hops)
    K = -(-len(seeds) // 32) * 32
    padded = np.full(K, port.num_atoms, np.int32)
    padded[: len(seeds)] = seeds
    seen = []

    def hook(h, visited, vmask):
        assert torch.equal(vmask, linemask.line_mask(visited)), f"hop {h}"
        seen.append(h)

    vt, s_ins, reach = ellbfs._bfs_pull_device(
        ellbfs.device_plans(port, "cpu"), ellbfs.plans_for(port),
        torch.from_numpy(padded), hops, ellbfs.PLAIN_CHUNK, True,
        hop_hook=hook)
    assert seen == list(range(hops + 1))
    assert np.array_equal(vt.numpy().view(np.uint32), np.asarray(ref.visited_t))
    assert np.array_equal(reach.numpy()[: len(seeds)],
                          np.asarray(ref.reach_counts))
    assert np.array_equal(s_ins[-1].numpy()[: len(seeds)], ref.edges_touched)
    res = ellbfs.bfs_pull(port, seeds, hops, fused=False, device="cpu")
    assert_same_result(ref, res)
    if case == "saturating" and hops == 3:
        assert (vt[:40].numpy().view(np.uint32) == 0xFFFFFFFF).all()
