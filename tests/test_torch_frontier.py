"""Dense frontier BFS: the port's ``bfs_levels`` and ``frontier_edge_counts``
against the reference's on the same snapshot. Tolerance: exact equality."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from hypergraphdb_tpu.ops import frontier as ref_frontier
from hypergraphdb_tpu.ops.snapshot import DeviceSnapshot as JaxDevice
from hypergraphdb_tpu_torch.ops import frontier
from hypergraphdb_tpu_torch.ops.snapshot import DeviceSnapshot
from tests.test_ellbfs import host_bfs, random_snapshot
from tests.test_torch_snapshot import to_port


@pytest.mark.parametrize("hops", [1, 3])
@pytest.mark.parametrize("zipf", [False, True])
def test_bfs_levels_matches_reference(hops, zipf):
    ref_snap = random_snapshot(120, 100, 4, seed=hops, zipf=zipf)
    seeds = np.random.default_rng(0).integers(0, 120, size=8).astype(np.int32)
    levels_r, visited_r = ref_frontier.bfs_levels(
        JaxDevice.from_host(ref_snap), jnp.asarray(seeds), hops)
    dev = DeviceSnapshot.from_host(to_port(ref_snap), device="cpu")
    levels, visited = frontier.bfs_levels(dev, torch.from_numpy(seeds), hops)
    assert levels.dtype == torch.int32 and visited.dtype == torch.bool
    assert np.array_equal(levels.numpy(), np.asarray(levels_r))
    assert np.array_equal(visited.numpy(), np.asarray(visited_r))


def test_frontier_edge_counts_match_reference_and_host():
    ref_snap = random_snapshot(150, 120, 4, seed=5, zipf=True)
    seeds = np.arange(0, 150, 19, dtype=np.int32)
    want = ref_frontier.frontier_edge_counts(
        JaxDevice.from_host(ref_snap), jnp.asarray(seeds), 2)
    dev = DeviceSnapshot.from_host(to_port(ref_snap), device="cpu")
    got = frontier.frontier_edge_counts(dev, torch.from_numpy(seeds), 2)
    assert np.array_equal(got.numpy(), np.asarray(want))
    for k, s in enumerate(seeds.tolist()):
        assert int(got[k]) == host_bfs(ref_snap, s, 2)[1]


def test_expand_frontier_batched_and_single():
    dev = DeviceSnapshot.from_host(
        to_port(random_snapshot(40, 30, 3, seed=2)), device="cpu")
    f = torch.zeros((2, dev.num_atoms + 1), dtype=torch.bool)
    f[0, 3] = f[1, 7] = True
    both = frontier.expand_frontier(dev, f)
    assert torch.equal(both[1], frontier.expand_frontier(dev, f[1]))
    assert not both[:, dev.num_atoms].any()


@pytest.mark.parametrize("pad", [128, 4096])
def test_dense_sweep_skips_padding(pad):
    """A snapshot padded coarsely (the snapshot manager pads to 2^19) and a
    delta in a large bucket: both carry their real entry counts, past
    which every entry is padding into the dummy row; the sweeps scatter
    only those, and the BFS equals the reference's over the same padded
    arrays (its scatter runs every pad entry into the dummy row, where a
    card's atomics serialise)."""
    from hypergraphdb_tpu.ops import incremental as ref_inc
    from hypergraphdb_tpu_torch.ops import incremental as inc
    from hypergraphdb_tpu_torch.ops.snapshot import CSRSnapshot

    ref_snap = random_snapshot(150, 120, 4, seed=5, zipf=True)
    port = to_port(ref_snap)
    r = np.random.default_rng(2)
    N = port.num_atoms
    flat = port.tgt_flat[: port.n_edges_tgt]
    snap = CSRSnapshot.from_tables(port.type_of[:N], port.is_link[:N],
                                   port.tgt_offsets[: N + 1], flat,
                                   pad_multiple=pad)
    dev = snap.device("cpu")
    assert len(snap.inc_links) % pad == 0
    assert (dev.n_inc, dev.n_tgt) == (snap.n_edges_inc, snap.n_edges_tgt)
    assert (dev.to("cpu").n_inc, dev.to("cpu").n_tgt) == (dev.n_inc, dev.n_tgt)
    mt = inc.DeltaMemtable(N, bucket_min=1024, device="cpu")
    for h in range(140, 150):
        mt.add_link(h, r.integers(0, 150, size=3))
    delta = mt.device()
    assert delta.inc_links.shape[0] == 1024
    assert (delta.n_inc, delta.n_tgt) == (30, 30)
    for holder in (dev, delta):  # past the counts, padding alone
        for name, n in (("inc_links", holder.n_inc),
                        ("tgt_flat", holder.n_tgt)):
            col = getattr(holder, name)
            assert 0 < n < len(col) and bool((col[n:] == N).all())
    seeds = r.integers(0, 150, size=16).astype(np.int32)
    lv, vis = inc.bfs_levels_delta(dev, delta, torch.from_numpy(seeds), 3)
    ref_dev = JaxDevice.from_host(ref_snap)
    ref_delta = ref_inc.DeviceDelta(
        **{c: jnp.asarray(getattr(delta, c).numpy())
           for c in inc.COLUMNS + ("dead",)})
    lv_r, vis_r = ref_inc.bfs_levels_delta(ref_dev, ref_delta,
                                           jnp.asarray(seeds), 3)
    assert np.array_equal(lv.numpy(), np.asarray(lv_r))
    assert np.array_equal(vis.numpy(), np.asarray(vis_r))
    lv_s, vis_s = frontier.bfs_levels(dev, torch.from_numpy(seeds), 3)
    lv_f, vis_f = ref_frontier.bfs_levels(ref_dev, jnp.asarray(seeds), 3)
    assert np.array_equal(vis_s.numpy(), np.asarray(vis_f))
