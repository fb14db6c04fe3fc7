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
