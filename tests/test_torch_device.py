"""Device policy and host BFS of the port: entry points default to the card
and raise, never fall back, where there is none; the port's host BFS agrees
with the reference test's set-based host BFS."""

import numpy as np
import pytest
import torch

from hypergraphdb_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from hypergraphdb_tpu_torch.ops import ellbfs, fused_bfs, incremental, setops
from hypergraphdb_tpu_torch.ops.host_bfs import host_bfs
from hypergraphdb_tpu_torch.ops.serving import serve_bfs, serve_pattern
from hypergraphdb_tpu_torch.ops.snapshot import DeviceSnapshot
from tests.test_ellbfs import host_bfs as ref_host_bfs
from tests.test_ellbfs import random_snapshot
from tests.test_torch_snapshot import to_port


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_cuda():
    assert DEFAULT_DEVICE == "cuda"
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize("entry", [
    "bfs_pull", "bfs_pull_fused", "serve_bfs", "device_snapshot",
    "snapshot_device", "ell_targets", "plan_pattern", "and_incident_pattern",
    "serve_pattern", "device_intersect_sorted", "delta_memtable",
    "delta_from_reference",
])
def test_entry_points_raise_without_cuda(no_cuda, entry):
    snap = to_port(random_snapshot(30, 20, 3, seed=1))
    seeds = np.arange(32, dtype=np.int32)
    pairs = [(0, 1), (2, 3)]
    call = {
        "bfs_pull": lambda: ellbfs.bfs_pull(snap, seeds, 1),
        "bfs_pull_fused": lambda: fused_bfs.bfs_pull_fused(snap, seeds, 1),
        "serve_bfs": lambda: serve_bfs(snap, seeds[:5], 1, 4),
        "device_snapshot": lambda: DeviceSnapshot.from_host(snap),
        "snapshot_device": lambda: snap.device(),
        "ell_targets": lambda: setops.ell_targets(snap),
        "plan_pattern": lambda: setops.plan_pattern(snap, pairs),
        "and_incident_pattern": lambda: setops.and_incident_pattern(snap, pairs),
        "serve_pattern": lambda: serve_pattern(snap, pairs, [None, None], 4),
        "device_intersect_sorted": lambda: setops.device_intersect_sorted(
            [seeds, seeds[::2]]),
        "delta_memtable": lambda: incremental.DeltaMemtable(snap.num_atoms),
        "delta_from_reference": lambda: incremental.delta_from_reference(
            {"capacity": snap.num_atoms, "dead": [],
             **{c: seeds[:2] for c in incremental.COLUMNS}}),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


@pytest.mark.parametrize("hops", [1, 3])
def test_host_bfs_matches_reference_host_bfs(hops):
    snap = random_snapshot(200, 160, 5, seed=hops, zipf=True)
    port = to_port(snap)
    for s in (0, 17, 123):
        got, edges = host_bfs(port, s, hops)
        want, want_edges = ref_host_bfs(snap, s, hops)
        assert set(got.tolist()) == want
        assert edges == want_edges
