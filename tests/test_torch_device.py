"""Device policy and host BFS of the port: entry points default to the card
and raise, never fall back, where there is none; the port's host BFS agrees
with the reference test's set-based host BFS."""

import numpy as np
import pytest
import torch

from hypergraphdb_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from hypergraphdb_tpu_torch.ops import ellbfs, fused_bfs
from hypergraphdb_tpu_torch.ops.host_bfs import host_bfs
from hypergraphdb_tpu_torch.ops.serving import serve_bfs
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


@pytest.mark.parametrize("entry", ["bfs_pull", "bfs_pull_fused", "serve_bfs",
                                   "device_snapshot"])
def test_entry_points_raise_without_cuda(no_cuda, entry):
    snap = to_port(random_snapshot(30, 20, 3, seed=1))
    seeds = np.arange(32, dtype=np.int32)
    call = {
        "bfs_pull": lambda: ellbfs.bfs_pull(snap, seeds, 1),
        "bfs_pull_fused": lambda: fused_bfs.bfs_pull_fused(snap, seeds, 1),
        "serve_bfs": lambda: serve_bfs(snap, seeds[:5], 1, 4),
        "device_snapshot": lambda: DeviceSnapshot.from_host(snap),
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
