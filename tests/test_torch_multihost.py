"""``parallel/multihost`` on ``torch.distributed``: the reference's
``local_process_info`` keys without a process group (and its refusal to
fall back to the CPU when no card is visible), and one sharded BFS
over a mesh held by two processes joined through gloo on the CPU (each
holds four shards of an 8-shard mesh; the all-gather and the sum finish
across the processes), equal to the single-process 8-shard run and to the
single-device BFS. The children are joined with a timeout and killed when
it expires, so the case fails rather than hangs.

Tolerance: exact equality."""

import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[3])   # the repository
sys.path.insert(0, sys.argv[4])   # the graph builder's directory
import numpy as np, torch
from hypergraphdb_tpu_torch.core.graph import HyperGraph
from hypergraphdb_tpu_torch.ops.snapshot import CSRSnapshot
from hypergraphdb_tpu_torch.parallel import (
    ShardedSnapshot, bfs_packed_sharded, multihost)
from conftest_graph import random_graph

rank, port = int(sys.argv[1]), int(sys.argv[2])
multihost.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=rank,
                     backend="gloo")
assert multihost.is_multihost()
info = multihost.local_process_info(devices=["cpu"] * 4)
mesh = multihost.global_mesh(devices=["cpu"] * 4)
g = HyperGraph()
nodes = random_graph(g)
snap = CSRSnapshot.pack(g)
sdev = ShardedSnapshot.from_host(snap, mesh)
seeds = np.asarray(nodes[:16], dtype=np.int32)
res = bfs_packed_sharded(sdev, seeds, 3)
print(json.dumps({"info": info, "n_dev": mesh.n_dev, "first": mesh.first_shard,
                  "visited": res.visited.numpy().tolist(),
                  "counts": res.edges_touched.numpy().tolist()}))
import torch.distributed as dist
dist.destroy_process_group()
"""

GRAPH = '''
import numpy as np

def random_graph(g, n_nodes=120, n_links=240, seed=7):
    r = np.random.default_rng(seed)
    nodes = [int(h) for h in g.add_nodes_bulk([f"n{i}" for i in range(n_nodes)])]
    for i in range(n_links):
        ts = r.choice(nodes, size=int(r.integers(1, 5)), replace=False)
        g.add_link([int(t) for t in ts], value=i)
    return nodes
'''


def test_local_process_info_keeps_the_reference_keys(monkeypatch):
    from hypergraphdb_tpu.parallel import multihost as ref
    from hypergraphdb_tpu_torch.parallel import multihost

    info = multihost.local_process_info(devices=["cpu"] * 3)
    assert set(info) == set(ref.local_process_info())
    assert info == {"process_index": 0, "process_count": 1,
                    "local_devices": 3, "global_devices": 3}
    assert not multihost.is_multihost()
    mesh = multihost.global_mesh(devices=["cpu"] * 3)
    assert mesh.n_dev == 3 and mesh.world == 1 and mesh.axis_names == ("shard",)
    # with no card visible, the defaults raise rather than fall back to
    # the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.global_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.local_process_info()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_hold_one_mesh(tmp_path):
    (tmp_path / "conftest_graph.py").write_text(GRAPH)
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(rank), str(port), str(ROOT),
         str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [o["info"]["process_index"] for o in outs] == [0, 1]
    assert all(o["info"]["process_count"] == 2 and o["n_dev"] == 8
               for o in outs)
    assert [o["first"] for o in outs] == [0, 4]
    assert outs[0]["visited"] == outs[1]["visited"]
    assert outs[0]["counts"] == outs[1]["counts"]

    sys.path.insert(0, str(tmp_path))
    try:
        from conftest_graph import random_graph
    finally:
        sys.path.remove(str(tmp_path))
    from hypergraphdb_tpu_torch.core.graph import HyperGraph
    from hypergraphdb_tpu_torch.ops.bitfrontier import bfs_packed
    from hypergraphdb_tpu_torch.ops.snapshot import CSRSnapshot
    from hypergraphdb_tpu_torch.parallel import (
        ShardedSnapshot,
        bfs_packed_sharded,
        make_mesh,
    )

    g = HyperGraph()
    try:
        nodes = random_graph(g)
        snap = CSRSnapshot.pack(g)
    finally:
        g.close()
    seeds = np.asarray(nodes[:16], dtype=np.int32)
    one = bfs_packed_sharded(
        ShardedSnapshot.from_host(snap, make_mesh(["cpu"] * 8)), seeds, 3)
    assert outs[0]["visited"] == one.visited.numpy().tolist()
    assert outs[0]["counts"] == one.edges_touched.numpy().tolist()
    vis, cnt, _ = bfs_packed(snap, seeds, 3, device="cpu")
    W = vis.shape[1]
    assert torch.equal(one.visited[:, :W], vis)
    assert torch.equal(one.edges_touched, cnt)
