"""Batched BFS serving: fixed-shape micro-batches with compact results.

The port of ``bfs_serve_batch_fused`` from ``hypergraphdb_tpu/ops/serving.py``
(without the delta overlay, which comes with the incremental snapshots). A
batch returns per-seed reach counts and the ``top_r`` smallest reached atom
ids, so the host link carries O(K · top_r) per batch instead of O(K · N).

Pad lanes carry the dummy row id (``n_atoms``) as their seed. They keep its
bit (``clear_dummy=False``), so a pad lane counts 1 and lists the dummy row:
well-defined garbage that the caller drops by lane index, lane for lane the
reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from hypergraphdb_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from hypergraphdb_tpu_torch.ops.fused_bfs import (
    DeviceFusedPlan,
    FusedGeom,
    bfs_fused,
    device_fused_plan,
    first_r_from_bitmap,
    plan_supported,
)

#: the seed-batch widths a server compiles for; a batch pads to the first
#: one that holds it
BUCKETS = (64, 256, 1024)


def bfs_serve_batch_fused(plan: DeviceFusedPlan, seeds: torch.Tensor,
                          geom: FusedGeom, max_hops: int, top_r: int):
    """K-seed BFS through the fused hop with on-device compaction. ``seeds``
    is (K,) int32 with K a multiple of 32, pad lanes at ``geom.n_atoms``.
    Returns ``(counts (K,) int32, first_r (K, top_r) int32)``: per-seed
    |visited| (seed included) and the ``top_r`` smallest reached atom ids
    ascending, SENTINEL-padded past the count."""
    visited, _, reach = bfs_fused(plan, seeds, geom, max_hops,
                                  count_edges=False, clear_dummy=False)
    K = seeds.shape[0]
    first_r = first_r_from_bitmap(visited, geom.n_atoms + 1, top_r, K)
    return reach.to(torch.int32), first_r


def serve_bfs(snap, seeds, max_hops: int, top_r: int,
              device: str | torch.device = DEFAULT_DEVICE):
    """Serve a few BFS requests as one bucketed batch: the seeds pad to the
    first of :data:`BUCKETS` that holds them. Returns host arrays
    ``(counts (n,), first_r (n, top_r))`` for the ``n`` requests."""
    dev = resolve_device(device)
    seeds = np.asarray(seeds, dtype=np.int32)
    n = len(seeds)
    bucket = next((b for b in BUCKETS if b >= n), None)
    if bucket is None or n == 0:
        raise ValueError(f"serve_bfs: {n} requests do not fit one bucket "
                         f"of {BUCKETS}")
    reason = plan_supported(snap, bucket)
    if reason is not None:
        raise ValueError(f"serve_bfs: fused path declined: {reason}")
    plan, geom = device_fused_plan(snap, dev)
    padded = np.full(bucket, snap.num_atoms, dtype=np.int32)
    padded[:n] = seeds
    counts, first_r = bfs_serve_batch_fused(
        plan, torch.from_numpy(padded).to(dev), geom, max_hops, top_r)
    return counts[:n].cpu().numpy(), first_r[:n].cpu().numpy()
