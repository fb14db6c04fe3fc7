"""Batched serving: fixed-shape micro-batches with compact results.

The port of ``bfs_serve_batch_fused`` and ``pattern_serve_batch`` from
``hypergraphdb_tpu/ops/serving.py`` (without the delta overlay, which comes
with the incremental snapshots). A batch returns per-request counts and the
``top_r`` smallest result ids, so the host link carries O(K · top_r) per
batch instead of O(K · N).

Pad lanes carry the dummy row id (``n_atoms``). A BFS pad lane keeps its
seed bit (``clear_dummy=False``), so it counts 1 and lists the dummy row; a
pattern pad lane has an empty incidence row and counts 0. Both are
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
from hypergraphdb_tpu_torch.ops.setops import (
    SENTINEL,
    compact,
    ell_targets,
    incident_intersection_ell,
)
from hypergraphdb_tpu_torch.ops.snapshot import DeviceSnapshot

#: the request-batch widths a server runs; a batch pads to the first one
#: that holds it
BUCKETS = (64, 256, 1024)
#: ``type_vec`` lane value meaning "no type constraint for this request"
NO_TYPE = -1
#: a served pattern's base-row budget: the gathered row width of every
#: pattern batch (the reference runtime's ``ServeConfig.pattern_pad``)
PATTERN_PAD = 128


def _bucket_for(n: int, what: str) -> int:
    bucket = next((b for b in BUCKETS if b >= n), None)
    if bucket is None or n == 0:
        raise ValueError(f"{what}: {n} requests do not fit one bucket of "
                         f"{BUCKETS}")
    return bucket


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
    bucket = _bucket_for(n, "serve_bfs")
    reason = plan_supported(snap, bucket)
    if reason is not None:
        raise ValueError(f"serve_bfs: fused path declined: {reason}")
    plan, geom = device_fused_plan(snap, dev)
    padded = np.full(bucket, snap.num_atoms, dtype=np.int32)
    padded[:n] = seeds
    counts, first_r = bfs_serve_batch_fused(
        plan, torch.from_numpy(padded).to(dev), geom, max_hops, top_r)
    return counts[:n].cpu().numpy(), first_r[:n].cpu().numpy()


def pattern_serve_batch(dev: DeviceSnapshot, tgt_ell: torch.Tensor,
                        anchors: torch.Tensor, type_vec: torch.Tensor,
                        pad_len: int, top_r: int):
    """K conjunctive incident patterns with a type filter per request
    (``type_vec`` lane ``NO_TYPE`` = any type), through the ELL route.
    ``anchors`` (K, P) int32 holds each request's smallest row first.
    Returns ``(counts (K,) int32, first_r (K, top_r) int32)``: per request
    the survivor count and the first ``top_r`` matching link ids ascending,
    SENTINEL-padded."""
    rows0, mask = incident_intersection_ell(dev, tgt_ell, anchors, pad_len)
    safe = torch.where(rows0 == int(SENTINEL), 0, rows0)
    want = type_vec[:, None]
    mask = mask & ((want < 0) | (dev.type_of[safe] == want))
    return compact(rows0, mask, top_r)


def serve_pattern(snap, anchor_lists, type_handles, top_r: int,
                  device: str | torch.device = DEFAULT_DEVICE):
    """Serve a few conjunctive-pattern requests (anchor tuples of one
    arity, a type handle or ``None`` each) as one bucketed batch: anchors
    smallest-row-first, pad lanes at the dummy row, base rows gathered at
    :data:`PATTERN_PAD`. Returns host arrays ``(counts (n,), first_r (n,
    top_r))``.

    Raises ``ValueError`` for a request the device batch cannot hold: an
    anchor outside the id space, a base row longer than the pad, or a
    snapshot with links too wide for the ELL matrix. A server answers those
    on the host."""
    dev = resolve_device(device)
    anchor_lists = [np.asarray(a, dtype=np.int64) for a in anchor_lists]
    n = len(anchor_lists)
    if len(type_handles) != n:
        raise ValueError(f"serve_pattern: {n} anchor tuples but "
                         f"{len(type_handles)} type handles")
    bucket = _bucket_for(n, "serve_pattern")
    P = len(anchor_lists[0])
    if P == 0 or any(len(a) != P for a in anchor_lists):
        raise ValueError("serve_pattern: anchor tuples must share one "
                         "non-zero arity")
    ell = ell_targets(snap, dev)
    if ell is None:
        raise ValueError("serve_pattern: the snapshot's links are too wide "
                         "for the ELL matrix")
    N, off = snap.num_atoms, snap.inc_offsets
    anchors = np.full((bucket, P), N, dtype=np.int32)
    type_vec = np.full(bucket, NO_TYPE, dtype=np.int32)
    for lane, (a, th) in enumerate(zip(anchor_lists, type_handles)):
        if a.min() < 0 or a.max() >= N:
            raise ValueError(f"serve_pattern: request {lane} names an atom "
                             f"outside [0, {N})")
        lens = off[a + 1].astype(np.int64) - off[a]
        order = np.argsort(lens, kind="stable")
        if lens[order[0]] > PATTERN_PAD:
            raise ValueError(f"serve_pattern: request {lane}'s base row has "
                             f"{lens[order[0]]} links, over the pad of "
                             f"{PATTERN_PAD}")
        anchors[lane] = a[order]
        if th is not None:
            type_vec[lane] = int(th)
    counts, first_r = pattern_serve_batch(
        snap.device(dev), ell, torch.from_numpy(anchors).to(dev),
        torch.from_numpy(type_vec).to(dev), PATTERN_PAD, top_r)
    return counts[:n].cpu().numpy(), first_r[:n].cpu().numpy()
