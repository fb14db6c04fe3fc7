"""Batched serving: fixed-shape micro-batches with compact results.

The port of ``bfs_serve_batch``, ``bfs_serve_batch_fused`` and
``pattern_serve_batch`` from ``hypergraphdb_tpu/ops/serving.py``. A batch
returns per-request counts and the ``top_r`` smallest result ids, so the
host link carries O(K · top_r) per batch instead of O(K · N).

A BFS batch over a base snapshot and a delta (``ops/incremental.py``) takes
one of the reference runtime's two routes (``serve/runtime.py:685-760``),
chosen by gates checked before anything launches: while a tombstone is
pending, the dense base ∪ delta sweep (:func:`bfs_serve_batch`); otherwise
the fused hop with the delta's overlay through K1, unless the fused plan
declines the bucket, which sends the batch to the dense sweep too.

Pad lanes carry the dummy row id (``n_atoms``). A BFS pad lane keeps its
seed bit (``clear_dummy=False``), so it counts 1 and lists the dummy row; a
pattern pad lane has an empty incidence row and counts 0. Both are
well-defined garbage that the caller drops by lane index, lane for lane the
reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from hypergraphdb_tpu_torch import verify as hgverify
from hypergraphdb_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from hypergraphdb_tpu_torch.ops import incremental
from hypergraphdb_tpu_torch.ops.fused_bfs import (
    DeltaOverlayPlan,
    DeviceFusedPlan,
    FusedGeom,
    bfs_fused,
    first_r_from_bitmap,
    serve_fused_kwargs,
)
from hypergraphdb_tpu_torch.ops.incremental import DeviceDelta
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


@hgverify.entry(
    shapes=lambda device, seed: (hgverify.dev_snapshot_exemplar(device, seed),
                                 hgverify.device_delta_exemplar(device, seed),
                                 hgverify.seeds_exemplar(device, seed, 8)),
    statics={"max_hops": 2, "top_r": 4},
)
def bfs_serve_batch(dev: DeviceSnapshot, delta: DeviceDelta,
                    seeds: torch.Tensor, max_hops: int, top_r: int):
    """K-seed BFS over base ∪ delta by the dense sweep
    (``incremental.bfs_levels_delta`` semantics: tombstones honoured),
    ``incremental.DENSE_LANE_BLOCK`` seed lanes at a time, each block
    compacted on the device before the next runs. ``seeds`` is (K,) int32,
    pad lanes at ``dev.num_atoms``. Returns ``(counts (K,) int32, first_r
    (K, top_r) int32)``: per-seed |visited| (the live seed included, a dead
    seed 0) and the ``top_r`` smallest reached atom ids ascending,
    SENTINEL-padded."""
    K, n1 = seeds.shape[0], dev.type_of.shape[0]
    counts = torch.empty(K, dtype=torch.int32, device=seeds.device)
    first_r = torch.empty((K, top_r), dtype=torch.int32, device=seeds.device)
    block = incremental.DENSE_LANE_BLOCK
    for s in range(0, K, block):
        visited, _ = incremental.bfs_delta_lanes(dev, delta,
                                                 seeds[s : s + block],
                                                 max_hops)
        e = s + visited.shape[1]
        counts[s:e] = visited.sum(0, dtype=torch.int32)
        first_r[s:e] = first_r_from_bitmap(visited, n1, top_r, e - s,
                                           packed=False)
    return counts, first_r


@hgverify.entry(
    shapes=hgverify.fused_args,
    statics={"max_hops": 2, "top_r": 4},
)
def bfs_serve_batch_fused(plan: DeviceFusedPlan, seeds: torch.Tensor,
                          geom: FusedGeom, max_hops: int, top_r: int,
                          overlay: DeltaOverlayPlan | None = None):
    """K-seed BFS through the fused hop with on-device compaction, the
    delta's edges riding ``overlay``. ``seeds`` is (K,) int32 with K a
    multiple of 32, pad lanes at ``geom.n_atoms``. Returns ``(counts (K,)
    int32, first_r (K, top_r) int32)``: per-seed |visited| (seed included)
    and the ``top_r`` smallest reached atom ids ascending, SENTINEL-padded
    past the count."""
    visited, _, reach = bfs_fused(plan, seeds, geom, max_hops,
                                  count_edges=False, clear_dummy=False,
                                  overlay=overlay)
    K = seeds.shape[0]
    first_r = first_r_from_bitmap(visited, geom.n_atoms + 1, top_r, K)
    return reach.to(torch.int32), first_r


def serve_bfs(snap, seeds, max_hops: int, top_r: int,
              delta: DeviceDelta | None = None,
              device: str | torch.device = DEFAULT_DEVICE):
    """Serve a few BFS requests as one bucketed batch over the base ``snap``
    and, when given, a ``delta`` on the same device: the seeds pad to the
    first of :data:`BUCKETS` that holds them. Returns host arrays ``(counts
    (n,), first_r (n, top_r))`` for the ``n`` requests.

    The route is decided before any launch and counted in
    ``serve_bfs.routes``: a pending tombstone sends the batch to the dense
    sweep, as does a bucket the fused plan declines when there is a delta;
    otherwise the fused hop serves it, the delta riding its overlay.
    Without a delta a declined bucket raises ``ValueError``."""
    dev = resolve_device(device)
    seeds = np.asarray(seeds, dtype=np.int32)
    n = len(seeds)
    bucket = _bucket_for(n, "serve_bfs")
    if delta is not None and (delta.n_atoms != snap.num_atoms or delta.device
                              != torch.empty(0, device=dev).device):
        raise ValueError(f"serve_bfs: the delta covers {delta.n_atoms} ids on "
                         f"{delta.device}, the base {snap.num_atoms} on {dev}")
    fused = None
    if delta is None or not delta.has_tombstones():
        fused = serve_fused_kwargs(snap, delta, bucket, dev)
        if isinstance(fused, str):
            if delta is None:
                raise ValueError(f"serve_bfs: fused path declined: {fused}")
            fused = None
    padded = np.full(bucket, snap.num_atoms, dtype=np.int32)
    padded[:n] = seeds
    seeds_t = torch.from_numpy(padded).to(dev)
    if fused is not None:
        route = "fused"
        counts, first_r = bfs_serve_batch_fused(
            fused["plan"], seeds_t, fused["geom"], max_hops, top_r,
            overlay=fused["overlay"])
    else:
        route = "dense"
        counts, first_r = bfs_serve_batch(snap.device(dev), delta, seeds_t,
                                          max_hops, top_r)
    serve_bfs.routes[route] += 1
    return counts[:n].cpu().numpy(), first_r[:n].cpu().numpy()


#: batches served by each route since the counts were last set to 0
serve_bfs.routes = {"fused": 0, "dense": 0}


@hgverify.entry(
    shapes=lambda device, seed: (
        hgverify.dev_snapshot_exemplar(device, seed),
        hgverify.ell_exemplar(device, seed),
        hgverify.tensor(hgverify.pattern_anchors(seed), device),
        hgverify.pattern_type_vec(device)),
    statics={"pad_len": 8, "top_r": 4},
)
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
