"""Sharded serving: the mesh twins of the ``ops/serving`` batch lanes.

The port of ``hypergraphdb_tpu/ops/sharded_serving.py``. Each lane keeps
its single-card result contract, so the serving runtime's collect path
(and its host-side memtable corrections) needs no sharded variant:

- :func:`bfs_serve_batch_sharded`: K-seed BFS over the row-sharded (base
  ∪ delta) pair (``parallel.sharded.bfs_packed_sharded_delta``), the
  compaction also per shard: each shard counts and takes the ``top_r``
  smallest ids of its row range, the counts sum and the windows gather
  and merge into the global ``top_r`` smallest.
- :func:`pattern_serve_batch_sharded`: K conjunctive incident patterns,
  candidate-sharded. The smallest anchor's incidence row (host-gathered
  a lane, its links' target tuples and type labels alongside) splits
  across shards; each tests its slice against the other anchors, then the
  same sum and merge. No device-resident ELL matrix.
- :func:`execute_join_sharded`: the join lane executor, lane-sharded:
  each shard runs ``ops/join.execute_join`` for its K / n_dev lanes
  (relations replicated), and counts, truncation flags and tuple windows
  are gathered along the lane axis.

Counts are int64 (the sums of per-shard counts), ``first_r`` int32
SENTINEL-padded, as the single-card lanes give them. No CUDA kernel of
the port runs here: the reference's programs build on the plain packed
BFS and ``setops.member_mask``, not on its Pallas kernels.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hypergraphdb_tpu_torch.ops.bitfrontier import WORD, popcount
from hypergraphdb_tpu_torch.ops.setops import ELL_MAX_WIDTH, SENTINEL, _bucket
from hypergraphdb_tpu_torch.ops.snapshot import CSRSnapshot
from hypergraphdb_tpu_torch.parallel.sharded import (
    Mesh,
    ShardedDelta,
    ShardedSnapshot,
    _bfs_local,
    all_gather,
    psum,
)


def _merge_first_r(mesh: Mesh, local_first: list, top_r: int) -> torch.Tensor:
    """Gather each shard's ascending (K, k_loc) candidate window and merge
    them into the global ``top_r`` smallest ids, ascending and
    SENTINEL-padded, on the home device."""
    cand = all_gather(mesh, local_first, 1)[0]
    short = top_r - cand.shape[1]
    if short > 0:  # tiny graphs: fewer candidate slots than top_r
        cand = torch.cat([cand, torch.full((cand.shape[0], short),
                                           int(SENTINEL), dtype=cand.dtype,
                                           device=cand.device)], dim=1)
    return torch.sort(cand, dim=1).values[:, :top_r]


def _local_first_r(vis: torch.Tensor, row_start: int, k_loc: int,
                   ) -> torch.Tensor:
    """The ``k_loc`` smallest set ids of each lane of a shard's packed
    (w_loc, K) atom-major bitmap, ascending, SENTINEL-padded: (K, k_loc)
    int32, read in word blocks with a top-k and a merge each."""
    w_loc, K = vis.shape
    dev = vis.device
    shifts = torch.arange(WORD, dtype=torch.int32, device=dev)
    wb = max(1, min(w_loc, (1 << 24) // max(K * WORD, 1)))
    cur = torch.full((K, k_loc), int(SENTINEL), dtype=torch.int32, device=dev)
    for s in range(0, w_loc, wb):
        blk = vis[s : s + wb]
        bits = ((blk[:, None, :] >> shifts[None, :, None]) & 1).bool()
        bits = bits.reshape(-1, K)
        ids = torch.arange(row_start + s * WORD,
                           row_start + s * WORD + bits.shape[0],
                           dtype=torch.int32, device=dev)
        masked = torch.where(bits, ids[:, None], int(SENTINEL))
        top = torch.topk(masked.T, min(k_loc, bits.shape[0]), dim=1,
                         largest=False).values
        cur = torch.sort(torch.cat([cur, top], dim=1), dim=1).values[:, :k_loc]
    return cur


def bfs_serve_batch_sharded(sdev: ShardedSnapshot, sdelta: ShardedDelta,
                            seeds, max_hops: int, top_r: int):
    """The mesh twin of ``ops.serving.bfs_serve_batch``: ``(counts (K,)
    int64, first_r (K, top_r) int32)`` from the row-sharded packed BFS.
    ``seeds`` (K,) int32, pad lanes at ``sdev.num_atoms``: they reach
    nothing, the dummy row being outside every shard's live mask."""
    mesh = sdev.mesh
    vis, _, _ = _bfs_local(sdev, sdelta, seeds, max_hops, with_levels=False)
    k_loc = min(top_r, sdev.n_loc)
    counts = psum(mesh, [popcount(v, axis=0).to(torch.int64) for v in vis])
    firsts = [_local_first_r(v, d * sdev.n_loc, k_loc)
              for v, (_, d, _) in zip(vis, mesh.local_shards())]
    return counts, _merge_first_r(mesh, firsts, top_r)


# ------------------------------------------ candidate-sharded patterns


def pattern_host_rows(snap: CSRSnapshot, anchors: np.ndarray, pad_len: int,
                      n_dev: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side batch assembly for :func:`pattern_serve_batch_sharded`:
    per lane the smallest anchor's incidence row (the candidates), each
    candidate's type and its target tuple, gathered from the snapshot's
    host arrays. The candidate axis rounds up to a multiple of ``n_dev``.
    Returns ``(rows0 (K, L) int32 SENTINEL-padded, row0_types (K, L)
    int32, tgt_tuples (K, L, W) int32 -1-padded)``."""
    anchors = np.asarray(anchors, dtype=np.int64)
    N = snap.num_atoms
    L = max(int(pad_len), 1)
    L = -(-L // n_dev) * n_dev
    a0 = np.clip(anchors[:, 0], 0, N)
    off = snap.inc_offsets
    starts = off[a0].astype(np.int64)
    lens = off[a0 + 1].astype(np.int64) - starts
    lane = np.arange(L, dtype=np.int64)
    have = lane[None, :] < np.minimum(lens, L)[:, None]
    idx = np.minimum(starts[:, None] + lane[None, :],
                     max(len(snap.inc_links) - 1, 0))
    rows0 = np.where(have, snap.inc_links[idx] if len(snap.inc_links)
                     else 0, SENTINEL).astype(np.int32)
    safe = np.where(have, rows0, N).astype(np.int64)  # the dummy row: empty
    row0_types = np.where(have, snap.type_of[safe], -1).astype(np.int32)
    W = _bucket(max(int(snap.arity[: N + 1].max(initial=0)), 1), minimum=2)
    tstart = snap.tgt_offsets[safe].astype(np.int64)
    tlen = snap.tgt_offsets[safe + 1].astype(np.int64) - tstart
    wlane = np.arange(W, dtype=np.int64)
    tvalid = wlane[None, None, :] < tlen[:, :, None]
    tidx = np.minimum(tstart[:, :, None] + wlane[None, None, :],
                      max(len(snap.tgt_flat) - 1, 0))
    tgt = np.where(tvalid, snap.tgt_flat[tidx] if len(snap.tgt_flat)
                   else 0, -1).astype(np.int32)
    return rows0, row0_types, tgt


def pattern_serve_batch_sharded(mesh: Mesh, rows0: np.ndarray,
                                row0_types: np.ndarray,
                                tgt_tuples: np.ndarray, anchors: np.ndarray,
                                type_vec: np.ndarray, top_r: int):
    """The mesh twin of ``ops.serving.pattern_serve_batch``: the
    candidates (host arrays from :func:`pattern_host_rows`, ``L`` a
    multiple of the mesh size) split across shards along L; each tests
    its slice's target tuples against anchors 1..P-1 and filters by the
    types that came along (``type_vec`` < 0: any), then the counts sum
    and the per-shard ``top_r`` windows merge. Returns ``(counts (K,)
    int64, first_r (K, top_r) int32)``."""
    L = rows0.shape[1]
    l_loc = L // mesh.n_dev
    k_loc = min(top_r, max(l_loc, 1))
    anchors = np.ascontiguousarray(anchors, dtype=np.int32)
    type_vec = np.ascontiguousarray(type_vec, dtype=np.int32)
    counts, firsts = [], []
    for _, d, dev in mesh.local_shards():
        cut = slice(d * l_loc, (d + 1) * l_loc)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        r0, rt, tg = put(rows0[:, cut]), put(row0_types[:, cut]), \
            put(tgt_tuples[:, cut])
        anc, tv = put(anchors), put(type_vec)
        mask = r0 != int(SENTINEL)
        for p in range(1, anc.shape[1]):
            mask &= (tg == anc[:, p, None, None]).any(dim=-1)
        mask &= (tv[:, None] < 0) | (rt == tv[:, None])
        counts.append(mask.sum(dim=1, dtype=torch.int64))
        ranked = torch.where(mask, r0, int(SENTINEL))
        firsts.append(torch.topk(ranked, k_loc, dim=1, largest=False).values)
    return psum(mesh, counts), _merge_first_r(mesh, firsts, top_r)


def pattern_sharded_ok(snap: CSRSnapshot) -> bool:
    """Route gate: the host-assembled target tuples keep the single-card
    ELL route's arity cap (wider links take the host path)."""
    N = snap.num_atoms
    return int(snap.arity[: N + 1].max(initial=0)) <= ELL_MAX_WIDTH


# ---------------------------------------------------- lane-sharded joins


def execute_join_sharded(snap: CSRSnapshot, mesh: Mesh, plan,
                         consts: np.ndarray, *, top_r: int = 16,
                         n_real: Optional[int] = None,
                         row_cap: Optional[int] = None,
                         pad_cap: Optional[int] = None,
                         slot_budget: Optional[int] = None,
                         hub_split: bool = True,
                         hub_threshold: Optional[int] = None,
                         factorized: Optional[bool] = None):
    """The mesh twin of ``ops.join.execute_join`` for the serving lanes:
    each shard runs the plan for its K / n_dev lanes (``K`` must divide by
    the mesh size; the serve buckets do) on its device, with the
    executor's pad and row-bucket arithmetic applied to its own lanes.
    Relations are replicated (each shard's device holds the join's CSRs).
    Returns an ``ops.join.JoinExecution`` with the lane axis reassembled
    on the home device: the single-card counts, trunc and tuples
    contract. A left-deep plan only; the caller serves bushy plans on one
    device."""
    from hypergraphdb_tpu_torch.ops.join import (
        DEFAULT_PAD_CAP,
        DEFAULT_ROW_CAP,
        DEFAULT_SLOT_BUDGET,
        JoinExecution,
        execute_join,
    )

    if getattr(plan, "bags", None):
        raise ValueError("execute_join_sharded runs left-deep plans only")
    n_dev = mesh.n_dev
    consts = np.ascontiguousarray(consts, dtype=np.int32)
    K = int(consts.shape[0])
    if K % n_dev:
        raise ValueError(f"lane count {K} must divide by the mesh size "
                         f"{n_dev}")
    k_loc = K // n_dev
    n_real = K if n_real is None else int(n_real)
    counts, trunc, tuples = [], [], []
    hub = syncs = 0
    for _, d, dev in mesh.local_shards():
        base = d * k_loc
        ex = execute_join(
            snap, plan, consts[base : base + k_loc], top_r=top_r,
            n_real=min(max(n_real - base, 0), k_loc),
            row_cap=DEFAULT_ROW_CAP if row_cap is None else row_cap,
            pad_cap=DEFAULT_PAD_CAP if pad_cap is None else pad_cap,
            slot_budget=(DEFAULT_SLOT_BUDGET if slot_budget is None
                         else slot_budget),
            hub_split=hub_split, hub_threshold=hub_threshold,
            factorized=factorized, device=dev)
        counts.append(ex.counts)
        trunc.append(ex.trunc)
        tuples.append(ex.tuples)
        hub += int(ex.hub_lanes)
        syncs += int(ex.host_syncs)
    return JoinExecution(
        order=plan.order, counts=all_gather(mesh, counts, 0)[0],
        trunc=all_gather(mesh, trunc, 0)[0],
        tuples=all_gather(mesh, tuples, 0)[0], hub_lanes=hub,
        host_syncs=syncs)
