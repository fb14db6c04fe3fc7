"""Sorted-set operators: the conjunctive-pattern lane and the n-way sorted
intersection.

The port of ``hypergraphdb_tpu/ops/setops.py``. The
conjunctive pattern ``And(type, incident(a), incident(b), ...)`` gathers the
smallest anchor's incidence row per query into a (K, pad) SENTINEL-padded
matrix and tests every candidate link against the other anchors: through
the ELL target matrix (one W-wide row compare per candidate) when every
link is at most :data:`ELL_MAX_WIDTH` wide, else by a binary search straight
into the incidence CSR (the zigzag route). None of it is a TPU kernel in the
reference; it is plain PyTorch here.

The value pushdown (:func:`incident_value_pattern`,
:func:`incident_value_range`) adds a predicate on each candidate's value
rank to the ELL route. Ranks compare as the port's rank words (one int64
per 64-bit rank, ``ops/snapshot.rank_words``); bounds are given as 64-bit
ranks. For variable-width kinds a rank tie cannot decide the predicate: tied
candidates come back in a separate tie mask, never in the definite one.

:func:`device_intersect_sorted` is the planner's large-intersection step.
On the card every call with more than one array launches K3
(``ops/membership.py``) on the arrays at their real lengths; on the CPU it
runs K3's plain version, :func:`intersect_mask_ragged`. Nothing falls back
from the one to the other.

Conventions: ids are int32, sorted ascending per row, padded with
:data:`SENTINEL` (int32 max) so padding stays sorted and never matches.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from hypergraphdb_tpu_torch import verify as hgverify
from hypergraphdb_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from hypergraphdb_tpu_torch.ops.snapshot import (
    CSRSnapshot,
    DeviceSnapshot,
    rank_word,
    rank_words,
)

SENTINEL = np.int32(np.iinfo(np.int32).max)

#: arity cap for the dense ELL targets matrix, one module-wide constant: the
#: matrix is cached on the snapshot, so differing caps would alias entries
ELL_MAX_WIDTH = 64
#: bytes of the (queries, pad, W) ELL gather transient above which
#: :func:`incident_intersection_ell` streams its queries in blocks
ELL_BLOCK_BYTES = 1 << 30


def pad_sorted(a: np.ndarray, length: int) -> np.ndarray:
    """Pad a sorted unique int array to ``length`` with SENTINEL."""
    out = np.full(length, SENTINEL, dtype=np.int32)
    out[: len(a)] = a
    return out


def _bucket(n: int, minimum: int = 128) -> int:
    """Round up to a power-of-two bucket."""
    b = minimum
    while b < n:
        b <<= 1
    return b


# ------------------------------------------------------------------ 1-D ops


@hgverify.entry(shapes=hgverify.member_args)
def member_mask(sorted_ref: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """``queries ∈ sorted_ref`` elementwise; both may be SENTINEL-padded.
    Leading dimensions, where given, must match and pair row with row."""
    if sorted_ref.shape[-1] == 0:
        return torch.zeros(queries.shape, dtype=torch.bool,
                           device=queries.device)
    pos = torch.searchsorted(sorted_ref, queries, right=False, out_int32=False)
    pos = pos.clamp_(max=sorted_ref.shape[-1] - 1)
    found = torch.gather(sorted_ref, -1, pos)
    return (found == queries) & (queries != int(SENTINEL))


def intersect_mask_many(base: torch.Tensor, others: torch.Tensor) -> torch.Tensor:
    """base (L,) against others (M, L'): the mask of base elements present
    in EVERY other row. The n-way And intersection, and K3's plain
    version."""
    mask = base != int(SENTINEL)
    for other in others:
        mask &= member_mask(other, base)
    return mask


def intersect_mask_ragged(base: torch.Tensor, flat: torch.Tensor,
                          offsets: np.ndarray) -> torch.Tensor:
    """base (L,) against the rows ``flat[offsets[j]:offsets[j + 1]]``
    (``offsets`` on the host): the mask of base elements present in every
    row. K3's plain version for ragged rows; on the padded form it equals
    :func:`intersect_mask_many`."""
    mask = base != int(SENTINEL)
    for s, e in zip(offsets[:-1], offsets[1:]):
        mask &= member_mask(flat[int(s) : int(e)], base)
    return mask


# ------------------------------------------------------------------ segment search


@hgverify.entry(shapes=hgverify.segment_args)
def segment_member_mask(
    flat: torch.Tensor,     # (E,) int32: concatenated sorted segments
    starts: torch.Tensor,   # (K,) int32: per-query segment start (inclusive)
    ends: torch.Tensor,     # (K,) int32: per-query segment end (exclusive)
    queries: torch.Tensor,  # (K, L) int32: SENTINEL-padded probe values
) -> torch.Tensor:
    """``queries[k] ∈ flat[starts[k]:ends[k]]`` elementwise, without
    gathering the segment: a branchless binary search of 32 rounds (any
    int32-indexed segment) against the CSR flat array with per-row bounds,
    so a hub row costs the same as a short one."""
    shape = queries.shape
    lo = starts[:, None].to(torch.int32).expand(shape)
    hi = ends[:, None].to(torch.int32).expand(shape)
    emax = flat.shape[0] - 1
    for _ in range(32):
        active = lo < hi
        # lo + (hi - lo) / 2: the midpoint (lo + hi) >> 1, free of overflow
        mid = lo + ((hi - lo) >> 1)
        go_right = flat[mid.clamp(max=emax)] < queries
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    found = flat[lo.clamp(max=emax)]
    in_seg = lo < ends[:, None]
    return in_seg & (found == queries) & (queries != int(SENTINEL))


# ------------------------------------------------------------------ CSR rows


def gather_rows(offsets: torch.Tensor, flat: torch.Tensor, atoms: torch.Tensor,
                pad_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """CSR rows of ``atoms`` as a (K, pad_len) SENTINEL-padded, per-row
    sorted matrix (rows longer than ``pad_len`` are cut). Returns
    ``(rows, valid)``."""
    starts = offsets[atoms]
    lens = offsets[atoms + 1] - starts
    lane = torch.arange(pad_len, dtype=torch.int32, device=flat.device)
    valid = lane[None, :] < lens[:, None]
    idx = torch.where(valid, starts[:, None] + lane[None, :], 0)
    rows = torch.where(valid, flat[idx], int(SENTINEL))
    return rows, valid


@hgverify.entry(
    shapes=lambda device, seed: (
        hgverify.dev_snapshot_exemplar(device, seed),
        hgverify.tensor(hgverify.pattern_anchors(seed), device)),
    statics={"pad_len": 8},
)
def incident_intersection(dev: DeviceSnapshot, anchors: torch.Tensor,
                          pad_len: int, type_handle: Optional[int] = None):
    """The conjunctive pattern by gathered rows: for each query k, the links
    incident to ALL ``anchors[k, :]`` (optionally of one type), with every
    anchor's row gathered at ``pad_len``. Returns ``(candidates (K, pad)
    int32 rows of anchor 0's incidence, mask (K, pad) bool of
    survivors)``."""
    rows0, mask = gather_rows(dev.inc_offsets, dev.inc_links, anchors[:, 0],
                              pad_len)
    for p in range(1, anchors.shape[1]):
        rows_p, _ = gather_rows(dev.inc_offsets, dev.inc_links, anchors[:, p],
                                pad_len)
        mask = mask & member_mask(rows_p, rows0)
    if type_handle is not None:
        safe = torch.where(rows0 == int(SENTINEL), 0, rows0)
        mask = mask & (dev.type_of[safe] == type_handle)
    return rows0, mask


def incident_intersection_zigzag(dev: DeviceSnapshot, anchors: torch.Tensor,
                                 pad_len: int,
                                 type_handle: Optional[int] = None):
    """The conjunctive pattern for any link width: gather only the base
    (smallest) incidence row per query and probe the other anchors' rows
    in place with :func:`segment_member_mask`. ``anchors[:, 0]`` must hold
    the smallest row."""
    rows0, mask = gather_rows(dev.inc_offsets, dev.inc_links, anchors[:, 0],
                              pad_len)
    for p in range(1, anchors.shape[1]):
        a = anchors[:, p]
        mask = mask & segment_member_mask(
            dev.inc_links, dev.inc_offsets[a], dev.inc_offsets[a + 1], rows0)
    if type_handle is not None:
        safe = torch.where(rows0 == int(SENTINEL), 0, rows0)
        mask = mask & (dev.type_of[safe] == type_handle)
    return rows0, mask


# ------------------------------------------------------------------ ELL targets


def ell_targets(snap: CSRSnapshot,
                device: str | torch.device = DEFAULT_DEVICE
                ) -> Optional[torch.Tensor]:
    """Dense (N+1, W) int32 matrix of each link's target tuple, -1-padded,
    W the power-of-two bucket of the widest link; ``None`` when a link is
    wider than :data:`ELL_MAX_WIDTH` (callers then take the zigzag route).
    Built on ``device`` once and cached on the snapshot per device: at 10M
    atoms it is (N+1) x 16 int32, about 640 MB.

    "Is anchor b a target of candidate link l" is the same predicate as
    "is l in b's incidence row", but over a row of at most W entries: one
    contiguous gather and a compare, where b's row may be a hub's."""
    dev = resolve_device(device)
    cache = getattr(snap, "_tgt_ell", None)
    if cache is None:
        cache = {}
        object.__setattr__(snap, "_tgt_ell", cache)
    key = str(dev)
    if key not in cache:
        cache[key] = _build_ell(snap, dev)
    return cache[key]


def _build_ell(snap: CSRSnapshot, dev: torch.device) -> Optional[torch.Tensor]:
    N = snap.num_atoms
    width_needed = int(snap.arity[: N + 1].max(initial=0))
    if width_needed > ELL_MAX_WIDTH:
        return None
    W = _bucket(max(width_needed, 1), minimum=2)
    e = snap.n_edges_tgt
    src = torch.from_numpy(snap.tgt_src[:e]).to(dev).long()
    offsets = torch.from_numpy(snap.tgt_offsets).to(dev).long()
    lane = torch.arange(e, device=dev) - offsets[src]
    ell = torch.full(((N + 1) * W,), -1, dtype=torch.int32, device=dev)
    ell[src * W + lane] = torch.from_numpy(snap.tgt_flat[:e]).to(dev)
    return ell.view(N + 1, W)


@hgverify.entry(
    shapes=lambda device, seed: (
        hgverify.dev_snapshot_exemplar(device, seed),
        hgverify.ell_exemplar(device, seed),
        hgverify.tensor(hgverify.pattern_anchors(seed), device)),
    statics={"pad_len": 8},
)
def incident_intersection_ell(dev: DeviceSnapshot, tgt_ell: torch.Tensor,
                              anchors: torch.Tensor, pad_len: int,
                              type_handle: Optional[int] = None):
    """The conjunctive pattern by target-tuple membership: gather the base
    anchor's incidence row (the smallest, so a hub row is never gathered)
    and, for every other anchor, compare it with each candidate's W-wide
    ELL row. ``anchors[:, 0]`` must hold the smallest row. Queries stream in
    blocks whose (block, pad, W) gather stays under
    :data:`ELL_BLOCK_BYTES`; the result does not depend on the blocks."""
    rows0, mask = gather_rows(dev.inc_offsets, dev.inc_links, anchors[:, 0],
                              pad_len)
    safe = torch.where(mask, rows0, dev.type_of.shape[0] - 1)  # dummy row N
    K, P = anchors.shape
    if P > 1:
        block = max(1, ELL_BLOCK_BYTES // (pad_len * tgt_ell.shape[1] * 4))
        for s in range(0, K, block):
            tg = tgt_ell[safe[s : s + block]]  # (block, pad, W)
            for p in range(1, P):
                hit = (tg == anchors[s : s + block, p, None, None]).any(-1)
                mask[s : s + block] &= hit
    if type_handle is not None:
        mask = mask & (dev.type_of[safe] == type_handle)
    return rows0, mask


def value_columns(snap: CSRSnapshot,
                  device: str | torch.device = DEFAULT_DEVICE
                  ) -> torch.Tensor:
    """Dense (N+1, 2) int64 row pack of ``[rank word, kind]``, built on
    ``device`` once and cached on the snapshot per device: the value
    predicates fetch a candidate's rank and kind in one 16-byte row gather
    instead of two column gathers (the reference's (N+1, 4) uint32 pack of
    ``[rank_hi, rank_lo, kind, 0]``)."""
    dev = resolve_device(device)
    cache = snap.__dict__.setdefault("_value_cols", {})
    key = str(dev)
    if key not in cache:
        n1 = snap.num_atoms + 1
        cols = np.zeros((n1, 2), dtype=np.int64)
        cols[:, 0] = rank_words(snap.value_rank[:n1])
        kind = snap.value_kind[:n1]
        cols[: len(kind), 1] = kind
        cache[key] = torch.from_numpy(cols).to(dev)
    return cache[key]


#: the comparison ops of one value bound
VALUE_OPS = ("eq", "lt", "lte", "gt", "gte")


def _candidate_values(dev: DeviceSnapshot, rows0, mask, vcols):
    """Rank words and kinds of the candidates (the dummy row where
    ``mask`` is off), from the row pack ``vcols`` when given."""
    safe = torch.where(mask, rows0, dev.type_of.shape[0] - 1)
    if vcols is not None:
        packed = vcols[safe]
        return packed[..., 0], packed[..., 1]
    return dev.value_rank[safe], dev.value_kind[safe]


def incident_value_pattern(
    dev: DeviceSnapshot,
    tgt_ell: torch.Tensor,    # (N+1, W) int32
    anchors: torch.Tensor,    # (K, P) int32: anchors[:, 0] is the base
    pad_len: int,
    kind: int,                # the value kind byte
    rank: int,                # the query's 64-bit rank
    op: str,                  # eq | lt | lte | gt | gte
    exact: bool,              # fixed-width kind: rank order is value order
    type_handle: Optional[int] = None,
    vcols: Optional[torch.Tensor] = None,  # value_columns row pack
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The conjunctive incident pattern with a value predicate on each
    candidate link, compared through the order-preserving ranks. For
    fixed-width kinds (``exact``) the rank comparison is the value
    comparison; otherwise rank ties come back in the tie mask for the
    host to decide. Returns ``(candidate rows, definite mask, tie
    mask)``."""
    if op not in VALUE_OPS:
        raise ValueError(f"value op {op!r} is not one of {VALUE_OPS}")
    rows0, mask = incident_intersection_ell(dev, tgt_ell, anchors, pad_len,
                                            type_handle)
    v, vk = _candidate_values(dev, rows0, mask, vcols)
    mask = mask & (vk == kind)
    q = rank_word(rank)
    gt, eq = v > q, v == q
    if exact:
        keep = {"eq": eq, "lt": ~gt & ~eq, "lte": ~gt, "gt": gt,
                "gte": gt | eq}[op]
        return rows0, mask & keep, torch.zeros_like(mask)
    strict = {"eq": torch.zeros_like(eq), "lt": ~gt & ~eq,
              "lte": ~gt & ~eq, "gt": gt, "gte": gt}[op]
    return rows0, mask & strict, mask & eq


@hgverify.entry(
    shapes=lambda device, seed: (
        (hgverify.dev_snapshot_exemplar(device, seed),
         hgverify.ell_exemplar(device, seed),
         hgverify.tensor(hgverify.pattern_anchors(seed), device)),
        {"kind": ord("i"), "lo": 4, "hi": 50}),
    statics={"pad_len": 8, "lo_op": "gte", "hi_op": "lt", "exact": True},
)
def incident_value_range(
    dev: DeviceSnapshot,
    tgt_ell: torch.Tensor,    # (N+1, W) int32
    anchors: torch.Tensor,    # (K, P) int32: anchors[:, 0] is the base
    pad_len: int,
    kind: int,                # the value kind byte
    lo: int,                  # lower-bound 64-bit rank
    hi: int,                  # upper-bound 64-bit rank
    lo_op: str,               # gt | gte
    hi_op: str,               # lt | lte
    exact: bool,
    type_handle: Optional[int] = None,
    vcols: Optional[torch.Tensor] = None,  # value_columns row pack
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both bounds of a value window in one pass: the incident
    intersection and the rank gathers run once. Returns ``(candidate
    rows, definite mask, tie mask, counts)``, counts (K,) int32 of the
    definite survivors. For variable-width kinds only candidates strictly
    inside the window are definite; a rank tie at either bound goes to the
    tie mask."""
    if lo_op not in ("gt", "gte") or hi_op not in ("lt", "lte"):
        raise ValueError(f"bad window ops ({lo_op}, {hi_op}): lower must "
                         "be gt/gte, upper lt/lte")
    rows0, mask = incident_intersection_ell(dev, tgt_ell, anchors, pad_len,
                                            type_handle)
    v, vk = _candidate_values(dev, rows0, mask, vcols)
    mask = mask & (vk == kind)
    q_lo, q_hi = rank_word(lo), rank_word(hi)
    gt_lo, eq_lo = v > q_lo, v == q_lo
    gt_hi, eq_hi = v > q_hi, v == q_hi
    if exact:
        keep_lo = gt_lo | eq_lo if lo_op == "gte" else gt_lo
        keep_hi = ~gt_hi if hi_op == "lte" else ~gt_hi & ~eq_hi
        keep = mask & keep_lo & keep_hi
        return (rows0, keep, torch.zeros_like(keep),
                keep.sum(dim=1, dtype=torch.int32))
    keep = mask & gt_lo & ~gt_hi & ~eq_hi
    tie = mask & (eq_lo | eq_hi)
    return rows0, keep, tie, keep.sum(dim=1, dtype=torch.int32)


def compact(rows: torch.Tensor, mask: torch.Tensor, top_r: int):
    """(counts (K,) int32, first_r (K, top_r) survivors ascending,
    SENTINEL-padded): the on-device compaction of a full mask."""
    counts = mask.sum(dim=1, dtype=torch.int32)
    ranked = torch.where(mask, rows, int(SENTINEL))
    return counts, torch.sort(ranked, dim=1).values[:, :top_r]


def _pattern_compact(dev: DeviceSnapshot, tgt_ell: torch.Tensor,
                     anchors: torch.Tensor, pad_len: int, top_r: int,
                     type_handle: Optional[int] = None):
    """ELL pattern + on-device compaction: ``(counts (K,), first_r (K,
    top_r))``. The host fetches O(K · top_r) per batch; a query with more
    than ``top_r`` matches is re-run whole by :func:`collect_pattern`."""
    rows0, mask = incident_intersection_ell(dev, tgt_ell, anchors, pad_len,
                                            type_handle)
    return compact(rows0, mask, top_r)


# ------------------------------------------------------------------ plans


@dataclass
class PatternPlan:
    """A conjunctive-pattern batch staged on a device: anchors ordered
    smallest-row-first, bucketed by base-row length, uploaded once. Build
    once, execute many times."""

    snap: CSRSnapshot
    type_handle: Optional[int]
    n_queries: int
    #: per bucket: (host query indices, device anchors, pad_len)
    buckets: list[tuple[np.ndarray, torch.Tensor, int]]
    use_ell: bool
    device: torch.device


def plan_pattern(snap: CSRSnapshot, anchor_lists: Sequence[Sequence[int]],
                 type_handle: Optional[int] = None,
                 device: str | torch.device = DEFAULT_DEVICE) -> PatternPlan:
    """Order each query's anchors smallest-incidence-row first (the hub row
    is never the gathered base), bucket by power-of-two base-row length and
    stage the anchors on ``device``."""
    dev = resolve_device(device)
    anchors = np.asarray(anchor_lists, dtype=np.int32)
    if anchors.ndim == 1:
        anchors = anchors[None, :]
    lens = snap.inc_offsets[anchors + 1] - snap.inc_offsets[anchors]
    if lens.size:
        order = np.argsort(lens, axis=1, kind="stable")
        anchors = np.take_along_axis(anchors, order, axis=1)
        base_len = np.take_along_axis(lens, order[:, :1], axis=1)[:, 0]
    else:
        base_len = np.zeros(0, dtype=np.int64)
    buckets_of = np.asarray([_bucket(int(m)) for m in base_len])
    staged = []
    for b in np.unique(buckets_of):
        sel = np.nonzero(buckets_of == b)[0]
        staged.append((sel, torch.from_numpy(anchors[sel]).to(dev), int(b)))
    return PatternPlan(
        snap=snap, type_handle=type_handle, n_queries=len(anchors),
        buckets=staged, use_ell=ell_targets(snap, dev) is not None,
        device=dev,
    )


def _dispatch_full(plan: PatternPlan, anchors: torch.Tensor, pad: int):
    """Full-mask outputs of one bucket, by the ELL route where the
    snapshot has its matrix, else by the zigzag route."""
    dev = plan.snap.device(plan.device)
    ell = ell_targets(plan.snap, plan.device) if plan.use_ell else None
    if ell is not None:
        return incident_intersection_ell(dev, ell, anchors, pad,
                                         plan.type_handle)
    return incident_intersection_zigzag(dev, anchors, pad, plan.type_handle)


def execute_pattern(plan: PatternPlan, top_r: int = 16) -> list[tuple]:
    """Run every bucket without a host sync and return
    ``[(sel, counts, first_r)]`` with the two tensors on the plan's device;
    pair with :func:`collect_pattern`."""
    dev = plan.snap.device(plan.device)
    ell = ell_targets(plan.snap, plan.device) if plan.use_ell else None
    pending = []
    for sel, anchors, pad in plan.buckets:
        if ell is not None:
            counts, first_r = _pattern_compact(dev, ell, anchors, pad, top_r,
                                               plan.type_handle)
        else:
            rows, mask = incident_intersection_zigzag(dev, anchors, pad,
                                                      plan.type_handle)
            counts, first_r = compact(rows, mask, top_r)
        pending.append((sel, counts, first_r))
    return pending


def collect_pattern(plan: PatternPlan, pending: list[tuple]) -> list[np.ndarray]:
    """Fetch the compact results and return each query's sorted int64
    result array. A bucket holding a query whose count exceeds the compact
    window re-runs whole through the full-mask route, at the plan's
    shapes."""
    out: list[Optional[np.ndarray]] = [None] * plan.n_queries
    overflow: set[int] = set()
    for sel, counts, first_r in pending:
        counts, first_r = counts.cpu().numpy(), first_r.cpu().numpy()
        over = counts > first_r.shape[1]
        for j, qi in enumerate(sel.tolist()):
            if over[j]:
                overflow.add(qi)
            else:
                out[qi] = first_r[j, : counts[j]].astype(np.int64)
    if overflow:
        for sel, anchors, pad in plan.buckets:
            hit = [j for j, q in enumerate(sel.tolist()) if q in overflow]
            if not hit:
                continue
            rows, mask = _dispatch_full(plan, anchors, pad)
            rows, mask = rows.cpu().numpy(), mask.cpu().numpy()
            for j in hit:
                out[int(sel[j])] = rows[j][mask[j]].astype(np.int64)
    return out  # type: ignore[return-value]


def and_incident_pattern(snap: CSRSnapshot,
                         anchor_lists: Sequence[Sequence[int]],
                         type_handle: Optional[int] = None,
                         device: str | torch.device = DEFAULT_DEVICE
                         ) -> list[np.ndarray]:
    """Plan, execute and collect K anchor tuples of one arity in one call;
    returns each query's sorted int64 result array. For repeated batches
    keep the :class:`PatternPlan` and call :func:`execute_pattern`."""
    plan = plan_pattern(snap, anchor_lists, type_handle, device)
    return collect_pattern(plan, execute_pattern(plan))


# ------------------------------------------------------------------ planner step


def _align16(n: int) -> int:
    return (n + 15) & ~15


class _PinnedStaging:
    """One page-locked host buffer that :func:`intersection_mask` stages its
    arrays in, reused across calls and devices (page-locked memory serves
    every card) and grown when too small. The event of the last copy out of
    it is waited on before the buffer is written again, and a lock keeps
    two threads from filling it at once."""

    def __init__(self):
        self.lock = threading.Lock()
        self.buf: Optional[torch.Tensor] = None
        self.copied: Optional[torch.cuda.Event] = None

    def take(self, nbytes: int) -> torch.Tensor:
        """``nbytes`` of the buffer, free to write; hold :attr:`lock`."""
        if self.copied is not None:
            self.copied.synchronize()
        if self.buf is None or self.buf.numel() < nbytes:
            grow = 2 * self.buf.numel() if self.buf is not None else 0
            self.buf = torch.empty(max(nbytes, grow), dtype=torch.uint8,
                                   pin_memory=True)
        return self.buf[:nbytes]


_STAGING = _PinnedStaging()


def _check_sorted_ids(arrays: Sequence[np.ndarray]) -> list[np.ndarray]:
    """The arrays shortest first, raising unless each is 1-D and strictly
    ascending in ``[0, SENTINEL)``."""
    arrays = sorted((np.asarray(a) for a in arrays), key=len)
    if not arrays:
        raise ValueError("device_intersect_sorted: no arrays")
    for a in arrays:
        if a.ndim != 1 or (a.size and (a[0] < 0 or a[-1] >= SENTINEL
                                       or (a[1:] <= a[:-1]).any())):
            raise ValueError("device_intersect_sorted: arrays must be 1-D, "
                             "strictly ascending ids in "
                             f"[0, {int(SENTINEL)})")
    return arrays


def intersection_mask(arrays: Sequence[np.ndarray], dev: torch.device
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """K3 on checked arrays, shortest first and at least two: ``(base,
    mask)`` on ``dev``, ``base`` the first array as int32 and ``mask`` the
    flags of its elements found in all the others.

    Nothing is padded. The offsets (int64), the base and the other arrays
    back to back (int32, at their real lengths) are laid out in one host
    buffer, each part 16-byte aligned; on the card that buffer is
    page-locked (:data:`_STAGING`) and goes over in one copy, and the
    kernel reads the ragged rows in place. On the CPU the same layout runs
    K3's plain ragged version."""
    # imported here: membership imports this module for K3's plain versions
    from hypergraphdb_tpu_torch.ops.membership import membership_mask_ragged

    base, rest = arrays[0], arrays[1:]
    offsets = np.zeros(len(rest) + 1, dtype=np.int64)
    np.cumsum([len(a) for a in rest], out=offsets[1:])
    at_base = _align16(offsets.nbytes)
    at_flat = _align16(at_base + 4 * len(base))
    nbytes = at_flat + 4 * int(offsets[-1])

    def fill(host: torch.Tensor) -> None:
        h = host.numpy()
        h[: offsets.nbytes].view(np.int64)[:] = offsets
        h[at_base : at_base + 4 * len(base)].view(np.int32)[:] = base
        for a, s in zip(rest, offsets):
            at = at_flat + 4 * int(s)
            h[at : at + 4 * len(a)].view(np.int32)[:] = a

    if dev.type == "cuda":
        with _STAGING.lock:
            host = _STAGING.take(nbytes)
            fill(host)
            buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
            buf.copy_(host, non_blocking=True)
            _STAGING.copied = torch.cuda.Event()
            _STAGING.copied.record(torch.cuda.current_stream(dev))
    else:
        buf = torch.empty(nbytes, dtype=torch.uint8)
        fill(buf)
    base_t = buf[at_base : at_base + 4 * len(base)].view(torch.int32)
    mask = membership_mask_ragged(
        base_t, buf[at_flat:].view(torch.int32),
        buf[: offsets.nbytes].view(torch.int64), offsets_host=offsets)
    return base_t, mask


def device_intersect_sorted(arrays: Sequence[np.ndarray],
                            device: str | torch.device = DEFAULT_DEVICE
                            ) -> np.ndarray:
    """n-way intersection of sorted, unique host id arrays on ``device``:
    the planner's large-intersection step. Returns sorted int64.

    The shortest array is the base; K3 (``ops/membership.py``) keeps each
    base element found in all the others, read at their real lengths
    (:func:`intersection_mask`). The survivors are selected where the mask
    is and only they come back: on the card that beat fetching the mask
    and indexing the base on the host at the planner's hub intersections
    (``PERF.md``). A single array comes back as it is."""
    dev = resolve_device(device)
    arrays = _check_sorted_ids(arrays)
    base = arrays[0]
    if len(base) == 0 or len(arrays) == 1:
        return base.astype(np.int64)
    base_t, mask = intersection_mask(arrays, dev)
    return base_t[mask].cpu().numpy().astype(np.int64)
