"""Batched worst-case-optimal join executor: leapfrog as tensor operations.

The port of ``hypergraphdb_tpu/ops/join.py``, eager PyTorch on the card (or
the CPU when the caller asks). It is the device lowering of
``join/planner.JoinPlan``: a binding table of variable columns grows one
variable per step; K independent requests ride one padded batch,
intersections are branchless binary searches against CSR rows
(``ops/setops.segment_member_mask``'s discipline), and the binding table
lives in power-of-two row buckets.

Per step::

    keys    = column j of the table (or a per-request constant)
    cand    = CSR row gather of keys           (R, pad)   — expansion
    cand   &= cand ∈ row(other)                per filter — leapfrog
    cand   &= type/value-window/distinct masks
    table'  = compact survivors into the next row bucket

Truncation honesty: a CSR row wider than the expansion pad, or a
compaction that would overflow the row bucket, flags the owning request in
``trunc`` — its count is then a LOWER bound and its prefix honest. Nothing
is silently dropped.

The engine's three refinements are here too: **degree-split plans** (hub
lanes stream their rows through :func:`join_hub_expand` in fixed-width
tiles, so a row of any width expands without width truncation),
**factorized relations** (:func:`factorized_relations`: identical rows
collapse to one stored group; the co groups hold CLOSED rows, self
included, and the kernels restore irreflexivity with one compare) and
**bushy bags** (:func:`join_bag_join` folds each materialized component
onto the spine).

What differs from the reference, and why:

- The co-incidence CSR (:func:`neighbor_csr`) and the factorized
  encodings are built on the device with sorts (the reference sorts on
  the host with ``np.lexsort``, minutes of one core at 10M atoms); one
  build fills both the host arrays and the device twins.
- Compaction is a stable partition by prefix sum
  (:func:`survivors_first`), the exact order of the reference's stable
  ``argsort(~mask)``, without a sort. A lane that lost survivors to a full
  bucket is found by comparing its survivors with its kept rows, where
  the reference adds each dropped row into its lane (same flags; on the
  card, millions of atomic adds onto a few lanes serialize); row-major
  compactions read it off a prefix sum over rows.
- Scatters that the reference writes with ``mode="drop"`` write into
  scratch rows past the end, one a write, which are cut off.
- The hub kernel's tiles run in groups of up to the slot budget, not one
  by one in a device loop; on the row-split route a group takes only the
  rows not yet exhausted (their widths read once from the card, counted
  in :attr:`JoinExecution.host_syncs`). Survivors keep the reference's
  stream order. The tile count comes from host widths where the step is
  constant-keyed; tiles past the widest row add nothing, so a larger
  count changes no result.
- Binary searches take the midpoint as ``lo + ((hi - lo) >> 1)``, which
  cannot wrap.
- Real lanes' constants must be atom ids in ``[0, N]`` (checked on the
  host); the reference clamps device indices instead.
- A value window's bounds are compared as the port's rank words (one
  int64 per 64-bit rank, ``ops/snapshot.rank_words``), against the device
  snapshot's rank and kind columns; the reference compares two uint32
  words each.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from hypergraphdb_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from hypergraphdb_tpu_torch.join.ir import JoinUnsupported
from hypergraphdb_tpu_torch.join.planner import hub_lane_mask
from hypergraphdb_tpu_torch.ops.setops import (
    SENTINEL,
    _bucket,
    segment_member_mask,
)
from hypergraphdb_tpu_torch.ops.snapshot import CSRSnapshot, rank_word

#: default binding-table row cap (rows per batch, all requests pooled)
DEFAULT_ROW_CAP = 1 << 15

#: default expansion-pad cap (CSR rows wider than this flag truncation);
#: the effective per-step pad is additionally bounded by ``slot_budget``
#: divided by the live row count
DEFAULT_PAD_CAP = 1 << 10

#: default candidate-slot budget per expand step (rows × pad) — the
#: executor's peak-memory bound: 2^25 int32 slots ≈ 128 MB
DEFAULT_SLOT_BUDGET = 1 << 25

#: default dense-frontier chunk width of the hub chain: the hub path's
#: peak tensor is rows × block, never rows × row-width
DEFAULT_HUB_BLOCK = 1 << 9

#: default co-incidence materialization budget, in ordered pairs
#: (Σ arity·(arity-1) over links); override with the environment variable
#: HG_JOIN_MAX_NBR_PAIRS, read at each call (:func:`nbr_max_pairs`)
NBR_MAX_PAIRS = 1 << 28

#: hard ceiling of the pair budget: the CSR offsets and gather indices
#: are int32, so a larger relation would wrap silently
NBR_PAIRS_CEILING = (1 << 31) - 256

_SENT = int(SENTINEL)


def nbr_max_pairs() -> int:
    """The pair budget in force: ``HG_JOIN_MAX_NBR_PAIRS`` if set, else
    :data:`NBR_MAX_PAIRS`, never above :data:`NBR_PAIRS_CEILING`."""
    return min(int(os.environ.get("HG_JOIN_MAX_NBR_PAIRS", NBR_MAX_PAIRS)),
               NBR_PAIRS_CEILING)


# ---------------------------------------------------------------- nbr CSR


def nbr_pair_count(snap: CSRSnapshot) -> int:
    """Ordered co-incidence pairs the snapshot's links imply (before
    dedupe) — the build cost AND an upper bound on the relation's size,
    O(N) from the arity column."""
    ar = snap.arity[: snap.num_atoms].astype(np.int64)
    return int((ar * np.maximum(ar - 1, 0)).sum())


def _device_cache(snap, name: str) -> dict:
    cache = getattr(snap, name, None)
    if cache is None:
        cache = {}
        object.__setattr__(snap, name, cache)
    return cache


def _pad_flat(flat: torch.Tensor, pad_value: int) -> torch.Tensor:
    """``flat`` as int32, padded with ``pad_value`` to a multiple of 128
    (128 pad entries when empty), as the reference pads its CSRs."""
    flat = flat.to(torch.int32)
    n = flat.shape[0]
    fill = 128 - n % 128 if n % 128 else (0 if n else 128)
    if not fill:
        return flat
    return torch.cat([flat, torch.full((fill,), pad_value, dtype=torch.int32,
                                       device=flat.device)])


def _build_neighbor_csr(snap: CSRSnapshot, dev: torch.device):
    """The co-incidence CSR built on ``dev``: every link contributes all
    ordered pairs of its targets; pairs of equal value go, the rest are
    sorted as one int64 key ``left·(N+1) + right`` and deduplicated."""
    N = snap.num_atoms
    e = snap.n_edges_tgt
    lens = np.diff(snap.tgt_offsets.astype(np.int64))
    total = int((lens * lens).sum())          # Σ over entries of arity
    t = torch.from_numpy(snap.tgt_flat[:e]).to(dev)
    src = torch.from_numpy(snap.tgt_src[:e]).to(dev).long()
    toff = torch.from_numpy(snap.tgt_offsets).to(dev).long()
    a_e = (toff[1:] - toff[:-1])[src]          # owning link's arity
    ent = torch.repeat_interleave(torch.arange(e, device=dev), a_e,
                                  output_size=total)
    # the i-th pair of entry ent pairs it with entry ss + i of its link
    co = torch.arange(total, device=dev)
    co -= (torch.cumsum(a_e, 0) - a_e)[ent]
    co += toff[src][ent]
    right = t[co]
    del co
    left = t[ent]
    del ent
    key = left.long() * (N + 1) + right.long()
    key = key[left != right]                   # irreflexive by VALUE
    del left, right
    key = torch.unique_consecutive(torch.sort(key).values)
    left = key // (N + 1)
    flat = _pad_flat(key - left * (N + 1), N)
    del key
    offsets = torch.zeros(N + 2, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(torch.bincount(left, minlength=N + 1), 0)
    return offsets.to(torch.int32), flat


def neighbor_csr_device(snap: CSRSnapshot, device=DEFAULT_DEVICE):
    """The co-incidence CSR ``(offsets (N+2,), flat)`` as int32 tensors on
    ``device``: ``flat[offsets[u]:offsets[u+1]]`` = sorted unique atoms
    sharing at least one link with ``u`` (never ``u`` itself). Row ``N``
    (the dummy) is empty; ``flat`` is padded with ``N`` to a multiple of
    128. Built on the device on first use and cached on the snapshot per
    device, with its host copy (:func:`neighbor_csr`); a second device
    gets the host copy uploaded. Raises :class:`JoinUnsupported` when the
    relation is over the pair budget (:func:`nbr_max_pairs`)."""
    dev = resolve_device(device)
    cache = _device_cache(snap, "_nbr_csr_dev")
    key = str(dev)
    if key in cache:
        return cache[key]
    host = getattr(snap, "_nbr_csr", None)
    if host is not None:
        cache[key] = tuple(torch.from_numpy(a).to(dev) for a in host)
        return cache[key]
    pairs = nbr_pair_count(snap)
    budget = nbr_max_pairs()
    if pairs > budget:
        raise JoinUnsupported(
            f"co-incidence relation would materialize {pairs} pairs "
            f"(budget {budget}, HG_JOIN_MAX_NBR_PAIRS); joins on "
            "this snapshot run on the host path"
        )
    out = _build_neighbor_csr(snap, dev)
    cache[key] = out
    object.__setattr__(snap, "_nbr_csr",
                       tuple(a.cpu().numpy() for a in out))
    return out


def neighbor_csr_on(snap: CSRSnapshot, device=DEFAULT_DEVICE) -> bool:
    """Whether ``snap``'s co-incidence CSR is already on ``device`` (built
    there or uploaded), so a join reading it pays no build."""
    return str(resolve_device(device)) in getattr(snap, "_nbr_csr_dev", {})


def neighbor_csr(snap: CSRSnapshot, device=DEFAULT_DEVICE
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Host copy ``(offsets, flat)`` (int32 numpy) of the co-incidence CSR
    of :func:`neighbor_csr_device`, built on ``device`` if no build is
    cached yet — equal, array for array, to the reference's."""
    resolve_device(device)
    host = getattr(snap, "_nbr_csr", None)
    if host is None:
        neighbor_csr_device(snap, device)
        host = snap._nbr_csr
    return host


def release_join_caches(snap: CSRSnapshot) -> None:
    """Drop every join cache of ``snap`` (the co-incidence CSR, the
    factorized encodings, their device twins, the width maxima), so their
    device memory can be returned."""
    for name in ("_nbr_csr", "_nbr_csr_dev", "_fact_rels", "_fact_rels_dev",
                 "_join_wmax"):
        if name in snap.__dict__:
            object.__delattr__(snap, name)


# ------------------------------------------------------- factorized relations


@dataclass(frozen=True)
class FactorizedRelation:
    """A prefix-grouped (trie-style) row encoding of one CSR relation:
    identical rows collapse into one stored GROUP. Row lookup is one extra
    indirection: ``flat[offsets[group_of[u]]:offsets[group_of[u] + 1]]``.
    Group 0 is the empty row (the dummy row maps there). ``closed=True``
    marks the co relation's convention: rows INCLUDE the owning atom, so
    every member of a single shared link carries an identical row, and the
    kernels restore irreflexivity with a one-compare mask."""

    group_of: np.ndarray     # (N+1,) int32 — row -> group id
    offsets: np.ndarray      # (G+1,) int32 — group extents
    flat: np.ndarray         # (F,) int32 — unique row contents, padded
    n_groups: int
    entries: int             # Σ unique-group widths (pre-pad)
    entries_flat: int        # Σ per-row widths the flat CSR stores
    closed: bool
    max_width: int           # widest group (the var_pad_max bound)


def _group_rows(offsets: torch.Tensor, flat: torch.Tensor, n_rows: int,
                pad_value: int) -> tuple:
    """Group identical rows of a CSR on its device, per length class
    (rows of one length form a dense matrix; ``torch.unique(dim=0)``
    orders and collapses it lexicographically, as ``np.unique(axis=0)``
    does). Returns ``(group_of, grp_offsets, grp_flat)`` int32 tensors
    with group 0 reserved for the empty row."""
    dev = flat.device
    offsets = offsets.to(torch.int64)
    flat = flat.to(torch.int64)
    lens = offsets[1: n_rows + 1] - offsets[:n_rows]
    group_of = torch.zeros(n_rows + 1, dtype=torch.int32, device=dev)
    sorted_lens, order = torch.sort(lens, stable=True)
    class_lens, class_n = torch.unique_consecutive(sorted_lens,
                                                   return_counts=True)
    chunks = [torch.empty(0, dtype=torch.int64, device=dev)]
    grp_lens: list = [0]                              # group 0 = empty
    next_g, pos = 1, 0
    for L, n in zip(class_lens.tolist(), class_n.tolist()):
        ids = order[pos: pos + n]
        pos += n
        if L == 0:
            continue
        mat = flat[offsets[ids][:, None]
                   + torch.arange(L, dtype=torch.int64, device=dev)]
        if n == 1:
            uniq, inv = mat, torch.zeros(1, dtype=torch.int64, device=dev)
        else:
            uniq, inv = torch.unique(mat, dim=0, return_inverse=True)
        group_of[ids] = (next_g + inv).to(torch.int32)
        next_g += uniq.shape[0]
        chunks.append(uniq.reshape(-1))
        grp_lens.extend([L] * uniq.shape[0])
    grp_offsets = torch.zeros(next_g + 1, dtype=torch.int64)
    grp_offsets[1:] = torch.cumsum(torch.tensor(grp_lens, dtype=torch.int64),
                                   0)
    return (group_of, grp_offsets.to(torch.int32).to(dev),
            _pad_flat(torch.cat(chunks), pad_value))


def _closed_co_csr(snap: CSRSnapshot, device=DEFAULT_DEVICE):
    """The co-incidence CSR with each non-empty row CLOSED under its
    owner (self inserted in sort position), as int64 tensors
    ``(offsets (N+2,), flat)`` on ``device``, ``flat`` unpadded — the
    content-equalizing transform: all k members of one k-ary link then
    share one row. Built from the neighbour CSR by moving each entry
    right by the closed rows before it (and one more past its owner),
    without a sort."""
    off, flat = neighbor_csr_device(snap, device)
    dev = flat.device
    N = snap.num_atoms
    off64 = off[: N + 1].to(torch.int64)
    w = off64[1:] - off64[:-1]
    n_e = int(snap._nbr_csr[0][N])
    owner = torch.repeat_interleave(torch.arange(N, device=dev), w,
                                    output_size=n_e)
    right = flat[:n_e].to(torch.int64)
    nonempty = (w > 0).to(torch.int64)
    before = torch.cumsum(nonempty, 0) - nonempty    # closed rows before u
    pos = torch.arange(n_e, device=dev) + before[owner] + (right > owner)
    n_below = torch.zeros(N, dtype=torch.int64, device=dev).index_add_(
        0, owner, (right < owner).to(torch.int64))
    self_pos = off64[:N] + before + n_below
    out = torch.empty(n_e + int(nonempty.sum()), dtype=torch.int64,
                      device=dev)
    out[pos] = right
    keep = nonempty.bool()
    out[self_pos[keep]] = torch.arange(N, device=dev)[keep]
    offsets = torch.zeros(N + 2, dtype=torch.int64, device=dev)
    offsets[1: N + 1] = torch.cumsum(w + nonempty, 0)
    offsets[N + 1] = offsets[N]
    return offsets, out


def _relation(group_of, offsets, flat, entries_flat: int, closed: bool
              ) -> FactorizedRelation:
    o = offsets.cpu().numpy()
    return FactorizedRelation(
        group_of=group_of.cpu().numpy(), offsets=o, flat=flat.cpu().numpy(),
        n_groups=len(o) - 1, entries=int(o[-1]), entries_flat=entries_flat,
        closed=closed,
        max_width=int(np.max(np.diff(o.astype(np.int64)), initial=1)),
    )


def factorized_relations(snap: CSRSnapshot, device=DEFAULT_DEVICE) -> dict:
    """Build (or return the cached) factorized encodings of the co and
    tgt relations, ``{"co": FactorizedRelation, "tgt": ...}`` with host
    arrays equal to the reference's. Built on ``device`` once per
    snapshot; the build also fills that device's twins
    (:func:`factorized_relations_device`). Raises ``JoinUnsupported``
    when the co relation itself is over the pair budget."""
    dev = resolve_device(device)
    cached = getattr(snap, "_fact_rels", None)
    if cached is not None:
        return cached
    N = snap.num_atoms
    co_off, co_flat = _closed_co_csr(snap, dev)
    co = _group_rows(co_off, co_flat, N, pad_value=N)
    del co_flat
    e = snap.n_edges_tgt
    tgt = _group_rows(torch.from_numpy(snap.tgt_offsets).to(dev),
                      torch.from_numpy(snap.tgt_flat[:e]).to(dev), N,
                      pad_value=N)
    out = {
        "co": _relation(*co, entries_flat=int(co_off[N + 1]), closed=True),
        "tgt": _relation(*tgt, entries_flat=int(e), closed=False),
    }
    _device_cache(snap, "_fact_rels_dev")[str(dev)] = {"co": co, "tgt": tgt}
    object.__setattr__(snap, "_fact_rels", out)
    return out


def factorized_relations_device(snap: CSRSnapshot, device=DEFAULT_DEVICE
                                ) -> dict:
    """Device twins of :func:`factorized_relations` on ``device``:
    ``{rel: (group_of, offsets, flat)}`` int32 tensors, from the build
    or uploaded from the host arrays once per device."""
    dev = resolve_device(device)
    cache = _device_cache(snap, "_fact_rels_dev")
    key = str(dev)
    if key not in cache:
        rels = factorized_relations(snap, dev)
        if key not in cache:
            cache[key] = {
                rel: tuple(torch.from_numpy(a).to(dev)
                           for a in (fr.group_of, fr.offsets, fr.flat))
                for rel, fr in rels.items()
            }
    return cache[key]


# ---------------------------------------------------------------- kernels


def survivors_first(mask: torch.Tensor) -> torch.Tensor:
    """The stable partition of the 1-D ``mask``'s indices: the set ones in
    index order, then the rest in index order — exactly
    ``argsort(~mask, stable=True)``, computed from one prefix sum and one
    scatter. A compaction into ``rows_out`` rows keeps
    ``order[:rows_out]``."""
    n = mask.shape[0]
    idx = torch.arange(n, device=mask.device)
    csum = torch.cumsum(mask, 0)
    dest = torch.where(mask, csum - 1, csum[-1:] + idx - csum) if n else idx
    return torch.empty_like(idx).scatter_(0, dest, idx)


def _spilled_rows(row_n: torch.Tensor, rows_out: int) -> torch.Tensor:
    """Rows with a survivor past a ``rows_out`` bucket when survivors are
    compacted row-major (``row_n`` survivors a row): the rows the
    reference's per-slot drop count adds into their lanes, found from a
    prefix sum over rows instead of one count a slot."""
    return (row_n > 0) & (torch.cumsum(row_n, 0) > rows_out)


def _lost_lanes(n_lanes: int, survivors: torch.Tensor,
                lanes: torch.Tensor, kept: torch.Tensor) -> torch.Tensor:
    """Lanes that lost survivors to a full bucket whatever the stream
    order: more survivors (``survivors``, per lane) than rows kept
    (``kept`` flags rows of ``lanes``)."""
    return survivors > _lane_add(n_lanes, lanes, kept)


def _lane_add(n_lanes: int, lanes: torch.Tensor,
              vals: torch.Tensor) -> torch.Tensor:
    """``zeros(n_lanes).at[lanes].add(vals)`` with lanes past the end
    dropped (the table's unused rows carry lane ``n_lanes``)."""
    acc = torch.zeros(n_lanes + 1, dtype=torch.int32, device=vals.device)
    acc.index_add_(0, lanes.to(torch.int64).clamp(max=n_lanes),
                   vals.to(torch.int32))
    return acc[:n_lanes]


def _member_elementwise(flat, starts, ends, queries):
    """``queries[i, j] ∈ flat[starts[i, j]:ends[i, j]]`` — the
    elementwise-bounds twin of ``setops.segment_member_mask`` (there the
    segment is per ROW; here per element, for reversed membership tests
    whose segment comes from the candidate itself)."""
    emax = flat.shape[0] - 1
    lo = starts.to(torch.int32)
    hi = ends.to(torch.int32)
    for _ in range(32):
        active = lo < hi
        # lo + (hi - lo) / 2: the midpoint (lo + hi) >> 1, free of overflow
        mid = lo + ((hi - lo) >> 1)
        go_right = flat[mid.clamp(max=emax)] < queries
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    found = flat[lo.clamp(max=emax)]
    return (lo < ends.to(torch.int32)) & (found == queries) \
        & (queries != _SENT)


def _norm_filt_sel(filt_sel: tuple) -> tuple:
    """Filter selectors as 4-tuples ``(rev, kind, idx, irref)`` — 3-tuple
    selectors read as irref=False."""
    return tuple(
        f if len(f) == 4 else (f[0], f[1], f[2], False) for f in filt_sel
    )


def _seg_of(offsets, group, keys):
    """Segment bounds of ``keys``'s rows, through the factorized group
    indirection when the relation is grouped (``group`` is its
    ``group_of`` column)."""
    g = keys if group is None else group[keys]
    return offsets[g], offsets[g + 1]


def _filter_masks(cand, cmask, safe, key_of, filt_sel, filt_offsets,
                  filt_flats, filt_groups):
    """The leapfrog intersection masks: one membership probe per filter
    relation, forward (candidate ∈ row(key)) or reversed (key ∈
    row(candidate)); ``irref`` filters additionally re-impose
    irreflexivity over CLOSED factorized co rows."""
    for (rev, kind, kidx, irref), off_f, flat_f, grp_f in zip(
        filt_sel, filt_offsets, filt_flats, filt_groups
    ):
        o = key_of((kind, kidx))
        if not rev:
            # candidate ∈ row(key): per-row segment, shared bounds
            s, e = _seg_of(off_f, grp_f, o)
            with torch.profiler.record_function("join.segment_member_mask"):
                cmask = cmask & segment_member_mask(flat_f, s, e, cand)
            if irref:
                cmask = cmask & (cand != o[:, None])
        else:
            # key ∈ row(candidate): per-element segments
            qo = o[:, None].expand(cand.shape)
            s, e = _seg_of(off_f, grp_f, safe)
            with torch.profiler.record_function("join.member_elementwise"):
                cmask = cmask & _member_elementwise(flat_f, s, e, qo)
            if irref:
                cmask = cmask & (qo != safe)
    return cmask


def _value_window_mask(cmask, safe, value_cols, value_win, value_ops):
    """Rank-window leapfrog: each candidate's rank word and kind byte
    against the window, applied before compaction so out-of-window
    candidates never take binding rows. ``value_cols`` is ``(rank words,
    kinds)`` (N+1,) each, ``value_win`` ``(kind, lo word, hi word)``;
    cross-kind comparisons are always False."""
    v = value_cols[0][safe]
    cmask = cmask & (value_cols[1][safe] == value_win[0])
    lo_op, hi_op = value_ops
    if lo_op is not None:
        cmask = cmask & (v >= value_win[1] if lo_op == "gte"
                         else v > value_win[1])
    if hi_op is not None:
        cmask = cmask & (v <= value_win[2] if hi_op == "lte"
                         else v < value_win[2])
    return cmask


def _distinct_masks(cmask, cand, cols, consts, lanes, n_distinct_cols,
                    distinct_consts):
    for j in range(n_distinct_cols):
        cmask = cmask & (cand != cols[:, j, None])
    if distinct_consts:
        for s in range(consts.shape[1]):
            cmask = cmask & (cand != consts[lanes, s][:, None])
    return cmask


def _keyer(cols, lanes, valid, consts, n_lanes: int, dummy: int):
    """``(key_of, lanes_c)``: the step's key reader (a binding column or a
    per-request constant, the dummy row where the row is not valid) and
    the lanes clamped into the constants' range, as the reference's
    gathers clamp them."""
    lanes_c = lanes.to(torch.int64).clamp(max=n_lanes - 1)

    def key_of(sel):
        kind, idx = sel
        k = cols[:, idx] if kind == "col" else consts[lanes_c, idx]
        return torch.where(valid, k, dummy)

    return key_of, lanes_c


def join_expand_step(
    exp_offsets: torch.Tensor,   # (N+2,) int32 — expansion CSR offsets
    exp_flat: torch.Tensor,      # (E,) int32 — expansion CSR payload
    cols: torch.Tensor,          # (R, T) int32 bound binding columns (T ≥ 0)
    lanes: torch.Tensor,         # (R,) int32 request lane per binding row
    valid: torch.Tensor,         # (R,) bool
    consts: torch.Tensor,        # (n_lanes, A) int32 per-request constants
    filt_offsets: tuple,         # one (N+2,) per membership filter
    filt_flats: tuple,           # one (E',) per membership filter
    type_of: torch.Tensor,       # (N+1,) int32
    exp_group: Optional[torch.Tensor] = None,  # (N+1,) int32 — factorized
    # row->group indirection of the expansion relation (None = flat CSR)
    filt_groups: Optional[tuple] = None,       # per-filter group columns
    *,
    exp_sel: tuple,              # ("col", j) | ("const", slot)
    filt_sel: tuple,             # ((rev, "col"|"const", idx[, irref]), ...)
    type_handle: int,            # -1 = unconstrained
    pad: int,                    # expansion width bucket
    rows_out: int,               # binding-row bucket after this step
    n_lanes: int,                # request lanes (K)
    n_distinct_cols: int,        # earlier columns candidates must differ from
    distinct_consts: bool,       # candidates must differ from every constant
    dedupe: bool,                # expansion rows may repeat values (tgt)
    exp_irref: bool = False,     # expansion rows are CLOSED (factorized co)
    value_cols: Optional[tuple] = None,  # (rank words, kinds) (N+1,) each
    value_win: Optional[tuple] = None,   # (kind, lo word, hi word)
    value_ops: Optional[tuple] = None,   # (lo_op|None, hi_op|None): a value
    # window on THIS step's candidates; None applies none
) -> tuple:
    """Bind ONE variable for every binding row of a K-request batch:
    expand candidates from the keyed CSR row, leapfrog-intersect against
    the filter relations, and compact survivors into the next row
    bucket. Returns ``(cols', lanes', valid', lane_counts, lane_trunc)``
    — counts are THIS step's exact per-request survivor totals (counted
    before compaction); ``lane_trunc`` flags requests whose expansion row
    overflowed ``pad`` or whose survivors overflowed ``rows_out``."""
    R, T = cols.shape
    dev = cols.device
    dummy = type_of.shape[0] - 1
    filt_sel = _norm_filt_sel(filt_sel)
    if filt_groups is None:
        filt_groups = (None,) * len(filt_sel)
    key_of, lanes_c = _keyer(cols, lanes, valid, consts, n_lanes, dummy)

    key = key_of(exp_sel)
    starts, ends = _seg_of(exp_offsets, exp_group, key)
    widths = ends - starts
    over_row = (widths > pad) & valid
    lane_ix = torch.arange(pad, dtype=torch.int32, device=dev)
    cmask = lane_ix[None, :] < widths.clamp(max=pad)[:, None]
    idx = (starts[:, None] + lane_ix[None, :]).clamp(
        max=exp_flat.shape[0] - 1)
    cand = torch.where(cmask, exp_flat[idx], _SENT)
    cmask = cmask & valid[:, None]
    if exp_irref:
        cmask = cmask & (cand != key[:, None])
    if dedupe:
        # target tuples may repeat a value; keep the first occurrence so
        # binding rows stay DISTINCT tuples: a stable sort keeps equal
        # values in position order, so marking each sorted element equal
        # to its predecessor drops every occurrence but the first
        ord_ = torch.argsort(cand, dim=1, stable=True)
        sc = torch.gather(cand, 1, ord_)
        dup_sorted = torch.cat(
            [torch.zeros((R, 1), dtype=torch.bool, device=dev),
             sc[:, 1:] == sc[:, :-1]], dim=1)
        dup = torch.zeros_like(dup_sorted).scatter_(1, ord_, dup_sorted)
        cmask = cmask & ~dup
    safe = torch.where(cmask, cand, dummy)
    cmask = _filter_masks(cand, cmask, safe, key_of, filt_sel,
                          filt_offsets, filt_flats, filt_groups)
    if type_handle >= 0:
        cmask = cmask & (type_of[safe] == type_handle)
    if value_ops is not None:
        cmask = _value_window_mask(cmask, safe, value_cols, value_win,
                                   value_ops)
    cmask = _distinct_masks(cmask, cand, cols, consts, lanes_c,
                            n_distinct_cols, distinct_consts)
    row_n = cmask.sum(dim=1)
    lane_counts = _lane_add(n_lanes, lanes, row_n)
    # compaction: survivors first (stable — canonical row order is
    # preserved), into the next bucket
    flat_mask = cmask.reshape(-1)
    sel = survivors_first(flat_mask)[:rows_out]
    new_valid = flat_mask[sel]
    rsel = sel // pad
    new_cols = torch.cat([cols[rsel], cand.reshape(-1)[sel][:, None]], dim=1)
    new_lanes = lanes[rsel]
    trunc = _lane_add(n_lanes, lanes,
                      over_row | _spilled_rows(row_n, rows_out)) > 0
    return new_cols, new_lanes, new_valid, lane_counts, trunc


def _hub_groups(R: int, block: int, n_chunks: int, group_slots: int,
                row_widths: Optional[np.ndarray]):
    """The hub kernel's tiles in groups ``(first tile, tiles, rows)``: each
    group is one ``(rows, tiles × block)`` candidate tensor of at most
    ``group_slots`` slots (one tile at least). Without host row widths
    every group takes all ``R`` rows; with them (``row_widths``, 0 for an
    invalid row) a group takes only the rows not exhausted before its
    first tile, so a lone hub row streams in a few wide groups."""
    t = 0
    while t < n_chunks:
        if row_widths is None:
            rows, n_rows = None, R
        else:
            rows = np.flatnonzero(row_widths > t * block)
            n_rows = len(rows)
            if not n_rows:
                return
        n_t = min(max(group_slots // max(n_rows * block, 1), 1),
                  n_chunks - t)
        yield t, n_t, rows
        t += n_t


def join_hub_expand(
    exp_offsets: torch.Tensor,   # (N+2,) int32 — expansion CSR offsets
    exp_flat: torch.Tensor,      # (E,) int32 — expansion CSR payload
    cols: torch.Tensor,          # (R, T) int32 bound binding columns
    lanes: torch.Tensor,         # (R,) int32
    valid: torch.Tensor,         # (R,) bool
    consts: torch.Tensor,        # (n_lanes, A) int32
    filt_offsets: tuple,
    filt_flats: tuple,
    type_of: torch.Tensor,       # (N+1,) int32
    exp_group: Optional[torch.Tensor] = None,
    filt_groups: Optional[tuple] = None,
    *,
    n_chunks: int,               # tiles to stream: ≥ ⌈widest valid row / block⌉
    exp_sel: tuple,
    filt_sel: tuple,
    type_handle: int,
    block: int,                  # dense-frontier chunk width
    rows_out: int,               # pooled survivor bucket
    n_lanes: int,
    n_distinct_cols: int,
    distinct_consts: bool,
    exp_irref: bool = False,
    value_cols: Optional[tuple] = None,
    value_win: Optional[tuple] = None,
    value_ops: Optional[tuple] = None,
    row_widths: Optional[np.ndarray] = None,  # host widths of the rows
    # (0 where not valid): groups then skip rows already exhausted
    group_slots: int = DEFAULT_SLOT_BUDGET,   # candidate slots a group
) -> tuple:
    """The degree-split twin of :func:`join_expand_step` for HUB rows: a
    dense-frontier expansion that streams each keyed row in fixed
    ``block``-wide tiles instead of one padded gather — a row of ANY
    width expands without width truncation. Filters/type/value/distinct
    masks apply per tile; survivors stream-compact into one pooled
    ``rows_out`` buffer through a running cursor, tile by tile and row-major within a
    tile, so each lane's survivors arrive in ascending candidate order.
    Returns the same ``(cols', lanes', valid', lane_counts, lane_trunc)``
    contract — ``lane_counts`` stay exact even when the pooled buffer
    overflows; only ``rows_out`` overflow can set ``lane_trunc``. No
    dedupe mode: degree-split plans route dedupe (tgt) steps through the
    tail kernel.

    The reference loops over the tiles on the device; here consecutive
    tiles run together as one group of up to ``group_slots`` candidates
    (:func:`_hub_groups`), their survivors ranked in the reference's
    stream order, so the result is the reference's for any grouping.
    Tiles past the widest valid row add nothing, so any ``n_chunks`` at
    or above the reference's count gives its result."""
    R, T = cols.shape
    dev = cols.device
    dummy = type_of.shape[0] - 1
    filt_sel = _norm_filt_sel(filt_sel)
    if filt_groups is None:
        filt_groups = (None,) * len(filt_sel)
    key = _keyer(cols, lanes, valid, consts, n_lanes, dummy)[0](exp_sel)
    starts, ends = _seg_of(exp_offsets, exp_group, key)
    widths = torch.where(valid, ends - starts, 0)
    emax = exp_flat.shape[0] - 1

    groups = list(_hub_groups(R, block, n_chunks, group_slots, row_widths))
    # the writes the reference drops land past the bucket, one scratch
    # row each (stores to one shared row would serialize on the card)
    scratch = max([(R if rows is None else len(rows)) * n_t * block
                   for _, n_t, rows in groups], default=0)
    n_out = rows_out + scratch
    out_cols = torch.zeros((n_out, T + 1), dtype=torch.int32, device=dev)
    out_lanes = torch.full((n_out,), n_lanes, dtype=torch.int32, device=dev)
    out_valid = torch.zeros(n_out, dtype=torch.bool, device=dev)
    counts = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    cursor = torch.zeros(1, dtype=torch.int64, device=dev)
    for t0, n_t, rows in groups:
        if rows is None:
            g_cols, g_lanes, g_valid = cols, lanes, valid
            g_key, g_starts, g_widths = key, starts, widths
        else:
            sel = torch.from_numpy(rows).to(dev)
            g_cols, g_lanes, g_valid = cols[sel], lanes[sel], valid[sel]
            g_key, g_starts, g_widths = key[sel], starts[sel], widths[sel]
        n_r = g_cols.shape[0]
        key_of, lanes_c = _keyer(g_cols, g_lanes, g_valid, consts, n_lanes,
                                 dummy)
        base_ix = t0 * block + torch.arange(n_t * block, dtype=torch.int32,
                                            device=dev)
        cmask = base_ix[None, :] < g_widths[:, None]
        idx = (g_starts[:, None] + base_ix[None, :]).clamp(max=emax)
        cand = torch.where(cmask, exp_flat[idx], _SENT)
        if exp_irref:
            cmask = cmask & (cand != g_key[:, None])
        safe = torch.where(cmask, cand, dummy)
        cmask = _filter_masks(cand, cmask, safe, key_of, filt_sel,
                              filt_offsets, filt_flats, filt_groups)
        if type_handle >= 0:
            cmask = cmask & (type_of[safe] == type_handle)
        if value_ops is not None:
            cmask = _value_window_mask(cmask, safe, value_cols, value_win,
                                       value_ops)
        cmask = _distinct_masks(cmask, cand, g_cols, consts, lanes_c,
                                n_distinct_cols, distinct_consts)
        counts += _lane_add(n_lanes, g_lanes, cmask.sum(dim=1))
        # the reference's stream: tile by tile, row-major within a tile;
        # a survivor's place in it is the cursor plus its rank
        flat_mask = cmask.view(n_r, n_t, block).transpose(0, 1).reshape(-1)
        flat_cand = cand.view(n_r, n_t, block).transpose(0, 1).reshape(-1)
        order = survivors_first(flat_mask)
        slot = torch.arange(order.shape[0], device=dev)
        pos = cursor + slot
        live = flat_mask[order]
        write = live & (pos < rows_out)
        dst = torch.where(write, pos, rows_out + slot)
        rsel = (order // block) % n_r
        out_cols[dst] = torch.cat([g_cols[rsel], flat_cand[order][:, None]],
                                  dim=1)
        out_lanes[dst] = g_lanes[rsel]
        out_valid[dst] = write
        cursor = cursor + flat_mask.sum()
    out_cols, out_lanes = out_cols[:rows_out], out_lanes[:rows_out]
    out_valid = out_valid[:rows_out]
    return (out_cols, out_lanes, out_valid, counts,
            _lost_lanes(n_lanes, counts, out_lanes, out_valid))


def join_bag_join(
    cols: torch.Tensor,       # (R1, T1) int32 — spine binding rows
    lanes: torch.Tensor,      # (R1,) int32
    valid: torch.Tensor,      # (R1,) bool
    bag_cols: torch.Tensor,   # (R2, T2) int32 — materialized bag rows
    bag_lanes: torch.Tensor,  # (R2,) int32
    bag_valid: torch.Tensor,  # (R2,) bool
    *,
    pad: int,                 # bag rows per lane bucket
    rows_out: int,            # joined-row bucket
    n_lanes: int,
    distinct: bool,           # cross-side all-distinct masks
) -> tuple:
    """Join a materialized GHD bag onto the spine table: every spine row
    pairs with its own lane's bag rows (components share no variables, so
    the join is a per-lane product under the cross-side distinctness
    masks). Same compaction/trunc/count contract as
    :func:`join_expand_step`; a lane whose bag holds more than ``pad``
    rows flags trunc."""
    R1, T1 = cols.shape
    R2, T2 = bag_cols.shape
    dev = cols.device
    # lane-sort the bag so each lane's rows are one contiguous segment
    bkey = torch.where(bag_valid, bag_lanes, n_lanes)
    border = torch.argsort(bkey, stable=True)
    sb_cols = bag_cols[border]
    sb_key = bkey[border]
    bag_off = torch.searchsorted(
        sb_key, torch.arange(n_lanes + 1, dtype=sb_key.dtype, device=dev))
    lane_k = torch.where(valid, lanes, n_lanes).clamp(max=n_lanes - 1)
    starts = bag_off[lane_k]
    bcount = bag_off[lane_k + 1] - starts
    j = torch.arange(pad, device=dev)
    cmask = (j[None, :] < bcount.clamp(max=pad)[:, None]) & valid[:, None]
    over_pad = (bcount > pad) & valid
    bidx = (starts[:, None] + j[None, :]).clamp(max=R2 - 1)
    if distinct:
        for i in range(T1):
            for k in range(T2):
                cmask = cmask & (sb_cols[bidx, k] != cols[:, i, None])
    row_n = cmask.sum(dim=1)
    lane_counts = _lane_add(n_lanes, lanes, row_n)
    flat_mask = cmask.reshape(-1)
    sel = survivors_first(flat_mask)[:rows_out]
    new_valid = flat_mask[sel]
    rsel = sel // pad
    bsel = bidx.reshape(-1)[sel]
    new_cols = torch.cat([cols[rsel], sb_cols[bsel]], dim=1)
    new_lanes = lanes[rsel]
    trunc = _lane_add(n_lanes, lanes,
                      over_pad | _spilled_rows(row_n, rows_out)) > 0
    return new_cols, new_lanes, new_valid, lane_counts, trunc


def join_finalize(
    cols: torch.Tensor,   # (R, V) int32 complete binding rows
    lanes: torch.Tensor,  # (R,) int32
    valid: torch.Tensor,  # (R,) bool
    *,
    top_r: int,
    n_lanes: int,
    sort_cols: tuple,     # column indices in sort priority (highest first)
) -> torch.Tensor:
    """Compact per-request result prefixes: the first ``top_r`` binding
    tuples of every lane, ascending lexicographically by ``sort_cols``
    (the REQUEST's variable order mapped onto the plan's column layout) —
    ``(n_lanes, top_r, V)`` int32, -1-padded."""
    R, V = cols.shape
    dev = cols.device
    lane_k = torch.where(valid, lanes, n_lanes)
    order = torch.arange(R, device=dev)
    for j in reversed(sort_cols):
        order = order[torch.argsort(cols[order, j], stable=True)]
    order = order[torch.argsort(lane_k[order], stable=True)]
    sl = lane_k[order].to(torch.int64)
    idx = torch.arange(R, device=dev)
    first = torch.ones(R, dtype=torch.bool, device=dev)
    first[1:] = sl[1:] != sl[:-1]
    seg_start = torch.cummax(torch.where(first, idx, 0), dim=0).values
    pos = idx - seg_start
    # rows of lane n_lanes or past top_r land in a scratch row each,
    # which is cut off
    keep = (sl < n_lanes) & (pos < top_r)
    dst = torch.where(keep, sl * top_r + pos, n_lanes * top_r + idx)
    out = torch.full((n_lanes * top_r + R, V), -1, dtype=torch.int32,
                     device=dev)
    out[dst] = cols[order]
    return out[: n_lanes * top_r].view(n_lanes, top_r, V)


# ---------------------------------------------------------------- execution


@dataclass
class JoinExecution:
    """Device handles of one executed join batch (nothing synced) — pair
    with ``.cpu()`` / :meth:`full_bindings` to read. ``counts[k]`` is
    exact unless ``trunc[k]`` (then a lower bound). ``hub_lanes`` counts
    the real lanes the degree-split routed through the dense-frontier hub
    chain; ``host_syncs`` the device-to-host reads the launch made (one
    for each row-split step)."""

    order: tuple
    counts: torch.Tensor                   # (K,) int32
    trunc: torch.Tensor                    # (K,) bool
    tuples: Optional[torch.Tensor] = None  # (K, top_r, V) int32, -1 pad
    cols: Optional[torch.Tensor] = None    # full mode: final binding rows
    lanes: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None
    hub_lanes: int = 0
    host_syncs: int = 0

    def full_bindings(self, lane: int) -> np.ndarray:
        """All complete binding rows of one request lane, host-side —
        (n, V) int64 in canonical (table) order."""
        if self.cols is None:
            raise ValueError("execute_join(full=True) required")
        cols = self.cols.cpu().numpy()
        keep = self.valid.cpu().numpy() & (self.lanes.cpu().numpy() == lane)
        return cols[keep].astype(np.int64)


def _rel_arrays(snap: CSRSnapshot, dsnap, rel: str, dev):
    if rel == "co":
        return neighbor_csr_device(snap, dev)
    if rel == "inc":
        return dsnap.inc_offsets, dsnap.inc_links
    return dsnap.tgt_offsets, dsnap.tgt_flat


def _rel_host_offsets(snap: CSRSnapshot, rel: str, device=DEFAULT_DEVICE):
    if rel == "co":
        return neighbor_csr(snap, device)[0]
    if rel == "inc":
        return snap.inc_offsets
    return snap.tgt_offsets


def _rel_max_width(snap: CSRSnapshot, rel: str, fact: Optional[dict],
                   device) -> int:
    """The relation's widest row, cached per (snapshot, relation);
    factorized relations answer from their own group extents (closed co
    rows are one wider than flat)."""
    if fact is not None and rel in fact:
        return fact[rel].max_width
    cache = _device_cache(snap, "_join_wmax")
    if rel not in cache:
        off = np.asarray(
            _rel_host_offsets(snap, rel, device)[: snap.num_atoms + 1],
            dtype=np.int64)
        cache[rel] = int(np.max(np.diff(off), initial=1))
    return cache[rel]


def _rel_widths_of(snap: CSRSnapshot, rel: str, keys: np.ndarray,
                   fact: Optional[dict], device) -> np.ndarray:
    """Host-side row widths of ``keys`` under the encoding the kernels
    will actually gather from (the pad must cover the CLOSED row when
    the factorized co relation serves the step)."""
    if fact is not None and rel in fact:
        fr = fact[rel]
        g = fr.group_of[np.minimum(keys, len(fr.group_of) - 1)]
        off = fr.offsets.astype(np.int64)
        return off[g + 1] - off[g]
    off_h = _rel_host_offsets(snap, rel, device)
    # gather, then widen: the offsets are N+2 long, the keys a batch
    return off_h[keys + 1].astype(np.int64) - off_h[keys]


class _ChainCtx:
    """Shared launch context of one :func:`execute_join` call: the
    device arrays, shape knobs, and factorized twins every chain (tail,
    hub, bag) reads, and the count of host syncs the launch made."""

    def __init__(self, snap, dsnap, device, K, A, consts, consts_dev, n_real,
                 distinct, row_cap, pad_cap, var_pad_max, slot_budget,
                 vwindows, hub_block, fact, fact_dev):
        self.snap = snap
        self.dsnap = dsnap
        self.device = device
        self.K = K
        self.A = A
        self.consts = consts
        self.consts_dev = consts_dev
        self.n_real = n_real
        self.distinct = distinct
        self.row_cap = row_cap
        self.pad_cap = pad_cap
        self.var_pad_max = var_pad_max
        self.slot_budget = slot_budget
        self.vwindows = vwindows
        self.hub_block = hub_block
        self.fact = fact
        self.fact_dev = fact_dev
        self.syncs = 0

    def rel(self, rel: str):
        """(offsets, flat, group, irref) device arrays of one relation —
        the factorized twin when one is in use (inc is never
        factorized)."""
        if self.fact_dev is not None and rel in self.fact_dev:
            g, o, f = self.fact_dev[rel]
            return o, f, g, self.fact[rel].closed
        o, f = _rel_arrays(self.snap, self.dsnap, rel, self.device)
        return o, f, None, False

    def value_window(self, var: str) -> dict:
        """The keyword arguments that put ``var``'s value window on the
        step binding it (none where it has no window)."""
        win = self.vwindows.get(var)
        if win is None:
            return {}
        kind, lo_r, lo_op, hi_r, hi_op = win
        return dict(
            value_cols=(self.dsnap.value_rank, self.dsnap.value_kind),
            value_win=(int(kind), rank_word(lo_r or 0), rank_word(hi_r or 0)),
            value_ops=(lo_op, hi_op),
        )

    def widths_of(self, rel: str, keys: np.ndarray) -> np.ndarray:
        return _rel_widths_of(self.snap, rel, keys, self.fact, self.device)

    def max_width(self, rel: str) -> int:
        return _rel_max_width(self.snap, rel, self.fact, self.device)

    def real_keys(self, step, lane_sel: Optional[np.ndarray]) -> np.ndarray:
        """Clipped const-slot keys of the REAL lanes a pad computation
        may price (optionally a sub-selection — the degree split prices
        tail pads from tail lanes only)."""
        real = (self.consts if self.n_real is None
                else self.consts[: self.n_real])
        if lane_sel is not None:
            real = real[lane_sel[: len(real)]]
        if not len(real):
            return np.zeros(0, dtype=np.int64)
        return np.clip(real[:, step.source_key.index].astype(np.int64),
                       0, self.snap.num_atoms)


def _run_chain(ctx: _ChainCtx, steps, cols, lanes, valid, *,
               hub: bool, lane_sel: Optional[np.ndarray] = None):
    """Run one expand-step chain over an existing binding table. In the
    hub chain, CONST-keyed non-dedupe steps — the ones whose keyed row
    IS a hub row — stream through the chunked dense-frontier kernel;
    var-keyed steps split their rows by width (narrow rows through the
    padded kernel, wide ones through the chunked kernel) and dedupe steps
    keep the padded single-gather path, with pads priced from
    ``lane_sel``'s lanes only. Returns ``(cols, lanes, valid, counts,
    trunc, final_drop)`` — ``final_drop`` isolates a LAST-step row-buffer
    overflow of the hub kernel: the one truncation class that leaves
    ``counts`` exact, so count-only callers need not treat it as
    truncation."""
    K, dev = ctx.K, ctx.device
    trunc = torch.zeros(K, dtype=torch.bool, device=dev)
    final_drop = torch.zeros(K, dtype=torch.bool, device=dev)
    counts = torch.zeros(K, dtype=torch.int32, device=dev)
    type_of = ctx.dsnap.type_of
    for si, s in enumerate(steps):
        R = int(cols.shape[0])
        exp_off, exp_flat, exp_grp, exp_irref = ctx.rel(s.source_rel)
        filt_sel, filt_offs, filt_flats, filt_grps = [], [], [], []
        for f in s.filters:
            fo, ff, fg, firr = ctx.rel(f.rel)
            filt_sel.append((f.rev, f.key.kind, f.key.index, firr))
            filt_offs.append(fo)
            filt_flats.append(ff)
            filt_grps.append(fg)
        common = dict(
            exp_sel=(s.source_key.kind, s.source_key.index),
            filt_sel=tuple(filt_sel),
            type_handle=(-1 if s.type_handle is None
                         else int(s.type_handle)),
            n_lanes=K,
            n_distinct_cols=int(cols.shape[1]) if ctx.distinct else 0,
            distinct_consts=ctx.distinct and ctx.A > 0,
            exp_irref=exp_irref,
            **ctx.value_window(s.var),
        )
        use_hub = hub and not s.dedupe and s.source_key.kind == "const"
        use_row_split = hub and not s.dedupe and \
            s.source_key.kind == "col"
        if use_hub:
            block = _bucket(
                max(min(ctx.hub_block,
                        max(ctx.slot_budget // max(R, 1), 8)), 8),
                minimum=8,
            )
            # survivor bucket sized to what the hub rows can actually
            # mint: on the chain's FIRST step (one table row per lane)
            # exactly the SUM of the keyed row widths; mid-chain rows ×
            # the widest keyed row
            keys = ctx.real_keys(s, lane_sel)
            widths_h = ctx.widths_of(s.source_rel, keys)
            w_max = int(np.max(widths_h, initial=1)) if len(keys) else 1
            cap_rows = (int(widths_h.sum()) if int(cols.shape[1]) == 0
                        else max(R, 1) * max(w_max, 1))
            rows_out = min(_bucket(max(cap_rows, 1)), ctx.row_cap)
            cols, lanes, valid, counts, step_trunc = join_hub_expand(
                exp_off, exp_flat, cols, lanes, valid, ctx.consts_dev,
                tuple(filt_offs), tuple(filt_flats), type_of,
                exp_grp, tuple(filt_grps),
                n_chunks=-(-w_max // block), block=block,
                rows_out=rows_out, group_slots=ctx.slot_budget, **common,
            )
            if si == len(steps) - 1:
                final_drop = final_drop | step_trunc
            else:
                trunc = trunc | step_trunc
            continue
        if s.source_key.kind == "const":
            # real lanes only: zero-filled pad lanes would price every
            # sparse batch's pad by atom 0's row; under a degree split,
            # tail lanes only — one hub must not inflate every tail pad
            keys = ctx.real_keys(s, lane_sel)
            w = (int(np.max(ctx.widths_of(s.source_rel, keys), initial=1))
                 if len(keys) else 1)
        elif ctx.var_pad_max:
            # exact-count mode: pay the relation's true max row width so
            # only the pad_cap itself can truncate
            w = ctx.max_width(s.source_rel)
        else:
            # the estimate is a relation AVERAGE; 4× headroom keeps
            # ordinary rows in-pad (hubs past it flag trunc honestly)
            w = 4 * (int(s.width_est) + 1)
        # the pad is additionally bounded by the candidate-slot budget
        # (R × pad is the step's peak tensor)
        pad = _bucket(
            max(min(w, ctx.pad_cap,
                    max(ctx.slot_budget // max(R, 1), 8)), 1),
            minimum=8,
        )
        rows_out = min(_bucket(R * pad), ctx.row_cap, R * pad)
        if use_row_split:
            # hub-VALUED variables: a var-keyed step on the hub chain can
            # bind rows that are themselves hubs, and no pad holds them.
            # Rows within the pad keep the single-gather kernel; the few
            # wider rows compact into a small bucket and stream through
            # the chunked kernel
            key_dev = torch.where(valid, cols[:, s.source_key.index],
                                  ctx.snap.num_atoms)
            s_dev, e_dev = _seg_of(exp_off, exp_grp, key_dev)
            w_dev = e_dev - s_dev
            wide = valid & (w_dev > pad)
            wide_bucket = min(_bucket(max(R // 8, 64)), _bucket(R))
            wsel = survivors_first(wide)[:wide_bucket]
            w_cols, w_lanes = cols[wsel], lanes[wsel]
            w_valid = wide[wsel]
            wide_over = _lane_add(K, lanes,
                                  _spilled_rows(wide, wide_bucket)) > 0
            n_cols, n_lanes_a, n_valid, n_counts, n_trunc = \
                join_expand_step(
                    exp_off, exp_flat, cols, lanes, valid & ~wide,
                    ctx.consts_dev, tuple(filt_offs), tuple(filt_flats),
                    type_of, exp_grp, tuple(filt_grps),
                    pad=pad, rows_out=rows_out, dedupe=False, **common,
                )
            block = _bucket(
                max(min(ctx.hub_block,
                        max(ctx.slot_budget // max(wide_bucket, 1),
                            8)), 8),
                minimum=8,
            )
            rows_out_w = min(
                _bucket(wide_bucket * ctx.max_width(s.source_rel)),
                ctx.row_cap,
            )
            # the wide rows' widths bound the tiles and let them skip
            # exhausted rows: one read of the card
            w_widths = torch.where(w_valid, w_dev[wsel], 0).cpu().numpy()
            ctx.syncs += 1
            w_max = int(w_widths.max(initial=0))
            w_cols, w_lanes_a, w_valid, w_counts, w_trunc = \
                join_hub_expand(
                    exp_off, exp_flat, w_cols, w_lanes, w_valid,
                    ctx.consts_dev, tuple(filt_offs), tuple(filt_flats),
                    type_of, exp_grp, tuple(filt_grps),
                    n_chunks=-(-w_max // block), block=block,
                    rows_out=rows_out_w, row_widths=w_widths,
                    group_slots=ctx.slot_budget, **common,
                )
            cols = torch.cat([n_cols, w_cols])
            lanes = torch.cat([n_lanes_a, w_lanes_a])
            valid = torch.cat([n_valid, w_valid])
            counts = n_counts + w_counts
            # narrow rows fit the pad by construction and the wide pass
            # never width-truncates: both kernels' flags are pure
            # row-buffer drops (count-preserving on a final step); only
            # the wide-bucket overflow loses candidates outright
            if si == len(steps) - 1:
                final_drop = final_drop | n_trunc | w_trunc
                trunc = trunc | wide_over
            else:
                trunc = trunc | n_trunc | w_trunc | wide_over
            continue
        cols, lanes, valid, counts, step_trunc = join_expand_step(
            exp_off, exp_flat, cols, lanes, valid, ctx.consts_dev,
            tuple(filt_offs), tuple(filt_flats), type_of,
            exp_grp, tuple(filt_grps),
            pad=pad, rows_out=rows_out, dedupe=s.dedupe, **common,
        )
        trunc = trunc | step_trunc
    return cols, lanes, valid, counts, trunc, final_drop


def _split_chain(ctx: _ChainCtx, steps, base_valid, hub_mask):
    """One component's chain under the degree split: tail lanes through
    the padded fast path, hub lanes (``hub_mask``) through the chunked
    dense-frontier chain, tables re-pooled afterwards. Returns
    ``(cols, lanes, valid, counts, trunc, final_drop, n_hub)``."""
    K, dev = ctx.K, ctx.device
    cols0 = torch.zeros((K, 0), dtype=torch.int32, device=dev)
    lanes0 = torch.arange(K, dtype=torch.int32, device=dev)
    n_hub = int(hub_mask.sum()) if hub_mask is not None else 0
    if not n_hub:
        out = _run_chain(ctx, steps, cols0, lanes0, base_valid, hub=False)
        return (*out, 0)
    hub_dev = torch.from_numpy(hub_mask).to(dev)
    if n_hub >= (ctx.K if ctx.n_real is None else ctx.n_real):
        out = _run_chain(ctx, steps, cols0, lanes0, base_valid & hub_dev,
                         hub=True, lane_sel=hub_mask)
        return (*out, n_hub)
    t_cols, t_lanes, t_valid, t_counts, t_trunc, t_fd = _run_chain(
        ctx, steps, cols0, lanes0, base_valid & ~hub_dev, hub=False,
        lane_sel=~hub_mask,
    )
    h_cols, h_lanes, h_valid, h_counts, h_trunc, h_fd = _run_chain(
        ctx, steps, cols0, lanes0, base_valid & hub_dev, hub=True,
        lane_sel=hub_mask,
    )
    return (
        torch.cat([t_cols, h_cols]),
        torch.cat([t_lanes, h_lanes]),
        torch.cat([t_valid, h_valid]),
        t_counts + h_counts,
        t_trunc | h_trunc,
        t_fd | h_fd,
        n_hub,
    )


def _resolve_factorized(snap: CSRSnapshot, factorized, dev):
    """The per-call factorized-relation decision: ``False`` = flat CSRs,
    ``True`` = build (and cache) the trie encoding now, ``None`` = use
    it only when someone already built it for this snapshot (ad-hoc
    callers never pay the build implicitly)."""
    if factorized is False:
        return None, None
    if factorized is None and getattr(snap, "_fact_rels", None) is None:
        return None, None
    fact = factorized_relations(snap, dev)
    return fact, factorized_relations_device(snap, dev)


def _base_valid(ctx: _ChainCtx) -> torch.Tensor:
    if ctx.n_real is None:
        return torch.ones(ctx.K, dtype=torch.bool, device=ctx.device)
    return torch.arange(ctx.K, device=ctx.device) < int(ctx.n_real)


def _hub_mask(ctx: _ChainCtx, steps, hub_split: bool,
              hub_threshold: Optional[int]):
    """The planner's degree-split policy applied to this batch's
    constants (``join/planner.hub_lane_mask``), or None when the split
    is off / no lane qualifies."""
    if not hub_split or not steps:
        return None
    thr = min(hub_threshold if hub_threshold is not None else ctx.pad_cap,
              ctx.pad_cap)
    n_real = ctx.K if ctx.n_real is None else ctx.n_real
    mask = hub_lane_mask(ctx.snap, steps, ctx.consts[:n_real], thr,
                         device=ctx.device)
    if not mask.any():
        return None
    if len(mask) < ctx.K:
        mask = np.concatenate([mask, np.zeros(ctx.K - len(mask), bool)])
    return mask


def _finish(ctx: _ChainCtx, plan, out: "JoinExecution", cols, lanes, valid,
            *, top_r: int, full: bool, count_only: bool) -> "JoinExecution":
    out.host_syncs = ctx.syncs
    if count_only:
        return out
    if top_r > 0:
        sort_cols = tuple(plan.order.index(v) for v in plan.sig.vars)
        out.tuples = join_finalize(cols, lanes, valid, top_r=top_r,
                                   n_lanes=ctx.K, sort_cols=sort_cols)
    if full:
        out.cols, out.lanes, out.valid = cols, lanes, valid
    return out


def execute_join(
    snap: CSRSnapshot,
    plan,                    # join/planner.JoinPlan | BushyJoinPlan
    consts: np.ndarray,      # (K, n_consts) int32 — per-request constants
    *,
    top_r: int = 16,
    full: bool = False,      # keep the final binding table downloadable
    count_only: bool = False,
    seeds: Optional[np.ndarray] = None,  # pre-bound var-0 candidates
    row_cap: int = DEFAULT_ROW_CAP,
    pad_cap: int = DEFAULT_PAD_CAP,
    var_pad_max: bool = False,
    n_real: Optional[int] = None,
    slot_budget: int = DEFAULT_SLOT_BUDGET,
    value_windows: Optional[dict] = None,
    hub_split: bool = True,
    hub_threshold: Optional[int] = None,
    hub_block: int = DEFAULT_HUB_BLOCK,
    factorized: Optional[bool] = None,
    device=DEFAULT_DEVICE,
) -> JoinExecution:
    """Run ``plan`` for K same-signature requests in one batched pass on
    ``device`` (the card unless the caller asks for the CPU). Every
    returned tensor stays on the device, unsynced; the launch itself
    reads the card only on row-split steps (``host_syncs``).

    Shape policy: expansion pads for constant-keyed steps come from the
    BATCH's actual maximum row width, power-of-two bucketed and capped at
    ``pad_cap``; variable-keyed steps use the plan's estimate bucket
    (``var_pad_max=True`` pays the relation's true max row width instead —
    the exact-count mode). Row buckets grow multiplicatively and cap at
    ``row_cap``. Anything the caps cut off surfaces per request in
    ``trunc`` — never silently.

    ``hub_split=True``: lanes whose const-keyed rows exceed
    ``hub_threshold`` (default: the pad cap) run their whole chain through
    the chunked :func:`join_hub_expand` kernel, so hub anchors expand at
    ANY width without truncation. ``factorized`` routes the co/tgt
    gathers through the prefix-grouped encoding (None = only when the
    snapshot already carries one — see :func:`factorized_relations`).

    ``seeds`` replaces the first step: the given ids become the var-0
    binding column of ONE request lane (global counting: chunk the id
    space, sum the counts). ``n_real`` marks lanes past it as padding:
    they count nothing and their constants are never read as rows.

    ``value_windows`` maps a plan variable to a value-rank window ``(kind,
    lo_rank, lo_op, hi_rank, hi_op)`` (64-bit ranks, ops gt/gte and
    lt/lte, None = open), applied as a candidate filter INSIDE the step
    binding that variable, so out-of-window candidates never take binding
    rows. Callers own kind exactness: fixed-width kinds only, since rank
    ties of variable-width kinds would drop true matches silently."""
    vwindows = dict(value_windows or {})
    for var, (kind, lo_r, lo_op, hi_r, hi_op) in vwindows.items():
        if not 0 <= int(kind) < 256 or lo_op not in (None, "gt", "gte") \
                or hi_op not in (None, "lt", "lte"):
            raise ValueError(f"bad value window on {var!r}: kind must be a "
                             "byte, lo_op gt/gte/None, hi_op lt/lte/None")
    dev = resolve_device(device)
    dsnap = snap.device(dev)
    K, A = (int(consts.shape[0]), int(consts.shape[1]))
    consts = np.ascontiguousarray(consts, dtype=np.int32)
    real = consts if n_real is None else consts[: int(n_real)]
    if real.size and (int(real.min()) < 0
                      or int(real.max()) > snap.num_atoms):
        raise ValueError(
            f"join constants must be atom ids in [0, {snap.num_atoms}]")
    consts_dev = (torch.from_numpy(consts).to(dev) if A
                  else torch.zeros((K, 0), dtype=torch.int32, device=dev))
    fact, fact_dev = _resolve_factorized(snap, factorized, dev)
    ctx = _ChainCtx(
        snap, dsnap, dev, K, A, consts, consts_dev, n_real, plan.distinct,
        row_cap, pad_cap, var_pad_max, slot_budget, vwindows, hub_block,
        fact, fact_dev,
    )
    kw = dict(top_r=top_r, full=full, count_only=count_only)
    if getattr(plan, "bags", None) is not None:
        if seeds is not None:
            raise ValueError("seeds mode requires a left-deep plan")
        return _execute_bushy(ctx, plan, hub_split=hub_split,
                              hub_threshold=hub_threshold, **kw)
    if seeds is None:
        hub_mask = _hub_mask(ctx, plan.steps, hub_split, hub_threshold)
        cols, lanes, valid, counts, trunc, final_drop, n_hub = \
            _split_chain(ctx, plan.steps, _base_valid(ctx), hub_mask)
    else:
        if K != 1:
            raise ValueError("seeds mode is single-lane (K == 1)")
        seeds = np.ascontiguousarray(seeds, dtype=np.int32)
        cols = torch.from_numpy(seeds).to(dev)[:, None]
        lanes = torch.zeros(len(seeds), dtype=torch.int32, device=dev)
        valid = torch.ones(len(seeds), dtype=torch.bool, device=dev)
        steps = plan.steps[1:]
        n_hub = 0
        final_drop = torch.zeros(K, dtype=torch.bool, device=dev)
        # a 1-variable plan in seeds mode has no steps left: the seeds
        # ARE the complete bindings
        if not steps:
            counts = _lane_add(K, lanes, valid)
            trunc = torch.zeros(K, dtype=torch.bool, device=dev)
        else:
            cols, lanes, valid, counts, trunc, final_drop = _run_chain(
                ctx, steps, cols, lanes, valid, hub=False
            )
    # count-only callers never download the (clipped) table, and a
    # final-step hub drop leaves counts exact — not a truncation for
    # them; tuple/full consumers still see it flagged
    out = JoinExecution(
        order=plan.order, counts=counts,
        trunc=(trunc if count_only else trunc | final_drop),
        hub_lanes=n_hub,
    )
    return _finish(ctx, plan, out, cols, lanes, valid, **kw)


def _execute_bushy(ctx: _ChainCtx, plan, *, top_r: int, full: bool,
                   count_only: bool, hub_split: bool,
                   hub_threshold: Optional[int]) -> JoinExecution:
    """The bushy GHD executor: run the spine component's chain, run each
    bag's chain to a small materialized table, then fold bags onto the
    spine with :func:`join_bag_join` (cross-component distinctness at
    each fold). Counts come from the final fold; truncation anywhere —
    spine, a bag chain, a fold's pad or row bucket — flags the owning
    lane."""
    K = ctx.K
    base_valid = _base_valid(ctx)
    hub_mask = _hub_mask(ctx, plan.spine, hub_split, hub_threshold)
    cols, lanes, valid, counts, trunc, s_fd, n_hub = _split_chain(
        ctx, plan.spine, base_valid, hub_mask
    )
    # every chain output feeds a fold here, so a clipped table anywhere
    # undercounts downstream: final-step drops are NOT count-preserving
    # in a bushy plan — fold them into trunc conservatively
    trunc = trunc | s_fd
    for bag in plan.bags:
        b_hub = _hub_mask(ctx, bag.steps, hub_split, hub_threshold)
        b_cols, b_lanes, b_valid, _, b_trunc, b_fd, b_n_hub = \
            _split_chain(ctx, bag.steps, base_valid, b_hub)
        b_trunc = b_trunc | b_fd
        n_hub += b_n_hub
        R1 = int(cols.shape[0])
        R2 = int(b_cols.shape[0])
        pad = _bucket(
            max(min(_bucket(R2),
                    max(ctx.slot_budget // max(R1, 1), 8)), 8),
            minimum=8,
        )
        rows_out = min(_bucket(R1 * pad), ctx.row_cap, R1 * pad)
        cols, lanes, valid, counts, j_trunc = join_bag_join(
            cols, lanes, valid, b_cols, b_lanes, b_valid,
            pad=pad, rows_out=rows_out, n_lanes=K,
            distinct=plan.distinct,
        )
        trunc = trunc | b_trunc | j_trunc
    out = JoinExecution(order=plan.order, counts=counts, trunc=trunc,
                        hub_lanes=n_hub)
    return _finish(ctx, plan, out, cols, lanes, valid, top_r=top_r,
                   full=full, count_only=count_only)
