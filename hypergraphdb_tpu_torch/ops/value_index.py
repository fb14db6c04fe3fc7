"""Batched range, ordered and top-k requests over sorted value columns.

The port of ``hypergraphdb_tpu/ops/value_index.py``, plain PyTorch (the
reference reaches no ``pl.pallas_call`` here), and of the range lane's
dispatch from ``serve/runtime.py`` (``_serve_range``, ``_range_win_pad``,
``_dummy_inc_csr``) as free functions. Against a
``storage/value_index.ValueIndexColumn`` a range predicate is two
vectorized binary searches, and an ordered or top-k request a bounded
gather off the window's relevant end.

- :func:`range_probe_batch`: per-lane ``searchsorted`` of the bounds'
  rank words over one sorted column; ``hi_idx - lo_idx`` is the exact
  unfiltered count.
- :func:`ordered_topk_batch`: the probe over a base AND a delta column,
  bounded candidate gathers, per-lane type and incident-anchor filters,
  then a merge of the two windows into the ``top_r`` smallest or largest
  per lane. ``covered`` flags lanes whose windows both fit the gather pad.
- :func:`serve_range_batch`: one batch of host bounds (:func:`lane_bounds`)
  through :func:`ordered_topk_batch` on the snapshot's device columns.

Rank words: a 64-bit rank is one int64 with its sign bit flipped
(``ops/snapshot.rank_words``), so the reference's four-uint32 compare
(hi, lo, hi2, lo2) is a two-word compare here (``rank``, then ``rank2``),
and its descending complement ``~x`` reverses the order of int64 words as
it does of uint32 ones. Fixed-width kinds carry zero second words.

What differs from the reference, and why:

- The search's midpoint is ``lo + ((hi - lo) >> 1)``, which cannot wrap,
  and it runs as many rounds as the column's depth needs (at most 32).
- Torch raises on an index out of range where JAX clamps: the anchor of a
  lane is clamped into the incidence offsets it is given, so the 2-entry
  dummy CSR of an anchor-free batch reads empty segments (every such lane
  masks the probe out, as in the reference). :func:`serve_range_batch`
  refuses anchors outside the snapshot's atoms.
- The request handling (``serve/runtime._range_result``: the memtable's
  corrections and the host oracle over the by-value index) lives in the
  serve runtime, which reads the graph.
"""

from __future__ import annotations

import numpy as np
import torch

from hypergraphdb_tpu_torch import verify as hgverify
from hypergraphdb_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from hypergraphdb_tpu_torch.ops.setops import (
    SENTINEL,
    _bucket,
    segment_member_mask,
)
from hypergraphdb_tpu_torch.ops.snapshot import rank_words
from hypergraphdb_tpu_torch.storage.value_index import (
    RANK_PAD,
    ValueIndexColumn,
    inc_csr_device,
    type_of_device,
)

#: the rank word of the largest rank: an open upper bound, and the key of
#: invalid slots (after every real one)
_WORD_MAX = int(RANK_PAD)


def _searchsorted2(col_rank: torch.Tensor, col_rank2: torch.Tensor,
                   n_real: int, q: torch.Tensor, q2: torch.Tensor,
                   right: torch.Tensor) -> torch.Tensor:
    """Branchless per-lane binary search of two-word queries over one
    sorted two-word column, bounded by the column's real length (pads are
    never probed). ``right`` picks the side per lane: False = leftmost
    position (ties insert before), True = rightmost."""
    m_max = col_rank.shape[0] - 1
    lo = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    hi = torch.full(q.shape, int(n_real), dtype=torch.int32, device=q.device)
    for _ in range(min(32, int(n_real).bit_length())):
        active = lo < hi
        mid = lo + ((hi - lo) >> 1)
        m = mid.clamp(max=m_max)
        v, v2 = col_rank[m], col_rank2[m]
        eq1 = v == q
        less = (v < q) | (eq1 & (v2 < q2))
        go_right = less | (right & eq1 & (v2 == q2))
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


@hgverify.entry(
    shapes=lambda device, seed: (
        hgverify.value_columns_exemplar(device, seed)[0],
        *hgverify.bound_tensors(hgverify.range_bounds(seed), device,
                                BOUND_KEYS[:6])),
)
def range_probe_batch(col: ValueIndexColumn, lo: torch.Tensor,
                      lo2: torch.Tensor, lo_right: torch.Tensor,
                      hi: torch.Tensor, hi2: torch.Tensor,
                      hi_right: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """K range windows over ONE sorted column: ``(lo_idx, hi_idx)`` (K,)
    int32 each, with ``hi_idx >= lo_idx``; their difference is the exact
    unfiltered count. Bounds are (K,) rank words; ``lo_right`` True makes
    the lower bound exclusive (gt), ``hi_right`` True the upper inclusive
    (lte). Pad lanes pass equal bounds (an empty window). Both bounds go
    through one search of 2K queries (half the launches of two)."""
    k = lo.shape[0]
    idx = _searchsorted2(col.rank, col.rank2, col.n, torch.cat([lo, hi]),
                         torch.cat([lo2, hi2]),
                         torch.cat([lo_right, hi_right]))
    lo_idx, hi_idx = idx[:k], idx[k:]
    return lo_idx, torch.maximum(hi_idx, lo_idx)


def _window_gather(col: ValueIndexColumn, lo_idx, hi_idx, desc,
                   win_pad: int):
    """Up to ``win_pad`` entries per lane off each window's relevant end
    (its start for ascending lanes, its end for descending ones):
    ``(rank, rank2, gid, valid)``, each (K, win_pad)."""
    m_max = col.rank.shape[0] - 1
    take = (hi_idx - lo_idx).clamp(max=win_pad)
    start = torch.where(desc, hi_idx - take, lo_idx)
    lane_ix = torch.arange(win_pad, dtype=torch.int32, device=lo_idx.device)
    valid = lane_ix[None, :] < take[:, None]
    idx = torch.where(valid, start[:, None] + lane_ix[None, :], 0)
    idx = idx.clamp(max=m_max)
    return col.rank[idx], col.rank2[idx], col.gids[idx], valid


def _topk_exemplar(device, seed: int) -> tuple:
    """:func:`ordered_topk_batch`'s exemplar: the base and delta columns
    of the exemplar snapshot, its type column and incidence CSR, and 8
    lanes of bounds."""
    base, delta = hgverify.value_columns_exemplar(device, seed)
    dev = hgverify.dev_snapshot_exemplar(device, seed)
    return (base, delta, dev.type_of, dev.inc_offsets, dev.inc_links,
            *hgverify.bound_tensors(hgverify.range_bounds(seed), device,
                                    BOUND_KEYS))


@hgverify.entry(
    shapes=lambda device, seed: _topk_exemplar(device, seed),
    statics={"win_pad": 8, "top_r": 4},
)
def ordered_topk_batch(
    base: ValueIndexColumn,
    delta: ValueIndexColumn,
    type_of: torch.Tensor,      # (N+1,) int32 per-atom type handles
    inc_offsets: torch.Tensor,  # incidence CSR offsets (anchor filter)
    inc_links: torch.Tensor,
    lo: torch.Tensor,           # (K,) int64 lower-bound rank words
    lo2: torch.Tensor,
    lo_right: torch.Tensor,     # (K,) bool: True = exclusive lower (gt)
    hi: torch.Tensor,           # (K,) int64 upper-bound rank words
    hi2: torch.Tensor,
    hi_right: torch.Tensor,     # (K,) bool: True = inclusive upper (lte)
    type_vec: torch.Tensor,     # (K,) int32 per-lane type handle, <0 = any
    anchor_vec: torch.Tensor,   # (K,) int32 per-lane anchor, <0 = none
    desc: torch.Tensor,         # (K,) bool: True = the LARGEST values
    *,
    win_pad: int,               # candidate gather width per column
    top_r: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Range probe, filters and merged top-k for K lanes.

    Returns ``(counts, first_r, covered, window_total)``:

    - ``window_total`` (K,) int32: the exact unfiltered window size (base
      plus delta);
    - ``covered`` (K,) bool: both windows fit the gather pad, so the
      filtered ``counts`` are exact and ``first_r`` is the complete
      filtered set's prefix; an uncovered lane is exact only without
      filters (its ``first_r`` is still the honest value-ordered prefix:
      each column's first or last ``win_pad`` dominate any top ``top_r``);
    - ``counts`` (K,) int32: filtered survivors among the candidates;
    - ``first_r`` (K, top_r) int32: gids in the requested value order
      (ascending rank, or descending for ``desc`` lanes; rank ties break
      toward the smaller gid either way), SENTINEL past the count.
    """
    if win_pad < top_r:
        raise ValueError(f"win_pad {win_pad} < top_r {top_r}: the merged "
                         "prefix could miss global top-k entries")
    bounds = (lo, lo2, lo_right, hi, hi2, hi_right)
    lo_b, hi_b = range_probe_batch(base, *bounds)
    lo_d, hi_d = range_probe_batch(delta, *bounds)
    window_total = (hi_b - lo_b) + (hi_d - lo_d)
    covered = ((hi_b - lo_b) <= win_pad) & ((hi_d - lo_d) <= win_pad)

    parts = [_window_gather(c, a, b, desc, win_pad)
             for c, a, b in ((base, lo_b, hi_b), (delta, lo_d, hi_d))]
    k, k2, gid, valid = (torch.cat(p, dim=1) for p in zip(*parts))

    n1 = type_of.shape[0]
    safe = gid.clamp(0, n1 - 1).long()
    want = type_vec[:, None]
    valid = valid & ((want < 0) | (type_of[safe] == want))
    # incident-anchor filter: candidate ∈ inc_row(anchor), searched in
    # place; anchor-free lanes read the dummy row, clamped into the
    # offsets given (an anchor-free batch may pass a 2-entry dummy CSR)
    anchor = torch.where(anchor_vec < 0, n1 - 1, anchor_vec)
    anchor = anchor.clamp(0, inc_offsets.shape[0] - 2).long()
    probe = torch.where(valid, gid, int(SENTINEL))
    member = segment_member_mask(inc_links, inc_offsets[anchor],
                                 inc_offsets[anchor + 1], probe)
    valid = valid & ((anchor_vec < 0)[:, None] | member)

    counts = valid.sum(dim=1, dtype=torch.int32)
    # the requested order as a key transform: complement the rank words
    # of descending lanes; gids stay ascending so rank ties break the same
    # way in both orders. Invalid slots take the largest keys AFTER the
    # transform, so they sort last everywhere
    flip = desc[:, None]
    k = torch.where(flip, ~k, k).masked_fill(~valid, _WORD_MAX)
    k2 = torch.where(flip, ~k2, k2).masked_fill(~valid, _WORD_MAX)
    gid = gid.masked_fill(~valid, int(SENTINEL))
    # (k, k2, gid) ascending: stable sorts from the least significant key
    order = torch.argsort(gid, dim=1, stable=True)
    for key in (k2, k):
        step = torch.argsort(torch.gather(key, 1, order), dim=1, stable=True)
        order = torch.gather(order, 1, step)
    first_r = torch.gather(gid, 1, order[:, :top_r])
    return counts, first_r, covered, window_total


# ------------------------------------------------------------ the range lane


def range_win_pad(top_r: int) -> int:
    """Candidate gather width per column: the smallest power-of-two bucket
    holding ``top_r`` (the merge's prefix-dominance floor)."""
    return _bucket(top_r, minimum=8)


def _dummy_inc_csr(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The anchor-free range dispatch's stand-in incidence CSR: empty
    segments wherever the (masked-off) probe reads."""
    return (torch.zeros(2, dtype=torch.int32, device=device),
            torch.zeros(8, dtype=torch.int32, device=device))


#: the host arrays of one range batch, in :func:`ordered_topk_batch`'s order
BOUND_KEYS = ("lo", "lo2", "lo_right", "hi", "hi2", "hi_right", "type_vec",
              "anchor", "desc")


def lane_bounds(n_lanes: int, lo, lo_right, hi, hi_right, *,
                lo2=None, hi2=None, type_vec=None, anchor=None,
                desc=None) -> dict:
    """Host arrays of one range batch of ``n_lanes`` lanes from the first
    ``len(lo)`` requests: 64-bit ranks (``lo``, ``hi``, and the second
    words ``lo2``, ``hi2``, default 0) as rank words, the sides
    (``lo_right`` True = gt, ``hi_right`` True = lte), per-lane type and
    anchor (-1 = none) and ``desc``. An open lower bound is rank 0 with
    gte; an open upper bound rank ``2**64 - 1`` with lte and second word
    ``2**64 - 1``. Lanes past the requests get empty windows (both bounds
    leftmost of rank 0)."""
    n = len(lo)
    if n > n_lanes:
        raise ValueError(f"{n} requests do not fit {n_lanes} lanes")

    def lanes(vals, dtype, fill):
        out = np.full(n_lanes, fill, dtype=dtype)
        if vals is not None:
            out[:n] = vals
        return out

    zero = int(rank_words(0))
    return {
        "lo": lanes(rank_words(lo), np.int64, zero),
        "lo2": lanes(None if lo2 is None else rank_words(lo2), np.int64,
                     zero),
        "lo_right": lanes(lo_right, bool, False),
        "hi": lanes(rank_words(hi), np.int64, zero),
        "hi2": lanes(None if hi2 is None else rank_words(hi2), np.int64,
                     zero),
        "hi_right": lanes(hi_right, bool, False),
        "type_vec": lanes(type_vec, np.int32, -1),
        "anchor": lanes(anchor, np.int32, -1),
        "desc": lanes(desc, bool, False),
    }


def serve_range_batch(snap, base: ValueIndexColumn, delta: ValueIndexColumn,
                      bounds: dict, top_r: int = 16,
                      device: str | torch.device = DEFAULT_DEVICE):
    """One range batch dispatch: :func:`ordered_topk_batch` over the base
    and delta columns on ``device`` (the card unless the caller asks for
    the CPU), with the host ``bounds`` of :func:`lane_bounds`, ``win_pad``
    from :func:`range_win_pad`. A batch with no anchored lane passes the
    dummy incidence CSR, so the snapshot's CSR is never uploaded for it.
    Returns the four device tensors unsynced."""
    dev = resolve_device(device)
    anchor = np.asarray(bounds["anchor"])
    if anchor.size and int(anchor.max()) >= snap.num_atoms:
        raise ValueError(f"range anchors must be atom ids below "
                         f"{snap.num_atoms} (or -1 for none)")
    if (anchor >= 0).any():
        inc_off, inc_links = inc_csr_device(snap, dev)
    else:
        inc_off, inc_links = _dummy_inc_csr(dev)
    lanes = [torch.from_numpy(np.ascontiguousarray(bounds[k])).to(dev)
             for k in BOUND_KEYS]
    return ordered_topk_batch(
        base, delta, type_of_device(snap, dev), inc_off, inc_links, *lanes,
        win_pad=range_win_pad(top_r), top_r=top_r)

