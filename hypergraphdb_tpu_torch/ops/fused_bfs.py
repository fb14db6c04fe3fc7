"""K2, the fused pull-BFS hop: a whole hop in one kernel launch.

The port of ``hypergraphdb_tpu/ops/pallas_bfs.py``. The staged chain of
``ops/ellbfs.py`` runs a hop as two pyramids of gather-ORs through stage
buffers; the fused hop composes both stages on the host into one atom→atom
adjacency, ``{t : t ∈ tgt(l), l ∈ inc(v)}`` (duplicates kept, OR is the
dedup), and runs

    new[r] = old[r] | OR_{c ∈ chunks(r)} OR_{j<w} old[idx[c·w + j]]

over the transposed visited bitmap, with nothing between old and new.

Replaces the Pallas kernel ``_hop_kernel`` (:313; launched by ``_hop_call``
:365, driven by ``_hop_fused`` :390 and ``_bfs_fused`` :571). The CUDA
kernel is ``csrc/fused_hop.cu``. Its plan is flat: the per-segment
``blk_off``/``chunk_rows``/``idx`` windows existed for the TPU's SMEM, and
the port keeps only the row→chunks composition (``row_chunk_starts``,
``idx``) plus a list of work items, each at most :data:`ITEM_CHUNKS` chunks
of one row. A hub row is split over several items (one warp each) instead
of being declined. Lanes are not padded to 128 words; that was a Mosaic
rule.

Each hop reads only the old bitmap and writes a second buffer; the two
ping-pong across hops. An in-place OR would let a hop see bits set in the
same hop and over-reach. Beside each bitmap the BFS keeps its line-occupancy
mask (``ops/linemask.py``): the kernel skips the gathers that cannot add a
bit (self entries, zero rows and lines, saturated lanes) and emits the mask
of the bitmap it writes, which the next hop reads.

A delta over the base (``ops/incremental.py``) rides each hop as an
*overlay* (reference :420-513): two small reduction pyramids over the delta
COO, run through K1 like the staged chain, whose rows are ORed into the
bitmap K2 wrote, with their line-mask fields. Tombstones cannot ride it
(the composed adjacency cannot drop a dead link): the served route checks
them first and takes the dense sweep instead.

:func:`plan_supported` keeps the "None or a reason string" contract with
the port's own rule: the fused index grows as Σ arity² and can dwarf the
CSR, so its int32 entries must fit :data:`FUSED_INDEX_BUDGET` bytes of
device memory, checked from the degrees before anything is materialized.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from hypergraphdb_tpu_torch import verify as hgverify
from hypergraphdb_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from hypergraphdb_tpu_torch.ops import _cuda, linemask
from hypergraphdb_tpu_torch.ops.ellbfs import (
    WORD,
    _apply_plan,
    _ceil_to,
    _rebase_upper,
    _segmented_ranges,
    bitdot,
    build_reduce_plan,
    seed_bitmap,
    seed_mask,
)
from hypergraphdb_tpu_torch.ops.gather_or import PLAIN_CHUNK, or_fold
from hypergraphdb_tpu_torch.ops.snapshot import CSRSnapshot

#: fused-adjacency chunk width (visited rows OR'd per chunk)
W = 8
#: most chunks one work item (one warp of the kernel) covers; longer rows
#: split over several items
ITEM_CHUNKS = 64
#: device bytes the fused index may take: a fifth of an 80 GB card, which
#: leaves room for the two visited bitmaps of a 10M-atom, 4096-seed BFS
FUSED_INDEX_BUDGET = 16 << 30
#: the first_r compaction's int32 id value for "no atom"
SENTINEL = np.int32(np.iinfo(np.int32).max)
#: chunks per streamed block of the fused hop's plain version
PLAIN_CHUNKS = 1 << 16


# ---------------------------------------------------------------- host plans


class FusedGeom(NamedTuple):
    """Static geometry of a fused plan."""

    n_atoms: int        # N; row N is the dummy row
    n_rows: int         # row space: atoms + dummy + spare rows, last is zero
    w: int              # chunk width
    zero_row: int       # guaranteed-all-zero visited row (= n_rows - 1)
    total_entries: int  # real fused-adjacency entries (traffic model)
    n_chunks: int       # chunks over all rows
    n_items: int        # kernel work items


@dataclass(frozen=True)
class FusedPlan:
    """Host precompute for the fused hop over one snapshot.

    Row ``v`` of the fused adjacency lists every atom ``t`` with ``t ∈
    tgt(l)`` for some incident link ``l ∈ inc(v)``. Rows pad to whole
    ``w``-chunks (pad entries gather the zero row) and chunks are ordered
    row-major: row ``r`` owns chunks ``[row_chunk_starts[r],
    row_chunk_starts[r+1])``. Work item ``i`` covers chunks ``[item_off[i],
    item_off[i+1])`` of row ``item_row[i]``; every row has at least one
    item, so the kernel writes every row of the new bitmap."""

    geom: FusedGeom
    row_chunk_starts: np.ndarray  # (n_rows+1,) int64
    idx: np.ndarray               # (n_chunks*w,) int32 — visited rows to gather
    item_off: np.ndarray          # (n_items+1,) int64 — chunk bounds per item
    item_row: np.ndarray          # (n_items,) int32 — row of each item
    inc_deg: np.ndarray           # (n_rows,) int32 — incidence degree


def _fused_degrees(snap: CSRSnapshot):
    """(ar, pre, fused_deg): arity per incidence entry, its prefix sums, and
    the fused degree per atom row (a segment sum of arities)."""
    n1 = snap.num_atoms + 1
    inc_off = np.asarray(snap.inc_offsets[: n1 + 1], dtype=np.int64)
    inc_links = np.asarray(snap.inc_links[: snap.n_edges_inc], dtype=np.int64)
    tgt_off = np.asarray(snap.tgt_offsets[: n1 + 1], dtype=np.int64)
    ar = tgt_off[inc_links + 1] - tgt_off[inc_links]
    pre = np.zeros(len(inc_links) + 1, dtype=np.int64)
    np.cumsum(ar, out=pre[1:])
    fused_deg = pre[inc_off[1 : n1 + 1]] - pre[inc_off[:n1]]
    return ar, pre, fused_deg


def fused_index_bytes(snap: CSRSnapshot) -> int:
    """Device bytes of the fused index for ``snap`` at chunk width ``W``
    (memoized): the cheap O(E) pre-check that runs before any plan is
    materialized."""
    nbytes = getattr(snap, "_fused_index_bytes", None)
    if nbytes is None:
        _, _, fused_deg = _fused_degrees(snap)
        nbytes = int((-(-fused_deg // W)).sum()) * W * 4
        object.__setattr__(snap, "_fused_index_bytes", nbytes)
    return nbytes


def build_fused_plan(snap: CSRSnapshot, w: int = W) -> FusedPlan:
    """Compose the snapshot's two CSR stages into the fused chunk plan."""
    N = snap.num_atoms
    n1 = N + 1
    inc_off = np.asarray(snap.inc_offsets[: n1 + 1], dtype=np.int64)
    inc_links = np.asarray(snap.inc_links[: snap.n_edges_inc], dtype=np.int64)
    tgt_off = np.asarray(snap.tgt_offsets[: n1 + 1], dtype=np.int64)
    tgt_flat = np.asarray(snap.tgt_flat[: snap.n_edges_tgt], dtype=np.int32)
    ar, pre, fused_deg = _fused_degrees(snap)
    nchunk = -(-fused_deg // w)  # ceil; 0 for empty rows

    # atom rows, the dummy row and at least one spare all-zero row
    n_rows = _ceil_to(n1 + 1, 8)
    zero_row = n_rows - 1
    row_chunks = np.zeros(n_rows, dtype=np.int64)
    row_chunks[:n1] = nchunk
    row_chunk_starts = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(row_chunks, out=row_chunk_starts[1:])
    total_chunks = int(row_chunk_starts[-1])

    # flat index, padded per row (pad → zero row): incidence entry e of
    # atom a contributes the targets of its link at a's running offset
    idx = np.full(total_chunks * w, zero_row, dtype=np.int32)
    live = np.nonzero(ar)[0]
    if len(live):
        atom_of = np.asarray(snap.inc_src[: len(ar)], dtype=np.int64)[live]
        dst_start = (row_chunk_starts[atom_of] * w
                     + (pre[live] - pre[inc_off[atom_of]]))
        dst = _segmented_ranges(dst_start, ar[live])
        src = _segmented_ranges(tgt_off[inc_links[live]], ar[live])
        idx[dst] = tgt_flat[src]

    # work items: ceil(chunks / ITEM_CHUNKS) per row, at least one
    per_row = np.maximum(1, -(-row_chunks // ITEM_CHUNKS))
    item_row = np.repeat(np.arange(n_rows, dtype=np.int32), per_row)
    first = np.zeros(n_rows, dtype=np.int64)
    np.cumsum(per_row[:-1], out=first[1:])
    j = np.arange(len(item_row), dtype=np.int64) - first[item_row]
    item_off = np.empty(len(item_row) + 1, dtype=np.int64)
    item_off[:-1] = row_chunk_starts[item_row] + j * ITEM_CHUNKS
    item_off[-1] = total_chunks

    inc_deg = np.zeros(n_rows, dtype=np.int32)
    inc_deg[:n1] = (inc_off[1 : n1 + 1] - inc_off[:n1]).astype(np.int32)
    inc_deg[N] = 0  # dummy row counts nothing

    geom = FusedGeom(
        n_atoms=N, n_rows=n_rows, w=w, zero_row=zero_row,
        total_entries=int(fused_deg.sum()), n_chunks=total_chunks,
        n_items=len(item_row),
    )
    return FusedPlan(geom=geom, row_chunk_starts=row_chunk_starts, idx=idx,
                     item_off=item_off, item_row=item_row, inc_deg=inc_deg)


def plan_supported(snap: CSRSnapshot, k_block: int) -> Optional[str]:
    """None when the fused path can serve ``k_block``-wide seed blocks on
    this snapshot; otherwise the reason it must fall back."""
    if k_block <= 0 or k_block % WORD:
        return f"k_block={k_block} is not a positive multiple of {WORD}"
    nbytes = fused_index_bytes(snap)
    if nbytes > FUSED_INDEX_BUDGET:
        return (f"fused index of {nbytes} B exceeds the "
                f"{FUSED_INDEX_BUDGET} B device budget (Σ arity² of the "
                f"hub rows)")
    return None


def fused_ready(snap: CSRSnapshot, k_block: int) -> bool:
    """Should ``bfs_pull`` route this seed block through the fused path?"""
    return plan_supported(snap, k_block) is None


#: version of the fused plan's arrays in a plan cache
FUSED_PLAN_FORMAT = 1
#: the fused plan's entry in an ``ops/aot_cache.AOTCache`` (its name, with
#: the plan format)
AOT_ENTRY = f"ops.fused_bfs.fused_plan.v{FUSED_PLAN_FORMAT}"


def fused_plan_arrays(plan: FusedPlan) -> dict:
    """The plan as numpy arrays (the geometry as one int64 row)."""
    return {
        "geom": np.asarray(plan.geom, dtype=np.int64),
        "row_chunk_starts": plan.row_chunk_starts, "idx": plan.idx,
        "item_off": plan.item_off, "item_row": plan.item_row,
        "inc_deg": plan.inc_deg,
    }


def fused_plan_from_arrays(z) -> FusedPlan:
    """The inverse of :func:`fused_plan_arrays`."""
    return FusedPlan(
        geom=FusedGeom(*(int(v) for v in z["geom"])),
        row_chunk_starts=np.asarray(z["row_chunk_starts"]),
        idx=np.asarray(z["idx"]), item_off=np.asarray(z["item_off"]),
        item_row=np.asarray(z["item_row"]),
        inc_deg=np.asarray(z["inc_deg"]))


AOT_CODEC = (fused_plan_arrays, fused_plan_from_arrays)


def fused_plans_for(snap: CSRSnapshot, aot=None) -> FusedPlan:
    """Fused plan for a snapshot, memoized on it. Raises ValueError when
    :func:`plan_supported` declines, before building anything.

    ``aot``, an ``ops/aot_cache.AOTCache`` whose content key is this
    snapshot's fingerprint, serves the plan (built, or handed over from
    the memo, on a miss); it is memoized here either way."""
    plan = getattr(snap, "_fused_plan", None)
    if plan is None or aot is not None:
        reason = plan_supported(snap, WORD)
        if reason is not None:
            raise ValueError(f"fused plan declined for this snapshot: {reason}")
        if aot is not None:
            have = plan
            plan = aot.get_or_compile(
                AOT_ENTRY, lambda: have if have is not None
                else build_fused_plan(snap), codec=AOT_CODEC)
        else:
            plan = build_fused_plan(snap)
        object.__setattr__(snap, "_fused_plan", plan)
    return plan


class DeviceFusedPlan(NamedTuple):
    """A :class:`FusedPlan`'s arrays on one device."""

    idx: torch.Tensor        # (n_chunks*w,) int32
    item_off: torch.Tensor   # (n_items+1,) int64
    item_row: torch.Tensor   # (n_items,) int32
    inc_deg: torch.Tensor    # (n_rows,) int32
    deg_rows: torch.Tensor   # int64 ids of the rows with inc_deg > 0
    w: int


def device_fused_plan(snap: CSRSnapshot,
                      device: str | torch.device = DEFAULT_DEVICE
                      ) -> tuple[DeviceFusedPlan, FusedGeom]:
    """The snapshot's fused plan on ``device``, cached per device."""
    dev = resolve_device(device)
    cache = getattr(snap, "_fused_device", None)
    if cache is None:
        cache = {}
        object.__setattr__(snap, "_fused_device", cache)
    key = str(dev)
    if key not in cache:
        plan = fused_plans_for(snap)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        cache[key] = (
            DeviceFusedPlan(
                idx=put(plan.idx), item_off=put(plan.item_off),
                item_row=put(plan.item_row), inc_deg=put(plan.inc_deg),
                deg_rows=put(np.nonzero(plan.inc_deg)[0].astype(np.int64)),
                w=plan.geom.w,
            ),
            plan.geom,
        )
    return cache[key]


# ---------------------------------------------------------------- the kernel


def _segment_or(x: torch.Tensor, seg: torch.Tensor):
    """OR of the rows of ``x`` per run of equal ``seg`` (sorted): a
    Hillis-Steele segmented scan, then the last row of each run. Returns
    (per-run OR, run's seg value)."""
    n = x.shape[0]
    d = 1
    while d < n:
        same = seg[d:] == seg[:-d]
        if not bool(same.any()):
            break
        x[d:] = torch.where(same[:, None], x[d:] | x[:-d], x[d:])
        d *= 2
    last = torch.ones(n, dtype=torch.bool, device=x.device)
    last[:-1] = seg[1:] != seg[:-1]
    return x[last], seg[last]


def fused_hop_plain(old: torch.Tensor, plan: DeviceFusedPlan,
                    out: Optional[torch.Tensor] = None,
                    chunk: int = PLAIN_CHUNKS,
                    out_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version of K2: ``new = old``, then per streamed
    block of chunks gather, OR-fold each chunk's ``w`` rows, OR the chunks
    of each row together and into ``new``. ``out_mask``, when given, is
    overwritten with ``line_mask(new)``; no input mask is read (under the
    mask contract the bitmap is the same with or without one)."""
    kw, w = old.shape[1], plan.w
    new = old.clone() if out is None else out.copy_(old)
    chunk_row = torch.repeat_interleave(plan.item_row,
                                        plan.item_off[1:] - plan.item_off[:-1])
    n_chunks = chunk_row.shape[0]
    for s in range(0, n_chunks, chunk):
        e = min(s + chunk, n_chunks)
        g = or_fold(old[plan.idx[s * w : e * w]].view(e - s, w, kw))
        acc, rows = _segment_or(g, chunk_row[s:e])
        new[rows] |= acc
    if out_mask is not None:
        out_mask.copy_(linemask.line_mask(new))
    return new


def _check_items(plan: DeviceFusedPlan) -> None:
    """Raise unless ``item_off`` is n_items+1 non-decreasing chunk bounds
    inside ``idx``: the kernel would read out of bounds. One sync."""
    offs, n_items = plan.item_off, plan.item_row.shape[0]
    if (offs.shape != (n_items + 1,) or int(offs[0]) < 0
            or int(offs[-1]) * plan.w > plan.idx.numel()
            or not bool((offs[1:] >= offs[:-1]).all())):
        raise ValueError("fused_hop: item_off must be n_items+1 "
                         "non-decreasing chunk bounds inside idx")


def fused_hop(old: torch.Tensor, plan: DeviceFusedPlan,
              out: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None,
              out_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One fused hop: ``old | OR-gather of the fused adjacency`` as a new
    (n_rows, kw) int32 bitmap, written into ``out`` when given.

    ``mask`` is the line mask of ``old`` (a superset of its nonzero lines,
    ``ops/linemask.py``; ``None``: every line live). ``out_mask``, when
    given, is overwritten with the exact line mask of the result.

    A CUDA tensor launches the kernel; a CPU tensor runs the plain version.
    ``out`` must not overlap ``old``, and on the card it must start as a
    subset of the result (zeros, or an earlier bitmap of the same BFS:
    visited sets only grow), because split hub rows OR into it and rows
    whose result is all zero are not stored."""
    if old.dim() != 2 or old.dtype != torch.int32 or not old.is_contiguous():
        raise ValueError(f"fused_hop: old must be a contiguous (n_rows, kw) "
                         f"int32 tensor, got {tuple(old.shape)} {old.dtype}")
    if out is None:
        out = torch.zeros_like(old)
    elif (out.shape != old.shape or out.dtype != torch.int32
          or not out.is_contiguous() or out.device != old.device):
        raise ValueError("fused_hop: out must match old's shape, type and "
                         "device, contiguous")
    if out.data_ptr() == old.data_ptr():
        raise ValueError("fused_hop: out must be a second buffer, not old")
    if plan.idx.device != old.device:
        raise ValueError("fused_hop: plan and bitmap on different devices")
    n_rows, kw = old.shape
    for m, what in ((mask, "mask"), (out_mask, "out_mask")):
        if m is not None:
            linemask.check_mask(m, n_rows, kw, old.device, f"fused_hop {what}")
    if old.device.type == "cpu":
        return fused_hop_plain(old, plan, out=out, out_mask=out_mask)
    if old.device.type != "cuda":
        raise ValueError(f"fused_hop: unsupported device {old.device}")
    n_items = plan.item_row.shape[0]
    if n_items == 0:
        if out_mask is not None:
            out_mask.copy_(linemask.line_mask(old))
        return out.copy_(old)
    _cuda.check_rows(plan.idx, n_rows, "fused_hop idx")
    _cuda.check_rows(plan.item_row, n_rows, "fused_hop item_row")
    _check_items(plan)
    if out_mask is not None:
        out_mask.zero_()
    fn = _cuda.kernel("fused_hop")
    code = fn(old.data_ptr(), out.data_ptr(), plan.idx.data_ptr(),
              plan.item_off.data_ptr(), plan.item_row.data_ptr(), n_items,
              plan.w, kw, _cuda.ptr(mask), _cuda.ptr(out_mask),
              linemask.line_words(kw), linemask.field_bits(kw),
              _cuda.stream_of(old))
    fused_hop.launches += 1
    _cuda.check(code, "fused_hop")
    return out


#: kernel launches since the count was last set to 0
fused_hop.launches = 0


# ------------------------------------------------------------- delta overlay


class OverlayArrays(NamedTuple):
    """The device half of a :class:`DeltaOverlayPlan`."""

    levels1: tuple          # stage 1: delta links ← visited rows (int32)
    levels2: tuple          # stage 2: level 0 composed into stage 1's buffer
    rows1: int              # rows of stage 1's buffer (its zero row last)
    rows2: int
    out_map: torch.Tensor   # (A,) int64 — stage-2 buffer row of each atom
    rows: torch.Tensor      # (A,) int64 — the distinct atoms gaining edges


@dataclass(frozen=True)
class DeltaOverlayPlan:
    """The delta's pull contribution: the staged chain's two pyramids
    (``ellbfs.build_pull_plans``) over the delta's edges only, with output
    restricted to the atoms that gained incidence, so a hop's overlay costs
    O(delta), not O(graph). Built from the delta's own padded arrays, once
    per delta (cached on it)."""

    arrays: OverlayArrays
    widths1: tuple
    widths2: tuple


def overlay_plan_for(delta, snap: CSRSnapshot,
                     geom: FusedGeom) -> Optional[DeltaOverlayPlan]:
    """The overlay plan of ``delta`` over the base ``snap`` in the fused row
    space ``geom``, on the delta's device, cached on the delta. None for a
    delta with no edges; raises ``ValueError`` for a delta the overlay
    cannot carry (see :func:`_build_overlay`)."""
    key = (snap.num_atoms, geom.zero_row)
    cached = getattr(delta, "_overlay_plan", None)
    if cached is not None and cached[1] == key:
        return cached[0]
    plan = _build_overlay(delta, snap, geom)
    delta._overlay_plan = (plan, key)
    return plan


def _build_overlay(delta, snap: CSRSnapshot,
                   geom: FusedGeom) -> Optional[DeltaOverlayPlan]:
    """Stage 1 reduces the delta links' target lists over visited rows
    (pads at ``geom.zero_row``); stage 2 reduces the delta incidence of
    each atom over stage 1's output, its level 0 composed through stage
    1's ``out_map``. The pull form equals the reference's dense push over
    base ∪ delta only for a delta shaped as a memtable builds it: its
    incidence entries are the transpose of its target entries, and its
    links have no targets in the base. Anything else raises."""
    N = snap.num_atoms
    ts, tf, il, isrc = (getattr(delta, c).cpu().numpy().astype(np.int64)
                        for c in ("tgt_src", "tgt_flat", "inc_links",
                                  "inc_src"))
    real_t, real_i = ts != N, il != N  # pad entries are the dummy row
    if not real_t.any() and not real_i.any():
        return None
    ts, tf, il, isrc = ts[real_t], tf[real_t], il[real_i], isrc[real_i]
    n1 = N + 1
    if not np.array_equal(np.sort(ts * n1 + tf), np.sort(il * n1 + isrc)):
        raise ValueError("overlay: the delta's incidence entries are not the "
                         "transpose of its target entries")

    # stage 1: the delta links' target lists as a compact CSR
    order = np.argsort(ts, kind="stable")
    ts, tf = ts[order], tf[order]
    links_u, l_counts = np.unique(ts, return_counts=True)
    base_arity = snap.tgt_offsets[links_u + 1] - snap.tgt_offsets[links_u]
    if (base_arity != 0).any():
        raise ValueError("overlay: delta links already have targets in the "
                         "base")
    n_links = len(links_u)
    l_off = np.zeros(n_links + 1, dtype=np.int64)
    np.cumsum(l_counts, out=l_off[1:])
    s1 = build_reduce_plan(l_off, tf, n_links, zero_row=geom.zero_row)

    # stage 2: the delta incidence grouped by atom; every link it names has
    # target entries (the transpose check), so each has a stage-1 row
    order = np.argsort(isrc, kind="stable")
    isrc, il = isrc[order], il[order]
    lpos = np.searchsorted(links_u, il)
    atoms_u, a_counts = np.unique(isrc, return_counts=True)
    n_a = len(atoms_u)
    a_off = np.zeros(n_a + 1, dtype=np.int64)
    np.cumsum(a_counts, out=a_off[1:])
    s2 = build_reduce_plan(a_off, lpos, n_a, zero_row=n_links)
    out_map_ext = np.append(s1.out_map, np.int32(s1.concat_size))
    s2_levels = (out_map_ext[s2.levels[0]],) + s2.levels[1:]

    dev = delta.inc_links.device

    def put(a, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    arrays = OverlayArrays(
        levels1=tuple(put(l) for l in _rebase_upper(s1.levels, s1.widths)),
        levels2=tuple(put(l) for l in _rebase_upper(s2_levels, s2.widths)),
        rows1=s1.concat_size + 1,
        rows2=s2.concat_size + 1,
        out_map=put(s2.out_map, torch.int64),
        rows=put(atoms_u, torch.int64),
    )
    return DeltaOverlayPlan(arrays=arrays, widths1=s1.widths,
                            widths2=s2.widths)


def _overlay_buffers(overlay: DeltaOverlayPlan, kw: int, dev) -> tuple:
    """Stage buffers and masks of one BFS's overlay, zeroed: reused by
    every hop, each hop's contents only grow (K1's ``out`` rule)."""
    ov = overlay.arrays
    return (torch.zeros((ov.rows1, kw), dtype=torch.int32, device=dev),
            linemask.empty_mask(ov.rows1, kw, dev),
            torch.zeros((ov.rows2, kw), dtype=torch.int32, device=dev),
            linemask.empty_mask(ov.rows2, kw, dev))


def _overlay_reach(visited: torch.Tensor, vmask: torch.Tensor,
                   overlay: DeltaOverlayPlan, bufs: tuple) -> torch.Tensor:
    """The delta edges' pull contribution for ``overlay.arrays.rows``: both
    pyramids through K1 (``ellbfs._apply_plan``), then the output rows,
    (A, kw) int32."""
    buf1, mask1, buf2, mask2 = bufs
    ov = overlay.arrays
    _apply_plan(visited, vmask, ov.levels1, overlay.widths1, buf1, mask1,
                PLAIN_CHUNK)
    _apply_plan(buf1, mask1, ov.levels2, overlay.widths2, buf2, mask2,
                PLAIN_CHUNK)
    return buf2[ov.out_map]


def _or_rows(bitmap: torch.Tensor, mask: torch.Tensor, rows: torch.Tensor,
             vals: torch.Tensor) -> None:
    """``bitmap[rows] |= vals`` for distinct ``rows``, and their fields
    ORed into ``mask``. The rows are scattered and several share a packed
    mask word, so the words are built from points, never by an indexed
    ``|=`` on the mask (duplicate words would lose updates)."""
    n_rows, kw = bitmap.shape
    new = bitmap[rows] | vals
    bitmap[rows] = new
    fields = linemask.row_fields_of(new)
    lines = torch.arange(linemask.n_lines(kw), device=bitmap.device)
    hit, line = (((fields[:, None] >> lines) & 1) != 0).nonzero(as_tuple=True)
    mask |= linemask.mask_of_points(rows[hit], line, n_rows, kw)


# --------------------------------------------------------------- fused BFS


@hgverify.entry(
    "ops.pallas_bfs._bfs_fused",
    shapes=hgverify.fused_args,
    statics={"max_hops": 2, "count_edges": True, "clear_dummy": True},
)
def bfs_fused(plan: DeviceFusedPlan, seeds: torch.Tensor, geom: FusedGeom,
              max_hops: int, count_edges: bool, clear_dummy: bool,
              hop_hook=None, overlay: Optional[DeltaOverlayPlan] = None):
    """Seed bitmap → ``max_hops`` fused hops → per-hop degree sums → reach
    counts. Returns ``(visited (n_rows, K/32) int32, s_ins list of (K,)
    int64, reach (K,) int64)``; equal to the staged chain on the same
    inputs. ``clear_dummy=False`` keeps the dummy-row bit of pad lanes (the
    serving contract); the pull path clears it.

    ``overlay`` adds a delta's edges: each hop computes the overlay's rows
    from the bitmap entering it, before K2 writes the spare buffer, and ORs
    them into the bitmap K2 wrote, fields and all.

    Each bitmap travels with its exact line mask: the seed rows' mask, then
    the mask each hop emits. ``hop_hook(h, visited, mask)``, when given, is
    called with the bitmap and mask entering hop ``h`` (0-based) and, with
    ``h == max_hops``, the final ones; it must not modify them."""
    kw = seeds.shape[0] // WORD
    visited = seed_bitmap(seeds, geom.n_rows, kw)
    dummy = geom.n_atoms if clear_dummy else None
    if dummy is not None:
        visited[dummy] = 0
    vmask = seed_mask(seeds, geom.n_rows, kw, clear_row=dummy)
    spare = torch.zeros_like(visited)
    smask = torch.empty_like(vmask)
    bufs = None
    if overlay is not None:
        bufs = _overlay_buffers(overlay, kw, visited.device)
    s_ins = []
    for h in range(max_hops):
        if hop_hook is not None:
            hop_hook(h, visited, vmask)
        if count_edges:
            s_ins.append(bitdot(visited, plan.inc_deg, plan.deg_rows))
        if overlay is not None:
            reach = _overlay_reach(visited, vmask, overlay, bufs)
        out = fused_hop(visited, plan, out=spare, mask=vmask, out_mask=smask)
        if overlay is not None:
            _or_rows(out, smask, overlay.arrays.rows, reach)
        visited, spare, vmask, smask = out, visited, smask, vmask
    if hop_hook is not None:
        hop_hook(max_hops, visited, vmask)
    return visited, s_ins, bitdot(visited)


def bfs_pull_fused(snap: CSRSnapshot, seeds: np.ndarray, max_hops: int,
                   count_edges: bool = True,
                   device: str | torch.device = DEFAULT_DEVICE):
    """Fused-path twin of one staged ``bfs_pull`` block: returns
    ``(visited_t (n_pad, K/32) int32, s_ins list, reach (K,) int64)`` with
    the ``bfs_pull`` block contract (pad seeds = dummy row, dummy row
    cleared). ``len(seeds)`` must be a multiple of 32."""
    dev = resolve_device(device)
    seeds = np.asarray(seeds, dtype=np.int32)
    if len(seeds) == 0 or len(seeds) % WORD:
        raise ValueError(f"bfs_pull_fused: need a positive multiple of "
                         f"{WORD} seeds, got {len(seeds)}")
    plan, geom = device_fused_plan(snap, dev)
    visited, s_ins, reach = bfs_fused(
        plan, torch.from_numpy(seeds).to(dev), geom, max_hops, count_edges,
        clear_dummy=True,
    )
    n_pad = _ceil_to(geom.n_atoms + 1, 8)
    return visited[:n_pad], s_ins, reach


def serve_fused_kwargs(snap: CSRSnapshot, delta, k_bucket: int,
                       device: str | torch.device = DEFAULT_DEVICE):
    """What ``serving.bfs_serve_batch_fused`` needs for a (base, delta,
    bucket): ``{"plan", "geom", "overlay"}`` (``overlay`` None without a
    delta or for one with no edges), or, when the fused path declines the
    bucket, :func:`plan_supported`'s reason string. Tombstones are the
    caller's gate: the overlay carries none."""
    reason = plan_supported(snap, k_bucket)
    if reason is not None:
        return reason
    plan, geom = device_fused_plan(snap, device)
    overlay = None if delta is None else overlay_plan_for(delta, snap, geom)
    return {"plan": plan, "geom": geom, "overlay": overlay}


def first_r_from_bitmap(visited: torch.Tensor, n1: int, top_r: int,
                        K: int, packed: bool = True) -> torch.Tensor:
    """Per seed lane the ``top_r`` smallest reached row ids below ``n1``,
    ascending and SENTINEL-padded: (K, top_r) int32, read straight off the
    transposed bitmap in row blocks with a per-block top-k and a merge.
    ``packed=False`` reads an (R, K) bool bitmap instead of (R, K/32)
    words."""
    R = visited.shape[0]
    dev = visited.device
    rb = min(R, max(4096, (1 << 24) // max(K, 1)))
    cols = torch.arange(K, device=dev)
    word, bit = cols >> 5, (cols & 31).to(torch.int32)
    cur = torch.full((K, top_r), int(SENTINEL), dtype=torch.int32, device=dev)
    for s in range(0, R, rb):
        blk = visited[s : s + rb]
        ids = torch.arange(s, s + blk.shape[0], dtype=torch.int32, device=dev)
        hit = ((blk[:, word] >> bit) & 1).bool() if packed else blk
        hit = hit & (ids < n1)[:, None]
        masked = torch.where(hit, ids[:, None], int(SENTINEL))
        top = torch.topk(masked.T, min(top_r, blk.shape[0]), dim=1,
                         largest=False).values
        cur = torch.sort(torch.cat([cur, top], dim=1), dim=1).values[:, :top_r]
    return cur


def fused_bytes_per_hop(geom: FusedGeom, K: int) -> int:
    """Device-memory traffic of one fused hop: one ``kw``-word row read per
    fused chunk entry (pad entries included), the index and item reads, and
    one read of the old and one write of the new bitmap per row."""
    row_bytes = _ceil_to(max(K, WORD), WORD) // WORD * 4
    per_hop = geom.n_chunks * geom.w * row_bytes   # gathered rows
    per_hop += geom.n_chunks * geom.w * 4          # idx
    per_hop += geom.n_items * (8 + 4)              # item_off + item_row
    per_hop += geom.n_rows * row_bytes * 2         # old read + new write
    return per_hop
