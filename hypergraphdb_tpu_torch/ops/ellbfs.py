"""Pull-mode, seed-transposed BFS over the incidence CSR: the staged chain.

The port of ``hypergraphdb_tpu/ops/ellbfs.py``. Same semantics (frontier
atom → incident links → their targets) and the same layout:

- the reached set is stored **transposed**: ``V[(n_pad, Kw)]`` 32-bit words,
  bit k of ``V[v, k>>5]`` says "seed k has reached atom v" (int32 here; the
  bits are those of the reference's uint32).
- a hop is two *pull* reductions from VISITED (monotone closure, no
  frontier array):
  stage 1: ``link_live[l] = OR_{t ∈ targets(l)} V[t]``
  stage 2: ``reach[v]    = OR_{l ∈ incident(v)} link_live[l]``
  each a gather of edge-many rows and a fixed-width OR over host-built
  padded index pyramids (:class:`ReducePlan`); stage 2's level 0 is
  composed with stage 1's output map on the host.
- every level of both pyramids runs through K1 (``ops/gather_or.py``) on
  the card, writing straight into its section of the stage buffer.
- ``visited`` and each stage buffer travel with their exact line masks
  (``ops/linemask.py``): each level reads the mask of what it gathers, so
  K1 skips zero rows and lines, and emits the mask of the rows it writes.

Differences from the reference, all deliberate:

- Edge and reach counts are exact integers. The reference's ``_bitdot``
  sums degrees in float32, exact only while a block's partial sum stays
  below 2^24. Here bit-unpacked row blocks are multiplied by the degrees in
  float64, exact while a sum stays below 2^53 (any graph under 2^31 edges),
  and the result is cast to int64.
- No per-hop staging for a 16 GiB memory: the stage buffers are allocated
  once per BFS and reused by every hop, and the visited update is in place.
- ``bfs_pull`` takes ``fused=False`` to force the staged chain, and a
  ``device`` (``"cuda"`` unless the caller asks for ``"cpu"``).
- The plan sidecar (``save_plans`` / ``load_plans``, ``HG_PLAN_CACHE``) is
  the reference's npz, field for field, read without unpickling. A
  corrupt cache entry is rebuilt and counted, never swallowed: only the
  errors of a damaged file (``aot_cache.CORRUPT_ERRORS``) are caught.
"""

from __future__ import annotations

import logging
import os
import zlib
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from hypergraphdb_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from hypergraphdb_tpu_torch.ops import linemask
from hypergraphdb_tpu_torch.ops.aot_cache import CORRUPT_ERRORS
from hypergraphdb_tpu_torch.ops.gather_or import PLAIN_CHUNK, gather_or
from hypergraphdb_tpu_torch.ops.snapshot import CSRSnapshot

WORD = 32


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


# ------------------------------------------------------------------ host plans


@dataclass(frozen=True)
class ReducePlan:
    """Padded-gather tree reduction over one CSR relation.

    ``levels[0]`` indexes caller-provided value rows (with ``zero_row``
    pointing at a guaranteed-all-zero row) and covers every row; level
    ``ℓ>0`` covers ONLY rows still unfinished (more than one chunk). Upper
    level indices are local to the previous level's chunk array, with index
    ``len(prev_chunks)`` meaning the per-level appended zero row.

    ``out_map[r]`` addresses the **concatenation** of all level chunk
    arrays (in order) with one global zero row at the very end
    (``concat_size``). Empty rows map to the zero row. All index arrays are
    int32; every level's length is a multiple of its width.
    """

    levels: tuple[np.ndarray, ...]
    widths: tuple[int, ...]
    out_map: np.ndarray  # (R,) int32 into concat space; empty rows → zero row
    n_rows: int
    concat_size: int     # total chunks across levels; zero row lives here

    @property
    def total_indices(self) -> int:
        return int(sum(len(l) for l in self.levels))


def build_reduce_plan(
    offsets: np.ndarray,
    flat: np.ndarray,
    n_rows: int,
    zero_row: int,
    w: int = 8,
    w_upper: int = 8,
) -> ReducePlan:
    """Build the padded index pyramid for an OR-reduce over CSR rows.

    ``offsets``/``flat`` describe rows ``0..n_rows``; ``zero_row`` indexes
    an all-zero value row used for level-0 padding. Level 0 width is ``w``;
    upper levels use ``w_upper``.
    """
    offsets = np.asarray(offsets, dtype=np.int64)
    deg = offsets[1 : n_rows + 1] - offsets[:n_rows]
    nchunk = -(-deg // w)  # ceil; 0 for empty rows

    total = int(nchunk.sum()) * w
    idx0 = np.full(total, zero_row, dtype=np.int32)
    row_pad_starts = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(nchunk * w, out=row_pad_starts[1:])
    nz = np.nonzero(deg)[0]
    if len(nz):
        reps = deg[nz]
        dst = _segmented_ranges(row_pad_starts[nz], reps)
        src = _segmented_ranges(offsets[nz], reps)
        idx0[dst] = np.asarray(flat, dtype=np.int32)[src]
    levels = [idx0]
    widths = [w]

    out_map = np.full(n_rows, -1, dtype=np.int64)
    level_offset = 0
    n_prev = int(nchunk.sum())  # chunks in the previous (current last) level
    cur_counts = nchunk
    cur_starts = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(cur_counts, out=cur_starts[1:])

    done = cur_counts == 1
    out_map[done] = level_offset + cur_starts[:n_rows][done]

    while int(cur_counts.max(initial=0)) > 1:
        wu = w_upper
        live = np.nonzero(cur_counts > 1)[0]
        live_counts = cur_counts[live]
        nxt_counts_live = -(-live_counts // wu)
        tot = int(nxt_counts_live.sum()) * wu
        idx = np.full(tot, n_prev, dtype=np.int32)  # pad → prev zero row
        pad_starts = np.zeros(len(live) + 1, dtype=np.int64)
        np.cumsum(nxt_counts_live * wu, out=pad_starts[1:])
        reps = live_counts
        dst = _segmented_ranges(pad_starts[:-1], reps)
        src = _segmented_ranges(cur_starts[live], reps)
        idx[dst] = src.astype(np.int32)
        levels.append(idx)
        widths.append(wu)

        level_offset += n_prev
        n_prev = int(nxt_counts_live.sum())
        cur_counts = np.zeros(n_rows, dtype=np.int64)
        cur_counts[live] = nxt_counts_live
        cur_starts = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(cur_counts, out=cur_starts[1:])
        done = cur_counts == 1
        out_map[done] = level_offset + cur_starts[:n_rows][done]

    concat_size = level_offset + n_prev
    out_map = np.where(out_map >= 0, out_map, concat_size)
    return ReducePlan(
        tuple(levels), tuple(widths), out_map.astype(np.int32),
        n_rows, concat_size,
    )


def _segmented_ranges(starts: np.ndarray, reps: np.ndarray) -> np.ndarray:
    """``concat([arange(s, s + r) for s, r in zip(starts, reps)])`` as two
    cumsums (no ``np.repeat``). Requires every rep ≥ 1."""
    total = int(reps.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    starts = np.asarray(starts, dtype=np.int64)
    delta = np.ones(total, dtype=np.int64)
    ends = np.cumsum(reps)
    delta[0] = starts[0]
    if len(starts) > 1:
        delta[ends[:-1]] = starts[1:] - (starts[:-1] + reps[:-1] - 1)
    return np.cumsum(delta)


class PullBFSResult(NamedTuple):
    visited_t: torch.Tensor    # (n_pad, Kw) int32 — TRANSPOSED packed bitmaps
    edges_touched: np.ndarray  # (K,) int64 — summed over hops, on host
    reach_counts: torch.Tensor  # (K,) int32 — |visited| per seed (incl. seed)


@dataclass
class PullBFSPlans:
    """Host-side precompute for :func:`bfs_pull` over one snapshot, reusable
    across every BFS on it (memoized by :func:`plans_for`)."""

    n_atoms: int
    n_pad: int
    stage1: ReducePlan  # tgt relation: link rows ← atom value rows
    stage2_levels: tuple[np.ndarray, ...]  # level0 composed into stage1 chunks
    stage2_widths: tuple[int, ...]
    out_map: np.ndarray
    inc_deg: np.ndarray  # (n_pad,) int32 — incidence degree (edge counting)

    @property
    def total_indices(self) -> int:
        return (
            self.stage1.total_indices
            + int(sum(len(l) for l in self.stage2_levels))
            + len(self.out_map)
        )


def build_pull_plans(
    snap: CSRSnapshot, w1: int = 8, w2: int = 8, w_upper: int = 8
) -> PullBFSPlans:
    N = snap.num_atoms
    n_pad = _ceil_to(N + 1, 8)
    e_tgt = snap.n_edges_tgt
    e_inc = snap.n_edges_inc
    # stage 1: link_live = OR of V over target rows (tgt CSR, rows=atoms)
    s1 = build_reduce_plan(
        snap.tgt_offsets[: N + 2], snap.tgt_flat[:e_tgt], N + 1,
        zero_row=N, w=w1, w_upper=w_upper,
    )
    # stage 2 runs over the incidence CSR; its level-0 entries are LINK
    # ids, composed through stage-1's concat-space out_map on the host
    s2 = build_reduce_plan(
        snap.inc_offsets[: N + 2], snap.inc_links[:e_inc], N + 1,
        zero_row=N, w=w2, w_upper=w_upper,
    )
    lvl0 = s1.out_map[s2.levels[0]]
    s2_levels = (lvl0,) + s2.levels[1:]

    out_map = np.full(n_pad, s2.concat_size, dtype=np.int32)
    out_map[: N + 1] = s2.out_map
    out_map[N] = s2.concat_size  # dummy row must stay empty
    inc_deg = np.zeros(n_pad, dtype=np.int32)
    inc_deg[: N + 1] = (
        snap.inc_offsets[1 : N + 2].astype(np.int64)
        - snap.inc_offsets[: N + 1]
    ).astype(np.int32)
    inc_deg[N] = 0
    return PullBFSPlans(
        n_atoms=N,
        n_pad=n_pad,
        stage1=s1,
        stage2_levels=s2_levels,
        stage2_widths=s2.widths,
        out_map=out_map,
        inc_deg=inc_deg,
    )


# ------------------------------------------------------------ plan sidecar

#: version of the plan file layout; a file of another version is stale
PLAN_FORMAT = 1
#: environment variable naming the directory of the plan sidecar cache
PLAN_CACHE_ENV = "HG_PLAN_CACHE"

_log = logging.getLogger("hypergraphdb_tpu_torch.ops.ellbfs")


class StalePlans(ValueError):
    """The plan file is WELL-FORMED but belongs to a different snapshot or
    plan format: the quiet-rebuild case loaders treat as "no sidecar",
    deliberately distinct from a corrupt or unreadable file (rebuilt too,
    but logged and counted as ``fault.sidecar_corrupt``)."""


def plan_arrays(plans: PullBFSPlans) -> dict:
    """The plan pyramid as the reference's npz fields (its field names and
    dtypes), without the fingerprint."""
    arrs: dict = {
        "format": np.int64(PLAN_FORMAT),
        "n_atoms": np.int64(plans.n_atoms),
        "n_pad": np.int64(plans.n_pad),
        "s1_widths": np.asarray(plans.stage1.widths, np.int64),
        "s1_out_map": plans.stage1.out_map,
        "s1_n_rows": np.int64(plans.stage1.n_rows),
        "s1_concat": np.int64(plans.stage1.concat_size),
        "s2_widths": np.asarray(plans.stage2_widths, np.int64),
        "out_map": plans.out_map,
        "inc_deg": plans.inc_deg,
    }
    for i, lvl in enumerate(plans.stage1.levels):
        arrs[f"s1_l{i}"] = lvl
    for i, lvl in enumerate(plans.stage2_levels):
        arrs[f"s2_l{i}"] = lvl
    return arrs


def plans_from_arrays(z) -> PullBFSPlans:
    """A plan pyramid from the fields :func:`plan_arrays` writes (a mapping
    or an open npz). Raises :class:`StalePlans` for another format."""
    if int(z["format"]) != PLAN_FORMAT:
        raise StalePlans(f"plan format {int(z['format'])} != {PLAN_FORMAT}")

    def levels(prefix):
        keys = sorted((k for k in z.keys() if k.startswith(prefix)),
                      key=lambda k: int(k[len(prefix):]))
        return tuple(np.asarray(z[k]) for k in keys)

    s1 = ReducePlan(
        levels("s1_l"), tuple(int(w) for w in z["s1_widths"]),
        np.asarray(z["s1_out_map"]), int(z["s1_n_rows"]),
        int(z["s1_concat"]),
    )
    return PullBFSPlans(
        n_atoms=int(z["n_atoms"]),
        n_pad=int(z["n_pad"]),
        stage1=s1,
        stage2_levels=levels("s2_l"),
        stage2_widths=tuple(int(w) for w in z["s2_widths"]),
        out_map=np.asarray(z["out_map"]),
        inc_deg=np.asarray(z["inc_deg"]),
    )


def save_plans(plans: PullBFSPlans, path, fingerprint: str = "") -> None:
    """Persist a plan pyramid as an uncompressed .npz in the reference's
    format (loading it is one sequential read; rebuilding it is the host
    work of :func:`build_pull_plans`). ``path`` may be an open binary file
    (the crash-atomic checkpoint writer hands in its tmp file).
    ``fingerprint`` (:func:`snapshot_fingerprint`) travels with the file so
    a loader can reject a sidecar that no longer matches its snapshot."""
    np.savez(path, fingerprint=np.frombuffer(fingerprint.encode("ascii"),
                                             dtype=np.uint8),
             **plan_arrays(plans))


def load_plans(path: str,
               expect_fingerprint: Optional[str] = None) -> PullBFSPlans:
    """Read a plan file written by :func:`save_plans` (or the reference's),
    without unpickling anything. Raises :class:`StalePlans` when it is
    another format or another snapshot's."""
    with np.load(path, allow_pickle=False) as z:
        if expect_fingerprint is not None:
            got = bytes(z["fingerprint"]).decode("ascii") \
                if "fingerprint" in z.files else ""
            if got != expect_fingerprint:
                raise StalePlans(
                    f"plan file {path}: fingerprint {got!r} does not match "
                    f"the snapshot ({expect_fingerprint!r}): stale sidecar"
                )
        return plans_from_arrays(z)


def read_sidecar(path: str, fingerprint: str) -> Optional[PullBFSPlans]:
    """The plans in ``path`` for the snapshot of ``fingerprint``, or None
    to rebuild: a stale file quietly, a corrupt or unreadable one (one of
    ``aot_cache.CORRUPT_ERRORS``) logged, counted in
    ``fault.sidecar_corrupt`` and recorded as a flight incident. Anything
    else raises."""
    try:
        return load_plans(path, expect_fingerprint=fingerprint)
    except StalePlans:
        return None
    except CORRUPT_ERRORS:
        from hypergraphdb_tpu_torch.obs.flight import global_flight
        from hypergraphdb_tpu_torch.utils.metrics import global_metrics

        _log.warning("plan file %s is corrupt or unreadable; plans will be "
                     "rebuilt", path, exc_info=True)
        global_metrics.incr("fault.sidecar_corrupt")
        global_flight().incident("sidecar_corrupt", path=str(path))
        return None


def snapshot_fingerprint(snap: CSRSnapshot) -> str:
    """Content key over the structural CSR arrays, the reference's: two
    snapshots with the same fingerprint have identical plans."""
    h = 0
    for a in (
        snap.tgt_offsets, snap.tgt_flat[: snap.n_edges_tgt],
        snap.inc_offsets, snap.inc_links[: snap.n_edges_inc],
    ):
        h = zlib.crc32(np.ascontiguousarray(a).view(np.uint8), h)
    return (f"{snap.num_atoms}_{snap.n_edges_tgt}_"
            f"{snap.n_edges_inc}_{h:08x}")


#: the pull plans' entry in an ``ops/aot_cache.AOTCache``: its name (with
#: the plan format) and codec
AOT_ENTRY = f"ops.ellbfs.pull_plans.v{PLAN_FORMAT}"
AOT_CODEC = (plan_arrays, plans_from_arrays)


def plans_for(snap: CSRSnapshot, aot=None) -> PullBFSPlans:
    """Plans for a snapshot: memoized on the snapshot object and, when
    ``HG_PLAN_CACHE`` names a directory, persisted there keyed by the
    snapshot's content fingerprint, so a fresh process over the same graph
    reads its plans instead of rebuilding them. A stale entry rebuilds
    quietly and a corrupt one rebuilds counted (:func:`read_sidecar`).

    ``aot``, an ``ops/aot_cache.AOTCache`` whose content key is this
    snapshot's fingerprint, takes the place of the sidecar: the plans come
    from it (built, or handed over from the memo, on a miss) and are
    memoized here."""
    plans = getattr(snap, "_pull_plans", None)
    if aot is not None:
        have = plans
        plans = aot.get_or_compile(
            AOT_ENTRY, lambda: have if have is not None
            else build_pull_plans(snap), codec=AOT_CODEC)
        object.__setattr__(snap, "_pull_plans", plans)
    if plans is None:
        cache_dir = os.environ.get(PLAN_CACHE_ENV)
        cache_path = None
        fp = None
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
            fp = snapshot_fingerprint(snap)
            cache_path = os.path.join(cache_dir, f"pullplans_{fp}.npz")
            if os.path.exists(cache_path):
                plans = read_sidecar(cache_path, fp)
        if plans is None:
            plans = build_pull_plans(snap)
            if cache_path is not None:
                # the .npz suffix keeps np.savez from appending another;
                # write-then-rename leaves no torn cache entry
                tmp = cache_path[:-4] + ".tmp.npz"
                save_plans(plans, tmp, fingerprint=fp)
                os.replace(tmp, cache_path)
        object.__setattr__(snap, "_pull_plans", plans)
    return plans


# ------------------------------------------------------------------ device ops

#: int32 word with only bit b set, for b in 0..31 (uint32 bits viewed signed)
_BITS = np.left_shift(np.uint32(1), np.arange(WORD, dtype=np.uint32)).view(
    np.int32)
#: elements of one bit-unpacked row block in the counting passes
_COUNT_BLOCK = 1 << 25


def seed_bitmap(seeds: torch.Tensor, n_rows: int, kw: int) -> torch.Tensor:
    """(n_rows, kw) int32 bitmap with bit k of row ``seeds[k]`` set. The
    per-k bits are distinct, so ``index_add_`` over (possibly duplicate)
    seed rows equals bitwise OR."""
    K = seeds.shape[0]
    k = torch.arange(K, device=seeds.device)
    bits = torch.from_numpy(_BITS).to(seeds.device)
    onehot = torch.zeros((K, kw), dtype=torch.int32, device=seeds.device)
    onehot[k, k >> 5] = bits[k & 31]
    visited = torch.zeros((n_rows, kw), dtype=torch.int32, device=seeds.device)
    return visited.index_add_(0, seeds, onehot)


def seed_mask(seeds: torch.Tensor, n_rows: int, kw: int,
              clear_row: Optional[int] = None) -> torch.Tensor:
    """The exact line mask of ``seed_bitmap(seeds, n_rows, kw)``: seed k
    sets the line holding word ``k >> 5`` of row ``seeds[k]``. With
    ``clear_row`` that row's field is left clear (the caller clears the
    row itself)."""
    k = torch.arange(seeds.shape[0], device=seeds.device)
    lines = (k >> 5) // linemask.line_words(kw)
    rows = seeds.to(torch.int64)
    if clear_row is not None:
        keep = rows != clear_row
        rows, lines = rows[keep], lines[keep]
    return linemask.mask_of_points(rows, lines, n_rows, kw)


def bitdot(packed: torch.Tensor, weight: Optional[torch.Tensor] = None,
           rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ_v weight[v] · bit(v, k) for every seed column k, as exact (K,)
    int64. ``packed`` is (R, Kw) int32; ``weight`` (R,) (None = 1 per row);
    ``rows`` restricts the sum to those row ids (rows of zero weight may be
    left out). Bit-unpacked row blocks times the weights in float64: exact
    while every sum stays below 2^53."""
    R, Kw = packed.shape
    K = Kw * WORD
    shifts = torch.arange(WORD, dtype=torch.int32, device=packed.device)
    acc = torch.zeros(K, dtype=torch.float64, device=packed.device)
    n = R if rows is None else rows.shape[0]
    rb = max(1, _COUNT_BLOCK // K)
    for s in range(0, n, rb):
        e = min(s + rb, n)
        if rows is None:
            blk, wt = packed[s:e], None if weight is None else weight[s:e]
        else:
            sel = rows[s:e]
            blk, wt = packed[sel], None if weight is None else weight[sel]
        bits = ((blk[:, :, None] >> shifts) & 1).reshape(e - s, K)
        if wt is None:
            acc += bits.sum(0, dtype=torch.float64)
        else:
            acc += wt.to(torch.float64) @ bits.to(torch.float64)
    return acc.to(torch.int64)


def _apply_plan(values: torch.Tensor, vmask: torch.Tensor, levels: tuple,
                widths: tuple, buf: torch.Tensor, bmask: torch.Tensor,
                chunk: int) -> torch.Tensor:
    """Run a reduction pyramid into ``buf``: the concatenation of every
    level's chunk array plus one global zero row at the end — the address
    space ``ReducePlan.out_map`` (and composed downstream level-0 indices)
    point into. Upper-level indices come rebased into that space
    (:func:`device_plans`), so every level is one gather-OR into its
    section: K1 on the card, its plain version on the CPU.

    Level 0 reads ``values`` with its line mask ``vmask``, the upper levels
    read ``buf`` with ``bmask``, which is zeroed here and receives every
    section's exact fields as it is written. ``buf`` must hold a subset of
    this run's result (zeros, or the previous hop's run of the same BFS:
    the reduced values only grow), so all-zero rows are not stored."""
    buf[-1].zero_()
    bmask.zero_()
    off = 0
    src, smask = values, vmask
    for idx, w in zip(levels, widths):
        n = idx.shape[0] // w
        gather_or(src, idx, w, out=buf[off : off + n], chunk=chunk,
                  mask=smask, out_mask=bmask, mask_row0=off)
        off += n
        src, smask = buf, bmask
    return buf


def _visited_update(visited: torch.Tensor, vmask: torch.Tensor,
                    reach: torch.Tensor, rmask: torch.Tensor,
                    out_map: torch.Tensor, n_atoms: int,
                    block: int = 1 << 20) -> torch.Tensor:
    """visited |= reach[out_map] and its mask vmask |= the fields of
    reach's mask at out_map (a line of ``a | b`` is nonzero iff it is in
    ``a`` or ``b``), in place, in row blocks so the gathered transient
    stays one block; the dummy row and its field stay clear. ``block`` is
    a multiple of 32 rows, so a block's fields start on a word."""
    kw = visited.shape[1]
    for s in range(0, visited.shape[0], block):
        rows = out_map[s : s + block]
        visited[s : s + block] |= reach[rows]
        linemask.or_fields(vmask, linemask.fields_at(rmask, rows, kw), s, kw)
    visited[n_atoms] = 0
    linemask.clear_field(vmask, n_atoms, kw)
    return visited


def _rebase_upper(levels: tuple, widths: tuple) -> list[np.ndarray]:
    """Upper-level indices of a pyramid moved from previous-level-local
    space into its concat buffer (pad marker ``len(prev)`` → the global zero
    row at the end). Level 0 is returned as is."""
    sizes = [len(l) // w for l, w in zip(levels, widths)]
    total = sum(sizes) + 1
    out = [levels[0]]
    off = sizes[0]
    for i, idx in enumerate(levels[1:]):
        n_prev = sizes[i]
        out.append(np.where(idx == n_prev, total - 1,
                            idx.astype(np.int64) + off - n_prev
                            ).astype(np.int32))
        off += sizes[i + 1]
    return out


def device_plans(snap: CSRSnapshot,
                 device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """The snapshot's pull plans as index arrays on ``device`` (upper levels
    rebased into their stage buffers), cached on the snapshot per device."""
    device = resolve_device(device)
    plans = plans_for(snap)
    cache = getattr(snap, "_pull_device", None)
    if cache is None:
        cache = {}
        object.__setattr__(snap, "_pull_device", cache)
    key = str(device)
    if key not in cache:
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        s1, w1 = plans.stage1.levels, plans.stage1.widths
        s2, w2 = plans.stage2_levels, plans.stage2_widths
        cache[key] = {
            "levels1": tuple(put(l) for l in _rebase_upper(s1, w1)),
            "levels2": tuple(put(l) for l in _rebase_upper(s2, w2)),
            "rows1": sum(len(l) // w for l, w in zip(s1, w1)) + 1,
            "rows2": sum(len(l) // w for l, w in zip(s2, w2)) + 1,
            "out_map": put(plans.out_map),
            "inc_deg": put(plans.inc_deg),
            "deg_rows": put(np.nonzero(plans.inc_deg)[0].astype(np.int64)),
        }
    return cache[key]


def _bfs_pull_device(dp: dict, plans: PullBFSPlans, seeds: torch.Tensor,
                     max_hops: int, chunk: int, count_edges: bool,
                     hop_hook=None):
    """One seed block through the staged chain. Returns ``(visited (n_pad,
    Kw) int32, s_ins list of (K,) int64 per hop, reach (K,) int64)``.

    Hops pull from VISITED, not from a frontier: the closure is monotone,
    so per-hop frontier edge counts fall out as differences of
    S_h = Σ_v visited_h[v]·deg(v) (frontiers partition visited).

    ``visited`` and the stage buffers each keep an exact line mask. The
    buffers start zeroed, so each hop's run holds a superset of the last
    one's and K1 skips storing all-zero rows. ``hop_hook(h, visited,
    vmask)``, when given, sees the bitmap and mask entering hop ``h``
    (0-based) and, with ``h == max_hops``, the final ones; it must not
    modify them."""
    kw = seeds.shape[0] // WORD
    dev = seeds.device
    visited = seed_bitmap(seeds, plans.n_pad, kw)
    visited[plans.n_atoms] = 0  # dummy row stays zero
    vmask = seed_mask(seeds, plans.n_pad, kw, clear_row=plans.n_atoms)
    buf1 = torch.zeros((dp["rows1"], kw), dtype=torch.int32, device=dev)
    buf2 = torch.zeros((dp["rows2"], kw), dtype=torch.int32, device=dev)
    mask1 = linemask.empty_mask(dp["rows1"], kw, dev)
    mask2 = linemask.empty_mask(dp["rows2"], kw, dev)
    s_ins = []
    for h in range(max_hops):
        if hop_hook is not None:
            hop_hook(h, visited, vmask)
        if count_edges:
            s_ins.append(bitdot(visited, dp["inc_deg"], dp["deg_rows"]))
        _apply_plan(visited, vmask, dp["levels1"], plans.stage1.widths,
                    buf1, mask1, chunk)
        _apply_plan(buf1, mask1, dp["levels2"], plans.stage2_widths, buf2,
                    mask2, chunk)
        _visited_update(visited, vmask, buf2, mask2, dp["out_map"],
                        plans.n_atoms)
    if hop_hook is not None:
        hop_hook(max_hops, visited, vmask)
    return visited, s_ins, bitdot(visited)


# ------------------------------------------------------------------ host API


def block_layout(K: int, k_block: int) -> list[int]:
    """The real seed-block widths :func:`bfs_pull` runs for (K, k_block):
    K is padded to a multiple of WORD (floor WORD), then split into
    k_block-wide blocks with a possibly-ragged tail."""
    K_pad = _ceil_to(max(K, WORD), WORD)
    return [min(k_block, K_pad - s) for s in range(0, K_pad, k_block)]


def bfs_pull(
    snap: CSRSnapshot,
    seeds: np.ndarray,
    max_hops: int,
    chunk: int = PLAIN_CHUNK,
    k_block: int = 1024,
    count_edges: bool = True,
    fused: bool = True,
    device: str | torch.device = DEFAULT_DEVICE,
) -> PullBFSResult:
    """Pull-mode multi-hop BFS over all seeds at once, in ``k_block``-wide
    seed blocks. Each block runs the fused hop (``ops/fused_bfs.py``, K2)
    when ``fused`` and the snapshot's fused plan is supported, else the
    staged chain (K1). ``chunk`` is the streaming block of the plain
    versions on the CPU.

    Returns ``PullBFSResult(visited_t, edges_touched, reach_counts)``:
    ``visited_t`` a (n_pad, K/32) int32 transposed bitmap on ``device``,
    ``edges_touched`` a host (K,) int64 array (Σ deg over the frontiers of
    every hop), ``reach_counts`` a (K,) int32 tensor (|visited|, seed
    included). Pad lanes (K rounded up to 32) seed the dummy row and are cut
    from the counts."""
    dev = resolve_device(device)
    if k_block <= 0 or k_block % WORD:
        raise ValueError(
            f"k_block must be a positive multiple of {WORD} (words pack "
            f"{WORD} seeds); got {k_block}"
        )
    from hypergraphdb_tpu_torch.ops import fused_bfs

    seeds = np.asarray(seeds, dtype=np.int32)
    K = len(seeds)
    K_pad = _ceil_to(max(K, WORD), WORD)
    if K_pad != K:
        seeds = np.concatenate(
            [seeds, np.full(K_pad - K, snap.num_atoms, dtype=np.int32)]
        )
    blocks = []
    for s in range(0, K_pad, k_block):
        block = seeds[s : s + k_block]
        if fused and fused_bfs.fused_ready(snap, len(block)):
            blocks.append(fused_bfs.bfs_pull_fused(
                snap, block, max_hops, count_edges=count_edges, device=dev))
            continue
        blocks.append(_bfs_pull_device(
            device_plans(snap, dev), plans_for(snap),
            torch.from_numpy(block).to(dev), max_hops, chunk, count_edges,
        ))

    # the last S_h telescopes to the total over all hops
    def total_edges(b) -> np.ndarray:
        if not len(b[1]):  # zero hops / counting off
            return np.zeros(b[2].shape[0], np.int64)
        return b[1][-1].cpu().numpy().astype(np.int64)

    visited_t = torch.cat([b[0] for b in blocks], dim=1) \
        if len(blocks) > 1 else blocks[0][0]
    edges = np.concatenate([total_edges(b) for b in blocks])
    reach = torch.cat([b[2] for b in blocks]).to(torch.int32)
    return PullBFSResult(visited_t, edges[:K], reach[:K])


def visited_rows(res: PullBFSResult, n_atoms: int,
                 lanes: Optional[list[int]] = None) -> list[np.ndarray]:
    """Per-seed sorted reachable-atom arrays from the transposed bitmap, for
    every lane or only ``lanes``; decoded where the bitmap lives."""
    vt = res.visited_t[:n_atoms]  # drop dummy+pad rows
    if lanes is None:
        lanes = range(vt.shape[1] * WORD)
    out = []
    for k in lanes:
        hit = (vt[:, k >> 5] >> (k & 31)) & 1
        out.append(torch.nonzero(hit).flatten().cpu().numpy().astype(np.int64))
    return out
