"""hgplan cardinality estimation: exact-for-free stats off the pinned base.

The port of ``hypergraphdb_tpu/plan/stats.py``: host numpy over the port's
``ops/snapshot.CSRSnapshot``, so its values equal the reference's for the
same graph.

The reference's cost-based compiler prices conditions with per-index
``HGIndexStats`` counters kept transactionally beside the data
(``query/HGQuery.java``); this twin reads everything it needs
off columns the serve tier ALREADY maintains — no new bookkeeping, no
device work, refreshed once per compaction epoch:

- **range windows** — per-kind ``(value_rank, value_rank2)`` columns of
  the base snapshot, sorted once per epoch; a range predicate's window
  width under 128-bit searchsorted IS its cardinality (exact whenever
  the column and bounds are rank-exact: always for fixed-width kinds,
  and for str/bytes whose keys fit the 16-byte rank prefix NUL-free —
  the hgindex tie-break contract, ``storage/value_index``);
- **degree stats** — the incidence CSR's row widths: per-type mean /
  max / hub count, plus the exact incidence-set size of any single atom
  (``Incident(a)``'s cardinality at the base, no estimate involved);
- **type counts** — ``by_type``-equivalent bincounts over ``type_of``.

All reads are host numpy over the IMMUTABLE base snapshot: estimates
describe the compacted graph; the memtable residual is bounded by the
serve tier's ``max_lag_edges`` discipline and compensated downstream by
the planner's feedback corrections, never here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from hypergraphdb_tpu_torch.utils.ordered_bytes import rank64


@dataclass(frozen=True)
class DegreeStats:
    """Incidence-degree summary of one type (or the whole graph):
    ``hubs`` counts atoms whose degree reaches ``hub_threshold`` — the
    same degree-skew signal the join engine's hub split keys on."""

    n: int
    mean: float
    max: int
    hubs: int
    hub_threshold: int


@dataclass(frozen=True)
class Estimate:
    """One cardinality estimate plus its honesty bit: ``exact`` means
    the number is a count, not a model — the planner's costing treats
    exact estimates as immune to feedback correction."""

    rows: float
    exact: bool


class CardinalityEstimator:
    """Epoch-cached, device-free cardinality reads for one graph.

    Pass the serve tier's ``SnapshotManager`` (``ServeRuntime.mgr``) so
    estimates track compaction epochs; standalone (tests, offline
    EXPLAIN) the estimator packs its own base per graph mutation
    counter. Every public method is O(log N) or O(types) against arrays
    built once per epoch.
    """

    def __init__(self, graph, mgr=None, hub_factor: float = 8.0):
        self.graph = graph
        self.mgr = mgr
        self.hub_factor = float(hub_factor)
        self._epoch: Optional[int] = None
        self._snap = None
        self._kind_cols: dict = {}       # kind -> (r1 sorted, r2 sorted)
        self._kind_ambig: dict = {}      # kind -> column has ambiguous keys
        self._type_counts: dict = {}
        self._degrees: Optional[np.ndarray] = None
        self._live: Optional[np.ndarray] = None
        self._deg_stats: dict = {}

    # -- epoch management ----------------------------------------------------
    def _current_epoch(self) -> int:
        if self.mgr is not None:
            return int(self.mgr.compactions)
        return int(getattr(self.graph, "_mutations", 0))

    def _base(self):
        if self.mgr is not None:
            return self.mgr.base
        from hypergraphdb_tpu_torch.ops.snapshot import CSRSnapshot

        return CSRSnapshot.pack(self.graph)

    def refresh(self) -> int:
        """Re-read the base snapshot if the epoch moved; returns the
        epoch the estimator now describes. Cheap no-op when current."""
        epoch = self._current_epoch()
        if epoch == self._epoch and self._snap is not None:
            return epoch
        snap = self._base()
        N = snap.num_atoms
        live = snap.type_of[:N] >= 0
        self._snap = snap
        self._live = live
        self._epoch = epoch
        self._kind_cols = {}
        self._kind_ambig = {}
        self._deg_stats = {}
        degrees = (snap.inc_offsets[1:N + 1]
                   - snap.inc_offsets[:N]).astype(np.int64)
        self._degrees = degrees
        th = snap.type_of[:N][live]
        if len(th):
            uniq, counts = np.unique(th, return_counts=True)
            self._type_counts = {int(t): int(c)
                                 for t, c in zip(uniq.tolist(),
                                                 counts.tolist())}
        else:
            self._type_counts = {}
        return epoch

    def _ensure(self):
        self.refresh()

    # -- simple exact reads --------------------------------------------------
    @property
    def epoch(self) -> Optional[int]:
        return self._epoch

    def n_atoms(self) -> int:
        """Live atoms at the base (exact)."""
        self._ensure()
        return int(self._live.sum())

    def type_count(self, type_handle: int) -> int:
        """Atoms of one type at the base (exact)."""
        self._ensure()
        return self._type_counts.get(int(type_handle), 0)

    def degree(self, h: int) -> int:
        """Incidence-set size of atom ``h`` at the base — EXACTLY
        ``Incident(h)``'s base cardinality (0 beyond the id space)."""
        self._ensure()
        if 0 <= int(h) < len(self._degrees):
            return int(self._degrees[int(h)])
        return 0

    def degree_stats(self, type_handle: Optional[int] = None) -> DegreeStats:
        """Mean / max / hub-count of incidence degrees, over one type's
        atoms or (``None``) all live atoms. The hub threshold is
        ``max(8, hub_factor × mean)`` — relative, so uniform graphs
        report zero hubs whatever their density."""
        self._ensure()
        key = None if type_handle is None else int(type_handle)
        cached = self._deg_stats.get(key)
        if cached is not None:
            return cached
        snap = self._snap
        N = snap.num_atoms
        if key is None:
            sel = self._live
        else:
            sel = snap.type_of[:N] == np.int32(key)
        deg = self._degrees[sel]
        if len(deg) == 0:
            out = DegreeStats(0, 0.0, 0, 0, 8)
        else:
            mean = float(deg.mean())
            thr = max(8, int(np.ceil(mean * self.hub_factor)))
            out = DegreeStats(len(deg), mean, int(deg.max()),
                              int((deg >= thr).sum()), thr)
        self._deg_stats[key] = out
        return out

    # -- range windows -------------------------------------------------------
    def _kind_column(self, kind: int):
        """The kind's (rank, rank2) pair sorted lexicographically, built
        once per epoch — the estimator's own twin of the device column,
        minus the upload."""
        kind = int(kind)
        col = self._kind_cols.get(kind)
        if col is not None:
            return col
        snap = self._snap
        N = snap.num_atoms
        sel = (snap.value_kind[:N] == np.uint8(kind)) & self._live
        r1 = snap.value_rank[:N][sel].astype(np.uint64)
        r2_col = getattr(snap, "value_rank2", None)
        if r2_col is not None and len(r2_col) >= N:
            r2 = r2_col[:N][sel].astype(np.uint64)
        else:
            r2 = np.zeros(len(r1), dtype=np.uint64)
        order = np.lexsort((r2, r1))
        col = (r1[order], r2[order])
        self._kind_cols[kind] = col
        ambig_col = getattr(snap, "value_ambig", None)
        from hypergraphdb_tpu_torch.storage.value_index import FIXED_WIDTH_KINDS

        if kind in FIXED_WIDTH_KINDS:
            self._kind_ambig[kind] = False
        elif ambig_col is not None and len(ambig_col) >= N:
            self._kind_ambig[kind] = bool(ambig_col[:N][sel].any())
        else:
            self._kind_ambig[kind] = bool(len(r1))  # no rank2: be honest
        return col

    @staticmethod
    def _searchsorted128(r1: np.ndarray, r2: np.ndarray, q1: int, q2: int,
                         side: str) -> int:
        """Host 128-bit lexicographic searchsorted: position of the
        (q1, q2) bound in the sorted (r1, r2) pair — numpy binary search
        on the high word, then on the low word inside the tie run."""
        lo = int(np.searchsorted(r1, np.uint64(q1), side="left"))
        hi = int(np.searchsorted(r1, np.uint64(q1), side="right"))
        return lo + int(np.searchsorted(r2[lo:hi], np.uint64(q2), side=side))

    def _value_rank128(self, value) -> tuple:
        """(kind, rank, rank2, clean) of one query value via the
        typesystem — the bridge's key derivation, estimator edition.
        ``clean`` means the payload fits the 16-byte rank NUL-free, so
        128-bit comparisons against a clean column are exact."""
        vt = self.graph.typesystem.infer(value)
        if vt is None:
            raise ValueError(f"value {value!r} has no registered type")
        key = vt.to_key(value)
        payload = key[1:]
        clean = len(payload) <= 16 and b"\x00" not in payload[:16]
        return key[0], rank64(payload), rank64(payload[8:16]), clean

    def range_window(self, lo=None, hi=None, lo_op: str = "gte",
                     hi_op: str = "lte") -> Estimate:
        """Width of the ``[lo, hi]`` window in the bounds' kind column —
        the range predicate's cardinality. Exact when both the column
        and the bounds are rank-exact (fixed-width kinds always;
        variable-width under the 16-byte NUL-free tie-break contract);
        otherwise the width is still the device window's honest size,
        flagged ``exact=False``."""
        self._ensure()
        if lo is None and hi is None:
            raise ValueError("range_window needs at least one bound")
        from hypergraphdb_tpu_torch.storage.value_index import FIXED_WIDTH_KINDS

        kind = None
        bounds_clean = True
        lo_r = hi_r = None
        if lo is not None:
            kind, r1, r2, clean = self._value_rank128(lo)
            bounds_clean &= clean
            lo_r = (r1, r2)
        if hi is not None:
            k2, r1, r2, clean = self._value_rank128(hi)
            if kind is not None and k2 != kind:
                raise ValueError("mixed-kind range bounds")
            kind = k2
            bounds_clean &= clean
            hi_r = (r1, r2)
        c1, c2 = self._kind_column(kind)
        if lo_r is None:
            lo_idx = 0
        else:
            side = "right" if lo_op == "gt" else "left"
            lo_idx = self._searchsorted128(c1, c2, lo_r[0], lo_r[1], side)
        if hi_r is None:
            hi_idx = len(c1)
        else:
            side = "right" if hi_op == "lte" else "left"
            hi_idx = self._searchsorted128(c1, c2, hi_r[0], hi_r[1], side)
        width = max(0, hi_idx - lo_idx)
        exact = (kind in FIXED_WIDTH_KINDS
                 or (bounds_clean and not self._kind_ambig[int(kind)]))
        return Estimate(float(width), exact)

    # -- composite estimates -------------------------------------------------
    def incident_count(self, target: int) -> Estimate:
        """``Incident(target)``'s base cardinality — the incidence-set
        size, exact by construction."""
        return Estimate(float(self.degree(target)), True)

    def coincident_count(self, other: int) -> Estimate:
        """``CoIncident(other)`` estimate: atoms sharing a link with
        ``other`` ≈ Σ (arity − 1) over other's incident links — an
        upper bound that overcounts only multi-link co-neighbours, so
        its relative error is bounded by the co-neighbour multiplicity
        (small on everything but pathological multigraphs)."""
        self._ensure()
        snap = self._snap
        h = int(other)
        if not (0 <= h < snap.num_atoms):
            return Estimate(0.0, True)
        s, e = int(snap.inc_offsets[h]), int(snap.inc_offsets[h + 1])
        links = snap.inc_links[s:e]
        if len(links) == 0:
            return Estimate(0.0, True)
        est = float(np.maximum(
            snap.arity[links].astype(np.int64) - 1, 0).sum())
        return Estimate(est, False)

    def bfs_frontier(self, seed: int, hops: int) -> Estimate:
        """Reachable-set estimate for a ``hops``-bounded BFS from
        ``seed``: seed degree compounded by the mean degree per extra
        hop, capped by the live-atom count — a growth model, never
        exact (the planner treats it as the coarsest input it has)."""
        self._ensure()
        d0 = float(self.degree(seed))
        if hops <= 0 or d0 == 0.0:
            return Estimate(0.0, False)
        mean = max(1.0, self.degree_stats().mean)
        est = d0 * (mean ** max(0, int(hops) - 1))
        return Estimate(min(est, float(self.n_atoms())), False)
