"""hgplan planner: candidate enumeration + costed lane choice for And(...).

The port of ``hypergraphdb_tpu/plan/planner.py``. Its constants
(:data:`GATHER_S`, :data:`FILTER_S`, :data:`HOST_SCAN_S`,
:data:`HOST_BASE_S`, :data:`DEFAULT_LANE_PRIOR_S`) are the reference's, so
for the same graph, baseline and feedback stream the port's choices,
estimates and costs equal the reference's to the last bit (both compute
in float64 on the host). Recorded differences: a missing baseline file
plans on :data:`DEFAULT_LANE_PRIOR_S` and :meth:`QueryPlanner.health_summary`
says which priors are in force, but an unreadable file or one with the
wrong schema raises (the reference swallows both); an unknown type in an
``AtomType`` clause is the only error ``_type_handle`` turns into "no
estimate".

The serve tier has four fast lanes (bfs / pattern / join / range) and a
bridge that translates a condition into AT MOST ONE of them — a mixed
``And(...)`` outside the bridge's shapes is flatly Unservable, and even
inside them the bridge never asks which lane is CHEAPEST. This module is
the missing chooser, the twin of the reference's cost-based
condition compiler: classify the conjunction's clauses, enumerate every
lane that can carry a subset of them (the rest riding along as a host
residual filter), price each candidate with

    cost = lane latency prior  (the baseline's p50, seeded on the card)
         + corrected est_rows × per-row gather cost
         + corrected est_rows × residual clauses × per-row filter cost
         + overflow penalty    (est beyond the lane's top-k / result cap
                                forces the exact host re-serve, so the
                                candidate must carry that cost honestly)

and emit a typed :class:`PlanChoice` the runtime dispatches
(``ServeRuntime.submit_planned``). Estimates come from
``plan/stats.CardinalityEstimator`` (window widths, degrees, type
counts); NON-exact estimates are multiplied by the per-shape feedback
correction (``plan/feedback.PlanFeedback``) before costing.

Candidate shapes (``PlanChoice.shape``):

- ``range_first`` — push 1-2 same-kind value bounds (plus ≤1 type, ≤1
  incident anchor) into the range lane, host-filter the rest;
- ``pattern``    — push the incident anchors (+type) into the pattern
  intersection lane, host-filter values and the rest;
- ``join``       — hand the adjacency conjunction to the join executor
  (the only lane that can carry ``CoIncident``);
- ``bfs``        — anchor the traversal at the RAREST seed among the
  BFS clauses, everything else residual;
- ``host``       — the exact brute-force scan, always enumerable, so
  the planner can never be WORSE than having no planner: a lane only
  wins by beating it.

Safety valve: a learned correction may re-rank candidates, but if the
corrected winner differs from the uncorrected one AND the perf sentinel
currently flags the corrected winner's lane as breaching its baseline,
the planner keeps the uncorrected choice and counts a guard veto
(``plan.guard_vetoes``) — telemetry never gets to steer traffic INTO a
lane that is already on fire.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from hypergraphdb_tpu_torch.query import bridge, conditions as c
from hypergraphdb_tpu_torch.serve.types import Unservable

from .feedback import PlanFeedback
from .stats import CardinalityEstimator, Estimate

#: shape -> serve lane kind (host has no lane; it is priced from N)
SHAPE_LANES: Dict[str, str] = {
    "range_first": "range",
    "pattern": "pattern",
    "join": "join",
    "bfs": "bfs",
}

#: fallback per-lane latency priors (seconds) when the baseline has no
#: entry for the lane — deliberately coarse, seeded values win
DEFAULT_LANE_PRIOR_S: Dict[str, float] = {
    "range": 2e-3,
    "pattern": 2e-3,
    "join": 4e-3,
    "bfs": 3e-3,
}

#: per-row costs (seconds): device-window gather / host residual filter
#: per clause / host brute-force scan per atom per clause, plus the flat
#: host setup. Constants stay fixed; the feedback loop corrects the ROW
#: estimates they multiply, which is where the real variance lives.
GATHER_S = 2e-7
FILTER_S = 2e-6
HOST_SCAN_S = 2e-6
HOST_BASE_S = 5e-4


@dataclass(frozen=True)
class PlanCandidate:
    """One enumerable strategy: the lane request carrying the pushed
    clauses (None = pure host), the residual clauses the runtime
    filters with ``.satisfies``, and the raw (uncorrected) estimate of
    rows the lane returns BEFORE the residual."""

    shape: str
    request: object
    residual: Tuple[c.HGQueryCondition, ...]
    est: Estimate


@dataclass(frozen=True)
class PlanChoice:
    """The planner's verdict for one condition — everything the runtime
    needs to dispatch, and everything EXPLAIN needs to record."""

    shape: str
    request: object
    residual: Tuple[c.HGQueryCondition, ...]
    condition: c.HGQueryCondition
    est_rows: float
    exact_est: bool
    cost: float
    correction: float
    guard_vetoed: bool
    epoch: Optional[int]
    alternatives: Tuple[Dict[str, float], ...] = field(default=())

    def explain(self) -> Dict[str, object]:
        """The ``plan`` sub-dict of an EXPLAIN record (actual_rows is
        stamped by the runtime once the result lands)."""
        return {
            "shape": self.shape,
            "est_rows": round(self.est_rows, 3),
            "exact_est": self.exact_est,
            "cost": round(self.cost, 9),
            "correction": round(self.correction, 6),
            "guard_vetoed": self.guard_vetoed,
            "epoch": self.epoch,
            "alternatives": list(self.alternatives),
        }


@dataclass(frozen=True, eq=False)
class PlannedResult:
    """A planned request's answer: the lane (or host) rows AFTER the
    residual filter, ascending atom ids. ``lane_kind``/``served_by``
    attribute the execution (``host``/``host`` for the brute-force
    shape); ``plan`` is the EXPLAIN sub-dict with ``actual_rows``
    stamped (the LANE's pre-residual row count — what the feedback
    digest compares against ``est_rows``)."""

    kind: str               # always "planned"
    count: int
    matches: tuple          # int ascending
    truncated: bool
    epoch: Optional[int]
    lane_kind: str
    served_by: str
    plan: Dict[str, object]


class QueryPlanner:
    """Cost-based chooser over the serve lanes for one graph.

    ``baseline`` is the parsed ``PERF_BASELINE.json`` record (or its
    ``lanes`` mapping); ``lane_degraded`` is a predicate over lane
    kinds, normally bound to the perf sentinel's violating set by
    ``ServeRuntime.attach_planner``. ``stats`` (a ``ServeStats``) is
    also bound there; standalone planners simply skip the metrics.
    """

    def __init__(self, graph, estimator: Optional[CardinalityEstimator] = None,
                 feedback: Optional[PlanFeedback] = None,
                 baseline: Optional[dict] = None,
                 stats=None,
                 lane_degraded: Optional[Callable[[str], bool]] = None,
                 default_max_hops: int = 2, top_r: int = 8):
        self.graph = graph
        self.estimator = estimator or CardinalityEstimator(graph)
        self.feedback = feedback or PlanFeedback()
        self.stats = stats
        self.lane_degraded = lane_degraded
        self.default_max_hops = int(default_max_hops)
        self.top_r = int(top_r)
        self._priors = dict(DEFAULT_LANE_PRIOR_S)
        #: lane -> "baseline" or "default": which prior prices the lane
        self._prior_from = dict.fromkeys(DEFAULT_LANE_PRIOR_S, "default")
        #: where the baseline came from (``from_committed_baseline`` names
        #: the file, or says none was found) and the backend it records
        self.baseline_source: Optional[str] = (
            None if baseline is None else "given")
        self.baseline_backend = (baseline.get("backend")
                                 if isinstance(baseline, dict) else None)
        lanes = None
        if isinstance(baseline, dict):
            lanes = baseline.get("lanes", baseline)
        if isinstance(lanes, dict):
            for kind in SHAPE_LANES.values():
                lane = lanes.get(kind)
                if isinstance(lane, dict):
                    p50 = lane.get("p50_s")
                    if isinstance(p50, (int, float)) and p50 > 0:
                        self._priors[kind] = float(p50)
                        self._prior_from[kind] = "baseline"
        self._guard_vetoes = 0

    @classmethod
    def from_committed_baseline(cls, graph, path: Optional[str] = None,
                                **kw) -> "QueryPlanner":
        """A planner priced from a ``PERF_BASELINE.json``-shaped record —
        the same record ``obs.perf.seed_baseline`` writes and the perf
        sentinel gates on. ``path`` defaults to
        ``obs.perf.default_baseline_path()`` (``HG_PERF_BASELINE``; never
        the repository root's CPU record). No path, or no file there,
        plans on :data:`DEFAULT_LANE_PRIOR_S` and ``health_summary()``
        says so; a file that cannot be read or fails the schema check
        raises."""
        from hypergraphdb_tpu_torch.obs.perf import (
            default_baseline_path,
            load_baseline,
        )

        path = path or default_baseline_path()
        baseline = None
        if path is not None:
            try:
                baseline = load_baseline(path)
            except FileNotFoundError:
                baseline = None
        planner = cls(graph, baseline=baseline, **kw)
        planner.baseline_source = (
            path if baseline is not None
            else f"none (no file at {path})" if path is not None
            else "none (HG_PERF_BASELINE unset)")
        return planner

    # -- clause classification -----------------------------------------------
    @staticmethod
    def _clauses(condition: c.HGQueryCondition) -> Tuple[c.HGQueryCondition, ...]:
        if isinstance(condition, c.And):
            return tuple(condition.clauses)
        return (condition,)

    def _type_handle(self, cl: c.AtomType) -> Optional[int]:
        """The clause's type handle, or None for a type the graph does not
        know (``TypeError_`` from the type system; ``TypeError`` /
        ``ValueError`` for a handle that is not an int). Any other error
        reaches the caller."""
        from hypergraphdb_tpu_torch.core.errors import TypeError_

        try:
            return int(cl.type_handle(self.graph))
        except (TypeError_, TypeError, ValueError):
            return None

    # -- per-clause estimates ------------------------------------------------
    def _clause_estimate(self, cl) -> Optional[Estimate]:
        """Base cardinality of ONE clause's match set, or None when the
        clause has no estimator (residual-only vocabulary) — the
        intersection estimate simply ignores it (a sound upper bound)."""
        est = self.estimator
        try:
            if isinstance(cl, c.AtomValue):
                if cl.op == "eq":
                    return est.range_window(lo=cl.value, hi=cl.value)
                lo = cl.value if cl.op in ("gt", "gte") else None
                hi = cl.value if cl.op in ("lt", "lte") else None
                return est.range_window(lo=lo, hi=hi,
                                        lo_op=cl.op if lo is not None else "gte",
                                        hi_op=cl.op if hi is not None else "lte")
            if isinstance(cl, c.TypedValue):
                return self._clause_estimate(c.AtomValue(cl.value, cl.op))
            if isinstance(cl, c.AtomType):
                th = self._type_handle(cl)
                if th is None:
                    return None
                return Estimate(float(est.type_count(th)), True)
            if isinstance(cl, c.Incident):
                return est.incident_count(int(cl.target))
            if isinstance(cl, c.TypedIncident):
                return est.incident_count(int(cl.target))
            if isinstance(cl, c.CoIncident):
                return est.coincident_count(int(cl.other))
            if isinstance(cl, c.BFS):
                hops = cl.max_distance
                if hops is None:
                    hops = self.default_max_hops
                return est.bfs_frontier(int(cl.start), int(hops))
        except (ValueError, Unservable):
            return None
        return None

    def _intersection_estimate(self, clauses) -> Estimate:
        """Upper-bound estimate of the conjunction: the MINIMUM of the
        clauses' individual cardinalities (an intersection can never
        exceed its smallest member). Exact only when the binding
        minimum clause is exact AND it is the only clause."""
        best: Optional[Estimate] = None
        n = 0
        for cl in clauses:
            e = self._clause_estimate(cl)
            if e is None:
                continue
            n += 1
            if best is None or e.rows < best.rows:
                best = e
        if best is None:
            return Estimate(float(self.estimator.n_atoms()), False)
        return Estimate(best.rows, best.exact and n == 1 and len(clauses) == 1)

    # -- candidate enumeration -----------------------------------------------
    def _candidates(self, condition) -> List[PlanCandidate]:
        clauses = self._clauses(condition)
        out: List[PlanCandidate] = []

        # host: the exact scan, always available
        out.append(PlanCandidate(
            "host", None, clauses,
            Estimate(self._intersection_estimate(clauses).rows, False)))

        # range_first: 1-2 same-kind value bounds (+ ≤1 type, ≤1 anchor)
        rng = self._range_candidate(clauses)
        if rng is not None:
            out.append(rng)

        # pattern: incident anchors (+ one consistent type)
        pat = self._pattern_candidate(clauses)
        if pat is not None:
            out.append(pat)

        # join: the adjacency conjunction (needs a CoIncident — without
        # one the join lane degenerates to the pattern intersection and
        # only adds executor overhead)
        jn = self._join_candidate(condition, clauses)
        if jn is not None:
            out.append(jn)

        # bfs: anchor the traversal at the rarest-degree seed
        bf = self._bfs_candidate(clauses)
        if bf is not None:
            out.append(bf)
        return out

    def _range_candidate(self, clauses) -> Optional[PlanCandidate]:
        vals = [cl for cl in clauses if isinstance(cl, c.AtomValue)]
        if not vals or len(vals) > 2:
            return None
        types = [cl for cl in clauses if isinstance(cl, c.AtomType)]
        incs = [cl for cl in clauses if isinstance(cl, c.Incident)]
        pushed: List[c.HGQueryCondition] = list(vals)
        type_h = None
        if len(types) == 1:
            type_h = self._type_handle(types[0])
            if type_h is not None:
                pushed.append(types[0])
        anchor = None
        if incs:
            # push the RAREST anchor: the device filter then prunes the
            # window hardest, the denser anchors stay residual
            rare = min(incs, key=lambda i: self.estimator.degree(int(i.target)))
            anchor = int(rare.target)
            pushed.append(rare)
        try:
            sub = c.And(*pushed) if len(pushed) > 1 else pushed[0]
            req = bridge.to_request(self.graph, sub,
                                    default_max_hops=self.default_max_hops)
        except Unservable:
            return None
        residual = tuple(cl for cl in clauses
                         if not any(cl is p for p in pushed))
        # the window width prices the lane; pushed type/anchor only
        # shrink what comes back, so the width stays the honest measure.
        # Both bounds estimate as ONE window (the exact-for-free claim:
        # its searchsorted width IS the conjunction's cardinality), not
        # as the min of two half-open windows
        win = self._window_estimate(vals)
        return PlanCandidate("range_first", req, residual, win)

    def _window_estimate(self, vals) -> Estimate:
        """The COMBINED window of 1-2 value bounds: eq collapses to
        [v, v]; a lower (gt/gte) and an upper (lt/lte) bound close one
        window. Falls back to the per-clause min only for same-direction
        pairs (which the bridge rejects anyway)."""
        if len(vals) == 1:
            e = self._clause_estimate(vals[0])
            return e if e is not None else Estimate(
                float(self.estimator.n_atoms()), False)
        lows = [v for v in vals if v.op in ("gt", "gte")]
        highs = [v for v in vals if v.op in ("lt", "lte")]
        if len(lows) == 1 and len(highs) == 1:
            try:
                return self.estimator.range_window(
                    lo=lows[0].value, hi=highs[0].value,
                    lo_op=lows[0].op, hi_op=highs[0].op)
            except (ValueError, Unservable):
                pass
        return self._intersection_estimate(vals)

    def _pattern_candidate(self, clauses) -> Optional[PlanCandidate]:
        pushed = [cl for cl in clauses
                  if isinstance(cl, (c.Incident, c.TypedIncident, c.AtomType))]
        if not any(isinstance(cl, (c.Incident, c.TypedIncident))
                   for cl in pushed):
            return None
        try:
            sub = c.And(*pushed) if len(pushed) > 1 else pushed[0]
            req = bridge.to_request(self.graph, sub,
                                    default_max_hops=self.default_max_hops)
        except Unservable:
            return None
        residual = tuple(cl for cl in clauses
                         if not any(cl is p for p in pushed))
        return PlanCandidate("pattern", req, residual,
                             self._intersection_estimate(pushed))

    def _join_candidate(self, condition, clauses) -> Optional[PlanCandidate]:
        if not any(isinstance(cl, c.CoIncident) for cl in clauses):
            return None
        pushed = [cl for cl in clauses
                  if isinstance(cl, (c.CoIncident, c.Incident,
                                     c.TypedIncident, c.AtomType, c.Link))]
        try:
            sub = c.And(*pushed) if len(pushed) > 1 else pushed[0]
            req = bridge.to_join_request(self.graph, {"x": sub},
                                         distinct=False)
        except Unservable:
            return None
        residual = tuple(cl for cl in clauses
                         if not any(cl is p for p in pushed))
        return PlanCandidate("join", req, residual,
                             self._intersection_estimate(pushed))

    def _bfs_candidate(self, clauses) -> Optional[PlanCandidate]:
        bfss = [cl for cl in clauses if isinstance(cl, c.BFS)]
        if not bfss:
            return None
        # the rarer end: smallest seed degree compounds to the smallest
        # frontier, every other clause (including other BFS legs)
        # filters the smaller set on the host
        seed_cl = min(bfss,
                      key=lambda b: self.estimator.degree(int(b.start)))
        try:
            req = bridge.to_request(self.graph, seed_cl,
                                    default_max_hops=self.default_max_hops)
        except Unservable:
            return None
        residual = tuple(cl for cl in clauses if cl is not seed_cl)
        return PlanCandidate("bfs", req, residual,
                             self._clause_estimate(seed_cl)
                             or Estimate(float(self.estimator.n_atoms()),
                                         False))

    # -- costing -------------------------------------------------------------
    def _cost(self, cand: PlanCandidate, rows: float) -> float:
        if cand.shape == "host":
            n = float(self.estimator.n_atoms())
            return HOST_BASE_S + n * max(1, len(cand.residual)) * HOST_SCAN_S
        cost = self._priors[SHAPE_LANES[cand.shape]]
        cost += rows * GATHER_S
        cost += rows * len(cand.residual) * FILTER_S
        if cand.shape == "range_first" and rows > self.top_r:
            # a window wider than the lane's top-k truncates on device
            # and the runtime must re-serve exactly on the host — price
            # the candidate as if it were the scan it will become
            n = float(self.estimator.n_atoms())
            cost += HOST_BASE_S + n * HOST_SCAN_S
        return cost

    def _corrected_rows(self, cand: PlanCandidate) -> Tuple[float, float]:
        """(rows for costing, correction applied). Exact estimates are
        counts — correcting them could only make them wrong."""
        if cand.est.exact or self.feedback is None:
            return cand.est.rows, 1.0
        corr = self.feedback.correction(cand.shape)
        return cand.est.rows * corr, corr

    # -- the verdict ---------------------------------------------------------
    def shapes_for(self, condition) -> List[str]:
        """The enumerable shapes for ``condition`` — the differential
        suite iterates this to force-execute every candidate."""
        return [cand.shape for cand in self._candidates(condition)]

    def plan(self, condition, force_shape: Optional[str] = None) -> PlanChoice:
        """Choose the cheapest candidate for ``condition``.

        ``force_shape`` bypasses costing and picks the named candidate
        (ValueError if it is not enumerable for this condition) — the
        hook the differential suite and the ≥2×-vs-worst smoke use."""
        self.estimator.refresh()
        cands = self._candidates(condition)
        scored = []
        for cand in cands:
            rows, corr = self._corrected_rows(cand)
            scored.append((cand, rows, corr,
                           self._cost(cand, rows),          # corrected
                           self._cost(cand, cand.est.rows)))  # raw

        if force_shape is not None:
            for cand, rows, corr, cost, _raw in scored:
                if cand.shape == force_shape:
                    return self._choice(condition, cand, rows, corr, cost,
                                        scored, guard_vetoed=False)
            raise ValueError(
                f"shape {force_shape!r} is not a candidate for this "
                f"condition (have {[s[0].shape for s in scored]})")

        best = min(scored, key=lambda s: s[3])
        best_raw = min(scored, key=lambda s: s[4])
        guard = False
        if best[0].shape != best_raw[0].shape and self.lane_degraded is not None:
            lane = SHAPE_LANES.get(best[0].shape)
            if lane is not None and self.lane_degraded(lane):
                # the learned correction steered the argmin onto a lane
                # the perf sentinel says is breaching its baseline: veto
                best = best_raw
                guard = True
                self._guard_vetoes += 1
                if self.stats is not None:
                    self.stats.record_plan_guard_veto()
        cand, rows, corr, cost, _ = best
        return self._choice(condition, cand, rows, corr, cost, scored,
                            guard_vetoed=guard)

    def _choice(self, condition, cand: PlanCandidate, rows: float,
                corr: float, cost: float, scored,
                guard_vetoed: bool) -> PlanChoice:
        alts = tuple(
            {"shape": s[0].shape, "cost": round(s[3], 9),
             "est_rows": round(s[1], 3)}
            for s in sorted(scored, key=lambda s: s[3])
        )
        # the original full condition travels on the choice so the
        # runtime's exactness escape hatch (truncated lane results)
        # can re-serve it brute-force without re-deriving it
        choice = PlanChoice(
            shape=cand.shape, request=cand.request, residual=cand.residual,
            condition=condition,
            est_rows=rows, exact_est=cand.est.exact, cost=cost,
            correction=corr, guard_vetoed=guard_vetoed,
            epoch=self.estimator.epoch, alternatives=alts)
        if self.stats is not None:
            self.stats.record_plan_request(cand.shape, rows, cost)
        return choice

    # -- feedback + observability --------------------------------------------
    def observe(self, choice: PlanChoice, actual_rows: int) -> None:
        """Close the loop for one executed choice: feed est-vs-actual
        into the drift digest (non-exact estimates only — an exact
        window width matching its actual teaches nothing) and the
        ``plan.*`` metrics."""
        if self.stats is not None:
            self.stats.record_plan_actual(choice.est_rows, actual_rows)
        if choice.exact_est or self.feedback is None:
            return
        stored = self.feedback.observe(choice.shape, choice.est_rows,
                                       float(actual_rows))
        if stored is not None and self.stats is not None:
            self.stats.record_plan_feedback_update(
                clamped=(stored != actual_rows / choice.est_rows))

    def health_summary(self) -> Dict[str, object]:
        """The ``plan`` payload of ``/healthz`` and ``/fleet/plan``:
        correction state + guard-veto count, JSON-safe."""
        fb = self.feedback.snapshot() if self.feedback is not None else {}
        return {
            "enabled": bool(fb.get("enabled", False)),
            "corrections_active": (self.feedback.corrections_active()
                                   if self.feedback is not None else 0),
            "guard_vetoes": self._guard_vetoes,
            "shapes": fb.get("shapes", {}),
            "updates": fb.get("updates", 0),
            # the port's addition: which lane priors are in force
            "priors": {
                "source": self.baseline_source,
                "backend": self.baseline_backend,
                "lanes": {kind: {"p50_s": self._priors[kind],
                                 "from": self._prior_from[kind]}
                          for kind in sorted(self._priors)},
            },
        }
