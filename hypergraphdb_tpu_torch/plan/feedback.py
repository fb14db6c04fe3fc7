"""hgplan feedback: bounded per-plan-shape drift digest over est-vs-actual.

The port of ``hypergraphdb_tpu/plan/feedback.py``, unchanged in behaviour.

Every planned request's EXPLAIN record carries ``plan.est_rows`` and
``plan.actual_rows``; this module is the loop that closes them. Per plan
shape (the coarse strategy key — ``range_first``, ``join``, ``bfs``,
``pattern``, ``host``) it keeps a bounded window of ``actual / est``
ratios and serves their clamped median as a multiplicative correction
the planner applies to NON-exact estimates before costing. Medians over
clamped windows make the digest robust to the two failure modes a
naive mean would amplify: a single pathological query (one huge ratio)
and systematic zero-actuals (est correction driven to the floor).

Discipline, mirroring every other adaptive surface in the repo
(admission controller, breaker ladder, subscription tier):

- **bounded** — at most ``max_shapes`` shapes × ``window`` samples;
  overflow evicts the least-recently-updated shape, never grows;
- **gated** — ``enabled=False`` (or fewer than ``min_samples``
  observations) serves the identity correction, so the planner without
  telemetry is exactly the planner with the loop switched off;
- **observable** — :meth:`snapshot` feeds the ``/fleet/plan`` surface
  and the ``plan.feedback.*`` metrics; nothing is learned silently.

The sentinel guard lives in the PLANNER, not here: a correction that
would flip the argmin onto a lane the perf sentinel currently flags is
vetoed at costing time (``plan.guard_vetoes``) — the digest still
learns, it just doesn't get to steer into a known-degraded lane.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Dict, Optional, Tuple


class PlanFeedback:
    """Bounded per-shape multiplicative-correction store.

    ``clamp`` bounds each STORED ratio (and therefore the served
    median), keeping one absurd observation from ever dominating;
    ``min_samples`` is the warm-up gate below which the correction is
    identity.
    """

    def __init__(self, max_shapes: int = 64, window: int = 128,
                 clamp: Tuple[float, float] = (0.25, 4.0),
                 min_samples: int = 8, enabled: bool = True):
        if max_shapes <= 0 or window <= 0:
            raise ValueError("max_shapes and window must be positive")
        lo, hi = float(clamp[0]), float(clamp[1])
        if not (0.0 < lo <= 1.0 <= hi):
            raise ValueError("clamp must bracket 1.0 with a positive floor")
        self.max_shapes = int(max_shapes)
        self.window = int(window)
        self.clamp = (lo, hi)
        self.min_samples = int(min_samples)
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        # shape -> deque of clamped actual/est ratios; OrderedDict as an
        # LRU so eviction drops the staletest shape, not an arbitrary one.
        self._ratios: "OrderedDict[str, deque]" = OrderedDict()
        self._updates = 0
        self._clamped = 0

    # -- learning ------------------------------------------------------------
    def observe(self, shape: str, est_rows: float,
                actual_rows: float) -> Optional[float]:
        """Record one est-vs-actual pair for ``shape``; returns the
        clamped ratio stored, or None when the pair is unusable (est
        non-finite or ≤ 0 gives the ratio no denominator — a zero
        estimate that materialized rows is a MODEL bug the oracle tests
        catch, not a scale error a multiplier can fix)."""
        try:
            est = float(est_rows)
            actual = float(actual_rows)
        except (TypeError, ValueError):
            return None
        if not (est > 0.0) or actual < 0.0 or est != est or actual != actual:
            return None
        lo, hi = self.clamp
        raw = actual / est
        ratio = min(hi, max(lo, raw))
        with self._lock:
            dq = self._ratios.get(shape)
            if dq is None:
                while len(self._ratios) >= self.max_shapes:
                    self._ratios.popitem(last=False)
                dq = deque(maxlen=self.window)
                self._ratios[shape] = dq
            else:
                self._ratios.move_to_end(shape)
            dq.append(ratio)
            self._updates += 1
            if ratio != raw:
                self._clamped += 1
        return ratio

    # -- serving -------------------------------------------------------------
    @staticmethod
    def _median(values) -> float:
        ordered = sorted(values)
        n = len(ordered)
        mid = n // 2
        if n % 2:
            return ordered[mid]
        return 0.5 * (ordered[mid - 1] + ordered[mid])

    def correction(self, shape: str) -> float:
        """The multiplicative correction for ``shape``: clamped median
        of its ratio window, or 1.0 while disabled / warming up."""
        if not self.enabled:
            return 1.0
        with self._lock:
            dq = self._ratios.get(shape)
            if dq is None or len(dq) < self.min_samples:
                return 1.0
            return self._median(dq)

    def corrections_active(self) -> int:
        """Shapes currently past warm-up and serving a non-identity
        correction — surfaced through the planner's health section and
        the fleet ``corrections_active`` rollup (not a registry name)."""
        if not self.enabled:
            return 0
        with self._lock:
            return sum(1 for dq in self._ratios.values()
                       if len(dq) >= self.min_samples
                       and self._median(dq) != 1.0)

    # -- observability -------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """JSON-safe state for ``/fleet/plan`` and tests: per-shape
        sample counts + served corrections, plus the update/clamp
        totals."""
        with self._lock:
            shapes = {
                shape: {
                    "samples": len(dq),
                    "correction": round(
                        self._median(dq), 6)
                    if self.enabled and len(dq) >= self.min_samples else 1.0,
                }
                for shape, dq in self._ratios.items()
            }
            return {
                "enabled": self.enabled,
                "shapes": shapes,
                "updates": self._updates,
                "clamped": self._clamped,
                "window": self.window,
                "min_samples": self.min_samples,
            }

    def reset(self) -> None:
        with self._lock:
            self._ratios.clear()
            self._updates = 0
            self._clamped = 0
