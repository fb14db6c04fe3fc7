"""hgplan: the cost-based cross-lane query planner (the port of
``hypergraphdb_tpu/plan``).

Public surface:

- :class:`~hypergraphdb_tpu_torch.plan.stats.CardinalityEstimator` — exact-
  for-free cardinalities off the pinned base (window widths, degrees,
  type counts);
- :class:`~hypergraphdb_tpu_torch.plan.planner.QueryPlanner` /
  :class:`~hypergraphdb_tpu_torch.plan.planner.PlanChoice` — candidate
  enumeration + costed lane choice for a mixed ``And(...)``;
- :class:`~hypergraphdb_tpu_torch.plan.feedback.PlanFeedback` — the bounded
  per-shape est-vs-actual drift digest feeding corrections back into
  costing.

Wire a planner into a runtime with ``ServeRuntime.attach_planner`` and
submit through ``ServeRuntime.submit_planned``; standalone use (offline
EXPLAIN, tests) needs only a graph.
"""

from .feedback import PlanFeedback
from .planner import (PlanCandidate, PlanChoice, PlannedResult, QueryPlanner,
                      SHAPE_LANES)
from .stats import CardinalityEstimator, DegreeStats, Estimate

__all__ = [
    "CardinalityEstimator",
    "DegreeStats",
    "Estimate",
    "PlanCandidate",
    "PlanChoice",
    "PlanFeedback",
    "PlannedResult",
    "QueryPlanner",
    "SHAPE_LANES",
]
