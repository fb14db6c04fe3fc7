"""Conjunctive pattern joins: the IR (:mod:`~hypergraphdb_tpu_torch.join.ir`),
the planner and the compiler's device plan
(:mod:`~hypergraphdb_tpu_torch.join.planner`), the exact host enumerator
(:mod:`~hypergraphdb_tpu_torch.join.host`) and, in ``ops/join.py``, the
batched executor on the card.

The port of ``hypergraphdb_tpu/join``. The host enumerator is both the
differential oracle and the serve lane's exact fallback::

    from hypergraphdb_tpu_torch import join
    from hypergraphdb_tpu_torch.query import conditions as c
    spec = {"y": c.And(c.CoIncident(a), c.CoIncident(join.var("z"))),
            "z": c.CoIncident(a)}                 # triangle through a
    p = join.extract_pattern(g, spec)
    join.host_join(g, p)                          # exact, sorted tuples
    sig, consts = join.split_constants(p)
    plan = join.plan_join(g.snapshot(), p, sig, consts)

    from hypergraphdb_tpu_torch.ops.join import execute_join
    ex = execute_join(g.snapshot(), plan, np.asarray([consts], np.int32),
                      device="cpu")               # the card by default

Serving rides ``ServeRuntime.submit_join`` / ``query.bridge.
to_join_request``; ``graph.find_all(And(CoIncident, ...))`` plans as a
:class:`~hypergraphdb_tpu_torch.join.planner.DeviceJoinPlan`. Patterns of
the reference's IR carry over with
:func:`~hypergraphdb_tpu_torch.join.ir.pattern_from_reference`.
"""

from hypergraphdb_tpu_torch.join.host import (
    host_join,
    host_join_count,
    host_join_touching,
)
from hypergraphdb_tpu_torch.join.ir import (
    ConjunctivePattern,
    JoinAtom,
    JoinUnsupported,
    PatternSignature,
    extract_pattern,
    pattern_from_reference,
    pattern_to_conditions,
    split_constants,
)
from hypergraphdb_tpu_torch.join.planner import (
    BagJoin,
    BushyJoinPlan,
    DeviceJoinPlan,
    JoinPlan,
    JoinStep,
    hub_lane_mask,
    plan_join,
)
from hypergraphdb_tpu_torch.query.variables import Var, var

__all__ = [
    "BagJoin",
    "BushyJoinPlan",
    "ConjunctivePattern",
    "DeviceJoinPlan",
    "JoinAtom",
    "JoinPlan",
    "JoinStep",
    "JoinUnsupported",
    "PatternSignature",
    "Var",
    "extract_pattern",
    "host_join",
    "host_join_count",
    "host_join_touching",
    "hub_lane_mask",
    "pattern_from_reference",
    "pattern_to_conditions",
    "plan_join",
    "split_constants",
    "var",
]
