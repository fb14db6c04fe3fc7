"""Conjunctive pattern joins: the IR (:mod:`~hypergraphdb_tpu_torch.join.ir`),
the planner (:mod:`~hypergraphdb_tpu_torch.join.planner`) and, in
``ops/join.py``, the batched executor on the card.

The port of ``hypergraphdb_tpu/join``. Not here yet: ``extract_pattern``
and ``pattern_to_conditions`` (they read the query layer), the exact host
enumerator ``host_join`` (it reads the graph), and the planner's cost model
with ``DeviceJoinPlan`` and ``try_single_var_join``, the value hook that
turns a query's value conditions into windows (both read a graph). The
executor takes the windows themselves: ``execute_join(value_windows=)``
filters a variable's candidates by value rank inside the step that binds
it. Patterns are built directly, or carried over from the reference with
:func:`~hypergraphdb_tpu_torch.join.ir.pattern_from_reference`::

    from hypergraphdb_tpu_torch.join import (
        ConjunctivePattern, JoinAtom, plan_join, split_constants)
    from hypergraphdb_tpu_torch.ops.join import execute_join
    p = ConjunctivePattern(vars=("y", "z"), atoms=(
        JoinAtom("co", "y", a), JoinAtom("co", "y", "z"),
        JoinAtom("co", "z", a)))                   # triangle through a
    sig, consts = split_constants(p)
    plan = plan_join(snap, p, sig, consts)
    ex = execute_join(snap, plan, np.asarray([consts], np.int32),
                      device="cpu")
    execute_join(snap, plan, np.asarray([consts], np.int32),
                 value_windows={plan.order[-1]: (0, 10, "gte", 99, "lt")},
                 device="cpu")                  # ranks in [10, 99), kind 0
"""

from hypergraphdb_tpu_torch.join.ir import (
    ConjunctivePattern,
    JoinAtom,
    JoinUnsupported,
    PatternSignature,
    pattern_from_reference,
    split_constants,
)
from hypergraphdb_tpu_torch.join.planner import (
    BagJoin,
    BushyJoinPlan,
    JoinPlan,
    JoinStep,
    hub_lane_mask,
    plan_join,
)

__all__ = [
    "BagJoin",
    "BushyJoinPlan",
    "ConjunctivePattern",
    "JoinAtom",
    "JoinPlan",
    "JoinStep",
    "JoinUnsupported",
    "PatternSignature",
    "hub_lane_mask",
    "pattern_from_reference",
    "plan_join",
    "split_constants",
]
