"""Condition → batched serving request: the supported subset.

The port's copy of ``hypergraphdb_tpu/query/bridge.py``.

The serving runtime batches four device shapes — K-seed BFS, K
conjunctive incident patterns, K same-signature conjunctive-pattern
JOINS (triangles, paths, stars, anchored multi-variable conjunctions —
the hgjoin subsystem), and K value RANGE / ordered / top-k probes over
one indexed dimension (the hgindex subsystem). This module maps the
query-condition vocabulary onto them:

==========================================  ================================
condition                                   request
==========================================  ================================
``BFS(start, max_distance=d)``              ``BFSRequest(start, d)``
``Incident(t)``                             ``PatternRequest((t,))``
``TypedIncident(t, T)``                     ``PatternRequest((t,), T)``
``Link(t1, .., tn)``                        ``PatternRequest((t1, .., tn))``
``And(Incident.., [AtomType])``             ``PatternRequest(anchors, T)``
``And(CoIncident.., ..)``                   ``JoinRequest(sig, consts)``
multi-variable spec (``to_join_request``)   ``JoinRequest(sig, consts)``
``AtomValue(v, op)``                        ``RangeRequest(dim, ...)``
``TypedValue(v, T, op)``                    ``RangeRequest(dim, ..., T)``
``And(AtomValue lo, AtomValue hi,           ``RangeRequest(dim, lo, hi,
[AtomType], [Incident])``                   [T], [anchor])``
==========================================  ================================

A single condition whose ``And`` mixes ``CoIncident`` with the incident
vocabulary becomes a one-variable join; a *spec* — ``{var: condition}``
with ``query.variables.Var`` cross-references — becomes a multi-variable
join via :func:`to_join_request` (``extract_pattern`` → signature/
constant split; see the README "Pattern joins" table for the exact
vocabulary: CoIncident/Incident/Target/AtomType per variable). Value
predicates batch by ``("range", dim)`` — one sorted device column per
value kind (``storage/value_index``); ordered/top-k shapes ride the same
lane via :func:`to_range_request`'s ``desc``/``limit``.

Anything else — Or/Not, regex, unbounded BFS, cross-kind value bounds —
raises a typed :class:`~hypergraphdb_tpu_torch.serve.types.Unservable`: the
caller runs those through ``graph.find_all`` (the planner's host/one-shot
device paths stay exact and general; the serving subset is deliberately
the batch-native shapes). This is honest scoping, not a
fallback-in-disguise: a serving tier that silently degraded to one-shot
execution would destroy the latency contract it exists to provide.
"""

from __future__ import annotations

from typing import Mapping, Optional

from hypergraphdb_tpu_torch.query import conditions as c
from hypergraphdb_tpu_torch.serve.types import (
    BFSRequest,
    JoinRequest,
    PatternRequest,
    RangeRequest,
    Unservable,
)


def _type_handle(graph, type_cond: c.AtomType) -> int:
    if graph is None and isinstance(type_cond.type, str):
        raise Unservable(
            "type names need a graph to resolve; pass a type handle"
        )
    return int(type_cond.type_handle(graph)) if isinstance(
        type_cond.type, str
    ) else int(type_cond.type)


def _value_key(graph, value) -> bytes:
    """The order-preserving key of one query value via the typesystem,
    or a typed :class:`Unservable` when the value has no key encoding."""
    if graph is None:
        raise Unservable("value predicates need a graph to derive the "
                         "indexed dimension and rank bounds")
    vt = graph.typesystem.infer(value)
    if vt is None:
        raise Unservable(f"value {value!r} has no registered type; no "
                         "indexed dimension to probe")
    return vt.to_key(value)


def to_range_request(graph, lo=None, hi=None, *, lo_op: str = "gte",
                     hi_op: str = "lte", type_handle: Optional[int] = None,
                     anchor: Optional[int] = None, desc: bool = False,
                     limit: Optional[int] = None) -> RangeRequest:
    """Build a :class:`RangeRequest` from VALUES (at least one bound):
    the typesystem derives the indexed dimension (the value kind byte)
    and the 128-bit rank-pair bounds; mixed-kind bounds are Unservable
    (ranks of different kinds are incomparable once the kind prefix is
    stripped). Variable-width kinds (str/bytes) produce ``exact=True``
    when every bound key is CLEAN (≤16 payload bytes, NUL-free — the
    zero-padded rank pair then orders the bound exactly against any
    column entry); ambiguous bounds produce ``exact=False`` requests —
    admitted, batched, and served on the exact host lane."""
    from hypergraphdb_tpu_torch.storage.value_index import FIXED_WIDTH_KINDS
    from hypergraphdb_tpu_torch.utils.ordered_bytes import rank128, rank_ambiguous

    if lo is None and hi is None:
        raise Unservable("a range request needs at least one bound "
                         "(an unbounded scan has no batchable window)")
    lo_rank = hi_rank = None
    lo_rank2 = hi_rank2 = 0
    dim = None
    bounds_clean = True
    if lo is not None:
        key = _value_key(graph, lo)
        dim = key[0]
        lo_rank, lo_rank2 = rank128(key[1:])
        bounds_clean = bounds_clean and not rank_ambiguous(key[1:])
    if hi is not None:
        key = _value_key(graph, hi)
        if dim is not None and key[0] != dim:
            raise Unservable(
                f"mixed-kind range bounds ({lo!r}, {hi!r}): ranks of "
                "different value kinds are incomparable"
            )
        dim = key[0]
        hi_rank, hi_rank2 = rank128(key[1:])
        bounds_clean = bounds_clean and not rank_ambiguous(key[1:])
    return RangeRequest(
        dim=int(dim), lo_rank=lo_rank, hi_rank=hi_rank,
        lo_op=lo_op, hi_op=hi_op,
        lo_rank2=lo_rank2, hi_rank2=hi_rank2, values=(lo, hi),
        type_handle=None if type_handle is None else int(type_handle),
        anchor=None if anchor is None else int(anchor),
        desc=bool(desc), limit=limit,
        exact=int(dim) in FIXED_WIDTH_KINDS or bounds_clean,
    )


def _value_to_range(graph, val: c.AtomValue,
                    type_handle: Optional[int] = None,
                    anchor: Optional[int] = None) -> RangeRequest:
    """One ``AtomValue`` as a window: eq collapses to [v, v]; ordered
    ops open the other side."""
    if val.op == "eq":
        return to_range_request(graph, lo=val.value, hi=val.value,
                                lo_op="gte", hi_op="lte",
                                type_handle=type_handle, anchor=anchor)
    if val.op in ("gt", "gte"):
        return to_range_request(graph, lo=val.value, lo_op=val.op,
                                type_handle=type_handle, anchor=anchor)
    if val.op in ("lt", "lte"):
        return to_range_request(graph, hi=val.value, hi_op=val.op,
                                type_handle=type_handle, anchor=anchor)
    raise Unservable(f"value op {val.op!r} has no range window")


def _try_range_and(graph, clauses) -> Optional[RangeRequest]:
    """``And(AtomValue{1,2}, [AtomType], [Incident])`` → one range
    window, or None when the conjunction is not range-shaped (the
    pattern/join translations then get their turn)."""
    vals: list[c.AtomValue] = []
    types: list[c.AtomType] = []
    incs: list[int] = []
    for cl in clauses:
        if isinstance(cl, c.AtomValue):
            vals.append(cl)
        elif isinstance(cl, c.AtomType):
            types.append(cl)
        elif isinstance(cl, c.Incident):
            incs.append(int(cl.target))
        else:
            return None
    if not vals or len(vals) > 2 or len(types) > 1 or len(incs) > 1:
        return None
    th = _type_handle(graph, types[0]) if types else None
    anchor = incs[0] if incs else None
    if len(vals) == 1:
        return _value_to_range(graph, vals[0], th, anchor)
    lo = next((v for v in vals if v.op in ("gt", "gte")), None)
    hi = next((v for v in vals if v.op in ("lt", "lte")), None)
    if lo is None or hi is None:
        return None
    return to_range_request(graph, lo=lo.value, hi=hi.value,
                            lo_op=lo.op, hi_op=hi.op,
                            type_handle=th, anchor=anchor)


def to_request(graph, condition, *, default_max_hops: int = 2):
    """Translate ``condition`` into a batchable request, or raise
    :class:`Unservable` naming the unsupported shape."""
    if isinstance(condition, c.AtomValue):
        return _value_to_range(graph, condition)
    if isinstance(condition, c.TypedValue):
        return _value_to_range(
            graph, c.AtomValue(condition.value, condition.op),
            _type_handle(graph, c.AtomType(condition.type)),
        )
    if isinstance(condition, c.BFS):
        hops = condition.max_distance
        if hops is None:
            # fixed-shape kernels need a static hop count; an unbounded
            # traversal has no batchable device form
            raise Unservable(
                "unbounded BFS is not batchable; set max_distance (the "
                f"runtime default is {default_max_hops})"
            )
        return BFSRequest(int(condition.start), int(hops),
                          include_seed=bool(condition.include_start))
    if isinstance(condition, c.Incident):
        return PatternRequest((int(condition.target),))
    if isinstance(condition, c.TypedIncident):
        return PatternRequest(
            (int(condition.target),),
            _type_handle(graph, c.AtomType(condition.type)),
        )
    if isinstance(condition, c.Link):
        return PatternRequest(tuple(int(t) for t in condition.targets))
    if isinstance(condition, c.CoIncident):
        # distinct=False: a single-variable CONDITION has find_all
        # semantics — CoIncident is already irreflexive and Incident(a)
        # legitimately admits a self-targeting a (the same reasoning as
        # the compiler's try_single_var_join); distinct=True would
        # silently drop that atom on the serve path only
        return to_join_request(graph, {"x": condition}, distinct=False)
    if isinstance(condition, c.And):
        if any(isinstance(cl, c.CoIncident) for cl in condition.clauses):
            # adjacency conjunctions (common neighbours, anchored
            # patterns) are the join lane's one-variable shape;
            # distinct=False per the single-variable contract above
            return to_join_request(graph, {"x": condition},
                                   distinct=False)
        if any(isinstance(cl, c.AtomValue) for cl in condition.clauses):
            # value-predicate conjunctions are the hgindex range lane's
            # shape: 1-2 bounds of ONE kind, optional type, optional
            # single incident anchor
            rr = _try_range_and(graph, condition.clauses)
            if rr is not None:
                return rr
            raise Unservable(
                "value conjunction outside the range lane's shape "
                "(need 1-2 same-kind bounds, at most one AtomType and "
                "one Incident)"
            )
        anchors: list[int] = []
        type_h = None
        for cl in condition.clauses:
            if isinstance(cl, c.Incident):
                anchors.append(int(cl.target))
            elif isinstance(cl, c.TypedIncident):
                anchors.append(int(cl.target))
                th = _type_handle(graph, c.AtomType(cl.type))
                if type_h is not None and type_h != th:
                    raise Unservable("conflicting type constraints")
                type_h = th
            elif isinstance(cl, c.AtomType):
                th = _type_handle(graph, cl)
                if type_h is not None and type_h != th:
                    raise Unservable("conflicting type constraints")
                type_h = th
            else:
                raise Unservable(
                    f"{type(cl).__name__} inside And is outside the "
                    "batchable subset (Incident/TypedIncident/AtomType)"
                )
        if not anchors:
            raise Unservable("And without an Incident anchor has no "
                             "batchable device form")
        return PatternRequest(tuple(anchors), type_h)
    raise Unservable(
        f"{type(condition).__name__} is outside the batchable subset; "
        "use graph.find_all"
    )


def to_join_request(graph, spec: Mapping[str, c.HGQueryCondition],
                    distinct: bool = True) -> JoinRequest:
    """Translate a multi-variable condition SPEC (``{var: condition}``,
    cross-references spelled with ``query.variables.Var``) into a
    batchable :class:`JoinRequest`, or raise :class:`Unservable`
    (``join/ir.JoinUnsupported`` is a subclass) naming the clause
    outside the pattern vocabulary. The signature/constant split means
    two requests for the same SHAPE — a triangle at atom 17, a triangle
    at atom 99 — share one batch key and ride one batched program."""
    from hypergraphdb_tpu_torch.join.ir import extract_pattern, split_constants

    pattern = extract_pattern(graph, spec, distinct=distinct)
    if not any(not a.key_is_var for a in pattern.atoms):
        raise Unservable(
            "a servable join needs at least one constant anchor; "
            "unanchored (whole-graph) patterns run through "
            "ops.join.execute_join's seeds mode instead"
        )
    sig, consts = split_constants(pattern)
    return JoinRequest(sig, consts)
