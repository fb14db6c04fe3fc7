"""Atom utilities: the subsumption part.

:func:`declare_subsumes` persists ``general subsumes specific`` as a
2-arity ``HGSubsumes`` link between two type atoms and registers it with
the type system; :func:`subsumes_declared` answers the declared
subsumption that ``query/conditions.Subsumes`` reads, and
:func:`load_subsumptions` re-registers the persisted links when a graph
opens.

The rest of the JAX package's ``atom/utilities.py`` (``HGAtomRef`` and its
ref maintenance, Berge links, relation types) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

from hypergraphdb_tpu_torch.core.handles import HGHandle

# ------------------------------------------------------------------ subsumption


@dataclass(frozen=True)
class SubsumesValue:
    """Marker value of a subsumption link (HGSubsumes)."""


def declare_subsumes(graph, general_type: str, specific_type: str) -> HGHandle:
    """Persist ``general subsumes specific`` as a 2-arity link between the
    two type atoms and register it with the type system (powers TypePlus
    expansion, ``cond2qry/ExpressionBasedQuery.java:603``)."""
    gh = graph.typesystem.handle_of(general_type)
    sh = graph.typesystem.handle_of(specific_type)
    graph.typesystem.declare_subtype(specific_type, general_type)
    return graph.add_link([int(gh), int(sh)], value=SubsumesValue())


def declared_specifics(graph, general: int) -> frozenset:
    """All atoms with a persisted ``HGSubsumes`` link ``(general, x)`` —
    ONE incidence scan, memoized per graph version, so a ``Subsumed``
    query over N candidates costs one scan instead of N (each
    ``satisfies`` call would otherwise re-walk the incidence set)."""
    from hypergraphdb_tpu_torch.types.record import _qualname

    # inside a transaction the incidence read merges the tx OVERLAY —
    # neither usable from nor storable into the committed-state memo
    # (an aborted tx would leave phantom subsumptions behind)
    in_tx = graph.txman.current() is not None
    version = graph._mutations
    cache = getattr(graph, "_subsumes_cache", None)
    if cache is None or cache[0] != version:
        th = graph._find_type_atom(_qualname(SubsumesValue))
        cache = (version, th, {})
        if not in_tx:
            graph._subsumes_cache = cache
    _, th, memo = cache
    if in_tx:
        memo = {}  # throwaway: overlay-tainted results must never be shared
    if th is None:
        return frozenset()
    general = int(general)
    if not in_tx:
        hit = memo.get(general)
        if hit is not None:
            return hit
    out = set()
    try:
        inc = graph.get_incidence_set(general).array()
    except Exception:
        memo[general] = frozenset()
        return memo[general]
    for l in inc.tolist():
        try:
            if int(graph.get_type_handle_of(l)) != int(th):
                continue
            ts_ = graph.get_targets(l)
        except Exception:
            continue
        if len(ts_) == 2 and int(ts_[0]) == general:
            out.add(int(ts_[1]))
    memo[general] = frozenset(out)
    return memo[general]


def subsumes_declared(graph, general: int, specific: int) -> bool:
    """Is there a persisted ``HGSubsumes`` link ``(general, specific)``?
    The declared-subsumption primitive of ``SubsumesImpl.declaredSubsumption``
    (And(type=HGSubsumes, OrderedLink(general, specific)) in the ref)."""
    return int(specific) in declared_specifics(graph, general)


def load_subsumptions(graph) -> int:
    """Reopen path: re-register persisted subsumption links with the type
    system; returns how many were loaded. Called automatically at graph
    open (a database must not forget its hierarchy)."""
    from hypergraphdb_tpu_torch.query import dsl as q
    from hypergraphdb_tpu_torch.types.record import _qualname

    # peek WITHOUT registering: a fresh store has no subsumption links and
    # must not grow a type atom just from being opened
    if graph._find_type_atom(_qualname(SubsumesValue)) is None:
        return 0
    t = graph.typesystem.infer(SubsumesValue())
    if t is None:
        return 0
    n = 0
    ts = graph.typesystem
    for h in q.find_all(graph, q.type_(t.name)):
        gh, sh = graph.get_targets(h)
        # the endpoint types may not be REGISTERED yet this session — adopt
        # their persisted name↔handle mappings so TypePlus resolves
        gname = ts.adopt_type_atom(int(gh))
        sname = ts.adopt_type_atom(int(sh))
        if gname is None or sname is None:
            continue
        ts.declare_subtype(sname, gname)
        n += 1
    return n
