"""Query condition vocabulary.

Re-expression of the reference's 41-file condition package
(``core/src/java/org/hypergraphdb/query/``): ``And/Or/Not/Nothing``, ``AtomTypeCondition``,
``TypePlusCondition``, ``AtomValueCondition``, ``AtomPartCondition``,
``TypedValueCondition``, ``IncidentCondition``,
``PositionedIncidentCondition``, ``LinkCondition``,
``OrderedLinkCondition``, ``TargetCondition``, ``ArityCondition``,
``BFSCondition``/``DFSCondition``, ``SubgraphMemberCondition``,
``IndexCondition``, ``MapCondition`` (here: ``Predicate``), ``IsCondition``,
``AnyAtomCondition``.

Conditions are frozen dataclasses — pure values the compiler rewrites.
Every condition can also act as a per-atom predicate via ``satisfies``
(the ``HGAtomPredicate.satisfies(graph, handle)`` contract), which is the
fallback execution mode when no index applies.
"""

from __future__ import annotations

import operator
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from hypergraphdb_tpu_torch.core.handles import HGHandle

_OPS = {
    "eq": operator.eq,
    "lt": operator.lt,
    "lte": operator.le,
    "gt": operator.gt,
    "gte": operator.ge,
}


def _coerce_handle(t):
    """int-coerce a target handle, letting non-integer placeholders (query
    Vars, bound later by ``variables.substitute``) pass through."""
    try:
        return int(t)
    except (TypeError, ValueError):
        return t


class HGQueryCondition:
    """Base class; every condition is also an atom predicate."""

    def satisfies(self, graph, h: HGHandle) -> bool:
        raise NotImplementedError


# ---------------------------------------------------------------- trivial


@dataclass(frozen=True)
class AnyAtom(HGQueryCondition):
    def satisfies(self, graph, h):
        return graph.contains(h)


@dataclass(frozen=True)
class Nothing(HGQueryCondition):
    def satisfies(self, graph, h):
        return False


# ---------------------------------------------------------------- boolean


@dataclass(frozen=True)
class And(HGQueryCondition):
    clauses: tuple[HGQueryCondition, ...]

    def __init__(self, *clauses: HGQueryCondition):
        object.__setattr__(self, "clauses", tuple(clauses))

    def satisfies(self, graph, h):
        return all(c.satisfies(graph, h) for c in self.clauses)


@dataclass(frozen=True)
class Or(HGQueryCondition):
    clauses: tuple[HGQueryCondition, ...]

    def __init__(self, *clauses: HGQueryCondition):
        object.__setattr__(self, "clauses", tuple(clauses))

    def satisfies(self, graph, h):
        return any(c.satisfies(graph, h) for c in self.clauses)


@dataclass(frozen=True)
class Not(HGQueryCondition):
    clause: HGQueryCondition

    def satisfies(self, graph, h):
        return not self.clause.satisfies(graph, h)


# ---------------------------------------------------------------- identity


@dataclass(frozen=True)
class Is(HGQueryCondition):
    """Identity (``IsCondition``)."""

    handle: HGHandle

    def satisfies(self, graph, h):
        return int(h) == int(self.handle)


# ---------------------------------------------------------------- type


@dataclass(frozen=True)
class AtomType(HGQueryCondition):
    """Exact type (``AtomTypeCondition.java:38``). ``type`` is a type name
    or a type-atom handle."""

    type: Any

    def type_handle(self, graph) -> HGHandle:
        if isinstance(self.type, str):
            return graph.typesystem.handle_of(self.type)
        return int(self.type)

    def satisfies(self, graph, h):
        return graph.get_type_handle_of(h) == self.type_handle(graph)


@dataclass(frozen=True)
class TypePlus(HGQueryCondition):
    """Type or any of its subtypes (``TypePlusCondition``); expanded to an
    ``Or`` of ``AtomType`` during compilation."""

    type: Any

    def satisfies(self, graph, h):
        ts = graph.typesystem
        name = self.type if isinstance(self.type, str) else ts.name_of(self.type)
        closure = {ts.handle_of(n) for n in ts.subtypes_closure(name)}
        return graph.get_type_handle_of(h) in closure


# ---------------------------------------------------------------- value


def _key_compare(graph, atom_key: bytes, query_key: bytes, op: str) -> bool:
    """Compare two order-preserving value keys. Cross-kind comparisons are
    always False (the reference's Java ``equals``/comparator is likewise
    type-strict), which keeps the predicate path bit-identical to the
    by-value index path."""
    if atom_key[:1] != query_key[:1]:
        return False
    return _OPS[op](atom_key, query_key)


@dataclass(frozen=True)
class AtomValue(HGQueryCondition):
    """Value comparison (``AtomValueCondition``); ``op`` one of
    eq/lt/lte/gt/gte — non-eq ops require an ordered value kind.

    Comparison is type-strict via order-preserving keys, so predicate
    evaluation and index lookup agree exactly."""

    value: Any
    op: str = "eq"

    def satisfies(self, graph, h):
        from hypergraphdb_tpu_torch.core.graph import HGLink

        v = graph.get(h)
        if isinstance(v, HGLink):
            v = v.value
        at = graph.typesystem.get_type(graph.get_type_handle_of(h))
        qt = graph.typesystem.infer(self.value)
        if qt is None:
            return False
        try:
            return _key_compare(graph, at.to_key(v), qt.to_key(self.value), self.op)
        except Exception:
            return False


@dataclass(frozen=True)
class TypedValue(HGQueryCondition):
    """Value + type (``TypedValueCondition``)."""

    value: Any
    type: Any
    op: str = "eq"

    def satisfies(self, graph, h):
        return AtomType(self.type).satisfies(graph, h) and AtomValue(
            self.value, self.op
        ).satisfies(graph, h)


@dataclass(frozen=True)
class AtomPart(HGQueryCondition):
    """Projection-path comparison on record values (``AtomPartCondition``)."""

    path: str
    value: Any
    op: str = "eq"

    def satisfies(self, graph, h):
        from hypergraphdb_tpu_torch.core.graph import HGLink

        v = graph.get(h)
        if isinstance(v, HGLink):
            v = v.value
        th = graph.get_type_handle_of(h)
        atype = graph.typesystem.get_type(th)
        try:
            part = atype.project(v, self.path)
        except Exception:
            return False
        if part is None:
            return False
        pt = graph.typesystem.infer(part)
        qt = graph.typesystem.infer(self.value)
        if pt is None or qt is None:
            return False
        try:
            return _key_compare(
                graph, pt.to_key(part), qt.to_key(self.value), self.op
            )
        except Exception:
            return False


# ---------------------------------------------------------------- structure


@dataclass(frozen=True)
class Incident(HGQueryCondition):
    """Links pointing at ``target`` (``IncidentCondition``) — i.e. membership
    in the target's incidence set. THE building block of graph patterns."""

    target: HGHandle

    def satisfies(self, graph, h):
        return int(h) in graph.get_incidence_set(self.target)


@dataclass(frozen=True)
class CoIncident(HGQueryCondition):
    """Atoms sharing at least one link with ``other`` — the binary
    adjacency view of the hypergraph (two atoms are co-incident when some
    link's target tuple contains both). This is the edge relation of
    conjunctive PATTERN queries (triangles, paths, stars — ``join/``):
    a pattern edge between two variables lowers to one CoIncident clause.

    By definition an atom is never co-incident with itself (a link
    containing ``a`` twice does not make ``a`` its own neighbour) — the
    relation is irreflexive and symmetric. ``other`` may be a query
    ``Var`` inside a pattern spec; as a standalone condition it must be
    a concrete handle."""

    other: HGHandle

    def satisfies(self, graph, h):
        if int(h) == int(self.other):
            return False
        mine = graph.get_incidence_set(h)
        theirs = graph.get_incidence_set(self.other)
        # probe the smaller incidence set against the larger
        a, b = (mine, theirs) if len(mine) <= len(theirs) else (theirs, mine)
        return any(int(l) in b for l in a)


@dataclass(frozen=True)
class TypedIncident(HGQueryCondition):
    """Links of a given TYPE pointing at ``target`` — the first-class form
    of the reference's bdb-native typed-incidence query
    (``storage/incidence/TypedIncidentCondition.java`` answered by
    ``QueryByTypedIncident`` off the annotated incidence index alone).
    Expanded to ``And(Incident, AtomType)`` at compile time, which the
    planner fuses onto the hot host type column
    (``compiler.TypedIncidencePlan``) — same no-record-loads execution."""

    target: HGHandle
    type: Any  # type name or type-atom handle

    def satisfies(self, graph, h):
        # compose the two primitives, mirroring the expand() rewrite —
        # type resolution lives in ONE place (AtomType.type_handle)
        return Incident(self.target).satisfies(graph, h) and AtomType(
            self.type
        ).satisfies(graph, h)


@dataclass(frozen=True)
class PositionedIncident(HGQueryCondition):
    """Links having ``target`` at position ``position``
    (``PositionedIncidentCondition``)."""

    target: HGHandle
    position: int

    def satisfies(self, graph, h):
        try:
            ts = graph.get_targets(h)
        except Exception:
            return False
        return self.position < len(ts) and ts[self.position] == int(self.target)


@dataclass(frozen=True)
class Link(HGQueryCondition):
    """Links containing ALL the given targets, any positions
    (``LinkCondition``); expanded to ``And`` of ``Incident``."""

    targets: tuple[HGHandle, ...]

    def __init__(self, *targets: HGHandle):
        object.__setattr__(self, "targets", tuple(_coerce_handle(t) for t in targets))

    def satisfies(self, graph, h):
        try:
            ts = set(graph.get_targets(h))
        except Exception:
            return False
        return set(self.targets) <= ts


@dataclass(frozen=True)
class OrderedLink(HGQueryCondition):
    """Links whose target tuple starts with exactly these targets in order
    (``OrderedLinkCondition``)."""

    targets: tuple[HGHandle, ...]

    def __init__(self, *targets: HGHandle):
        object.__setattr__(self, "targets", tuple(_coerce_handle(t) for t in targets))

    def satisfies(self, graph, h):
        try:
            ts = graph.get_targets(h)
        except Exception:
            return False
        return ts[: len(self.targets)] == self.targets


@dataclass(frozen=True)
class ValueRegex(HGQueryCondition):
    """Atoms whose (string) value matches a regular expression — the
    reference's ``AtomValueRegExPredicate``. A predicate (P class): it
    narrows other conditions' results, never produces a set by itself."""

    pattern: str
    flags: int = 0

    def _rx(self):
        import re

        return re.compile(self.pattern, self.flags)

    def satisfies(self, graph, h):
        from hypergraphdb_tpu_torch.core.graph import HGLink

        v = graph.get(h)
        if isinstance(v, HGLink):
            v = v.value
        return isinstance(v, str) and self._rx().search(v) is not None


@dataclass(frozen=True)
class PartRegex(HGQueryCondition):
    """Record-projection regex (``AtomPartRegExPredicate``): the value's
    ``path`` projection matches the pattern."""

    path: str
    pattern: str
    flags: int = 0

    def satisfies(self, graph, h):
        import re

        from hypergraphdb_tpu_torch.core.graph import HGLink

        v = graph.get(h)
        if isinstance(v, HGLink):
            v = v.value
        try:
            atype = graph.typesystem.get_type(graph.get_type_handle_of(h))
            part = atype.project(v, self.path)
        except Exception:
            return False
        return isinstance(part, str) and re.search(
            self.pattern, part, self.flags
        ) is not None


def _subsumption_holds(graph, general: int, specific: int) -> bool:
    """Reference subsumption check (``query/impl/SubsumesImpl.java``):
    a DECLARED ``HGSubsumes`` link ``(general, specific)`` wins outright;
    otherwise both atoms must share a type whose ``subsumes`` relation
    accepts the value pair."""
    from hypergraphdb_tpu_torch.atom.utilities import subsumes_declared

    if subsumes_declared(graph, general, specific):
        return True
    try:
        gt = int(graph.get_type_handle_of(general))
        st = int(graph.get_type_handle_of(specific))
    except Exception:
        return False
    if gt != st:
        return False
    try:
        atype = graph.typesystem.get_type(gt)
    except Exception:
        return False
    from hypergraphdb_tpu_torch.core.graph import HGLink

    def val(h):
        v = graph.get(h)
        return v.value if isinstance(v, HGLink) else v

    return bool(atype.subsumes(val(general), val(specific)))


@dataclass(frozen=True)
class Subsumes(HGQueryCondition):
    """Atoms that subsume ``specific`` — i.e. are more general than it
    (``SubsumesCondition.java``: declared ``HGSubsumes`` links first, then
    same-type value subsumption)."""

    specific: HGHandle

    def satisfies(self, graph, h):
        return _subsumption_holds(graph, int(h), int(self.specific))


@dataclass(frozen=True)
class Subsumed(HGQueryCondition):
    """Atoms subsumed by ``general`` — more specific than it
    (``SubsumedCondition.java``)."""

    general: HGHandle

    def satisfies(self, graph, h):
        return _subsumption_holds(graph, int(self.general), int(h))


@dataclass(frozen=True)
class Target(HGQueryCondition):
    """Atoms that are targets of the given link (``TargetCondition``)."""

    link: HGHandle

    def satisfies(self, graph, h):
        try:
            return int(h) in graph.get_targets(self.link)
        except Exception:
            return False


@dataclass(frozen=True)
class Arity(HGQueryCondition):
    """Link arity comparison (``ArityCondition``)."""

    arity: int
    op: str = "eq"

    def satisfies(self, graph, h):
        try:
            n = graph.arity(h)
        except Exception:
            return False
        return _OPS[self.op](n, self.arity)


@dataclass(frozen=True)
class IsLink(HGQueryCondition):
    def satisfies(self, graph, h):
        try:
            return graph.is_link(h)
        except Exception:
            return False


@dataclass(frozen=True)
class IsNode(HGQueryCondition):
    def satisfies(self, graph, h):
        try:
            return not graph.is_link(h)
        except Exception:
            return False


# ---------------------------------------------------------------- index


@dataclass(frozen=True)
class IndexCondition(HGQueryCondition):
    """Direct lookup in a registered user index (``IndexCondition`` /
    ``IndexedPartCondition``): key comparison against index ``name``."""

    name: str
    key: bytes
    op: str = "eq"

    def satisfies(self, graph, h):
        from hypergraphdb_tpu_torch.indexing.manager import get_index

        idx = get_index(graph, self.name)
        if self.op == "eq":
            return int(h) in idx.find(self.key)
        rs = {
            "lt": idx.find_lt,
            "lte": idx.find_lte,
            "gt": idx.find_gt,
            "gte": idx.find_gte,
        }[self.op](self.key)
        return int(h) in rs


# ---------------------------------------------------------------- traversal


@dataclass(frozen=True)
class BFS(HGQueryCondition):
    """Atoms reachable breadth-first from ``start`` (``BFSCondition``)."""

    start: HGHandle
    max_distance: Optional[int] = None
    include_start: bool = False

    def satisfies(self, graph, h):
        from hypergraphdb_tpu_torch.algorithms.traversals import HGBreadthFirstTraversal

        if self.include_start and int(h) == int(self.start):
            return True
        for _, atom in HGBreadthFirstTraversal(
            graph, self.start, max_distance=self.max_distance
        ):
            if atom == int(h):
                return True
        return False


@dataclass(frozen=True)
class DFS(HGQueryCondition):
    """Atoms reachable depth-first from ``start`` (``DFSCondition``)."""

    start: HGHandle
    max_distance: Optional[int] = None
    include_start: bool = False

    def satisfies(self, graph, h):
        from hypergraphdb_tpu_torch.algorithms.traversals import HGDepthFirstTraversal

        if self.include_start and int(h) == int(self.start):
            return True
        for _, atom in HGDepthFirstTraversal(
            graph, self.start, max_distance=self.max_distance
        ):
            if atom == int(h):
                return True
        return False


# ---------------------------------------------------------------- subgraph


@dataclass(frozen=True)
class SubgraphMember(HGQueryCondition):
    """Members of a named subgraph (``SubgraphMemberCondition``)."""

    subgraph: HGHandle

    def satisfies(self, graph, h):
        from hypergraphdb_tpu_torch.atom.subgraph import HGSubgraph

        return HGSubgraph.of(graph, self.subgraph).is_member(h)


@dataclass(frozen=True)
class SubgraphContains(HGQueryCondition):
    """Subgraphs containing the given atom (``SubgraphContainsCondition``)."""

    atom: HGHandle

    def satisfies(self, graph, h):
        from hypergraphdb_tpu_torch.atom.subgraph import HGSubgraph

        try:
            return HGSubgraph.of(graph, h).is_member(self.atom)
        except Exception:
            return False


# ---------------------------------------------------------------- arbitrary


@dataclass(frozen=True)
class MapCondition(HGQueryCondition):
    """First-class result-mapping condition (``query/MapCondition.java``):
    the result set of ``condition`` passed through ``mapping`` (an object
    with ``apply(graph, np.ndarray) -> np.ndarray``, e.g.
    ``LinkProjectionMapping``). COMPOSABLE inside And/Or — the mapped set
    intersects/unions like any other set — which the ``result_map`` API
    (top-level only) could not do. Inside a composition the mapping must
    return handles; value-producing mappings (Deref) stay top-level."""

    mapping: Any
    condition: Any

    def satisfies(self, graph, h):
        # membership of h in a mapped set has no per-handle form (the
        # mapping is not invertible in general) — same stance as the
        # reference's MapCondition, which only exists as a query
        from hypergraphdb_tpu_torch.core.errors import QueryError

        raise QueryError(
            "MapCondition has no per-atom satisfies(); use it as a query"
        )


@dataclass(frozen=True)
class Predicate(HGQueryCondition):
    """Arbitrary predicate over (graph, handle) (``MapCondition`` /
    user ``HGAtomPredicate``). Opaque to the planner: always a filter."""

    fn: Callable[[Any, HGHandle], bool]

    def satisfies(self, graph, h):
        return self.fn(graph, h)
