"""The ``hg`` query DSL.

Mirror of the reference's ``hg`` expression namespace
(``core/src/java/org/hypergraphdb/HGQuery.java:364`` — ``hg.type(...)``,
``hg.value(...)``, ``hg.incident(...)``, ``hg.and(...)``, ``hg.findAll``).

    from hypergraphdb_tpu_torch.query import dsl as hg
    hg.find_all(graph, hg.and_(hg.type("string"), hg.incident(h)))
"""

from __future__ import annotations

from typing import Any, Optional

from hypergraphdb_tpu_torch.query import conditions as c

# condition constructors ------------------------------------------------------

all_atoms = c.AnyAtom
nothing = c.Nothing


def and_(*clauses) -> c.And:
    return c.And(*clauses)


def or_(*clauses) -> c.Or:
    return c.Or(*clauses)


def not_(clause) -> c.Not:
    return c.Not(clause)


def _h(x):
    """Handle coercion that lets Var placeholders pass through (bound later
    by query.variables.substitute)."""
    from hypergraphdb_tpu_torch.query.variables import Var

    return x if isinstance(x, Var) else int(x)


def is_(handle) -> c.Is:
    return c.Is(_h(handle))


def type_(t) -> c.AtomType:
    return c.AtomType(t)


# keep reference-style aliases too
type = type_  # noqa: A001
typePlus = type_plus = lambda t: c.TypePlus(t)  # noqa: E731


def value(v, op: str = "eq") -> c.AtomValue:
    return c.AtomValue(v, op)


def eq(v) -> c.AtomValue:
    return c.AtomValue(v, "eq")


def lt(v) -> c.AtomValue:
    return c.AtomValue(v, "lt")


def lte(v) -> c.AtomValue:
    return c.AtomValue(v, "lte")


def gt(v) -> c.AtomValue:
    return c.AtomValue(v, "gt")


def gte(v) -> c.AtomValue:
    return c.AtomValue(v, "gte")


def typed_value(t, v, op: str = "eq") -> c.TypedValue:
    return c.TypedValue(v, t, op)


def part(path: str, v, op: str = "eq") -> c.AtomPart:
    return c.AtomPart(path, v, op)


def incident(target) -> c.Incident:
    return c.Incident(_h(target))


def co_incident(other) -> c.CoIncident:
    """Atoms sharing at least one link with ``other`` — the pattern-edge
    relation of conjunctive joins (``join/``); irreflexive."""
    return c.CoIncident(_h(other))


def typed_incident(target, t) -> c.TypedIncident:
    """Links of type ``t`` incident to ``target`` (the bdb-native
    typed-incidence query as a first-class condition)."""
    return c.TypedIncident(_h(target), t)


def incident_at(target, position: int) -> c.PositionedIncident:
    return c.PositionedIncident(_h(target), position)


def link(*targets) -> c.Link:
    return c.Link(*targets)


def ordered_link(*targets) -> c.OrderedLink:
    return c.OrderedLink(*targets)


def value_regex(pattern: str, flags: int = 0) -> c.ValueRegex:
    """String-value regex predicate (``AtomValueRegExPredicate``)."""
    return c.ValueRegex(pattern, flags)


def part_regex(path: str, pattern: str, flags: int = 0) -> c.PartRegex:
    """Record-projection regex predicate (``AtomPartRegExPredicate``)."""
    return c.PartRegex(path, pattern, flags)


def target_at(graph, condition, position: int):
    """Map each result link to its target at ``position`` — the
    LinkProjectionMapping form of ``ResultMapQuery``."""
    from hypergraphdb_tpu_torch.query.compiler import (
        LinkProjectionMapping,
        result_map,
    )

    return result_map(graph, condition, LinkProjectionMapping(position))


def deref(graph, condition):
    """Map each result handle to its value (``DerefMapping``)."""
    from hypergraphdb_tpu_torch.query.compiler import DerefMapping, result_map

    return result_map(graph, condition, DerefMapping())


def pipe(graph, producer_condition, key_condition):
    """``PipeQuery``: each producer result keys a dependent condition;
    returns the union of the keyed queries' results."""
    from hypergraphdb_tpu_torch.query.compiler import pipe as _pipe

    return _pipe(graph, producer_condition, key_condition)


def mapped(condition, mapping=None, position: Optional[int] = None
           ) -> c.MapCondition:
    """First-class ``MapCondition`` — composable inside and_/or_ (the
    ``result_map`` API is top-level only). ``position=n`` is shorthand for
    the LinkProjectionMapping at target position n."""
    if mapping is None:
        if position is None:
            raise ValueError("mapped() needs a mapping or a position")
        from hypergraphdb_tpu_torch.query.compiler import LinkProjectionMapping

        mapping = LinkProjectionMapping(position)
    return c.MapCondition(mapping, condition)


def subsumes(specific) -> c.Subsumes:
    """Atoms more general than ``specific`` (``SubsumesCondition``)."""
    return c.Subsumes(_h(specific))


def subsumed(general) -> c.Subsumed:
    """Atoms more specific than ``general`` (``SubsumedCondition``)."""
    return c.Subsumed(_h(general))


def target(link_handle) -> c.Target:
    return c.Target(_h(link_handle))


def arity(n: int, op: str = "eq") -> c.Arity:
    return c.Arity(n, op)


is_link = c.IsLink
is_node = c.IsNode


def in_index(name: str, key: bytes, op: str = "eq") -> c.IndexCondition:
    return c.IndexCondition(name, key, op)


def bfs(start, max_distance: Optional[int] = None, include_start: bool = False) -> c.BFS:
    return c.BFS(int(start), max_distance, include_start)


def dfs(start, max_distance: Optional[int] = None, include_start: bool = False) -> c.DFS:
    return c.DFS(int(start), max_distance, include_start)


def member_of(subgraph) -> c.SubgraphMember:
    return c.SubgraphMember(int(subgraph))


def contains(atom) -> c.SubgraphContains:
    return c.SubgraphContains(int(atom))


def predicate(fn) -> c.Predicate:
    return c.Predicate(fn)


# execution helpers (hg.findAll / hg.getAll / hg.count) -----------------------


def find_all(graph, condition) -> list[int]:
    return graph.find_all(condition)


def find_one(graph, condition) -> Optional[int]:
    return graph.find_one(condition)


def get_all(graph, condition) -> list[Any]:
    return [graph.get(h) for h in graph.find_all(condition)]


def get_one(graph, condition) -> Any:
    h = graph.find_one(condition)
    return None if h is None else graph.get(h)


def count(graph, condition) -> int:
    return graph.count(condition)
