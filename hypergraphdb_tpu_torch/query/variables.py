"""Parameterized queries: ``Var`` placeholders bound at execution time.

Re-expression of the reference's query-variable machinery (``util/Var``,
``VarContext``, ``Ref``/``Constant`` and ``HGQuery.var`` — precompile a
query once, run it many times with different bindings). Conditions are
frozen dataclasses, so substitution is a pure tree rewrite::

    pq = prepare(graph, q.and_(q.type_("string"), q.value(var("v"))))
    pq.execute(v="hello")
    pq.execute(v="world")
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

from hypergraphdb_tpu_torch.core.errors import QueryError
from hypergraphdb_tpu_torch.query import conditions as c


@dataclass(frozen=True)
class Var:
    """A named placeholder usable anywhere a condition field takes a value."""

    name: str


def var(name: str) -> Var:
    return Var(name)


def variables_of(cond: c.HGQueryCondition) -> set[str]:
    out: set[str] = set()

    def visit(v: Any) -> None:
        if isinstance(v, Var):
            out.add(v.name)
        elif isinstance(v, c.HGQueryCondition):
            for f in dataclasses.fields(v):
                visit(getattr(v, f.name))
        elif isinstance(v, tuple):
            for x in v:
                visit(x)

    visit(cond)
    return out


def substitute(cond: c.HGQueryCondition, bindings: dict[str, Any]
               ) -> c.HGQueryCondition:
    """Rewrite the condition tree, replacing every ``Var`` with its binding."""

    def sub(v: Any) -> Any:
        if isinstance(v, Var):
            if v.name not in bindings:
                raise QueryError(f"unbound query variable {v.name!r}")
            return bindings[v.name]
        if isinstance(v, (c.And, c.Or)):
            return type(v)(*[sub(x) for x in v.clauses])
        if isinstance(v, (c.Link, c.OrderedLink)):  # variadic ctors too
            return type(v)(*[sub(t) for t in v.targets])
        if isinstance(v, c.HGQueryCondition):
            kw = {f.name: sub(getattr(v, f.name))
                  for f in dataclasses.fields(v)}
            return type(v)(**kw)
        if isinstance(v, tuple):
            return tuple(sub(x) for x in v)
        return v

    return sub(cond)


class PreparedQuery:
    """A reusable query template (``HGQuery`` with variables)."""

    def __init__(self, graph, condition: c.HGQueryCondition):
        self.graph = graph
        self.condition = condition
        self.variables = variables_of(condition)

    def execute(self, **bindings) -> list[int]:
        missing = self.variables - bindings.keys()
        if missing:
            raise QueryError(f"unbound query variables: {sorted(missing)}")
        return self.graph.find_all(substitute(self.condition, bindings))

    def count(self, **bindings) -> int:
        return len(self.execute(**bindings))


def prepare(graph, condition: c.HGQueryCondition) -> PreparedQuery:
    return PreparedQuery(graph, condition)
