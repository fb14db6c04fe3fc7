"""Exact host evaluation of conjunctive patterns — the ground truth.

The port of ``hypergraphdb_tpu/join/host.py``, host Python as there.

Recursive enumeration through the ordinary single-variable query engine:
binding variables in order, each variable's candidates come from
``graph.find_all`` over the clauses whose references are already bound
(the compiler's own cost-based planning answers each step), and every
deferred cross-reference is checked via the conditions' ``satisfies``
contract the moment its last variable binds. This is the differential
oracle the device executor is held to, and the serving tier's exact
fallback lane — deliberately a SEPARATE implementation path from
``ops/join.py`` (find_all + satisfies vs batched CSR gathers), so
agreement is evidence.
"""

from __future__ import annotations

from hypergraphdb_tpu_torch.join.ir import (
    ConjunctivePattern,
    JoinAtom,
    JoinUnsupported,
    pattern_to_conditions,
)
from hypergraphdb_tpu_torch.query import conditions as c
from hypergraphdb_tpu_torch.query.variables import substitute, variables_of


def _clauses(cond) -> tuple:
    return cond.clauses if isinstance(cond, c.And) else (cond,)


def host_join(graph, pattern: ConjunctivePattern) -> list[tuple]:
    """Enumerate every binding tuple of ``pattern`` (variables in
    ``pattern.vars`` order), sorted lexicographically. Always complete:
    a capped enumeration would be a DFS-order sample, not the
    lexicographic prefix a truncation differential needs — callers
    slice the sorted result instead."""
    spec = pattern_to_conditions(pattern)
    # owner clauses, tagged with their free variables
    items = []
    for v, cond in spec.items():
        for cl in _clauses(cond):
            items.append((v, cl, frozenset(variables_of(cl))))
    # binding order must be FEASIBLE, not the spec's declaration order:
    # each variable needs a generating clause whose references are
    # already bound when its turn comes (the device planner reorders
    # freely — e.g. {'y': co(var('z')), 'z': co(a)} binds z first).
    # Greedy: repeatedly take any unbound variable with a ready
    # generator; emitted tuples stay in pattern.vars order.
    order: list[str] = []
    bound_set: set[str] = set()
    remaining = list(pattern.vars)
    while remaining:
        ready = next(
            (v for v in remaining if any(
                owner == v and free <= bound_set
                for owner, _, free in items
            )),
            None,
        )
        if ready is None:
            raise JoinUnsupported(
                f"variables {remaining} have no constant-anchored path "
                "into the pattern (disconnected or unanchored)"
            )
        order.append(ready)
        bound_set.add(ready)
        remaining.remove(ready)
    consts = {int(a.key) for a in pattern.atoms if not a.key_is_var}
    out: list[tuple] = []

    def bind(depth: int, bound: dict) -> bool:
        if depth == len(order):
            out.append(tuple(bound[v] for v in pattern.vars))
            return False
        v = order[depth]
        gen: list = []
        checks: list = []
        for owner, cl, free in items:
            if owner == v and free <= bound.keys():
                gen.append(substitute(cl, bound) if free else cl)
            elif (owner != v and owner in bound and v in free
                  and free <= bound.keys() | {v}):
                checks.append((owner, cl))
        cond_v = gen[0] if len(gen) == 1 else c.And(*gen)
        for h in sorted(int(x) for x in graph.find_all(cond_v)):
            if pattern.distinct and (
                h in consts or any(h == b for b in bound.values())
            ):
                continue
            ok = True
            for owner, cl in checks:
                inst = substitute(cl, {**bound, v: h})
                if not inst.satisfies(graph, bound[owner]):
                    ok = False
                    break
            if not ok:
                continue
            bound[v] = h
            stop = bind(depth + 1, bound)
            del bound[v]
            if stop:
                return True
        return False

    bind(0, {})
    return sorted(out)


def host_join_count(graph, pattern: ConjunctivePattern) -> int:
    return len(host_join(graph, pattern))


def _substitute_var(graph, pattern: ConjunctivePattern, v: str, d: int):
    """The reduced pattern with variable ``v`` bound to atom ``d``:
    every atom touching ``v`` becomes either a constant-keyed atom on
    its OTHER variable (relation direction rewritten — ``inc(v, w)``
    with ``v`` a link becomes ``tgt(w, d)``, etc.) or, when the other
    side is already a constant, a direct ``satisfies`` check on ``d``.
    Returns ``(ok, atoms)`` — ``ok`` False when a direct check failed
    (no tuple through this substitution exists)."""
    atoms: list[JoinAtom] = []
    for a in pattern.atoms:
        if a.var == v:
            if a.key_is_var:
                w = a.key
                if a.rel == "co":
                    atoms.append(JoinAtom("co", w, d))
                elif a.rel == "inc":
                    # d is a link whose targets include w
                    atoms.append(JoinAtom("tgt", w, d))
                else:  # tgt(v, w): d ∈ targets(w) → w is a link over d
                    atoms.append(JoinAtom("inc", w, d))
            else:
                cond = {"co": c.CoIncident, "inc": c.Incident,
                        "tgt": c.Target}[a.rel](int(a.key))
                if not cond.satisfies(graph, d):
                    return False, ()
        elif a.key == v:
            # the var side stays a variable; v becomes its constant key
            atoms.append(JoinAtom(a.rel, a.var, d))
        else:
            atoms.append(a)
    return True, tuple(atoms)


def host_join_touching(graph, pattern: ConjunctivePattern,
                       touched) -> list[tuple]:
    """Every binding tuple of ``pattern`` that contains at least one
    atom from ``touched`` — the per-lane memtable correction's work
    set. Soundness rests on link immutability: a tuple that is
    a result NOW but not over the pre-ingest base must witness some
    newly added link, and every endpoint a new link makes newly
    co-incident/incident/target-related is the link itself or one of
    its targets — all members of the dirty set. So enumerating tuples
    through each ``(variable, touched atom)`` substitution
    (:func:`_substitute_var` + :func:`host_join` on the reduced
    pattern) covers exactly the results a device answer over the base
    can be missing, at cost proportional to the dirty set instead of
    the whole batch's host re-serve."""
    out: set = set()
    consts_in = {int(a.key) for a in pattern.atoms if not a.key_is_var}
    touched = sorted({int(x) for x in touched})
    for vi, v in enumerate(pattern.vars):
        rest = tuple(x for x in pattern.vars if x != v)
        th = pattern.type_of(v)
        types_rest = tuple(
            (w, t) for w, t in pattern.types if w != v
        )
        for d in touched:
            if pattern.distinct and d in consts_in:
                continue
            if th is not None and not c.AtomType(int(th)).satisfies(
                graph, d
            ):
                continue
            ok, atoms = _substitute_var(graph, pattern, v, d)
            if not ok:
                continue
            if not rest:
                out.add((d,))
                continue
            sub = ConjunctivePattern(
                vars=rest, atoms=atoms, types=types_rest,
                distinct=pattern.distinct,
            )
            for t in host_join(graph, sub):
                # the ORIGINAL pattern's all-distinct convention: no
                # binding repeats d or any original constant (atoms the
                # substitution folded into direct checks dropped their
                # constant from the reduced pattern's exclusion set)
                if pattern.distinct and (
                    d in t or any(x in consts_in for x in t)
                ):
                    continue
                out.add(t[:vi] + (d,) + t[vi:])
    return sorted(out)
