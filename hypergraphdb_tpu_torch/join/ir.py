"""Conjunctive-pattern IR: variables + incidence/type/link predicates.

The port of ``hypergraphdb_tpu/join/ir.py``. A pattern is a set of named
VARIABLES plus binary atoms over three relations, every one of which is a
sorted-CSR row-membership predicate on the snapshot:

=========  =====================================  ======================
relation   meaning                                device rows
=========  =====================================  ======================
``co``     var and key share at least one link    ``ops/join.neighbor_csr``
``inc``    var is a link whose targets include    incidence CSR
           key
``tgt``    var is a target of link key            target CSR (dual of
           (≡ ``key ∈ incidence(var)``)           ``inc``)
=========  =====================================  ======================

plus unary type constraints and an all-distinct flag (vars bind pairwise
distinct atoms, and never a pattern constant).

Extraction (:func:`extract_pattern`) starts from ordinary query
conditions — one condition per variable, cross-references spelled with
``query.variables.Var`` — and reuses the compiler's own normalization
(``expand`` → ``to_dnf`` → ``simplify``) before mapping ``And`` clauses
onto atoms, so every piece of sugar the single-variable pipeline accepts
(``Link``, ``TypedIncident``, ``TypePlus``…) works in a pattern spec too;
:func:`pattern_to_conditions` is its inverse.

:func:`split_constants` factors a pattern into a hashable
:class:`PatternSignature` (the structure) plus the constant vector (what
varies per request), the serve tier's batch-key/payload split. Patterns
of the reference's IR carry over with :func:`pattern_from_reference`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Optional

from hypergraphdb_tpu_torch.query import conditions as c
from hypergraphdb_tpu_torch.query.variables import Var
from hypergraphdb_tpu_torch.serve.types import Unservable

#: binary relations a pattern atom may use
RELATIONS = ("co", "inc", "tgt")


class JoinUnsupported(Unservable):
    """The pattern is outside what the join engine serves (a condition
    outside the pattern vocabulary, an unknown relation, an unanchored
    variable, a co-incidence relation over its pair budget) — run it
    through ``graph.find_all`` per variable instead."""


@dataclass(frozen=True)
class JoinAtom:
    """One binary predicate: ``var`` related to ``key`` under ``rel``.
    ``key`` is another variable's name (str) or a constant atom handle
    (int)."""

    rel: str
    var: str
    key: Any

    def __post_init__(self):
        if self.rel not in RELATIONS:
            raise JoinUnsupported(f"unknown join relation {self.rel!r}")

    @property
    def key_is_var(self) -> bool:
        return isinstance(self.key, str)


@dataclass(frozen=True)
class ConjunctivePattern:
    """A normalized conjunctive pattern: ordered variables, binary atoms,
    per-variable type constraints, all-distinct convention."""

    vars: tuple[str, ...]
    atoms: tuple[JoinAtom, ...]
    types: tuple[tuple[str, int], ...] = ()
    distinct: bool = True

    def __post_init__(self):
        names = set(self.vars)
        if len(names) != len(self.vars):
            raise JoinUnsupported("duplicate pattern variable names")
        for a in self.atoms:
            if a.var not in names:
                raise JoinUnsupported(f"atom over unknown variable {a.var!r}")
            if a.key_is_var and a.key not in names:
                raise JoinUnsupported(f"atom references unknown {a.key!r}")
            if a.key_is_var and a.key == a.var:
                raise JoinUnsupported(f"self-referential atom on {a.var!r}")
        for v, _ in self.types:
            if v not in names:
                raise JoinUnsupported(f"type over unknown variable {v!r}")

    def atoms_of(self, var: str) -> tuple[JoinAtom, ...]:
        """Atoms touching ``var`` on either side."""
        return tuple(a for a in self.atoms
                     if a.var == var or a.key == var)

    def type_of(self, var: str) -> Optional[int]:
        for v, th in self.types:
            if v == var:
                return th
        return None


def pattern_from_reference(p) -> ConjunctivePattern:
    """The port's pattern for another implementation's: any object with
    the reference's ``vars``, ``atoms`` (each with ``rel``, ``var`` and
    ``key``), ``types`` and ``distinct`` (the reference's
    ``ConjunctivePattern``). Constants become Python ints, variable keys
    stay names."""
    return ConjunctivePattern(
        vars=tuple(str(v) for v in p.vars),
        atoms=tuple(
            JoinAtom(str(a.rel), str(a.var),
                     a.key if isinstance(a.key, str) else int(a.key))
            for a in p.atoms
        ),
        types=tuple((str(v), int(th)) for v, th in p.types),
        distinct=bool(p.distinct),
    )


# ---------------------------------------------------------------- signature


@dataclass(frozen=True)
class PatternSignature:
    """The structural half of a pattern: constants replaced by slot
    indices (``("$", i)``), so requests sharing one signature batch into
    one device program regardless of which atoms they anchor on.
    ``n_consts`` is the length of the per-request constant vector."""

    vars: tuple[str, ...]
    atoms: tuple[tuple[str, str, Any], ...]   # (rel, var, key|("$", slot))
    types: tuple[tuple[str, int], ...]
    distinct: bool
    n_consts: int

    def bind(self, consts) -> ConjunctivePattern:
        """Re-inflate the concrete pattern for one constant vector — the
        host-fallback / ground-truth side of the signature split."""
        consts = tuple(int(x) for x in consts)
        if len(consts) != self.n_consts:
            raise JoinUnsupported(
                f"signature expects {self.n_consts} constants, "
                f"got {len(consts)}"
            )

        def key_of(k):
            return consts[k[1]] if isinstance(k, tuple) else k

        return ConjunctivePattern(
            vars=self.vars,
            atoms=tuple(JoinAtom(r, v, key_of(k)) for r, v, k in self.atoms),
            types=self.types,
            distinct=self.distinct,
        )

    def to_conditions(self, consts) -> dict:
        """The pattern as a per-variable condition spec (``Var`` cross
        references) — what ``graph.find_all``-based evaluation consumes."""
        return pattern_to_conditions(self.bind(consts))


def split_constants(p: ConjunctivePattern
                    ) -> tuple[PatternSignature, tuple[int, ...]]:
    """Factor ``p`` into (signature, constant vector). Constants are
    slotted in atom order — two patterns with the same shape but
    different anchors share a signature and differ only in the vector."""
    consts: list[int] = []
    atoms = []
    for a in p.atoms:
        if a.key_is_var:
            atoms.append((a.rel, a.var, a.key))
        else:
            atoms.append((a.rel, a.var, ("$", len(consts))))
            consts.append(int(a.key))
    return PatternSignature(
        vars=p.vars, atoms=tuple(atoms), types=p.types,
        distinct=p.distinct, n_consts=len(consts),
    ), tuple(consts)


# ---------------------------------------------------------------- extraction


def _clauses_of(cond: c.HGQueryCondition) -> tuple:
    if isinstance(cond, c.And):
        return cond.clauses
    return (cond,)


def _key_of(ref, var: str):
    """Var → its name; anything int-coercible → constant handle."""
    if isinstance(ref, Var):
        return ref.name
    try:
        return int(ref)
    except (TypeError, ValueError):
        raise JoinUnsupported(
            f"pattern reference on {var!r} must be a handle or Var, "
            f"got {type(ref).__name__}"
        ) from None


def extract_pattern(graph, spec: Mapping[str, c.HGQueryCondition],
                    distinct: bool = True) -> ConjunctivePattern:
    """Extract the conjunctive-pattern IR from a per-variable condition
    spec. Each variable's condition runs through the compiler's own
    ``expand → to_dnf → simplify`` normalization; the surviving ``And``
    clauses must all be pattern vocabulary (CoIncident / Incident /
    Target / AtomType, constants or ``Var`` references) — anything else
    raises :class:`JoinUnsupported` naming the offending clause, the
    same contract as ``query/bridge.to_request``."""
    from hypergraphdb_tpu_torch.query.compiler import expand, simplify, to_dnf

    vars_ = tuple(spec.keys())
    atoms: list[JoinAtom] = []
    types: list[tuple[str, int]] = []
    for v, cond in spec.items():
        norm = simplify(graph, to_dnf(expand(graph, cond)))
        if isinstance(norm, c.Or):
            raise JoinUnsupported(
                f"variable {v!r} normalizes to a disjunction; pattern "
                "variables must be conjunctive"
            )
        if isinstance(norm, c.Nothing):
            raise JoinUnsupported(
                f"variable {v!r} normalizes to a contradiction; the "
                "host path answers it (exactly empty) for free"
            )
        for cl in _clauses_of(norm):
            if isinstance(cl, c.AnyAtom):
                continue
            if isinstance(cl, c.CoIncident):
                atoms.append(JoinAtom("co", v, _key_of(cl.other, v)))
            elif isinstance(cl, c.Incident):
                atoms.append(JoinAtom("inc", v, _key_of(cl.target, v)))
            elif isinstance(cl, c.Target):
                atoms.append(JoinAtom("tgt", v, _key_of(cl.link, v)))
            elif isinstance(cl, c.AtomType):
                types.append((v, int(cl.type_handle(graph))))
            else:
                raise JoinUnsupported(
                    f"{type(cl).__name__} on variable {v!r} is outside "
                    "the pattern vocabulary (CoIncident/Incident/Target/"
                    "AtomType)"
                )
    # dedupe mirrored var-var atoms: co(x, y) and co(y, x) are the same
    # constraint (the relation is symmetric); inc(x, y) and tgt(y, x) are
    # each other's duals
    seen: set = set()
    uniq: list[JoinAtom] = []
    for a in atoms:
        if a.key_is_var:
            if a.rel == "co":
                k = ("co",) + tuple(sorted((a.var, a.key)))
            elif a.rel == "inc":
                k = ("inc", a.var, a.key)
            else:  # tgt(x, y) ≡ inc(y, x)
                k = ("inc", a.key, a.var)
        else:
            k = (a.rel, a.var, a.key)
        if k in seen:
            continue
        seen.add(k)
        uniq.append(a)
    return ConjunctivePattern(
        vars=vars_, atoms=tuple(uniq), types=tuple(dict(types).items()),
        distinct=distinct,
    )


def pattern_to_conditions(p: ConjunctivePattern) -> dict:
    """The inverse of :func:`extract_pattern`: one condition per
    variable, ``Var`` cross references — what the find_all-based ground
    truth (``join/host.py``) and the serve host fallback evaluate."""
    out: dict[str, list] = {v: [] for v in p.vars}

    def ref(k):
        return Var(k) if isinstance(k, str) else int(k)

    for a in p.atoms:
        if a.rel == "co":
            out[a.var].append(c.CoIncident(ref(a.key)))
        elif a.rel == "inc":
            out[a.var].append(c.Incident(ref(a.key)))
        else:
            out[a.var].append(c.Target(ref(a.key)))
    for v, th in p.types:
        out[v].append(c.AtomType(int(th)))
    return {
        v: (cls[0] if len(cls) == 1 else c.And(*cls)) if cls
        else c.AnyAtom()
        for v, cls in out.items()
    }
