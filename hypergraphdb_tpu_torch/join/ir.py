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

:func:`split_constants` factors a pattern into a hashable
:class:`PatternSignature` (the structure) plus the constant vector (what
varies per request), the serve tier's batch-key/payload split.

Not here yet, because they read the query layer: ``extract_pattern`` (a
pattern from per-variable query conditions), ``pattern_to_conditions`` and
``PatternSignature.to_conditions``. Until then a pattern is built from
:class:`JoinAtom` s, or carried over from the reference's IR with
:func:`pattern_from_reference`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from hypergraphdb_tpu_torch.serve.types import Unservable

#: binary relations a pattern atom may use
RELATIONS = ("co", "inc", "tgt")


class JoinUnsupported(Unservable):
    """The pattern is outside what the join engine serves (an unknown
    relation, an unanchored variable, a co-incidence relation over its
    pair budget) — run it through the host path instead."""


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
