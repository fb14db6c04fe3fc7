"""Atom utilities: refs, directed hyperedges, typed relations and
subsumption.

- :class:`HGAtomRef`: a value that refers to another atom, with a mode.
  A hard ref pins its referent (it cannot be removed while referenced,
  cascades included) once :func:`install_ref_maintenance` wires the pin
  index into the graph's events; symbolic and floating refs may dangle.
- :class:`HGBergeLink`: a directed hyperedge, stored as an ordinary link
  whose value (:class:`BergeValue`) records the head count, so the device
  plane sees a plain row.
- :func:`define_rel_type` and :func:`add_rel`: named relation types of a
  fixed arity (:class:`RelTypeValue`) and their instances
  (:class:`RelValue`).
- :func:`declare_subsumes` persists ``general subsumes specific`` as a
  2-arity ``HGSubsumes`` link between two type atoms and registers it with
  the type system; :func:`subsumes_declared` answers the declared
  subsumption that ``query/conditions.Subsumes`` reads, and
  :func:`load_subsumptions` re-registers the persisted links when a graph
  opens.

Each value class is a dataclass, so it binds to a record type of its own
on first use, named by its module as every record type is.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from hypergraphdb_tpu_torch.core.errors import HGException
from hypergraphdb_tpu_torch.core.handles import HGHandle

# ref modes (HGAtomRef.Mode)
HARD = "hard"
SYMBOLIC = "symbolic"
FLOATING = "floating"

#: index: referent handle (encoded) -> referring atoms holding a HARD ref
IDX_HARD_REFS = "hg.atomref.hard"


@dataclass(frozen=True)
class HGAtomRef:
    """A reference-to-atom value. Store it (possibly inside a record) and
    the kernel maintains the hard-ref pin index."""

    target: int
    mode: str = HARD

    def deref(self, graph):
        """Resolve to the referent's value; symbolic/floating refs return
        None when dangling, hard refs raise (they cannot dangle)."""
        if graph.contains(self.target):
            return graph.get(self.target)
        if self.mode == HARD:
            raise HGException(f"hard ref target {self.target} is missing")
        return None


def _hard_ref_key(target: int) -> bytes:
    from hypergraphdb_tpu_torch.utils.ordered_bytes import encode_int

    return encode_int(int(target))


def scan_refs(value) -> list[HGAtomRef]:
    """Find HGAtomRef values inside an atom value (top-level, dataclass
    fields, list/tuple/dict containers — the projection surface)."""
    out: list[HGAtomRef] = []

    def visit(v, depth=0):
        if depth > 4:
            return
        if isinstance(v, HGAtomRef):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            for x in v:
                visit(x, depth + 1)
        elif isinstance(v, dict):
            for x in v.values():
                visit(x, depth + 1)
        else:
            import dataclasses

            if dataclasses.is_dataclass(v) and not isinstance(v, type):
                for f in dataclasses.fields(v):
                    visit(getattr(v, f.name), depth + 1)

    visit(value)
    return out


def install_ref_maintenance(graph) -> None:
    """Wire hard-ref pinning into the graph's event stream: validates refs
    BEFORE the write (propose/replace-request phase, so an invalid atom is
    never persisted), adds/releases pin index entries after commit, and
    vetoes removal — including cascade removal — of pinned atoms. (The
    reference bakes this into ``AtomRefType``; here it is an opt-in kernel
    extension kept out of the hot path.)"""
    from hypergraphdb_tpu_torch.core import events as ev

    idx = graph.store.get_index(IDX_HARD_REFS)
    #: handle -> hard-ref targets of the value being replaced (request phase
    #: stash, consumed by the post-commit replaced event)
    pending_replace: dict[int, list[int]] = {}

    def _hard_targets(value) -> list[int]:
        return [r.target for r in scan_refs(value) if r.mode == HARD]

    def _validate(g, value) -> None:
        for t in _hard_targets(value):
            if not g.contains(t):
                raise HGException(f"hard ref to missing atom {t}")

    def on_propose(g, event):
        _validate(g, event.atom)

    def on_added(g, event):
        for t in _hard_targets(event.atom):
            idx.add_entry(_hard_ref_key(t), int(event.handle))

    def on_replace_request(g, event):
        h = int(event.handle)
        _validate(g, event.atom)
        try:
            old = g.get(h)
            old = getattr(old, "value", old)
        except Exception:
            old = None
        pending_replace[h] = _hard_targets(old)

    def on_replaced(g, event):
        h = int(event.handle)
        for t in pending_replace.pop(h, ()):
            idx.remove_entry(_hard_ref_key(t), h)
        for t in _hard_targets(event.atom):
            idx.add_entry(_hard_ref_key(t), h)

    def on_remove_request(g, event):
        if len(idx.find(_hard_ref_key(int(event.handle)))):
            return ev.HGListener.CANCEL
        # dropping the referrer releases its pins
        try:
            val = g.get(int(event.handle))
            val = getattr(val, "value", val)
        except Exception:
            return None
        for t in _hard_targets(val):
            idx.remove_entry(_hard_ref_key(t), int(event.handle))
        return None

    graph.events.add_listener(ev.HGAtomProposeEvent, on_propose)
    graph.events.add_listener(ev.HGAtomAddedEvent, on_added)
    graph.events.add_listener(ev.HGAtomReplaceRequestEvent, on_replace_request)
    graph.events.add_listener(ev.HGAtomReplacedEvent, on_replaced)
    graph.events.add_listener(ev.HGAtomRemoveRequestEvent, on_remove_request)


# ------------------------------------------------------------------ Berge links


@dataclass(frozen=True)
class BergeValue:
    """Stored value of a Berge link: payload + head-count split."""

    head_count: int
    payload: object = None


class HGBergeLink:
    """Directed hyperedge view: targets[:head_count] are the head set,
    the rest the tail (``HGBergeLink.java:28``)."""

    def __init__(self, graph, handle: HGHandle):
        self.graph = graph
        self.handle = int(handle)

    @staticmethod
    def add(graph, head: Sequence[int], tail: Sequence[int],
            payload=None) -> "HGBergeLink":
        targets = [int(h) for h in head] + [int(t) for t in tail]
        h = graph.add_link(targets, value=BergeValue(len(head), payload))
        return HGBergeLink(graph, h)

    def _value(self) -> BergeValue:
        v = self.graph.get(self.handle)
        return v.value if hasattr(v, "value") else v

    @property
    def head(self) -> tuple[int, ...]:
        ts = self.graph.get_targets(self.handle)
        return tuple(int(t) for t in ts[: self._value().head_count])

    @property
    def tail(self) -> tuple[int, ...]:
        ts = self.graph.get_targets(self.handle)
        return tuple(int(t) for t in ts[self._value().head_count :])

    @property
    def payload(self):
        return self._value().payload


# ------------------------------------------------------------------ relations


@dataclass(frozen=True)
class RelTypeValue:
    """Value of a relation-type atom: name + arity (HGRelType)."""

    name: str
    arity: int


@dataclass(frozen=True)
class RelValue:
    """Value of a relation instance (HGRel): its relation-type handle."""

    rel_type: int
    name: str = ""


def define_rel_type(graph, name: str, arity: int) -> HGHandle:
    """Create (or find) a named relation type atom."""
    from hypergraphdb_tpu_torch.query import dsl as q

    t = graph.typesystem.infer(RelTypeValue("", 0))
    existing = q.find_one(
        graph, q.and_(q.type_(t.name), q.part("name", name),
                      q.part("arity", arity))
    )
    if existing is not None:
        return existing
    return graph.add(RelTypeValue(name, arity))


def add_rel(graph, rel_type: HGHandle, *targets: int) -> HGHandle:
    """Instantiate a relation over targets; arity-checked."""
    rt = graph.get(int(rel_type))
    rt = rt.value if hasattr(rt, "value") else rt
    if not isinstance(rt, RelTypeValue):
        raise HGException(f"{rel_type} is not a relation type atom")
    if len(targets) != rt.arity:
        raise HGException(
            f"relation {rt.name} wants {rt.arity} targets, got {len(targets)}"
        )
    return graph.add_link([int(t) for t in targets],
                          value=RelValue(int(rel_type), rt.name))


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
