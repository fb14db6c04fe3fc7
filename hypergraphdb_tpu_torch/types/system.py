"""The type system: types are atoms; values are typed, serialised and
indexable.

Every type gives ``store(value) -> bytes`` and ``make(bytes) -> value``
(the payload in the data store) and ``to_key(value) -> bytes``, an
order-preserving index key led by the type's one-byte kind, so keys of
different kinds never collide. Each registered type gets a type atom in
the graph (value = its name, type = the top type). Bootstrap registers
``top``, ``null`` and the eight predefined primitive types in that order:
the handles they take are part of every later handle's number.

A dataclass value binds to a record type (``types/record.py``) on first
use, its dataclass bases becoming its supertypes. The type hierarchy
(``declare_subtype``, ``subtypes_closure``, ``supertypes_of``) powers
``TypePlus`` queries and supertype indexer registration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from hypergraphdb_tpu_torch.core.errors import TypeError_
from hypergraphdb_tpu_torch.core.handles import HGHandle


class HGAtomType:
    """A type: serialisation, index key and subsumption of its values."""

    #: symbolic name, unique in a type system
    name: str = ""
    #: one-byte kind prefix of index keys
    kind: bytes = b"?"

    def store(self, value: Any) -> bytes:
        raise NotImplementedError

    def make(self, data: bytes) -> Any:
        raise NotImplementedError

    def to_key(self, value: Any) -> bytes:
        """Order-preserving index key, kind prefix included."""
        raise NotImplementedError

    def handles_value(self, value: Any) -> bool:
        return False

    def subsumes(self, general: Any, specific: Any) -> bool:
        """Value-level subsumption; by default, equality."""
        return general == specific

    def dimensions(self) -> list[str]:
        """Projection dimensions; none for a scalar type."""
        return []

    def project(self, value: Any, dimension: str) -> Any:
        raise TypeError_(f"type {self.name} has no dimension {dimension!r}")


class TopType(HGAtomType):
    """The type of type atoms; its values are type names."""

    name = "top"
    kind = b"T"

    def store(self, value: Any) -> bytes:
        return str(value).encode("utf-8")

    def make(self, data: bytes) -> Any:
        return data.decode("utf-8")

    def to_key(self, value: Any) -> bytes:
        return self.kind + str(value).encode("utf-8")

    def handles_value(self, value: Any) -> bool:
        return False  # never inferred


class NullType(HGAtomType):
    """The type of ``None``: valueless atoms store the null value handle."""

    name = "null"
    kind = b"0"

    def store(self, value: Any) -> bytes:
        return b""

    def make(self, data: bytes) -> Any:
        return None

    def to_key(self, value: Any) -> bytes:
        return self.kind

    def handles_value(self, value: Any) -> bool:
        return value is None


class HGTypeSystem:
    """Binds runtime classes, types and type atoms."""

    def __init__(self, graph):
        self.graph = graph
        self._by_name: dict[str, HGAtomType] = {}
        self._handle_by_name: dict[str, HGHandle] = {}
        self._name_by_handle: dict[HGHandle, str] = {}
        self._by_class: dict[type, str] = {}
        self._inference: list[Callable[[Any], Optional[HGAtomType]]] = []
        #: direct supertype edges: type name -> parent type names
        self._supertypes: dict[str, set[str]] = {}
        #: bumped on every hierarchy change; lookup caches key on it
        self.hierarchy_version = 0
        self.top = TopType()
        self.null = NullType()

    def bootstrap(self) -> None:
        """Create the predefined type atoms, in the reference's order."""
        from hypergraphdb_tpu_torch.types import primitive as prim

        self.register(self.top, classes=())
        self.register(self.null, classes=(type(None),))
        for t, classes in prim.PREDEFINED:
            self.register(t, classes=classes)

    def register(self, atype: HGAtomType, classes: tuple = (),
                 supertypes: tuple[str, ...] = ()) -> HGHandle:
        if atype.name in self._by_name:
            return self._handle_by_name[atype.name]
        self._by_name[atype.name] = atype
        h = self.graph._find_type_atom(atype.name)
        if h is None:
            h = self.graph._add_type_atom(atype.name)
        self._handle_by_name[atype.name] = h
        self._name_by_handle[h] = atype.name
        for c in classes:
            self._by_class[c] = atype.name
        if supertypes:
            self._supertypes[atype.name] = set(supertypes)
            self.hierarchy_version += 1
        return h

    def add_inference(self, fn: Callable[[Any], Optional[HGAtomType]]
                      ) -> None:
        """Register a fallback value → type inference hook."""
        self._inference.append(fn)

    def get_type(self, name_or_handle) -> HGAtomType:
        if isinstance(name_or_handle, str):
            t = self._by_name.get(name_or_handle)
            if t is None:
                raise TypeError_(f"unknown type {name_or_handle!r}")
            return t
        name = self._name_by_handle.get(int(name_or_handle))
        if name is None:
            name = self._recover_type_name(int(name_or_handle))
        if name is None:
            raise TypeError_(f"handle {name_or_handle} is not a type atom")
        return self._by_name[name]

    def _type_atom_name(self, handle: int) -> Optional[str]:
        """The stored name of ``handle`` if it is a type atom (typed by
        ``top``), registered in this session or not; else None."""
        rec = self.graph.store.get_link(handle)
        if rec is None or len(rec) < 3:
            return None
        top_h = self._handle_by_name.get("top")
        if top_h is not None and rec[0] != int(top_h) and handle != int(top_h):
            return None
        data = self.graph.store.get_data(rec[1]) if rec[1] >= 0 else None
        if data is None:
            return None
        return self.top.make(data)

    def _recover_type_name(self, handle: int) -> Optional[str]:
        """A reopened store's type atom that this session has not bound:
        its stored name, bound to ``handle`` where a type of that name is
        registered; else None."""
        name = self._type_atom_name(handle)
        if name is not None and name in self._by_name:
            self._handle_by_name.setdefault(name, handle)
            self._name_by_handle[handle] = name
            return name
        return None

    def handle_of(self, name: str) -> HGHandle:
        h = self._handle_by_name.get(name)
        if h is None:
            raise TypeError_(f"unknown type {name!r}")
        return h

    def name_of(self, handle: HGHandle) -> str:
        return self._name_by_handle[int(handle)]

    def adopt_type_atom(self, handle: int) -> Optional[str]:
        """The name of type atom ``handle`` (an atom typed by ``top``),
        bound to it even where its type is not registered here, or None:
        enough for by-type and ``TypePlus`` queries to resolve."""
        h = int(handle)
        name = self._type_atom_name(h)
        if name is None:
            return None
        self._handle_by_name.setdefault(name, h)
        self._name_by_handle.setdefault(h, name)
        return name

    def is_type_handle(self, handle: HGHandle) -> bool:
        h = int(handle)
        # a stored type atom of an earlier session counts too, registered
        # here or not: the remove guard protects it across sessions
        return h in self._name_by_handle or self._type_atom_name(h) is not None

    def get_type_handle(self, value: Any) -> HGHandle:
        """The type of a runtime value."""
        t = self.infer(value)
        if t is None:
            raise TypeError_(
                f"no type for value of class {type(value).__name__}")
        return self._handle_by_name[t.name]

    def infer(self, value: Any) -> Optional[HGAtomType]:
        """The type bound to the value's class, then the inference hooks',
        then a record type bound to a dataclass value; else None."""
        name = self._by_class.get(type(value))
        if name is not None:
            return self._by_name[name]
        for fn in self._inference:
            t = fn(value)
            if t is not None:
                if t.name not in self._by_name:
                    self.register(t, classes=(type(value),))
                return t
        if dataclasses.is_dataclass(value) and not isinstance(value, type):
            from hypergraphdb_tpu_torch.types.record import RecordType

            t = RecordType.for_dataclass(type(value), self)
            if t.name not in self._by_name:
                self.register(t, classes=(type(value),),
                              supertypes=t.supertype_names)
            return self._by_name[t.name]
        return None

    # -- subsumption (type level) -------------------------------------------
    def declare_subtype(self, sub: str, sup: str) -> None:
        self._supertypes.setdefault(sub, set()).add(sup)
        self.hierarchy_version += 1

    def subtypes_closure(self, name: str) -> set[str]:
        """Every type name subsumed by ``name``, itself included: what a
        ``TypePlus`` condition expands to."""
        out = {name}
        changed = True
        while changed:
            changed = False
            for sub, sups in self._supertypes.items():
                if sub not in out and (sups & out):
                    out.add(sub)
                    changed = True
        return out

    def supertypes_of(self, name: str) -> set[str]:
        out: set[str] = set()
        frontier = set(self._supertypes.get(name, ()))
        while frontier:
            out |= frontier
            nxt: set[str] = set()
            for n in frontier:
                nxt |= self._supertypes.get(n, set()) - out
            frontier = nxt
        return out
