"""The type system: types are atoms; values are typed, serialised and
indexable.

Every type gives ``store(value) -> bytes`` and ``make(bytes) -> value``
(the payload in the data store) and ``to_key(value) -> bytes``, an
order-preserving index key led by the type's one-byte kind, so keys of
different kinds never collide. Each registered type gets a type atom in
the graph (value = its name, type = the top type). Bootstrap registers
``top``, ``null`` and the eight predefined primitive types in that order:
the handles they take are part of every later handle's number.

Record types (dataclasses bound to types) are not ported: a value no
registered type takes raises ``TypeError_``.
"""

from __future__ import annotations

from typing import Any, Optional

from hypergraphdb_tpu_torch.core.errors import TypeError_
from hypergraphdb_tpu_torch.core.handles import HGHandle


class HGAtomType:
    """A type: serialisation and index key of its values."""

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
        self.top = TopType()
        self.null = NullType()

    def bootstrap(self) -> None:
        """Create the predefined type atoms, in the reference's order."""
        from hypergraphdb_tpu_torch.types import primitive as prim

        self.register(self.top, classes=())
        self.register(self.null, classes=(type(None),))
        for t, classes in prim.PREDEFINED:
            self.register(t, classes=classes)

    def register(self, atype: HGAtomType, classes: tuple = ()) -> HGHandle:
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
        return h

    def get_type(self, name_or_handle) -> HGAtomType:
        if isinstance(name_or_handle, str):
            t = self._by_name.get(name_or_handle)
            if t is None:
                raise TypeError_(f"unknown type {name_or_handle!r}")
            return t
        name = self._name_by_handle.get(int(name_or_handle))
        if name is None:
            raise TypeError_(f"handle {name_or_handle} is not a type atom")
        return self._by_name[name]

    def handle_of(self, name: str) -> HGHandle:
        h = self._handle_by_name.get(name)
        if h is None:
            raise TypeError_(f"unknown type {name!r}")
        return h

    def is_type_handle(self, handle: HGHandle) -> bool:
        return int(handle) in self._name_by_handle

    def get_type_handle(self, value: Any) -> HGHandle:
        """The type of a runtime value."""
        t = self.infer(value)
        if t is None:
            raise TypeError_(
                f"no type for value of class {type(value).__name__}")
        return self._handle_by_name[t.name]

    def infer(self, value: Any) -> Optional[HGAtomType]:
        """The type bound to the value's class, or None."""
        name = self._by_class.get(type(value))
        return None if name is None else self._by_name[name]
