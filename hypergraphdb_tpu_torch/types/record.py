"""Record (composite) types with projections.

The analogue of the reference's ``RecordType`` (``type/RecordType.java:46``),
``HGCompositeType``/``HGProjection`` dimension paths and the Java-bean
binding (``JavaTypeFactory.java:37``, ``BonesOfBeans``). In Python the
natural binding is **dataclasses**: each dataclass becomes a record type
whose dimensions are its fields; nested paths ("part.subpart") power
by-part indexing and ``AtomPartCondition`` exactly like the reference's
projection paths.

Values pack through the port's ``utils/msgpack_lite`` with the same
``default`` hook as the JAX package's ``msgpack`` call, so a record's
bytes, and its index key, are the same in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from hypergraphdb_tpu_torch.core.errors import TypeError_
from hypergraphdb_tpu_torch.types.system import HGAtomType
from hypergraphdb_tpu_torch.utils import msgpack_lite


def _pack_default(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"__dc__": _qualname(type(obj)),
                "f": {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}}
    raise TypeError(f"unpackable: {type(obj)}")


def _qualname(cls: type) -> str:
    return f"{cls.__module__}.{cls.__qualname__}"


class RecordType(HGAtomType):
    """A composite type over named dimensions, bound to a dataclass."""

    kind = b"r"

    def __init__(self, name: str, cls: Optional[type] = None,
                 fields: tuple[str, ...] = (),
                 supertype_names: tuple[str, ...] = ()):
        self.name = name
        self.cls = cls
        self.fields = fields
        self.supertype_names = supertype_names
        self._registry: dict[str, type] = {}
        if cls is not None:
            self._registry[_qualname(cls)] = cls

    # -- dataclass binding ------------------------------------------------------
    @staticmethod
    def for_dataclass(cls: type, ts=None) -> "RecordType":
        if not dataclasses.is_dataclass(cls):
            raise TypeError_(f"{cls} is not a dataclass")
        fields = tuple(f.name for f in dataclasses.fields(cls))
        supers = tuple(
            _qualname(b)
            for b in cls.__mro__[1:]
            if dataclasses.is_dataclass(b)
        )
        return RecordType(_qualname(cls), cls, fields, supers)

    # -- serialization ----------------------------------------------------------
    def store(self, value: Any) -> bytes:
        if isinstance(value, dict):
            # schema-only binding: a peer that installed this record type
            # over the wire (SyncTypes) has no dataclass class; values
            # round-trip as field dicts (the reference likewise degrades
            # when the Java class is off the classpath)
            d = {f: value.get(f) for f in self.fields} if self.fields else value
        else:
            d = {
                f.name: getattr(value, f.name)
                for f in dataclasses.fields(value)
            }
        return msgpack_lite.packb(d, default=_pack_default)

    def make(self, data: bytes) -> Any:
        d = msgpack_lite.unpackb(data)
        return self._revive(d)

    def _revive(self, d: Any) -> Any:
        if isinstance(d, dict) and "__dc__" in d:
            cls = self._registry.get(d["__dc__"])
            vals = {k: self._revive(v) for k, v in d["f"].items()}
            if cls is None:
                return vals
            return cls(**vals)
        if isinstance(d, dict):
            if self.cls is not None and set(d) >= set(self.fields):
                vals = {k: self._revive(v) for k, v in d.items() if k in self.fields}
                return self.cls(**vals)
            return {k: self._revive(v) for k, v in d.items()}
        if isinstance(d, list):
            return [self._revive(v) for v in d]
        return d

    # -- index key ---------------------------------------------------------------
    def to_key(self, value: Any) -> bytes:
        return self.kind + self.store(value)

    def handles_value(self, value: Any) -> bool:
        return self.cls is not None and isinstance(value, self.cls)

    # -- projections (HGCompositeType) -------------------------------------------
    def dimensions(self) -> list[str]:
        return list(self.fields)

    def project(self, value: Any, dimension: str) -> Any:
        """Resolve a (possibly dotted) projection path — the analogue of the
        reference's ``HGProjection`` dimension paths used by ``ByPartIndexer``
        and ``AtomPartCondition``."""
        obj = value
        for part in dimension.split("."):
            if obj is None:
                return None
            if isinstance(obj, dict):
                obj = obj.get(part)
            else:
                obj = getattr(obj, part, None)
        return obj

    # -- subsumption ----------------------------------------------------------------
    def subsumes(self, general: Any, specific: Any) -> bool:
        """Structural subsumption: every set field of `general` matches
        `specific` (reference ``RecordType.subsumes`` treats null parts as
        wildcards)."""
        if general is None:
            return True
        if specific is None:
            return False
        for f in self.fields:
            g = self.project(general, f)
            if g is None:
                continue
            if g != self.project(specific, f):
                return False
        return True
