"""The predefined primitive types.

Each is serialisation plus an order-preserving key. Kind prefixes keep
the primitives in disjoint key ranges: b(ool) < f(loat) < i(nt) < l(ist)
< m(ap) < s(tr) < t(imestamp) < y(bytes). Lists and dicts are MessagePack
bytes (``utils/msgpack_lite``): their keys support equality lookups only.
"""

from __future__ import annotations

import datetime
import struct
from typing import Any

from hypergraphdb_tpu_torch.types.system import HGAtomType
from hypergraphdb_tpu_torch.utils import msgpack_lite
from hypergraphdb_tpu_torch.utils import ordered_bytes as ob


class IntType(HGAtomType):
    name = "int"
    kind = b"i"

    def store(self, value: Any) -> bytes:
        return ob.encode_int(int(value))

    def make(self, data: bytes) -> Any:
        return ob.decode_int(data)

    def to_key(self, value: Any) -> bytes:
        return self.kind + ob.encode_int(int(value))

    def handles_value(self, value: Any) -> bool:
        return isinstance(value, int) and not isinstance(value, bool)

    def subsumes(self, general: Any, specific: Any) -> bool:
        """Equal as integers: ``"7"`` subsumes ``7``."""
        return int(general) == int(specific)


class FloatType(HGAtomType):
    name = "float"
    kind = b"f"

    def store(self, value: Any) -> bytes:
        return struct.pack(">d", float(value))

    def make(self, data: bytes) -> Any:
        return struct.unpack(">d", data)[0]

    def to_key(self, value: Any) -> bytes:
        return self.kind + ob.encode_float(float(value))

    def handles_value(self, value: Any) -> bool:
        return isinstance(value, float)


class StringType(HGAtomType):
    name = "string"
    kind = b"s"

    def store(self, value: Any) -> bytes:
        return str(value).encode("utf-8")

    def make(self, data: bytes) -> Any:
        return data.decode("utf-8")

    def to_key(self, value: Any) -> bytes:
        return self.kind + str(value).encode("utf-8")

    def handles_value(self, value: Any) -> bool:
        return isinstance(value, str)


class BoolType(HGAtomType):
    name = "bool"
    kind = b"b"

    def store(self, value: Any) -> bytes:
        return ob.encode_bool(bool(value))

    def make(self, data: bytes) -> Any:
        return ob.decode_bool(data)

    def to_key(self, value: Any) -> bytes:
        return self.kind + ob.encode_bool(bool(value))

    def handles_value(self, value: Any) -> bool:
        return isinstance(value, bool)


class BytesType(HGAtomType):
    name = "bytes"
    kind = b"y"

    def store(self, value: Any) -> bytes:
        return bytes(value)

    def make(self, data: bytes) -> Any:
        return data

    def to_key(self, value: Any) -> bytes:
        return self.kind + bytes(value)

    def handles_value(self, value: Any) -> bool:
        return isinstance(value, (bytes, bytearray))


class TimestampType(HGAtomType):
    """Dates and datetimes, stored as epoch microseconds (naive values
    read as UTC)."""

    name = "timestamp"
    kind = b"t"

    def store(self, value: Any) -> bytes:
        return ob.encode_int(self._micros(value))

    def make(self, data: bytes) -> Any:
        us = ob.decode_int(data)
        return datetime.datetime.fromtimestamp(us / 1e6,
                                               tz=datetime.timezone.utc)

    def to_key(self, value: Any) -> bytes:
        return self.kind + ob.encode_int(self._micros(value))

    def handles_value(self, value: Any) -> bool:
        return isinstance(value, (datetime.datetime, datetime.date))

    @staticmethod
    def _micros(value: Any) -> int:
        if isinstance(value, datetime.datetime):
            if value.tzinfo is None:
                value = value.replace(tzinfo=datetime.timezone.utc)
            return int(value.timestamp() * 1e6)
        if isinstance(value, datetime.date):
            dt = datetime.datetime(value.year, value.month, value.day,
                                   tzinfo=datetime.timezone.utc)
            return int(dt.timestamp() * 1e6)
        raise TypeError(f"not a date: {value!r}")


class ListType(HGAtomType):
    """Lists and tuples of primitives, as MessagePack; the key is the
    MessagePack bytes (equality lookups only)."""

    name = "list"
    kind = b"l"

    def store(self, value: Any) -> bytes:
        return msgpack_lite.packb(list(value))

    def make(self, data: bytes) -> Any:
        return msgpack_lite.unpackb(data)

    def to_key(self, value: Any) -> bytes:
        return self.kind + msgpack_lite.packb(list(value))

    def handles_value(self, value: Any) -> bool:
        return isinstance(value, (list, tuple))


class DictType(HGAtomType):
    """String-keyed maps; the key packs the sorted items."""

    name = "dict"
    kind = b"m"

    def store(self, value: Any) -> bytes:
        return msgpack_lite.packb(dict(value))

    def make(self, data: bytes) -> Any:
        return msgpack_lite.unpackb(data)

    def to_key(self, value: Any) -> bytes:
        return self.kind + msgpack_lite.packb(sorted(dict(value).items()))

    def handles_value(self, value: Any) -> bool:
        return isinstance(value, dict)

    def dimensions(self) -> list[str]:
        return []  # the keys vary by value: project() takes any of them

    def project(self, value: Any, dimension: str) -> Any:
        return value.get(dimension)


#: (type, bound runtime classes), in the order their type atoms are made
PREDEFINED: list[tuple[HGAtomType, tuple]] = [
    (BoolType(), (bool,)),          # bool before int: bool is an int
    (IntType(), (int,)),
    (FloatType(), (float,)),
    (StringType(), (str,)),
    (BytesType(), (bytes, bytearray)),
    (TimestampType(), (datetime.datetime, datetime.date)),
    (ListType(), (list, tuple)),
    (DictType(), (dict,)),
]
