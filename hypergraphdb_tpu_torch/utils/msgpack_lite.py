"""The subset of MessagePack that the list, dict and record types write.

``ListType``, ``DictType`` and ``RecordType`` store their values, and
build their index keys, as MessagePack bytes. The port carries its own
encoder and decoder for the types those values hold (nil, bool, int,
float, str, bin, array, map), so it runs where the ``msgpack`` package is
missing. :func:`packb` gives the bytes of ``msgpack.packb(obj,
use_bin_type=True, default=default)`` (record types pack nested
dataclasses through the hook) and :func:`unpackb` reads them as
``msgpack.unpackb(data, raw=False)`` does: arrays as lists, maps as dicts
with str or bytes keys.
"""

from __future__ import annotations

import struct
from typing import Any


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out += struct.pack("b" if v < 0 else "B", v)
    elif 0 <= v <= 0xFF:
        out += b"\xcc" + struct.pack("B", v)
    elif -0x80 <= v < 0:
        out += b"\xd0" + struct.pack("b", v)
    elif 0 <= v <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", v)
    elif -0x8000 <= v < 0:
        out += b"\xd1" + struct.pack(">h", v)
    elif 0 <= v <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", v)
    elif -0x80000000 <= v < 0:
        out += b"\xd2" + struct.pack(">i", v)
    elif 0 <= v <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + struct.pack(">Q", v)
    elif -0x8000000000000000 <= v < 0:
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: int, fix_max: int, codes: tuple, out: bytearray,
              what: str) -> None:
    """A length header: the fix form up to ``fix_max``, then the 8-, 16-
    and 32-bit forms of ``codes`` (None where the family has no form)."""
    if n <= fix_max and fix is not None:
        out.append(fix | n)
        return
    for code, limit, fmt in zip(codes, (0xFF, 0xFFFF, 0xFFFFFFFF),
                                ("B", ">H", ">I")):
        if code is not None and n <= limit:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise ValueError(f"{what} is too large")


def _pack(obj: Any, out: bytearray, default=None) -> None:
    if obj is None:
        out += b"\xc0"
    elif isinstance(obj, bool):
        out += b"\xc3" if obj else b"\xc2"
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), None, -1, (0xC4, 0xC5, 0xC6), out, "bytes")
        out += obj
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), out, "string")
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out, "array")
        for item in obj:
            _pack(item, out, default)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out, "dict")
        for k, v in obj.items():
            _pack(k, out, default)
            _pack(v, out, default)
    elif default is not None:
        _pack(default(obj), out, default)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any, default=None) -> bytes:
    """``obj`` as MessagePack bytes (str as str, bytes as bin). An object
    of no MessagePack type is packed as what ``default(obj)`` returns, as
    ``msgpack.packb``'s hook of that name does (it raises ``TypeError``
    when the object has no form)."""
    out = bytearray()
    _pack(obj, out, default)
    return bytes(out)


#: fixed-width scalar codes: code -> (struct format, size)
_SCALARS = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: ("B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: ("b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
#: length-prefixed codes: code -> (family, length format, size)
_SIZED = {
    0xC4: ("bin", "B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
    0xD9: ("str", "B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
    0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
    0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4),
}


def _unpack(data: bytes, i: int) -> tuple[Any, int]:
    if i >= len(data):
        raise ValueError("unpackb: truncated data")
    code = data[i]
    i += 1
    if code <= 0x7F:
        return code, i
    if code >= 0xE0:
        return code - 0x100, i
    if code == 0xC0:
        return None, i
    if code in (0xC2, 0xC3):
        return code == 0xC3, i
    if code in _SCALARS:
        fmt, size = _SCALARS[code]
        if i + size > len(data):
            raise ValueError("unpackb: truncated data")
        return struct.unpack_from(fmt, data, i)[0], i + size
    if 0xA0 <= code <= 0xBF:
        family, n = "str", code & 0x1F
    elif 0x90 <= code <= 0x9F:
        family, n = "array", code & 0x0F
    elif 0x80 <= code <= 0x8F:
        family, n = "map", code & 0x0F
    elif code in _SIZED:
        family, fmt, size = _SIZED[code]
        n = struct.unpack_from(fmt, data, i)[0]
        i += size
    else:
        raise ValueError(f"unpackb: unsupported type code 0x{code:02x}")
    if family in ("str", "bin"):
        if i + n > len(data):
            raise ValueError("unpackb: truncated data")
        raw = bytes(data[i : i + n])
        return (raw.decode("utf-8") if family == "str" else raw), i + n
    if family == "array":
        items = []
        for _ in range(n):
            item, i = _unpack(data, i)
            items.append(item)
        return items, i
    out = {}
    for _ in range(n):
        k, i = _unpack(data, i)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"{type(k).__name__} is not allowed for map "
                             f"key")
        out[k], i = _unpack(data, i)
    return out, i


def unpackb(data: bytes) -> Any:
    """The one object MessagePack ``data`` holds."""
    obj, end = _unpack(bytes(data), 0)
    if end != len(data):
        raise ValueError("unpackb: extra data")
    return obj
