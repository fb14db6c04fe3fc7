"""Order-preserving byte encodings for index keys.

Every primitive type encodes to bytes whose plain lexicographic (memcmp)
order is the value order, so indexes need no per-type comparator and the
first 8 bytes of a key give an order-preserving 64-bit rank for the
device columns.
"""

from __future__ import annotations

import struct

_MASK64 = (1 << 64) - 1


def encode_int(v: int) -> bytes:
    """int64: sign bit flipped, big-endian."""
    return struct.pack(">Q", (v + (1 << 63)) & _MASK64)


def decode_int(b: bytes) -> int:
    return struct.unpack(">Q", b)[0] - (1 << 63)


def encode_float(v: float) -> bytes:
    """float64 in IEEE total order: a non-negative value flips its sign
    bit, a negative one flips every bit."""
    bits = struct.unpack(">Q", struct.pack(">d", v))[0]
    if bits & (1 << 63):
        bits = ~bits & _MASK64
    else:
        bits |= 1 << 63
    return struct.pack(">Q", bits)


def decode_float(b: bytes) -> float:
    bits = struct.unpack(">Q", b)[0]
    if bits & (1 << 63):
        bits &= ~(1 << 63) & _MASK64
    else:
        bits = ~bits & _MASK64
    return struct.unpack(">d", struct.pack(">Q", bits))[0]


def encode_str(v: str) -> bytes:
    """UTF-8: byte order is code point order."""
    return v.encode("utf-8")


def decode_str(b: bytes) -> str:
    return b.decode("utf-8")


def encode_bool(v: bool) -> bytes:
    return b"\x01" if v else b"\x00"


def decode_bool(b: bytes) -> bool:
    return b != b"\x00"


def rank64(key: bytes) -> int:
    """The first 8 bytes of a key, zero-padded, as a big-endian unsigned
    rank: ``rank64(a) < rank64(b)`` implies ``a < b``; ties need the key."""
    return int.from_bytes(key[:8].ljust(8, b"\x00"), "big")


def rank128(key: bytes) -> tuple[int, int]:
    """The first 16 bytes of a key as two rank words, compared in order:
    exact (order and identity) for NUL-free payloads of at most 16 bytes."""
    return rank64(key), rank64(key[8:16])


def rank_ambiguous(payload: bytes) -> bool:
    """Does the 128-bit rank pair fail to stand in for the whole key? True
    past 16 bytes, or with a NUL among the first 16 (zero padding collides
    with it). Fixed-width kinds never ask: their one word is exact."""
    return len(payload) > 16 or b"\x00" in payload[:16]
