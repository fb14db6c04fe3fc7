"""Line-occupancy masks of the transposed visited bitmaps.

A bitmap row is ``kw`` 32-bit words, one bit per seed. Its mask holds one
bit per *line* of the row: a run of :func:`line_words` words, 32 words (one
128-byte line of the card's caches) for every row up to 1024 words, wider
beyond that so a row never has more than 32 lines. Bit ``l`` of a row's
field says "line ``l`` of this row may hold a set bit".

Layout: each row owns a field of :func:`field_bits` bits (the line count
rounded up to a power of two, at most 32), at bit ``row * field_bits`` of a
packed ``int32`` array, so a field never straddles two words. At 10M rows
of 128 words (4 lines) that is 4 bits a row, 5 MB: it stays in the L2.

**Contract: a mask is a superset of the nonzero lines.** A kernel skips a
gathered row whose field is clear and a line whose bit is clear, so a line
with a set bit and a clear mask bit loses bits silently. Clearing bits in a
row may leave its field as it is; setting bits must set it. The kernels
emit exact masks of what they write (``csrc/fused_hop.cu``,
``csrc/gather_or.cu``); :func:`line_mask` is the plain version and the
check.
"""

from __future__ import annotations

import torch

#: words per line for rows up to MAX_LINES lines (one 128-byte line)
LINE_WORDS = 32
#: most lines a row's field holds (one 32-bit word)
MAX_LINES = 32
#: rows per block of :func:`line_mask` (bounds its bool transient)
ROW_BLOCK = 1 << 20


def line_words(kw: int) -> int:
    """Words per line for rows of ``kw`` words: 32, or a multiple of 32
    wide enough that a row has at most :data:`MAX_LINES` lines."""
    return LINE_WORDS * max(1, -(-kw // (LINE_WORDS * MAX_LINES)))


def n_lines(kw: int) -> int:
    """Lines of a row of ``kw`` words."""
    return max(1, -(-kw // line_words(kw)))


def field_bits(kw: int) -> int:
    """Bits of one row's field: the line count rounded up to a power of
    two (1, 2, 4, 8, 16 or 32)."""
    return 1 << (n_lines(kw) - 1).bit_length()


def mask_words(n_rows: int, kw: int) -> int:
    """``int32`` words of the mask of an ``(n_rows, kw)`` bitmap."""
    return -(-n_rows * field_bits(kw) // 32)


def empty_mask(n_rows: int, kw: int, device) -> torch.Tensor:
    """An all-clear mask: exact for an all-zero bitmap."""
    return torch.zeros(mask_words(n_rows, kw), dtype=torch.int32,
                       device=device)


def full_mask(n_rows: int, kw: int, device) -> torch.Tensor:
    """An all-set mask: a superset for any bitmap (every line live)."""
    return torch.full((mask_words(n_rows, kw),), -1, dtype=torch.int32,
                      device=device)


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → the int32 words with the same bits."""
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)


def pack_fields(fields: torch.Tensor, kw: int) -> torch.Tensor:
    """(R,) int64 row fields → the packed int32 words of rows 0..R-1. The
    fields of one word are disjoint bit ranges, so their sum is their OR."""
    P = field_bits(kw)
    rpw = 32 // P
    R = fields.shape[0]
    padded = torch.zeros(-(-R // rpw) * rpw, dtype=torch.int64,
                         device=fields.device)
    padded[:R] = fields
    shifts = torch.arange(rpw, device=fields.device, dtype=torch.int64) * P
    return _to_int32((padded.view(-1, rpw) << shifts).sum(1))


def row_fields_of(bitmap: torch.Tensor) -> torch.Tensor:
    """(R,) int64 exact fields of the rows of an (R, kw) int32 bitmap."""
    R, kw = bitmap.shape
    G, L = line_words(kw), n_lines(kw)
    lines = torch.arange(L, device=bitmap.device, dtype=torch.int64)
    out = torch.empty(R, dtype=torch.int64, device=bitmap.device)
    for s in range(0, R, ROW_BLOCK):
        blk = bitmap[s : s + ROW_BLOCK]
        if L * G != kw:
            blk = torch.nn.functional.pad(blk, (0, L * G - kw))
        nz = (blk.reshape(blk.shape[0], L, G) != 0).any(-1)
        out[s : s + blk.shape[0]] = (nz.to(torch.int64) << lines).sum(1)
    return out


def line_mask(bitmap: torch.Tensor) -> torch.Tensor:
    """The exact mask of an (R, kw) int32 bitmap: the plain version of the
    masks the kernels emit."""
    return pack_fields(row_fields_of(bitmap), bitmap.shape[1])


def fields_at(mask: torch.Tensor, rows: torch.Tensor, kw: int) -> torch.Tensor:
    """(n,) int64 fields of ``rows`` (any integer ids) read from ``mask``."""
    P = field_bits(kw)
    bit = rows.to(torch.int64) * P
    word = mask[bit >> 5].to(torch.int64) & 0xFFFFFFFF
    return (word >> (bit & 31)) & ((1 << P) - 1)


def or_fields(mask: torch.Tensor, fields: torch.Tensor, row0: int,
              kw: int) -> torch.Tensor:
    """OR the (n,) int64 fields of rows ``row0 .. row0+n-1`` into ``mask``,
    in place."""
    P = field_bits(kw)
    rpw = 32 // P
    lead = row0 % rpw
    if lead:
        fields = torch.cat([fields.new_zeros(lead), fields])
    w0 = (row0 - lead) * P // 32
    words = pack_fields(fields, kw)
    mask[w0 : w0 + words.shape[0]] |= words
    return mask


def mask_of_points(rows: torch.Tensor, lines: torch.Tensor, n_rows: int,
                   kw: int) -> torch.Tensor:
    """The mask with bit ``lines[i]`` of row ``rows[i]`` set for every i
    (duplicates allowed) and nothing else."""
    P = field_bits(kw)
    bits = torch.unique(rows.to(torch.int64) * P + lines.to(torch.int64))
    words = torch.zeros(mask_words(n_rows, kw), dtype=torch.int64,
                        device=rows.device)
    words.index_add_(0, bits >> 5, torch.ones_like(bits) << (bits & 31))
    return _to_int32(words)


def clear_field(mask: torch.Tensor, row: int, kw: int) -> torch.Tensor:
    """Clear row ``row``'s field of ``mask`` in place (after the row itself
    was cleared)."""
    P = field_bits(kw)
    bit = row * P
    w = bit >> 5
    keep = ~(((1 << P) - 1) << (bit & 31)) & 0xFFFFFFFF
    word = mask[w : w + 1].to(torch.int64) & keep
    mask[w : w + 1] = _to_int32(word)
    return mask


def check_mask(mask: torch.Tensor, n_rows: int, kw: int, device,
               what: str) -> None:
    """Raise unless ``mask`` is a contiguous int32 mask of an (n_rows, kw)
    bitmap on ``device``."""
    n = mask_words(n_rows, kw)
    if (mask.dim() != 1 or mask.dtype != torch.int32 or mask.shape[0] != n
            or not mask.is_contiguous() or mask.device != device):
        raise ValueError(f"{what}: need a contiguous ({n},) int32 line mask "
                         f"on {device} for ({n_rows}, {kw}) rows, got "
                         f"{tuple(mask.shape)} {mask.dtype} on {mask.device}")
