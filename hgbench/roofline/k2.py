"""What one launch of K2 (the fused hop, ``csrc/fused_hop.cu``) must read
and compute on the data it is given: a frozen copy of ``data_need`` in
``chip_smoke.py`` and of the line-mask arithmetic it rests on
(``ops/linemask.py``).

K2 ORs, for every output row, the rows its fused adjacency lists into it,
line by line (a line is 32 words of a row: 1024 seed lanes). The data
needs no source line where the row's own line is all ones, one load where
some source line is all ones (the saturation exit), and otherwise every
source line that holds a set bit; a row's own entry adds nothing. Each
line is read once, each index entry of a row not saturated from the start
once, the masks once, and each nonzero output line written once. Counted
so, the bound is what these inputs need, not the most a hop could read
(``fused_bfs.fused_bytes_per_hop``).
"""

from __future__ import annotations

import torch

from hgbench.roofline import bound_ms

LINE_WORDS = 32
MAX_LINES = 32
ROW_BLOCK = 1 << 20


def line_words(kw: int) -> int:
    return LINE_WORDS * max(1, -(-kw // (LINE_WORDS * MAX_LINES)))


def n_lines(kw: int) -> int:
    return max(1, -(-kw // line_words(kw)))


def field_bits(kw: int) -> int:
    return 1 << (n_lines(kw) - 1).bit_length()


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)


def pack_fields(fields: torch.Tensor, kw: int) -> torch.Tensor:
    """(R,) int64 row fields → packed int32 mask words."""
    P = field_bits(kw)
    rpw = 32 // P
    R = fields.shape[0]
    padded = torch.zeros(-(-R // rpw) * rpw, dtype=torch.int64,
                         device=fields.device)
    padded[:R] = fields
    shifts = torch.arange(rpw, device=fields.device, dtype=torch.int64) * P
    return _to_int32((padded.view(-1, rpw) << shifts).sum(1))


def fields_at(mask: torch.Tensor, rows: torch.Tensor, kw: int
              ) -> torch.Tensor:
    P = field_bits(kw)
    bit = rows.to(torch.int64) * P
    word = mask[bit >> 5].to(torch.int64) & 0xFFFFFFFF
    return (word >> (bit & 31)) & ((1 << P) - 1)


def _fields(bitmap: torch.Tensor, test) -> torch.Tensor:
    """(R,) int64: per row, bit l set where ``test`` holds for line l's
    words (padded with -1 for ``full``, 0 for ``live``)."""
    R, kw = bitmap.shape
    G, L = line_words(kw), n_lines(kw)
    lines = torch.arange(L, device=bitmap.device, dtype=torch.int64)
    out = torch.empty(R, dtype=torch.int64, device=bitmap.device)
    for s in range(0, R, ROW_BLOCK):
        blk = bitmap[s : s + ROW_BLOCK]
        hit = test(blk, L, G, kw)
        out[s : s + blk.shape[0]] = (hit.to(torch.int64) << lines).sum(1)
    return out


def full_fields(bitmap: torch.Tensor) -> torch.Tensor:
    """Per row, the lines whose every bit is set."""
    def test(blk, L, G, kw):
        if L * G != kw:
            blk = torch.nn.functional.pad(blk, (0, L * G - kw), value=-1)
        return (blk.reshape(blk.shape[0], L, G) == -1).all(-1)
    return _fields(bitmap, test)


def live_fields(bitmap: torch.Tensor) -> torch.Tensor:
    """Per row, the lines that hold a set bit."""
    def test(blk, L, G, kw):
        if L * G != kw:
            blk = torch.nn.functional.pad(blk, (0, L * G - kw))
        return (blk.reshape(blk.shape[0], L, G) != 0).any(-1)
    return _fields(bitmap, test)


def live_lines(bitmap: torch.Tensor) -> int:
    f = live_fields(bitmap)
    return sum(int(((f >> l) & 1).sum())
               for l in range(n_lines(bitmap.shape[1])))


def data_need(vals, vmask, idx, rows_of, n_out: int, own_full,
              block: int = 1 << 24) -> dict:
    """K2's need on one hop's input ``vals`` (with its exact mask
    ``vmask``): ``idx`` the fused index, ``rows_of(a, b)`` the output row
    of entries ``a..b-1``, ``own_full`` each output row's full-line field.
    Returns the index entries read (``idx``), the line loads (``loads``)
    and the distinct lines of ``vals`` read (``lines``)."""
    kw = vals.shape[1]
    L = n_lines(kw)
    dev = vals.device
    full = pack_fields(full_fields(vals), kw)
    end = idx.shape[0]
    cnt = torch.zeros((L, n_out), dtype=torch.int64, device=dev)
    first = torch.full((L, n_out), end, dtype=torch.int64, device=dev)
    lines = torch.arange(L, device=dev, dtype=torch.int64)
    own = ((own_full[None, :] >> lines[:, None]) & 1).bool()
    got = {"idx": 0}

    def fields(s):
        ix = idx[s : s + block]
        r = rows_of(s, s + ix.shape[0])
        other = ix.to(torch.int64) != r
        f = fields_at(vmask, ix, kw) * other
        u = fields_at(full, ix, kw) * other
        return ix, r, f, u

    for s in range(0, end, block):
        ix, r, f, u = fields(s)
        got["idx"] += int((own_full[r] != (1 << L) - 1).sum())
        e = torch.arange(s, s + ix.shape[0], device=dev, dtype=torch.int64)
        for l in range(L):
            cnt[l].index_add_(0, r, (f >> l) & 1)
            first[l].scatter_reduce_(0, r, torch.where(
                ((u >> l) & 1).bool(), e, end), "amin")
    sat = first < end
    got["loads"] = int(torch.where(own, 0, torch.where(sat, 1, cnt)).sum())
    used = torch.zeros((L, vals.shape[0]), dtype=torch.bool, device=dev)
    for l in range(L):
        pick = sat[l] & ~own[l]
        used[l, idx[first[l][pick]].long()] = True
    f_own = fields_at(vmask, torch.arange(n_out, device=dev), kw)
    for l in range(L):
        used[l] |= ((f_own >> l) & 1).bool()
    for s in range(0, end, block):
        ix, r, f, _ = fields(s)
        for l in range(L):
            keep = ((f >> l) & 1).bool() & ~sat[l][r] & ~own[l][r]
            used[l, ix[keep].long()] = True
    got["lines"] = int(used.sum())
    return got


def hop_bound_ms(old, old_mask, new, idx, item_off, item_row, w: int
                 ) -> tuple[float, str]:
    """The data bound of one K2 launch that turned ``old`` (mask
    ``old_mask``) into ``new``, over the fused plan's ``idx`` (``w``
    entries a chunk), ``item_off`` and ``item_row``."""
    n_rows, kw = old.shape
    chunk_row = torch.repeat_interleave(
        item_row, item_off[1:] - item_off[:-1]).long()

    def rows_of(a, b):
        return chunk_row[a // w : b // w].repeat_interleave(w)

    got = data_need(old, old_mask, idx, rows_of, n_rows,
                    full_fields(old), block=w << 21)
    line_bytes = min(line_words(kw), kw) * 4
    line_ops = min(line_words(kw), kw)
    nbytes = (got["idx"] * 4 + item_off.numel() * 8 + item_row.numel() * 4
              + 2 * old_mask.numel() * 4
              + (got["lines"] + live_lines(new)) * line_bytes)
    return bound_ms(nbytes, got["loads"] * line_ops)
