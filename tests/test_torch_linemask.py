"""Line-occupancy masks (``ops/linemask.py``): ``line_mask`` against a numpy
reference at several row widths, the field helpers, and the seed masks of
both BFS paths. Tolerance: exact equality of the packed words (uint32
view)."""

import numpy as np
import pytest
import torch

from hypergraphdb_tpu_torch.ops import linemask
from hypergraphdb_tpu_torch.ops.ellbfs import seed_bitmap, seed_mask

WIDTHS = [1, 2, 3, 32, 128, 288]


def _np_mask(bm: np.ndarray) -> np.ndarray:
    """numpy reference: one bit per 32-word line, fields padded to a power
    of two, packed little-endian into uint32 words."""
    R, kw = bm.shape
    L = -(-kw // 32)
    P = 1 << (L - 1).bit_length()
    bits = np.zeros((R, P), dtype=bool)
    for l in range(L):
        bits[:, l] = (bm[:, l * 32 : (l + 1) * 32] != 0).any(1)
    flat = bits.reshape(-1)
    flat = np.concatenate([flat, np.zeros(-len(flat) % 32, bool)])
    words = (flat.reshape(-1, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(1)
    return words.astype(np.uint32)


def _sparse_bitmap(r, R, kw, density):
    """Random bits in a random ~``density`` share of the (row, line)
    cells, nothing elsewhere."""
    words = r.integers(0, 2**32, size=(R, kw), dtype=np.uint64).astype(np.uint32)
    live = r.random((R, -(-kw // 32))) < density
    keep = np.repeat(live, 32, axis=1)[:, :kw]
    return np.where(keep, words, 0).astype(np.uint32)


@pytest.mark.parametrize("kw", WIDTHS)
@pytest.mark.parametrize("density", [0.0, 0.05, 0.5, 1.0])
def test_line_mask_matches_numpy(kw, density):
    r = np.random.default_rng(kw * 7 + int(density * 100))
    bm = _sparse_bitmap(r, 77, kw, density)
    got = linemask.line_mask(torch.from_numpy(bm.view(np.int32)))
    assert got.dtype == torch.int32
    assert got.shape == (linemask.mask_words(77, kw),)
    assert np.array_equal(got.numpy().view(np.uint32), _np_mask(bm))


@pytest.mark.parametrize("kw,G,L,P", [(1, 32, 1, 1), (3, 32, 1, 1),
                                      (32, 32, 1, 1), (33, 32, 2, 2),
                                      (128, 32, 4, 4), (288, 32, 9, 16),
                                      (1024, 32, 32, 32), (1025, 64, 17, 32),
                                      (2048, 64, 32, 32)])
def test_geometry(kw, G, L, P):
    assert linemask.line_words(kw) == G
    assert linemask.n_lines(kw) == L
    assert linemask.field_bits(kw) == P
    assert linemask.mask_words(100, kw) == -(-100 * P // 32)


def test_wide_rows_fold_lines_to_fit_one_word():
    """Past 1024 words a line grows so a row keeps at most 32 lines."""
    bm = np.zeros((3, 2048), np.uint32)
    bm[1, 64 * 5 + 3] = 1
    fields = linemask.row_fields_of(torch.from_numpy(bm.view(np.int32)))
    assert fields.tolist() == [0, 1 << 5, 0]


@pytest.mark.parametrize("kw", [2, 128, 288])
@pytest.mark.parametrize("row0", [0, 1, 5, 13])
def test_or_fields_at_an_offset(kw, row0):
    """Sections of a buffer OR their fields in at unaligned row offsets
    without touching their neighbours' fields."""
    r = np.random.default_rng(row0)
    whole = _sparse_bitmap(r, 40, kw, 0.3)
    t = torch.from_numpy(whole.view(np.int32))
    mask = linemask.empty_mask(40, kw, "cpu")
    cuts = [0, row0, row0 + 11, 40]
    for a, b in zip(cuts[:-1], cuts[1:]):
        linemask.or_fields(mask, linemask.row_fields_of(t[a:b]), a, kw)
    assert torch.equal(mask, linemask.line_mask(t))
    rows = torch.arange(40)
    assert torch.equal(linemask.fields_at(mask, rows, kw),
                       linemask.row_fields_of(t))


def test_clear_field_and_full_mask():
    kw = 128
    bm = np.full((9, kw), 0xFFFFFFFF, np.uint32)
    t = torch.from_numpy(bm.view(np.int32)).clone()
    mask = linemask.line_mask(t)
    t[4] = 0
    linemask.clear_field(mask, 4, kw)
    assert torch.equal(mask, linemask.line_mask(t))
    full = linemask.full_mask(9, kw, "cpu")
    assert (full == -1).all() and full.shape == mask.shape


@pytest.mark.parametrize("K", [32, 64, 4096])
def test_seed_mask_is_the_seed_bitmaps_mask(K):
    n_rows = 500
    seeds = torch.from_numpy(np.random.default_rng(K).integers(
        0, n_rows, size=K).astype(np.int32))
    seeds[-3:] = 17  # duplicates OR
    kw = K // 32
    bm = seed_bitmap(seeds, n_rows, kw)
    assert torch.equal(seed_mask(seeds, n_rows, kw), linemask.line_mask(bm))
    bm[17] = 0
    assert torch.equal(seed_mask(seeds, n_rows, kw, clear_row=17),
                       linemask.line_mask(bm))


def test_mask_validation():
    with pytest.raises(ValueError, match="line mask"):
        linemask.check_mask(torch.zeros(3, dtype=torch.int64), 10, 4,
                            torch.device("cpu"), "x")
    with pytest.raises(ValueError, match="line mask"):
        linemask.check_mask(torch.zeros(7, dtype=torch.int32), 10, 4,
                            torch.device("cpu"), "x")
    linemask.check_mask(torch.zeros(1, dtype=torch.int32), 10, 4,
                        torch.device("cpu"), "x")
