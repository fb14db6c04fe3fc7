"""K1 gather-OR: the port's plain version against the reference Pallas
kernel run in interpret mode, on the cases of ``test_pallas_gather.py``.
Tolerance: bit-exact (the port's int32 words viewed as uint32)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from hypergraphdb_tpu.ops import pallas_gather as pg
from hypergraphdb_tpu_torch.ops import linemask
from hypergraphdb_tpu_torch.ops.gather_or import gather_or, gather_or_plain


def _inputs(seed, S, Kw, n_out, w):
    r = np.random.default_rng(seed)
    values = r.integers(0, 2**32, size=(S, Kw), dtype=np.uint64).astype(np.uint32)
    idx = r.integers(0, S, size=n_out * w).astype(np.int32)
    return values, idx


def _port(values, idx, w, **kw):
    out = gather_or(torch.from_numpy(values.view(np.int32)),
                    torch.from_numpy(idx), w, **kw)
    return out.numpy().view(np.uint32)


@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("n_out", [pg.G, pg.G * 3 + 17])
def test_gather_or_matches_pallas(w, n_out):
    values, idx = _inputs(0, 500, 128, n_out, w)
    ref = pg.gather_or(jnp.asarray(values), jnp.asarray(idx), w, interpret=True)
    assert np.array_equal(_port(values, idx, w), np.asarray(ref))


def test_gather_or_streamed_blocks_match_pallas():
    """A small plain-version block (the reference's multi-segment case)."""
    w = 8
    n_out = pg.G * 2 * 3 + 5
    values, idx = _inputs(1, 300, 128, n_out, w)
    ref = pg.gather_or(jnp.asarray(values), jnp.asarray(idx), w, interpret=True)
    assert np.array_equal(_port(values, idx, w, chunk=pg.G), np.asarray(ref))


@pytest.mark.parametrize("Kw", [1, 37])
def test_gather_or_ragged_width(Kw):
    """No 128-lane rule in the port: any row width works."""
    w = 8
    values, idx = _inputs(2, 64, Kw, 50, w)
    want = np.bitwise_or.reduce(values[idx].reshape(-1, w, Kw), axis=1)
    assert np.array_equal(_port(values, idx, w), want)


def test_gather_or_writes_into_buffer_section():
    """``out`` as a section of the buffer ``values`` lies in: the pyramid's
    upper levels read one section and write the next, into zeros (``out``
    starts as a subset of the result)."""
    w = 4
    buf = torch.from_numpy(_inputs(3, 40, 8, 1, 1)[0].view(np.int32)).clone()
    buf[16:] = 0
    idx = torch.from_numpy(np.arange(16, dtype=np.int32))
    want = buf[:16].view(4, 4, 8)
    want = want[:, 0] | want[:, 1] | want[:, 2] | want[:, 3]
    got = gather_or(buf, idx, w, out=buf[20:24])
    assert got.data_ptr() == buf[20:24].data_ptr()
    assert torch.equal(buf[20:24], want)


def test_gather_or_rejects_bad_shapes():
    values = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        gather_or(values, torch.zeros(15, dtype=torch.int32), 8)  # not % w
    with pytest.raises(ValueError):
        gather_or(values.to(torch.int64), torch.zeros(16, dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        gather_or(values, torch.zeros(16, dtype=torch.int32), 8,
                  out=torch.zeros((3, 4), dtype=torch.int32))


def test_cpu_tensors_use_plain_version_and_count_no_launch():
    values, idx = _inputs(4, 50, 4, 10, 8)
    before = gather_or.launches
    a = gather_or(torch.from_numpy(values.view(np.int32)), torch.from_numpy(idx), 8)
    b = gather_or_plain(torch.from_numpy(values.view(np.int32)),
                        torch.from_numpy(idx), 8)
    assert torch.equal(a, b)
    assert gather_or.launches == before


# ------------------------------------------------ line masks through K1


@pytest.mark.parametrize("Kw", [2, 3, 128, 256])
def test_gather_or_emits_exact_mask_superset_mask_changes_nothing(Kw):
    """The rows written OR their exact line fields into the buffer's mask at
    their offset, and an input mask (exact or all-set) changes nothing."""
    r = np.random.default_rng(Kw)
    values, idx = _inputs(5, 64, Kw, 30, 8)
    values[r.random(64) < 0.7] = 0  # mostly zero rows
    values[3] = 0xFFFFFFFF          # one saturated row
    v = torch.from_numpy(values.view(np.int32))
    want = gather_or(v, torch.from_numpy(idx), 8)
    for mask in (None, linemask.full_mask(64, Kw, "cpu"),
                 linemask.line_mask(v)):
        buf = torch.zeros((45, Kw), dtype=torch.int32)
        bmask = linemask.empty_mask(45, Kw, "cpu")
        got = gather_or(v, torch.from_numpy(idx), 8, out=buf[7:37],
                        mask=mask, out_mask=bmask, mask_row0=7)
        assert torch.equal(got, want)
        assert torch.equal(bmask, linemask.line_mask(buf))


def test_gather_or_rejects_bad_masks():
    values = torch.zeros((8, 4), dtype=torch.int32)
    idx = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="line mask"):
        gather_or(values, idx, 8, mask=torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="exceed"):
        gather_or(values, idx, 8, out_mask=linemask.empty_mask(8, 4, "cpu"),
                  mask_row0=31)  # the mask word holds 32 rows


def test_index_range_check_rescans_after_an_in_place_write():
    """The kernels' index range check scans the index on every call: a
    smaller table, or an index written in place, is caught."""
    from hypergraphdb_tpu_torch.ops import _cuda

    idx = torch.tensor([0, 3, 7], dtype=torch.int32)
    _cuda.check_rows(idx, 8, "idx")
    with pytest.raises(ValueError, match="outside"):
        _cuda.check_rows(idx, 7, "idx")
    idx[1] = 9
    with pytest.raises(ValueError, match=r"\[0, 9\]"):
        _cuda.check_rows(idx, 8, "idx")
    idx[1] = -1
    with pytest.raises(ValueError, match=r"\[-1, 7\]"):
        _cuda.check_rows(idx, 8, "idx")
