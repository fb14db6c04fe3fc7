"""K1 gather-OR: the port's plain version against the reference Pallas
kernel run in interpret mode, on the cases of ``test_pallas_gather.py``.
Tolerance: bit-exact (the port's int32 words viewed as uint32)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from hypergraphdb_tpu.ops import pallas_gather as pg
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
    upper levels read one section and write the next."""
    w = 4
    buf = torch.from_numpy(_inputs(3, 40, 8, 1, 1)[0].view(np.int32)).clone()
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
