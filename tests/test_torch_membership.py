"""K3 sorted-set membership: the port's wrapper (its plain version on the
CPU) against the reference Pallas kernel run in interpret mode, the way
``test_pallas_kernels.py`` runs it. Shapes stay small (Lb ≤ 2048, Lo ≤ 1024,
M ≤ 3): interpret mode walks every grid step. Tolerance: exact equality of
the masks and of the intersections."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from hypergraphdb_tpu.ops import setops as ref_setops
from hypergraphdb_tpu.ops.pallas_kernels import (
    intersect_sorted_pallas,
    membership_mask_pallas,
)
from hypergraphdb_tpu_torch.ops.membership import membership_mask
from hypergraphdb_tpu_torch.ops.setops import (
    SENTINEL,
    device_intersect_sorted,
    intersect_mask_many,
)

BIG = int(SENTINEL) - 1


def _sorted_row(r, n, lo, hi, length):
    """``n`` sorted unique draws from [lo, hi), SENTINEL-padded to
    ``length``."""
    vals = np.unique(r.integers(lo, hi, size=n)).astype(np.int32)[:length]
    out = np.full(length, SENTINEL, np.int32)
    out[: len(vals)] = vals
    return out


def _case(seed, lb, m, lo, hi=None, near_max=False):
    """A base and M others, ragged real lengths under SENTINEL padding,
    others drawn partly from the base so matches occur."""
    r = np.random.default_rng(seed)
    hi = hi or 2 * (lb + lo)
    lo_v = BIG - 3 * hi if near_max else 0
    hi_v = BIG + 1 if near_max else hi
    base = _sorted_row(r, int(lb * 0.8) + 1, lo_v, hi_v, lb)
    real = base[base != SENTINEL]
    others = []
    for j in range(m):
        pick = real[r.random(len(real)) < 0.6]
        extra = r.integers(lo_v, hi_v, size=lo // 3 + 1)
        vals = np.unique(np.concatenate([pick, extra]).astype(np.int32))
        n_real = int(r.integers((lo + 1) // 2, lo + 1))
        row = np.full(lo, SENTINEL, np.int32)
        row[: min(n_real, len(vals))] = vals[:n_real]
        others.append(row)
    return base, np.stack(others)


def _pallas(base, others):
    return np.asarray(membership_mask_pallas(
        jnp.asarray(base), jnp.asarray(others), interpret=True))


def _port(base, others):
    return membership_mask(torch.from_numpy(base),
                           torch.from_numpy(others)).numpy()


@pytest.mark.parametrize("lb,m,lo,seed", [
    (2, 1, 1, 1), (5, 1, 3, 0), (700, 2, 350, 0), (1000, 3, 900, 0),
    (2048, 3, 1024, 0), (333, 2, 129, 0),
])
def test_membership_matches_pallas(lb, m, lo, seed):
    base, others = _case(seed, lb, m, lo)
    want = _pallas(base, others)
    got = _port(base, others)
    assert want.any() and not want.all()
    assert got.dtype == np.bool_ and got.shape == (lb,)
    assert np.array_equal(got, want)


def test_membership_near_int32_max_matches_pallas():
    base, others = _case(9, 600, 2, 500, hi=300, near_max=True)
    assert base[base != SENTINEL].max() >= BIG - 300
    assert np.array_equal(_port(base, others), _pallas(base, others))


def test_membership_sentinel_rows_and_base_entries():
    """An all-SENTINEL other row matches nothing; SENTINEL base entries
    never match, although every other row holds SENTINEL padding."""
    base = np.array([3, 5, BIG, SENTINEL, SENTINEL], np.int32)
    full = np.array([[3, 5, BIG, SENTINEL], [3, BIG, SENTINEL, SENTINEL]],
                    np.int32)
    want = _pallas(base, full)
    assert want.tolist() == [True, False, True, False, False]
    assert np.array_equal(_port(base, full), want)
    empty_row = np.vstack([full, np.full((1, 4), SENTINEL, np.int32)])
    assert not _pallas(base, empty_row).any()
    assert not _port(base, empty_row).any()


def test_membership_without_others_keeps_real_base():
    base = np.array([1, 4, SENTINEL], np.int32)
    others = np.zeros((0, 8), np.int32)
    want = np.asarray(ref_setops.intersect_mask_many(jnp.asarray(base),
                                                     jnp.asarray(others)))
    assert want.tolist() == [True, True, False]
    assert np.array_equal(_port(base, others), want)


def test_plain_version_is_intersect_mask_many():
    base, others = _case(4, 900, 3, 700)
    got = intersect_mask_many(torch.from_numpy(base), torch.from_numpy(others))
    want = ref_setops.intersect_mask_many(jnp.asarray(base),
                                          jnp.asarray(others))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sizes", [(700, 350, 900), (40, 1024), (1, 5, 3),
                                   (600,)])
def test_intersect_sorted_matches_pallas(sizes):
    r = np.random.default_rng(len(sizes))
    arrays = [np.unique(r.integers(0, 2000, size=n)).astype(np.int64)
              for n in sizes]
    want = intersect_sorted_pallas(arrays, interpret=True)
    got = device_intersect_sorted(arrays, device="cpu")
    assert got.dtype == np.int64
    assert np.array_equal(got, want)
    folded = arrays[0]
    for a in arrays[1:]:
        folded = np.intersect1d(folded, a)
    assert np.array_equal(got, folded)


def test_cpu_wrapper_counts_no_launch():
    base, others = _case(5, 300, 2, 200)
    before = membership_mask.launches
    _port(base, others)
    device_intersect_sorted([base[base != SENTINEL],
                             others[0][others[0] != SENTINEL]], device="cpu")
    assert membership_mask.launches == before


def test_membership_rejects_bad_inputs():
    base = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        membership_mask(base.long(), torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        membership_mask(base, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        membership_mask(base[None], torch.zeros((1, 4), dtype=torch.int32))
    for bad in ([1, int(SENTINEL)], [-1, 3], [4, 2], [2, 2, 5]):
        with pytest.raises(ValueError, match="ascending"):
            device_intersect_sorted([np.array(bad), np.array([1, 2, 3])],
                                    device="cpu")
