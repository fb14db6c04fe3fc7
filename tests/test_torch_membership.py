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
from hypergraphdb_tpu_torch.ops.membership import (
    membership_mask,
    membership_mask_ragged,
)
from hypergraphdb_tpu_torch.ops.setops import (
    SENTINEL,
    device_intersect_sorted,
    intersect_mask_many,
    intersect_mask_ragged,
    pad_sorted,
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
                                   (600,), (1000, 777, 1023), (129, 1021),
                                   (3, 999, 1017, 1001)])
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


# ------------------------------------------------------------------ ragged rows


def _ragged_case(seed, lb, lens, near_max=False, tail=0, disjoint_first=False):
    """A base of ``lb`` (its last ``tail`` entries SENTINEL) and ragged rows
    of the given real lengths, each drawn partly from the base. With
    ``disjoint_first`` the first row lies wholly above the base's values,
    so every flag clears at the first row."""
    r = np.random.default_rng(seed)
    span = 2 * (lb + max(lens, default=1)) + 8
    lo_v = BIG - span if near_max else 0
    hi_v = BIG + 1 if near_max else lo_v + span
    vals = np.unique(r.integers(lo_v, hi_v, size=lb - tail))
    base = np.full(lb, SENTINEL, np.int32)
    base[: len(vals)] = vals
    rows = []
    for j, n in enumerate(lens):
        if disjoint_first and j == 0:
            rows.append(np.arange(n, dtype=np.int32) + int(vals[-1]) + 1)
            continue
        pick = vals[r.random(len(vals)) < 0.6]
        extra = r.integers(lo_v, hi_v, size=n)
        rows.append(np.unique(np.concatenate([pick, extra]))[:n]
                    .astype(np.int32))
    return base, rows


def _flat(rows):
    offsets = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(x) for x in rows], out=offsets[1:])
    flat = (np.concatenate(rows) if rows else np.zeros(0)).astype(np.int32)
    return flat, offsets


@pytest.mark.parametrize("lb,lens,kw", [
    (700, (350, 600), {}),
    (20, (1024,), {}),                       # short base, long row
    (2048, (3, 1000), {}),                   # long base, tiny first row
    (900, (1024, 9, 512, 77, 1000), {}),     # M = 5, skewed lengths
    (500, (400, 0, 300), {}),                # an empty row
    (600, (500, 450), {"near_max": True}),   # values up to INT32_MAX - 1
    (1000, (800, 900), {"tail": 300}),       # a SENTINEL base tail
    (1500, (600, 700), {"disjoint_first": True}),
])
def test_ragged_matches_pallas_on_the_padded_form(lb, lens, kw):
    """The ragged plain version and the ragged entry on the CPU equal the
    Pallas kernel (interpret mode) on the same rows SENTINEL-padded to the
    longest, and the padded entry on the same padded rows."""
    base, rows = _ragged_case(lb + len(lens), lb, lens, **kw)
    flat, offsets = _flat(rows)
    lo = max(max(lens), 1)
    others = np.stack([pad_sorted(x, lo) for x in rows])
    want = _pallas(base, others)
    b, f = torch.from_numpy(base), torch.from_numpy(flat)
    plain = intersect_mask_ragged(b, f, offsets)
    got = membership_mask_ragged(b, f, torch.from_numpy(offsets))
    assert got.dtype == torch.bool and got.shape == (lb,)
    assert np.array_equal(plain.numpy(), want)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(_port(base, others), want)
    if kw.get("disjoint_first") or 0 in lens:
        assert not want.any()
    else:
        assert want.any()


def test_ragged_without_rows_keeps_real_base():
    base = np.array([1, 4, 9, SENTINEL], np.int32)
    want = np.asarray(ref_setops.intersect_mask_many(
        jnp.asarray(base), jnp.zeros((0, 4), jnp.int32)))
    got = membership_mask_ragged(torch.from_numpy(base),
                                 torch.zeros(0, dtype=torch.int32),
                                 torch.zeros(1, dtype=torch.int64))
    assert want.tolist() == [True, True, True, False]
    assert np.array_equal(got.numpy(), want)


def test_ragged_entry_counts_no_launch_on_the_cpu():
    base, rows = _ragged_case(3, 300, (200, 100))
    flat, offsets = _flat(rows)
    before = membership_mask.launches
    membership_mask_ragged(torch.from_numpy(base), torch.from_numpy(flat),
                           torch.from_numpy(offsets))
    assert membership_mask.launches == before


@pytest.mark.parametrize("offsets,match", [
    ([0, 3, 2, 5], "never decrease"),        # not monotone
    ([0, 2, 4], "never decrease"),           # ends short of flat
    ([0, 2, 6], "never decrease"),           # ends past flat
    ([-1, 2, 5], "never decrease"),          # starts below 0
    ([], "non-empty"),
])
def test_ragged_rejects_bad_offsets(offsets, match):
    base = torch.tensor([1, 2, 3], dtype=torch.int32)
    flat = torch.arange(5, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        membership_mask_ragged(base, flat,
                               torch.tensor(offsets, dtype=torch.int64))


def test_ragged_rejects_bad_types():
    base = torch.tensor([1, 2, 3], dtype=torch.int32)
    flat = torch.arange(5, dtype=torch.int32)
    offsets = torch.tensor([0, 5], dtype=torch.int64)
    with pytest.raises(ValueError, match="offsets must be"):
        membership_mask_ragged(base, flat, offsets.int())
    with pytest.raises(ValueError, match="flat must be"):
        membership_mask_ragged(base, flat.long(), offsets)
    with pytest.raises(ValueError, match="base must be"):
        membership_mask_ragged(base[None], flat, offsets)
    with pytest.raises(ValueError, match="entries"):
        membership_mask_ragged(base, flat, offsets,
                               offsets_host=np.array([0, 2, 5]))
