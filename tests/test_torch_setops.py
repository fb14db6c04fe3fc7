"""The port's sorted-set operators against ``hypergraphdb_tpu.ops.setops`` on
the same inputs: the same generated snapshot goes to both packages through
``CSRSnapshot.from_reference_arrays``. Ids, masks and counts are integers,
so the tolerance is exact equality."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from hypergraphdb_tpu.models.generators import dbpedia_snapshot as jax_dbpedia
from hypergraphdb_tpu.ops import setops as S
from hypergraphdb_tpu.ops.snapshot import CSRSnapshot as JaxSnapshot
from hypergraphdb_tpu_torch.ops import setops
from hypergraphdb_tpu_torch.ops.setops import SENTINEL, pad_sorted
from tests.test_torch_snapshot import to_port


@pytest.fixture(scope="module")
def dbp():
    ref, info = jax_dbpedia(n_entities=3000, n_links=12000)
    port = to_port(ref)
    th = max(info["property_types"], key=lambda t: len(ref.type_set(t)))
    return ref, port, info, int(th)


def c3_pairs(snap, th, k, seed=42):
    """Anchor pairs that co-occur in a link of type ``th`` (bench c3's
    traffic): the first two targets of ``k`` random such links."""
    r = np.random.default_rng(seed)
    cands = snap.type_set(th)
    links = cands[r.integers(0, len(cands), size=k)].astype(np.int64)
    starts = snap.tgt_offsets[links].astype(np.int64)
    return np.stack([snap.tgt_flat[starts], snap.tgt_flat[starts + 1]],
                    axis=1).astype(np.int32)


def hubs(snap, n):
    """The ``n`` atoms with the longest incidence rows, longest first."""
    deg = np.diff(snap.inc_offsets[: snap.num_atoms + 1])
    return np.argsort(-deg, kind="stable")[:n].astype(np.int32)


def smallest_first(snap, anchors):
    off = snap.inc_offsets
    lens = off[anchors + 1] - off[anchors]
    order = np.argsort(lens, axis=1, kind="stable")
    anchors = np.take_along_axis(anchors, order, axis=1)
    return anchors, S._bucket(int(lens.min(axis=1).max()))


def host_pattern(snap, anchors, th):
    """Numpy truth: the anchors' incidence rows intersected, then filtered
    by type."""
    out = []
    for a in anchors:
        rows = [snap.incidence_row(int(x)) for x in a]
        got = rows[0]
        for row in rows[1:]:
            got = np.intersect1d(got, row)
        if th is not None:
            got = got[snap.type_of[got] == th]
        out.append(got.astype(np.int64))
    return out


def _mixed_anchors(snap, th, P):
    """c3 pairs, hub pairs (larger base buckets; a hub with itself has
    many matches of every type) and anchors with no common link, widened
    to P anchors by a hub."""
    pairs = c3_pairs(snap, th, 40)
    h = hubs(snap, 3)
    extra = np.array([[h[0], h[1]], [h[1], h[2]], [h[1], h[1]], [5, 900]],
                     np.int32)
    anchors = np.concatenate([pairs, extra])
    if P == 3:
        third = np.where(np.arange(len(anchors)) % 2 == 0, h[0], anchors[:, 1])
        anchors = np.concatenate([anchors, third[:, None]], axis=1)
    return anchors.astype(np.int32)


# ------------------------------------------------------------------ 1-D ops


def test_member_mask_edges():
    ref = pad_sorted(np.asarray([2, 5, 9], np.int32), 8)
    q = pad_sorted(np.asarray([1, 2, 9, 10], np.int32), 8)
    want = np.asarray(S.member_mask(jnp.asarray(ref), jnp.asarray(q)))
    got = setops.member_mask(torch.from_numpy(ref), torch.from_numpy(q))
    assert got.numpy().tolist() == want.tolist()
    assert got.numpy()[:4].tolist() == [False, True, True, False]
    assert not got.numpy()[4:].any()  # padding never matches


def test_member_mask_random_matches_reference():
    r = np.random.default_rng(1)
    ref = pad_sorted(np.unique(r.integers(0, 500, 200)).astype(np.int32), 256)
    q = r.integers(0, 520, 300).astype(np.int32)
    q[::7] = SENTINEL
    want = np.asarray(S.member_mask(jnp.asarray(ref), jnp.asarray(q)))
    got = setops.member_mask(torch.from_numpy(ref), torch.from_numpy(q))
    assert np.array_equal(got.numpy(), want) and want.any()


@pytest.mark.parametrize("m", [0, 1, 3])
def test_intersect_mask_many_matches_reference(m):
    r = np.random.default_rng(m)
    base = pad_sorted(np.unique(r.integers(0, 300, 150)).astype(np.int32), 256)
    others = np.stack([
        pad_sorted(np.unique(r.integers(0, 300, 200)).astype(np.int32), 512)
        for _ in range(m)]) if m else np.zeros((0, 512), np.int32)
    want = np.asarray(S.intersect_mask_many(jnp.asarray(base),
                                            jnp.asarray(others)))
    got = setops.intersect_mask_many(torch.from_numpy(base),
                                     torch.from_numpy(others))
    assert np.array_equal(got.numpy(), want)


def test_segment_member_mask_matches_reference(dbp):
    ref, port, _, _ = dbp
    r = np.random.default_rng(2)
    atoms = np.concatenate([hubs(port, 4), r.integers(65, 3065, 12)])
    atoms = atoms.astype(np.int32)
    off = port.inc_offsets
    starts, ends = off[atoms], off[atoms + 1]
    probe = r.integers(0, port.num_atoms, size=len(atoms))
    queries = np.stack([
        pad_sorted(np.union1d(port.incidence_row(int(p))[:40],
                              port.incidence_row(int(a))[::3][:40]), 96)
        for p, a in zip(probe, atoms)]).astype(np.int32)
    want = np.asarray(S.segment_member_mask(
        jnp.asarray(ref.inc_links), jnp.asarray(starts), jnp.asarray(ends),
        jnp.asarray(queries)))
    got = setops.segment_member_mask(
        torch.from_numpy(port.inc_links), torch.from_numpy(starts),
        torch.from_numpy(ends), torch.from_numpy(queries))
    assert np.array_equal(got.numpy(), want) and want.any()


@pytest.mark.parametrize("pad", [64, 2048])
def test_gather_rows_matches_reference(dbp, pad):
    ref, port, _, _ = dbp
    atoms = np.concatenate([hubs(port, 2), [7, 100, 2000, port.num_atoms]])
    atoms = atoms.astype(np.int32)
    want_rows, want_valid = S.gather_rows(
        jnp.asarray(ref.inc_offsets), jnp.asarray(ref.inc_links),
        jnp.asarray(atoms), pad)
    rows, valid = setops.gather_rows(
        torch.from_numpy(port.inc_offsets), torch.from_numpy(port.inc_links),
        torch.from_numpy(atoms), pad)
    assert np.array_equal(rows.numpy(), np.asarray(want_rows))
    assert np.array_equal(valid.numpy(), np.asarray(want_valid))


# ------------------------------------------------------------------ pattern


@pytest.mark.parametrize("route", ["gathered", "ell", "zigzag"])
@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("P", [2, 3])
def test_incident_intersection_matches_reference(dbp, route, typed, P):
    ref, port, _, th = dbp
    anchors, pad = smallest_first(port, _mixed_anchors(port, th, P))
    t = th if typed else None
    jt = jnp.int32(th) if typed else None
    a_j, a_t = jnp.asarray(anchors), torch.from_numpy(anchors)
    dev = port.device("cpu")
    if route == "gathered":
        want = S.incident_intersection(ref.device, a_j, pad, jt)
        got = setops.incident_intersection(dev, a_t, pad, t)
    elif route == "ell":
        want = S.incident_intersection_ell(ref.device, S.ell_targets(ref),
                                           a_j, pad, jt)
        got = setops.incident_intersection_ell(
            dev, setops.ell_targets(port, "cpu"), a_t, pad, t)
    else:
        want = S.incident_intersection_zigzag(ref.device, a_j, pad, jt)
        got = setops.incident_intersection_zigzag(dev, a_t, pad, t)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].numpy().any()


def test_ell_streams_in_query_blocks(dbp, monkeypatch):
    """A block budget below one query's gather gives the same result."""
    _, port, _, th = dbp
    anchors, pad = smallest_first(port, _mixed_anchors(port, th, 3))
    a_t, dev = torch.from_numpy(anchors), port.device("cpu")
    ell = setops.ell_targets(port, "cpu")
    whole = setops.incident_intersection_ell(dev, ell, a_t, pad, th)
    monkeypatch.setattr(setops, "ELL_BLOCK_BYTES", 1)
    blocked = setops.incident_intersection_ell(dev, ell, a_t, pad, th)
    assert torch.equal(whole[0], blocked[0])
    assert torch.equal(whole[1], blocked[1])


def test_ell_targets_matches_reference_and_is_cached(dbp):
    ref, port, _, _ = dbp
    ell = setops.ell_targets(port, "cpu")
    assert ell.dtype == torch.int32 and ell.shape == (port.num_atoms + 1, 16)
    assert np.array_equal(ell.numpy(), np.asarray(S.ell_targets(ref)))
    assert setops.ell_targets(port, "cpu") is ell


def _wide_snapshot():
    """80 nodes, one link over all of them (wider than the ELL cap) and
    two short links."""
    n = 80
    N = n + 3
    type_of = np.zeros(N, np.int32)
    type_of[n:] = [1, 2, 1]
    is_link = np.zeros(N, bool)
    is_link[n:] = True
    flat = np.concatenate([np.arange(n), [0, 1], [0, 2]]).astype(np.int32)
    offsets = np.zeros(N + 1, np.int64)
    offsets[n + 1 :] = np.cumsum([n, 2, 2])
    return JaxSnapshot.from_tables(type_of, is_link, offsets, flat)


def test_ell_width_cap_takes_zigzag_route():
    ref = _wide_snapshot()
    port = to_port(ref)
    assert S.ell_targets(ref) is None
    assert setops.ell_targets(port, "cpu") is None
    plan = setops.plan_pattern(port, [(0, 1), (0, 2), (3, 4)], device="cpu")
    assert not plan.use_ell
    results = {}
    for th in (None, 1):
        want = S.and_incident_pattern(ref, [(0, 1), (0, 2), (3, 4)], th)
        got = setops.and_incident_pattern(port, [(0, 1), (0, 2), (3, 4)], th,
                                          device="cpu")
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
        results[th] = [g.tolist() for g in got]
    assert results[None] == [[80, 81], [80, 82], [80]]
    assert results[1] == [[80], [80, 82], [80]]


@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("top_r", [16, 1])
def test_plan_execute_collect_matches_reference(dbp, typed, top_r):
    """A query with more matches than ``top_r`` (a hub with itself) sends
    its bucket through the full-mask re-run."""
    ref, port, _, th = dbp
    anchors = _mixed_anchors(port, th, 2)
    t = th if typed else None
    plan = setops.plan_pattern(port, anchors, t, device="cpu")
    ref_plan = S.plan_pattern(ref, anchors, t)
    assert [(s.tolist(), p) for s, _, p in plan.buckets] == \
        [(s.tolist(), p) for s, _, p in ref_plan.buckets]
    pending = setops.execute_pattern(plan, top_r=top_r)
    ref_pending = S.execute_pattern(ref_plan, top_r=top_r)
    for (_, c, f), (_, rc, rf) in zip(pending, ref_pending):
        assert np.array_equal(c.numpy(), np.asarray(rc))
        assert np.array_equal(f.numpy(), np.asarray(rf))
    got = setops.collect_pattern(plan, pending)
    want = S.collect_pattern(ref_plan, ref_pending)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    counts = np.concatenate([c.numpy() for _, c, _ in pending])
    if top_r == 1 or not typed:
        assert (counts > top_r).any()


@pytest.mark.parametrize("typed", [False, True])
def test_and_incident_pattern_matches_reference_and_host(dbp, typed):
    ref, port, _, th = dbp
    anchors = _mixed_anchors(port, th, 3)
    t = th if typed else None
    got = setops.and_incident_pattern(port, anchors, t, device="cpu")
    want = S.and_incident_pattern(ref, anchors, t)
    truth = host_pattern(port, anchors, t)
    for g, w, h in zip(got, want, truth):
        assert g.dtype == np.int64
        assert g.tolist() == w.tolist() == h.tolist()


# ------------------------------------------------------------------ intersection


def partner(snap, hub, ratio):
    """The atom that shares a link with ``hub`` whose incidence row is
    nearest ``ratio`` times as long as the hub's: the skewed intersection."""
    links = snap.incidence_row(int(hub))
    targets = np.unique(np.concatenate([
        snap.tgt_flat[snap.tgt_offsets[l] : snap.tgt_offsets[l + 1]]
        for l in links]))
    targets = targets[targets != hub]
    deg = snap.inc_offsets[targets + 1] - snap.inc_offsets[targets]
    want = ratio * len(links)
    return int(targets[np.argmin(np.abs(deg - want))])


@pytest.mark.parametrize("which", ["h1h2", "h1h2h3", "h1type", "disjoint",
                                   "skew"])
def test_device_intersect_sorted_matches_reference(dbp, which):
    ref, port, _, th = dbp
    h = hubs(port, 3)
    rows = [port.incidence_row(int(x)).astype(np.int64) for x in h]
    arrays = {
        "h1h2": rows[:2],
        "h1h2h3": rows,
        "h1type": [rows[0], port.type_set(th).astype(np.int64)],
        "disjoint": [rows[0], np.arange(3)],
        "skew": [port.incidence_row(partner(port, h[0], 0.02)), rows[0]],
    }[which]
    got = setops.device_intersect_sorted(arrays, device="cpu")
    want = S.device_intersect_sorted(arrays)
    folded = arrays[0]
    for a in arrays[1:]:
        folded = np.intersect1d(folded, a)
    assert got.dtype == np.int64
    assert np.array_equal(got, want)
    assert np.array_equal(got, folded)
    if which in ("h1h2", "h1type", "skew"):
        assert len(got) > 0


def test_device_intersect_sorted_short_cases():
    a = np.array([1, 2, 3])
    assert setops.device_intersect_sorted([a], device="cpu").tolist() == [1, 2, 3]
    got = setops.device_intersect_sorted([a, np.array([], np.int64)],
                                         device="cpu")
    assert got.dtype == np.int64 and got.size == 0
    with pytest.raises(ValueError):
        setops.device_intersect_sorted([], device="cpu")


@pytest.mark.parametrize("lens", [(), (300,), (1, 700, 40), (0, 90)])
def test_intersect_mask_ragged_equals_padded_form(lens):
    """K3's ragged plain version equals :func:`intersect_mask_many` on the
    same rows SENTINEL-padded to one length."""
    r = np.random.default_rng(len(lens))
    base = pad_sorted(np.unique(r.integers(0, 900, 400)).astype(np.int32), 512)
    rows = [np.unique(r.integers(0, 900, n)).astype(np.int32)[:n]
            for n in lens]
    offsets = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(x) for x in rows], out=offsets[1:])
    flat = np.concatenate(rows + [np.zeros(0, np.int32)]).astype(np.int32)
    padded = (np.stack([pad_sorted(x, 1024) for x in rows]) if rows
              else np.zeros((0, 1024), np.int32))
    want = setops.intersect_mask_many(torch.from_numpy(base),
                                      torch.from_numpy(padded))
    got = setops.intersect_mask_ragged(torch.from_numpy(base),
                                       torch.from_numpy(flat), offsets)
    assert torch.equal(got, want)


def test_intersection_mask_lays_out_odd_lengths():
    """The staging layout (offsets, base and rows each 16-byte aligned)
    keeps every array whole at odd lengths; the mask equals the fold of
    ``np.isin``."""
    r = np.random.default_rng(8)
    arrays = [np.unique(r.integers(0, 400, n)).astype(np.int64)
              for n in (13, 101, 57)]
    arrays.sort(key=len)
    base_t, mask = setops.intersection_mask(arrays, torch.device("cpu"))
    assert base_t.dtype == torch.int32
    assert base_t.numpy().tolist() == arrays[0].tolist()
    want = np.isin(arrays[0], arrays[1]) & np.isin(arrays[0], arrays[2])
    assert mask.numpy().tolist() == want.tolist()


def test_device_intersect_sorted_rejects_bad_shapes():
    with pytest.raises(ValueError, match="1-D"):
        setops.device_intersect_sorted([np.zeros((2, 2), np.int64),
                                        np.arange(4)], device="cpu")
