"""Port value index vs the reference: the sorted device columns of
``hypergraphdb_tpu_torch.storage.value_index`` and the range, top-k and
range-lane functions of ``hypergraphdb_tpu_torch.ops.value_index`` against
``hypergraphdb_tpu.storage.value_index``, ``hypergraphdb_tpu.ops.value_index``
and the runtime's ``_dummy_inc_csr`` on the same host arrays, and against a
numpy oracle. Columns: random ranks with heavy ties settled by the second
word, a base and a delta (empty or not). Batches: ascending and descending
lanes, type and anchor filters, covered and uncovered windows, open bounds
and pad lanes. The port runs on the CPU. Tolerance: exact equality
(integers), rank words compared through ``reference_words``."""

import bisect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypergraphdb_tpu.ops import value_index as rv
from hypergraphdb_tpu.ops.snapshot import CSRSnapshot as JaxSnapshot
from hypergraphdb_tpu.serve.runtime import _dummy_inc_csr as ref_dummy_csr
from hypergraphdb_tpu.storage import value_index as rvs
from hypergraphdb_tpu_torch.ops import value_index as pv
from hypergraphdb_tpu_torch.ops.snapshot import reference_words
from hypergraphdb_tpu_torch.storage import value_index as pvs
from tests.test_torch_snapshot import to_port
from tests.test_torch_value_columns import valued_graph

U64_MAX = 2**64 - 1
N_TYPES = 4


def random_world(seed: int, n_nodes: int = 150, n_links: int = 250):
    """A reference snapshot with random types (some dead atoms), zipf
    link targets and tie-heavy value ranks of one kind, and its port."""
    r = np.random.default_rng(seed)
    N = n_nodes + n_links
    type_of = r.integers(0, N_TYPES, size=N).astype(np.int32)
    type_of[r.random(N) < 0.05] = -1
    is_link = np.zeros(N, dtype=bool)
    is_link[n_nodes:] = True
    offsets = np.zeros(N + 1, dtype=np.int64)
    offsets[n_nodes + 1:] = np.cumsum(r.integers(1, 5, size=n_links))
    flat = r.zipf(1.4, size=int(offsets[-1])) % n_nodes
    # a few distinct first words, high bits included, so ranks tie often
    firsts = np.asarray([0, 1, 7, 2**32 - 1, 2**32, 2**40 + 3, 2**63,
                         2**63 + 5, U64_MAX - 1], np.uint64)
    ranks = r.choice(firsts, size=N)
    ranks2 = r.integers(0, 3, size=N).astype(np.uint64)
    ranks2[r.random(N) < 0.1] = np.uint64(U64_MAX)
    ref = JaxSnapshot.from_tables(
        type_of, is_link, offsets, flat, value_rank=ranks,
        value_kind=np.full(N, ord("s"), np.uint8), value_rank2=ranks2,
        value_ambig=np.zeros(N, bool))
    return ref, to_port(ref)


def both_columns(gids, ranks, ranks2, minimum=128, **kw):
    ref = rvs._sorted_device_column(ord("s"), ranks, gids, minimum=minimum,
                                    ranks2=ranks2, **kw)
    port = pvs._sorted_device_column(ord("s"), ranks, gids, minimum=minimum,
                                     ranks2=ranks2, device="cpu", **kw)
    return ref, port


def assert_same_column(ref, port):
    assert (ref.kind, ref.n, ref.epoch, ref.covered, ref.device_exact) == (
        port.kind, port.n, port.epoch, port.covered, port.device_exact)
    for words, hi, lo in ((port.rank, ref.rank_hi, ref.rank_lo),
                          (port.rank2, ref.rank2_hi, ref.rank2_lo)):
        assert words.dtype == torch.int64
        got_hi, got_lo = reference_words(words.numpy())
        assert np.array_equal(got_hi, np.asarray(hi))
        assert np.array_equal(got_lo, np.asarray(lo))
    assert port.gids.dtype == torch.int32
    assert np.array_equal(port.gids.numpy(), np.asarray(ref.gids))


def ref_col(c):
    return (c.rank_hi, c.rank_lo, c.rank2_hi, c.rank2_lo, c.gids,
            jnp.int32(c.n))


def ref_bounds(b: dict):
    """The reference's per-lane bound arrays of the port's host bounds."""
    out = []
    for side in ("lo", "hi"):
        for k in (side, side + "2"):
            out += [jnp.asarray(w) for w in reference_words(b[k])]
        out.append(jnp.asarray(b[side + "_right"]))
    return out + [jnp.asarray(b["type_vec"]), jnp.asarray(b["anchor"]),
                  jnp.asarray(b["desc"])]


def port_bounds(b: dict):
    return [torch.from_numpy(np.ascontiguousarray(b[k]))
            for k in pv.BOUND_KEYS]


def assert_same_out(r, t):
    for a, b in zip(r, t):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype
        assert np.array_equal(a, b.numpy())


def random_bounds(r, ranks, n_real, n_lanes, n_nodes):
    """Host bounds of ``n_real`` random requests in ``n_lanes`` lanes:
    bounds at and beside real ranks, open ends, both sides, filters."""
    pick = r.choice(ranks, size=(n_real, 2))
    lo, hi = np.sort(pick, axis=1).T.astype(np.uint64)
    open_lo = r.random(n_real) < 0.15
    open_hi = r.random(n_real) < 0.15
    lo[open_lo] = 0
    hi[open_hi] = U64_MAX
    lo2 = r.integers(0, 3, size=n_real).astype(np.uint64)
    hi2 = r.integers(0, 3, size=n_real).astype(np.uint64)
    lo2[open_lo] = 0
    hi2[open_hi] = U64_MAX
    lo_right = r.random(n_real) < 0.5
    hi_right = r.random(n_real) < 0.5
    lo_right[open_lo] = False
    hi_right[open_hi] = True
    type_vec = np.where(r.random(n_real) < 0.4,
                        r.integers(0, N_TYPES, size=n_real), -1)
    anchor = np.where(r.random(n_real) < 0.4,
                      r.integers(0, n_nodes, size=n_real), -1)
    desc = r.random(n_real) < 0.5
    return pv.lane_bounds(n_lanes, lo, lo_right, hi, hi_right, lo2=lo2,
                          hi2=hi2, type_vec=type_vec, anchor=anchor,
                          desc=desc)


def oracle(snap, entries, b: dict, lane: int):
    """Every entry of ``entries`` (gid, rank, rank2) in the lane's window
    and filters, in the requested order: ranks ascending (descending for
    ``desc``), gid ascending within full ties."""
    lo = (int(np.int64(b["lo"][lane])) + 2**63,
          int(np.int64(b["lo2"][lane])) + 2**63)
    hi = (int(np.int64(b["hi"][lane])) + 2**63,
          int(np.int64(b["hi2"][lane])) + 2**63)
    th, anchor = int(b["type_vec"][lane]), int(b["anchor"][lane])
    row = set(snap.incidence_row(anchor).tolist()) if anchor >= 0 else None
    keep = []
    for gid, rank, rank2 in entries:
        key = (rank, rank2)
        if (key <= lo if b["lo_right"][lane] else key < lo):
            continue
        if (key > hi if b["hi_right"][lane] else key >= hi):
            continue
        if th >= 0 and snap.type_of[gid] != th:
            continue
        if row is not None and gid not in row:
            continue
        keep.append((rank, rank2, gid))
    if b["desc"][lane]:
        keep.sort(key=lambda e: (-e[0], -e[1], e[2]))
    else:
        keep.sort()
    return [g for _, _, g in keep]


# ---------------------------------------------------------------- columns


@pytest.mark.parametrize("minimum", [32, 128])
@pytest.mark.parametrize("n", [0, 1, 100, 300])
def test_column_layout_matches_reference(n, minimum):
    r = np.random.default_rng(n)
    gids = r.permutation(10 * n + 1)[:n]
    ranks = r.choice(np.asarray([0, 5, 2**33, 2**63, U64_MAX], np.uint64),
                     size=n)
    ranks2 = r.integers(0, 4, size=n).astype(np.uint64)
    ref, port = both_columns(gids, ranks, ranks2, minimum=minimum, epoch=3,
                             covered=n + 2)
    assert_same_column(ref, port)
    assert port.rank.shape[0] == max(minimum, 1 << max(n - 1, 0).bit_length())
    ref0 = rvs._sorted_device_column(ord("i"), ranks, gids)
    port0 = pvs._sorted_device_column(ord("i"), ranks, gids, device="cpu")
    assert_same_column(ref0, port0)
    assert port0.device_exact and not port.device_exact


def test_value_index_column_of_a_valued_graph():
    g = valued_graph()
    try:
        snap = g.snapshot()
        port = to_port(snap)
        N = port.num_atoms
        kinds = sorted(set(port.value_kind[:N].tolist()))
        for kind in kinds:
            ref = rvs.value_index_column(snap, kind)
            got = pvs.value_index_column(port, kind, "cpu")
            assert_same_column(ref, got)
            assert pvs.value_index_column(port, kind, "cpu") is got
            live = (port.value_kind[:N] == kind) & (port.type_of[:N] >= 0)
            assert np.array_equal(np.sort(got.gids.numpy()[: got.n]),
                                  np.flatnonzero(live))
        assert not pvs.value_index_column(port, ord("s"), "cpu").device_exact
        assert pvs.value_index_column(port, ord("i"), "cpu").device_exact
    finally:
        g.close()


def test_device_twins_of_the_range_lane():
    ref, port = random_world(4)
    t = pvs.type_of_device(port, "cpu")
    off, links = pvs.inc_csr_device(port, "cpu")
    assert not getattr(port, "_device_twins", None)   # no full twin forced
    assert np.array_equal(t.numpy(), port.type_of)
    assert np.array_equal(off.numpy(), port.inc_offsets)
    assert np.array_equal(links.numpy(), port.inc_links)
    assert pvs.type_of_device(port, "cpu") is t


# ---------------------------------------------------------------- probes


def test_range_probe_batch_matches_reference_and_bisect():
    """``tests/test_value_index.py``'s kernel differential, through both
    packages: duplicates, first-word ties, both column ends."""
    r = np.random.default_rng(9)
    ranks = np.sort(r.integers(0, 1 << 40, size=100).astype(np.uint64))
    ranks[10:15] = ranks[10]
    ranks2 = r.integers(0, 1 << 40, size=100).astype(np.uint64)
    ranks2[10:15] = np.sort(ranks2[10:15])
    ranks2[12] = ranks2[11]
    gids = np.arange(100)
    ref, port = both_columns(gids, ranks, ranks2)
    assert_same_column(ref, port)
    pairs = sorted(zip(ranks.tolist(), ranks2.tolist()))
    qi = [0, 10, 12, 50, 99]
    q = np.concatenate([np.sort(ranks)[qi],
                        np.asarray([0, 1 << 63], np.uint64)])
    q2 = np.concatenate([np.asarray([p[1] for p in pairs], np.uint64)[qi],
                         np.asarray([0, 0], np.uint64)])
    for right in (False, True):
        sides = np.full(len(q), right)
        b = pv.lane_bounds(len(q), q, sides, q, sides, lo2=q2, hi2=q2)
        rb = ref_bounds(b)
        lo_r, hi_r = rv.range_probe_batch(*ref_col(ref)[:4],
                                          jnp.int32(ref.n), *rb[:10])
        lo_t, hi_t = pv.range_probe_batch(port, *port_bounds(b)[:6])
        fn = bisect.bisect_right if right else bisect.bisect_left
        want = np.asarray([fn(pairs, (int(a), int(c))) for a, c in zip(q, q2)],
                          dtype=np.int32)
        for a, t in ((lo_r, lo_t), (hi_r, hi_t)):
            assert t.dtype == torch.int32
            assert np.array_equal(np.asarray(a), t.numpy())
            assert np.array_equal(t.numpy(), want)


# ---------------------------------------------------------------- top-k


@pytest.mark.parametrize("delta", ["empty", "split"])
@pytest.mark.parametrize("win_pad,top_r", [(8, 4), (16, 16), (32, 8)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ordered_topk_matches_reference_and_oracle(seed, win_pad, top_r,
                                                   delta):
    ref_snap, port = random_world(seed)
    r = np.random.default_rng(100 + seed)
    N = port.num_atoms
    live = np.flatnonzero(port.type_of[:N] >= 0)
    if delta == "split":
        in_delta = r.random(len(live)) < 0.3
        base_ids, delta_ids = live[~in_delta], live[in_delta]
    else:
        base_ids, delta_ids = live, live[:0]
    cols = [both_columns(ids, port.value_rank[ids], port.value_rank2[ids],
                         minimum=m)
            for ids, m in ((base_ids, 128), (delta_ids, 32))]
    for ref_c, port_c in cols:
        assert_same_column(ref_c, port_c)
    (rb, pb), (rd, pd) = cols
    n_lanes, n_real = 64, 57
    b = random_bounds(r, port.value_rank[live], n_real, n_lanes, 150)
    want = rv.ordered_topk_batch(
        *ref_col(rb), *ref_col(rd), jnp.asarray(ref_snap.type_of),
        jnp.asarray(ref_snap.inc_offsets), jnp.asarray(ref_snap.inc_links),
        *ref_bounds(b), win_pad=win_pad, top_r=top_r)
    dev = port.device("cpu")
    got = pv.ordered_topk_batch(pb, pd, dev.type_of, dev.inc_offsets,
                                dev.inc_links, *port_bounds(b),
                                win_pad=win_pad, top_r=top_r)
    assert_same_out(want, got)
    counts, first_r, covered, total = (x.numpy() for x in got)
    entries = [(int(g), int(port.value_rank[g]), int(port.value_rank2[g]))
               for g in live]
    filtered = (b["type_vec"] >= 0) | (b["anchor"] >= 0)
    seen = set()
    for lane in range(n_lanes):
        truth = oracle(port, entries, b, lane)
        head = first_r[lane][first_r[lane] != np.iinfo(np.int32).max]
        if lane >= n_real:
            assert total[lane] == 0 and counts[lane] == 0 and covered[lane]
        if not filtered[lane]:
            assert total[lane] == len(truth)
        if covered[lane]:
            assert head.tolist() == truth[: len(head)]
            assert len(head) == min(len(truth), top_r)
            assert counts[lane] == len(truth)
        elif not filtered[lane]:
            # an uncovered window is the value-ordered prefix; a rank tie
            # across the gathered end keeps the gids the gather reached
            # (the largest of the tie on descending lanes), as in the
            # reference
            assert len(head) == min(len(truth), top_r)
            value = lambda g: (int(port.value_rank[g]),  # noqa: E731
                               int(port.value_rank2[g]))
            assert [value(g) for g in head] == [value(g)
                                                for g in truth[: len(head)]]
        seen.add((bool(covered[lane]), bool(b["desc"][lane]),
                  bool(filtered[lane])))
    assert len(seen) >= 6   # covered and not, both orders, filters or not


def test_win_pad_below_top_r_raises():
    _, port = random_world(1)
    col = pvs.value_index_column(port, ord("s"), "cpu")
    dev = port.device("cpu")
    b = port_bounds(pv.lane_bounds(4, [0], [False], [U64_MAX], [True]))
    with pytest.raises(ValueError, match="win_pad"):
        pv.ordered_topk_batch(col, col, dev.type_of, dev.inc_offsets,
                              dev.inc_links, *b, win_pad=8, top_r=16)


# ---------------------------------------------------------------- the lane


@pytest.mark.parametrize("anchored", [False, True])
def test_serve_range_batch_matches_the_runtime_dispatch(anchored):
    """The runtime's dispatch: the dummy CSR on an anchor-free batch (the
    probe reads past its two entries in the reference, clamped), the
    snapshot's CSR otherwise; ``win_pad`` from ``_range_win_pad``."""
    ref_snap, port = random_world(7)
    r = np.random.default_rng(8)
    N = port.num_atoms
    live = np.flatnonzero(port.type_of[:N] >= 0)
    cut = len(live) - 40
    (rb, pb), (rd, pd) = (
        both_columns(ids, port.value_rank[ids], port.value_rank2[ids],
                     minimum=m)
        for ids, m in ((live[:cut], 128), (live[cut:], 32)))
    b = random_bounds(r, port.value_rank[live], 50, 64, 150)
    if not anchored:
        b["anchor"][:] = -1
    top_r = 16
    win_pad = pv.range_win_pad(top_r)
    assert win_pad == 16 and pv.range_win_pad(3) == 8
    if anchored:
        inc = (jnp.asarray(ref_snap.inc_offsets),
               jnp.asarray(ref_snap.inc_links))
    else:
        inc = ref_dummy_csr()
    want = rv.ordered_topk_batch(
        *ref_col(rb), *ref_col(rd), jnp.asarray(ref_snap.type_of), *inc,
        *ref_bounds(b), win_pad=win_pad, top_r=top_r)
    got = pv.serve_range_batch(port, pb, pd, b, top_r=top_r, device="cpu")
    assert_same_out(want, got)
    # the dummy CSR changes nothing on an anchor-free batch
    dev = port.device("cpu")
    full = pv.ordered_topk_batch(pb, pd, dev.type_of, dev.inc_offsets,
                                 dev.inc_links, *port_bounds(b),
                                 win_pad=win_pad, top_r=top_r)
    assert_same_out([x.numpy() for x in full], got)


def test_serve_range_batch_refuses_outside_anchors():
    _, port = random_world(2)
    col = pvs.value_index_column(port, ord("s"), "cpu")
    for bad in (port.num_atoms, port.num_atoms + 5):
        b = pv.lane_bounds(8, [0], [False], [U64_MAX], [True], anchor=[bad])
        with pytest.raises(ValueError, match="anchors"):
            pv.serve_range_batch(port, col, col, b, device="cpu")
    with pytest.raises(ValueError, match="lanes"):
        pv.lane_bounds(1, [0, 1], [False] * 2, [1, 2], [True] * 2)
