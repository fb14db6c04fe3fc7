"""The metric arithmetic: rates over the whole window, the roofline's
bytes, the busy union, the idle share and the per-layer readers; and the
comparisons that decide ``correct``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hgbench import judge, spec, trace
from hgbench.roofline import bound_ms, k2

closed = spec.load_module(spec.HERE / "runners" / "serve_closed.py")


def test_rate_counts_only_answers_inside_the_window():
    nan = float("nan")
    done = np.asarray([0.5, 1.0, 1.0001, nan, 0.2, 2.0, 0.3])
    out = np.asarray([closed.OK] * 6 + [closed.ERROR], dtype=np.int8)
    out[3] = closed.PENDING
    assert closed.answered_by(done, out, 1.0) == 3
    assert closed.answered_by(done, out, 10.0) == 5
    assert closed.answered_by(done[:0], out[:0], 1.0) == 0


def test_comparisons_count_each_wrong_answer():
    assert judge.lanes([3, 4, 5], [10, 20, 30], [3, 4, 6], [10, 21, 30]) \
        == [("lanes_wrong", 2, 0)]
    want = np.asarray([0b0110, 0b1000, 0], dtype=np.uint64)
    got = np.asarray([0b0111, 0b1000, 1 << 63], dtype=np.uint64)
    assert judge.reach_sets(want, want) == [("reach_sets_wrong", 0, 0)]
    assert judge.reach_sets(got, want) == [("reach_sets_wrong", 2, 0)]
    sets = [np.arange(3), np.arange(20), np.arange(17)]
    given = judge.served_as(sets, 16)
    assert judge.answers(given, sets, 16) == [("answers_wrong", 0, 0)]
    bad = [given[0], (20, False, given[1][2]), (17, True, given[2][2] + 1)]
    assert judge.answers(bad, sets, 16) == [("answers_wrong", 2, 0)]


@pytest.mark.parametrize("width,group,per", [(4096, 32, 2), (4096, 64, 1),
                                             (64, 32, 2), (100, 32, 3)])
def test_spread_lanes_cover_every_group(width, group, per):
    from hgbench import traffic

    lanes = traffic.spread_lanes(2**31 + 1, width, group, per, 5)
    assert len(np.unique(lanes)) == len(lanes)
    assert lanes.min() >= 0 and lanes.max() < width
    counts = np.bincount(lanes // group, minlength=-(-width // group))
    assert counts.min() >= 1 and counts.max() <= per


def test_union_and_idle_share():
    ops = [("a", 0.0, 100.0), ("b", 50.0, 150.0), ("c", 300.0, 400.0),
           ("d", 310.0, 320.0)]
    assert trace.union_s(ops) == pytest.approx(250e-6)
    tr = trace.Trace(ops=sorted(ops, key=lambda o: o[1]), host=[],
                     window_s=500e-6, busy_s=trace.union_s(ops))
    assert tr.gaps() == [(150.0, 300.0)]
    ctx = SimpleNamespace(trace=tr, counters={}, spans={})
    for name in ("device.idle_share.bfs", "device.idle_share.served"):
        assert spec.load_reader(name)(ctx) == pytest.approx(50.0)
    assert tr.device_ms(lambda n: n in "ab") == pytest.approx(0.2)


def test_breakdown_names_ops_and_gaps():
    ops = [("k1", 0.0, 10.0), ("k2", 30.0, 40.0), ("k1", 100.0, 110.0)]
    host = [("hgbench.batch", 0.0, 200.0), ("hgbench.counts_to_host",
                                             50.0, 80.0),
            ("cudaStreamSynchronize", 55.0, 79.0)]
    tr = trace.Trace(ops=ops, host=host, window_s=200e-6, busy_s=30e-6)
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    gaps = dict((n, v) for n, v in b["idle_gaps"])
    assert gaps["counts_to_host / cudaStreamSynchronize"] == pytest.approx(
        60e-6)
    assert gaps["batch / python"] == pytest.approx(20e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_bfs_readers():
    ops = ([("at::native::reduce_kernel", 0.0, 1000.0)]
           + [("void (anonymous namespace)::fused_hop_kernel<u>",
               1000.0 + 100 * i, 1050.0 + 100 * i) for i in range(6)])
    tr = trace.Trace(ops=ops, host=[], window_s=1.0, busy_s=1.3e-3)
    ctx = SimpleNamespace(trace=tr, counters={"batches": 2, "hops": 3,
                                              "k2_bound_ms": 0.03},
                          spans={"setup.build": 4.0, "setup.plans": 2.0})
    assert spec.load_reader("k2.ms_per_batch")(ctx) == pytest.approx(0.15)
    assert spec.load_reader("bfs.plain_ms_per_batch")(ctx) == \
        pytest.approx(0.5)
    # the first batch's three K2 launches took 0.15 ms against 0.03
    assert spec.load_reader("fused_hop_roofline")(ctx) == pytest.approx(20.0)
    assert spec.load_reader("setup.build_s")(ctx) == 4.0
    assert spec.load_reader("setup.plans_s")(ctx) == 2.0
    empty = SimpleNamespace(trace=trace.Trace(), counters={}, spans={})
    for name in ("k2.ms_per_batch", "bfs.plain_ms_per_batch",
                 "fused_hop_roofline", "device.idle_share.bfs"):
        assert spec.load_reader(name)(empty) is None


def test_serve_readers():
    ctx = SimpleNamespace(trace=None, spans={}, counters={
        "occupancy": 87.5, "launch_ms": 118.0, "collect_ms": 24.0})
    assert spec.load_reader("serve.occupancy.closed")(ctx) == 87.5
    assert spec.load_reader("executor.launch_ms.closed")(ctx) == 118.0
    assert spec.load_reader("executor.collect_ms.closed")(ctx) == 24.0


def test_bound_takes_the_larger_rate():
    assert bound_ms(3.35e9, 0) == (pytest.approx(1.0), "bytes")
    assert bound_ms(0, 67e9) == (pytest.approx(1.0), "operations")


def _brute_need(vals, vmask_rows, idx, rows, n_out, kw):
    """K2's need counted entry by entry: per (output row, line), nothing
    where the row's own line is full, one load of the first full source
    line, else every live source line; self entries add nothing."""
    L = k2.n_lines(kw)
    G = k2.line_words(kw)

    def line(r, l):
        return vals[r, l * G:(l + 1) * G]

    own_full = [[bool((line(r, l) == -1).all()) for l in range(L)]
                for r in range(n_out)]
    loads, used, n_idx = 0, set(), 0
    for r in range(n_out):
        ents = [e for e in range(len(idx)) if rows[e] == r]
        if not all(own_full[r]):
            n_idx += len(ents)
        for l in range(L):
            if vmask_rows[r] >> l & 1:
                used.add((l, r))
            if own_full[r][l]:
                continue
            srcs = [int(idx[e]) for e in ents if int(idx[e]) != r]
            full = [s for s in srcs if (line(s, l) == -1).all()]
            if full:
                loads += 1
                used.add((l, full[0]))
                continue
            live = [s for s in srcs if vmask_rows[s] >> l & 1]
            loads += len(live)
            used.update((l, s) for s in live)
    return {"idx": n_idx, "loads": loads, "lines": len(used)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k2_need_equals_brute_count(seed):
    r = np.random.default_rng(seed)
    R, kw, w = 24, 64, 4
    words = r.integers(0, 2**32, size=(R, kw), dtype=np.uint64)
    words[r.random(R) < 0.3] = 0
    words[r.random(R) < 0.2] = 0xFFFFFFFF
    words[:, 32:][r.random(R) < 0.3] = 0
    vals = torch.from_numpy(words.astype(np.uint32).view(np.int32))
    fields = k2.live_fields(vals)
    vmask = k2.pack_fields(fields, kw)
    item_row = torch.arange(R, dtype=torch.int32)
    chunks = torch.from_numpy(r.integers(1, 3, size=R))
    item_off = torch.cat([torch.zeros(1, dtype=torch.int64),
                          torch.cumsum(chunks, 0)])
    idx = torch.from_numpy(r.integers(0, R, size=int(chunks.sum()) * w)
                           .astype(np.int32))
    chunk_row = torch.repeat_interleave(item_row, chunks).long()
    rows = chunk_row.repeat_interleave(w)
    got = k2.data_need(vals, vmask, idx, lambda a, b: rows[a:b], R,
                       k2.full_fields(vals), block=8)
    want = _brute_need(vals, fields.tolist(), idx, rows.tolist(), R, kw)
    assert got == want
