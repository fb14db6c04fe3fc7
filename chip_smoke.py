#!/usr/bin/env python3
"""Card smoke run of the PyTorch / CUDA port (``hypergraphdb_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py            # every phase (about two minutes)
    python3 chip_smoke.py --quick    # build + kernel checks only

Phases, each of which raises (and the script exits non-zero) on a mismatch:

1. build: ``nvcc`` compiles every ``hypergraphdb_tpu_torch/csrc/*.cu`` for
   ``sm_90a``, in parallel, into ``build/cuda_kernels/``.
2. K1 gather-OR against its plain PyTorch version, bit for bit, on random
   shapes (512-byte rows and ragged widths).
3. K2 fused hop against its plain version, bit for bit, on a generated
   graph with zipf hubs (split hub rows included); then a small BFS on the
   card (both kernels) against the plain staged chain on the CPU.
   K3 sorted-set membership against its plain version, bit for bit, on
   :data:`K3_CASES` (M from 1 to 5, Lb up to about 300K, ragged lengths
   under SENTINEL padding, all-SENTINEL rows, values near INT32_MAX - 1).
4. The main path at full width: the DBpedia-shaped 10M-atom snapshot (built
   once, shared by every later phase), K = 4096 seeds, 3 hops, through
   ``bfs_pull`` on the fused path (K2) and on the staged chain (K1). The two
   must agree exactly, the reach sets of 8 seeds must equal a numpy host
   BFS, and both kernels must have launched.
5. Served path: 5 requests padded to the 64-seed bucket, checked against
   the main path's result.
6. K1 and K2 timed at the main path's shapes beside their plain versions
   and their bounds.
7. The intersection path: ``device_intersect_sorted`` on the incidence rows
   of the hubs at :data:`HUB_RANKS` (h1 ∩ h2, h1 ∩ h2 ∩ h3, h1 ∩ the most
   common property type's links), each equal to ``np.intersect1d`` folded
   over the same arrays, timed host to host; K3 must have launched.
8. The pattern path: bench.py c3's traffic (:data:`PATTERN_PAIRS` anchor
   pairs from ``default_rng(PATTERN_SEED)``, type filter ``th``) through
   ``plan_pattern`` / ``execute_pattern`` / ``collect_pattern``, every
   query equal to a numpy host intersection (also through the overflow
   re-run); queries/s of execute-only and execute+collect windows. Then
   :data:`SERVE_PATTERNS` requests, typed and untyped, through
   ``serve_pattern`` in the 64 bucket, equal to the pattern path.
9. K3 timed at the h1 ∩ h2 shape beside its plain version, ``torch.isin``
   and its bound.
10. The device's busy share of the main path (fused and staged), the
    h1 ∩ h2 intersection and the pattern windows, from ``torch.profiler``,
    after every timed phase.

Every log line carries the card's name and power limit. The last lines are
the card line, one JSON line of kernel records and the result
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, the script prints no result and exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM device-memory rate, bytes/s (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores, the table's closest
#: entry for the kernels' 32-bit integer ORs, ops/s
ALU_OPS_PER_S = 67e12

N_SEEDS, HOPS, HOST_SEEDS = 4096, 3, 8
#: timed runs of each path (fused and staged alternate)
TIMED_RUNS = 5
SERVE_SEEDS, SERVE_TOP_R = 5, 16

#: K3 check cases (Lb, M, Lo, values up to INT32_MAX - 1, an all-SENTINEL
#: other row): ragged real lengths under SENTINEL padding
K3_CASES = (
    (1, 1, 1, False, False), (3, 2, 7, False, False),
    (1000, 3, 777, True, False), (4099, 5, 3001, False, True),
    (65_537, 2, 100_003, True, False), (123_457, 5, 9_999, False, False),
    (250_001, 3, 250_000, True, True), (299_999, 1, 300_007, False, False),
)
#: incidence-row ranks of the hubs the intersection path intersects
#: (0 = the longest row): h1 ∩ h2, h1 ∩ h2 ∩ h3, h1 ∩ type_set(th)
HUB_RANKS = (0, 1, 2)
#: bench.py c3's traffic: PATTERN_PAIRS anchor pairs from links of the most
#: common property type ``th``, drawn by default_rng(PATTERN_SEED), with
#: the type filter ``th``
PATTERN_PAIRS, PATTERN_SEED, PATTERN_TOP_R = 1024, 42, 16
#: executions per timed window of the pattern path, and windows per mode
PATTERN_REPS, PATTERN_WINDOWS = 32, 3
#: served pattern requests (typed and untyped alternate), one 64 bucket
SERVE_PATTERNS = 5


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Smoke:
    def __init__(self, torch, card: str):
        self.torch = torch
        self.card = card
        self.dev = torch.device("cuda")
        self.profiles: list = []

    def log(self, msg: str) -> None:
        print(f"[{self.card}] {msg}", flush=True)

    def expect(self, ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(what)

    def time_ms(self, fn, reps: int) -> float:
        """Mean milliseconds of ``fn`` over ``reps`` runs after one warm
        run, by CUDA events."""
        torch = self.torch
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def profile_later(self, name: str, fn, unprofiled_ms: float,
                      reps: int = 1) -> None:
        """Queue ``fn`` for :func:`phase_profiles`: ``reps`` runs under
        ``torch.profiler``, set against ``unprofiled_ms``, the wall time of
        one run without it."""
        self.profiles.append((name, fn, unprofiled_ms, reps))

    def record(self, name, src, replaces, n, err, ms, plain, nbytes, ops,
               library_ms=None) -> dict:
        """One entry of the ``kernels`` JSON line; the bound is the larger
        of ``nbytes`` over the memory rate and ``ops`` over the ALU rate."""
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / ALU_OPS_PER_S * 1e3
        self.log(f"{name}: bound {max(bytes_ms, ops_ms):.6f} ms "
                 f"({nbytes} bytes, {ops} ops)")
        return {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": n, "max_abs_err": err,
            "ms": ms, "plain_ms": plain,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
        }

    def rand_bits(self, rng, shape):
        import numpy as np

        words = rng.integers(0, 2**32, size=shape, dtype=np.uint64)
        return self.torch.from_numpy(
            words.astype(np.uint32).view(np.int32)).to(self.dev)


def phase_build(s: Smoke) -> None:
    from hypergraphdb_tpu_torch.ops import _cuda

    libs = _cuda.build_all()
    s.log(f"build: {len(libs)} kernels in {_cuda.last_build_seconds:.2f} s")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                s.log(f"ptxas {name}: {line.strip()}")


def phase_k1(s: Smoke) -> None:
    import numpy as np

    from hypergraphdb_tpu_torch.ops.gather_or import gather_or, gather_or_plain

    torch = s.torch
    rng = np.random.default_rng(1)
    cases = [(1000, 128, 5000, 8), (777, 37, 3001, 8), (300, 4, 100, 4),
             (50, 1, 7, 3), (4096, 256, 999, 8)]
    for S, kw, n_out, w in cases:
        values = s.rand_bits(rng, (S, kw))
        idx = torch.from_numpy(
            rng.integers(0, S, size=n_out * w).astype(np.int32)).to(s.dev)
        got = gather_or(values, idx, w)
        torch.cuda.synchronize()
        s.expect(torch.equal(got, gather_or_plain(values, idx, w)),
                 f"K1 != plain at S={S} Kw={kw} n_out={n_out} w={w}")
    # output into a later section of the buffer it reads (pyramid levels)
    buf = s.rand_bits(rng, (600, 128))
    idx = torch.from_numpy(
        rng.integers(0, 400, size=1600).astype(np.int32)).to(s.dev)
    want = gather_or_plain(buf, idx, 8)
    gather_or(buf, idx, 8, out=buf[400:600])
    torch.cuda.synchronize()
    s.expect(torch.equal(buf[400:600], want), "K1 != plain into a section")
    s.log(f"K1 gather_or: bit-exact against plain on {len(cases) + 1} cases")


def phase_k2(s: Smoke) -> None:
    import numpy as np

    from hypergraphdb_tpu_torch.models import dbpedia_snapshot
    from hypergraphdb_tpu_torch.ops import ellbfs, fused_bfs

    torch = s.torch
    snap, info = dbpedia_snapshot(n_entities=20_000, n_links=80_000, seed=3)
    plan, geom = fused_bfs.device_fused_plan(snap, s.dev)
    split_rows = int((torch.bincount(plan.item_row.long()) > 1).sum())
    s.expect(split_rows > 0, "K2 check graph has no split hub rows")
    rng = np.random.default_rng(2)
    for kw in (128, 3):
        old = s.rand_bits(rng, (geom.n_rows, kw))
        old[geom.zero_row] = 0
        want = fused_bfs.fused_hop_plain(old, plan)
        got = fused_bfs.fused_hop(old, plan)
        torch.cuda.synchronize()
        s.expect(torch.equal(got, want), f"K2 != plain at kw={kw}")
        # a second buffer holding a subset of the result (ping-pong)
        out = old & s.rand_bits(rng, (geom.n_rows, kw))
        got = fused_bfs.fused_hop(old, plan, out=out)
        torch.cuda.synchronize()
        s.expect(torch.equal(got, want), f"K2 != plain into a subset, kw={kw}")
    s.log(f"K2 fused_hop: bit-exact against plain ({geom.n_rows} rows, "
          f"{geom.n_chunks} chunks, {split_rows} split hub rows)")

    e0, e1 = info["entities"]
    seeds = rng.integers(e0, e1, size=96).astype(np.int32)
    cpu = ellbfs.bfs_pull(snap, seeds, 3, k_block=32, fused=False, device="cpu")
    for fused in (True, False):
        res = ellbfs.bfs_pull(snap, seeds, 3, k_block=32, fused=fused,
                              device=s.dev)
        s.expect(torch.equal(res.visited_t.cpu(), cpu.visited_t),
                 f"small BFS on the card (fused={fused}) != plain on CPU")
        s.expect(np.array_equal(res.edges_touched, cpu.edges_touched),
                 "small BFS edge counts differ")
        s.expect(torch.equal(res.reach_counts.cpu(), cpu.reach_counts),
                 "small BFS reach counts differ")
    s.log("small BFS: card (fused and staged) == plain staged chain on CPU")


def build_snapshot(s: Smoke):
    from hypergraphdb_tpu_torch.models import dbpedia_snapshot

    t0 = time.perf_counter()
    snap, info = dbpedia_snapshot()
    s.log(f"snapshot: {snap.num_atoms} atoms, {snap.n_edges_tgt} target "
          f"entries, {snap.n_edges_inc} incidence entries in "
          f"{time.perf_counter() - t0:.2f} s")
    return snap, info


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    from hypergraphdb_tpu_torch.ops import fused_bfs
    from hypergraphdb_tpu_torch.ops.gather_or import gather_or
    from hypergraphdb_tpu_torch.ops.membership import membership_mask

    gather_or.launches = 0
    fused_bfs.fused_hop.launches = 0
    membership_mask.launches = 0


def launches() -> dict:
    from hypergraphdb_tpu_torch.ops import fused_bfs
    from hypergraphdb_tpu_torch.ops.gather_or import gather_or
    from hypergraphdb_tpu_torch.ops.membership import membership_mask

    return {"gather_or": gather_or.launches,
            "fused_hop": fused_bfs.fused_hop.launches,
            "membership": membership_mask.launches}


def phase_main(s: Smoke, snap, info, records: dict) -> None:
    import numpy as np

    from hypergraphdb_tpu_torch.ops import ellbfs, fused_bfs
    from hypergraphdb_tpu_torch.ops.gather_or import gather_or, gather_or_plain
    from hypergraphdb_tpu_torch.ops.host_bfs import host_bfs
    from hypergraphdb_tpu_torch.ops.serving import serve_bfs

    torch = s.torch
    N = snap.num_atoms
    e0, e1 = info["entities"]
    seeds = np.random.default_rng(7).integers(e0, e1, size=N_SEEDS).astype(
        np.int32)

    pool = ThreadPoolExecutor(max_workers=4)
    host = [pool.submit(host_bfs, snap, int(x), HOPS)
            for x in seeds[:HOST_SEEDS]]

    t0 = time.perf_counter()
    plans = ellbfs.plans_for(snap)
    t1 = time.perf_counter()
    fplan = fused_bfs.fused_plans_for(snap)
    t2 = time.perf_counter()
    geom = fplan.geom
    s.log(f"plans: staged {t1 - t0:.2f} s ({plans.total_indices} indices), "
          f"fused {t2 - t1:.2f} s ({geom.total_entries} entries, "
          f"{geom.n_chunks} chunks, {geom.n_items} items)")
    dp = ellbfs.device_plans(snap, s.dev)
    dplan, _ = fused_bfs.device_fused_plan(snap, s.dev)

    def run(fused: bool):
        return ellbfs.bfs_pull(snap, seeds, HOPS, k_block=N_SEEDS,
                               fused=fused, device=s.dev)

    # the host BFS ran beside the plan builds; collect it before any timing
    t0 = time.perf_counter()
    host_results = [f.result() for f in host]
    pool.shutdown()
    s.log(f"host BFS of {HOST_SEEDS} seeds done, waited "
          f"{time.perf_counter() - t0:.2f} s after the plans")

    for fused in (True, False):  # warm runs: allocator, first launches
        run(fused)
    torch.cuda.synchronize()

    def timed(fused: bool):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(fused)
        torch.cuda.synchronize()
        secs[fused].append(time.perf_counter() - t0)
        return res

    secs = {True: [], False: []}
    reset_launches()
    results = {fused: timed(fused) for fused in (True, False)}
    n_launch = launches()
    for _ in range(TIMED_RUNS - 1):  # more runs, for the spread
        for fused in (True, False):
            timed(fused)
    res_f, res_s = results[True], results[False]
    s.expect(n_launch["fused_hop"] > 0, "main path never launched K2")
    s.expect(n_launch["gather_or"] > 0, "main path never launched K1")
    s.expect(torch.equal(res_f.visited_t, res_s.visited_t),
             "fused and staged visited bitmaps differ")
    s.expect(np.array_equal(res_f.edges_touched, res_s.edges_touched),
             "fused and staged edge counts differ")
    s.expect(torch.equal(res_f.reach_counts, res_s.reach_counts),
             "fused and staged reach counts differ")
    edges = int(res_f.edges_touched.sum())
    for fused, name in ((True, "fused (K2)"), (False, "staged (K1)")):
        med = float(np.median(secs[fused]))
        s.log(f"main path {name}: {N_SEEDS} seeds x {HOPS} hops, {edges} "
              f"edges; runs {[round(t * 1e3, 1) for t in secs[fused]]} ms; "
              f"median {med * 1e3:.1f} ms, {edges / med:.4e} edges/s")
    s.log(f"launches on the main path: {n_launch}")
    for fused, name in ((True, "fused"), (False, "staged")):
        s.profile_later(f"main path {name}", lambda f=fused: run(f),
                        float(np.median(secs[fused])) * 1e3)

    lanes = list(range(HOST_SEEDS))
    rows = ellbfs.visited_rows(res_f, N, lanes=lanes)
    reach = res_f.reach_counts.cpu().numpy()
    for k, (want, want_edges) in zip(lanes, host_results):
        s.expect(np.array_equal(rows[k], want),
                 f"seed lane {k}: reach set differs from the host BFS")
        s.expect(int(reach[k]) == len(want), f"seed lane {k}: reach count")
        s.expect(int(res_f.edges_touched[k]) == want_edges,
                 f"seed lane {k}: edge count differs from the host BFS")
    s.log(f"host BFS: {HOST_SEEDS} seeds agree (reach sizes "
          f"{[int(reach[k]) for k in lanes]})")

    # served path: a few requests padded to the 64-seed bucket
    t0 = time.perf_counter()
    counts, first_r = serve_bfs(snap, seeds[:SERVE_SEEDS], HOPS, SERVE_TOP_R,
                                device=s.dev)
    serve_s = time.perf_counter() - t0
    sentinel = int(fused_bfs.SENTINEL)
    for k in range(SERVE_SEEDS):
        s.expect(int(counts[k]) == int(reach[k]), f"served count lane {k}")
        want = np.full(SERVE_TOP_R, sentinel, np.int64)
        head = rows[k][:SERVE_TOP_R]
        want[: len(head)] = head
        s.expect(np.array_equal(first_r[k].astype(np.int64), want),
                 f"served first_r lane {k}")
    s.log(f"served: {SERVE_SEEDS} requests in the 64 bucket, top_r "
          f"{SERVE_TOP_R}, {serve_s * 1e3:.1f} ms, match the main path")

    # kernel timing at the main path's shapes (final visited bitmap as data)
    visited = res_s.visited_t
    kw = visited.shape[1]
    row_bytes = kw * 4
    del results, res_s, res_f
    # the plain counting passes each path runs HOPS + 1 times
    deg_ms = s.time_ms(
        lambda: ellbfs.bitdot(visited, dp["inc_deg"], dp["deg_rows"]), 2)
    reach_ms = s.time_ms(lambda: ellbfs.bitdot(visited), 2)
    s.log(f"counting (plain bitdot): {deg_ms:.1f} ms degree-weighted over "
          f"{dp['deg_rows'].numel()} rows, {reach_ms:.1f} ms reach over "
          f"{visited.shape[0]} rows")
    idx1 = dp["levels1"][0]
    w1 = plans.stage1.widths[0]
    n_out = idx1.shape[0] // w1
    out_k = torch.empty((n_out, kw), dtype=torch.int32, device=s.dev)
    out_p = torch.empty_like(out_k)
    k1_ms = s.time_ms(lambda: gather_or(visited, idx1, w1, out=out_k), 5)
    k1_plain = s.time_ms(
        lambda: gather_or_plain(visited, idx1, w1, out=out_p), 2)
    k1_err = int((out_k.long() - out_p.long()).abs().max())
    used = torch.zeros(visited.shape[0], dtype=torch.bool, device=s.dev)
    used[idx1.long()] = True
    k1_bytes = (int(used.sum()) * row_bytes + idx1.numel() * 4
                + n_out * row_bytes)
    k1_ops = idx1.numel() * kw
    s.log(f"K1 at stage-1 level 0: {n_out} rows x {w1}, {k1_ms:.3f} ms "
          f"kernel, {k1_plain:.3f} ms plain, {idx1.numel() * row_bytes} "
          f"gathered bytes")
    del out_k, out_p, used

    old = torch.zeros((geom.n_rows, kw), dtype=torch.int32, device=s.dev)
    old[: visited.shape[0]] = visited
    out_k = torch.zeros_like(old)
    out_p = torch.empty_like(old)
    k2_ms = s.time_ms(lambda: fused_bfs.fused_hop(old, dplan, out=out_k), 3)
    k2_plain = s.time_ms(
        lambda: fused_bfs.fused_hop_plain(old, dplan, out=out_p), 1)
    k2_err = int((out_k.long() - out_p.long()).abs().max())
    k2_bytes = (2 * geom.n_rows * row_bytes + dplan.idx.numel() * 4
                + dplan.item_off.numel() * 8 + dplan.item_row.numel() * 4)
    k2_ops = (dplan.idx.numel() + geom.n_rows) * kw
    s.log(f"K2 one hop: {geom.n_items} items, {k2_ms:.3f} ms kernel, "
          f"{k2_plain:.3f} ms plain, "
          f"{fused_bfs.fused_bytes_per_hop(geom, N_SEEDS)} modelled bytes")
    s.expect(k1_err == 0 and k2_err == 0,
             "kernels differ from plain at main-path shapes")

    records["kernels"] += [
        s.record("gather_or", "hypergraphdb_tpu_torch/csrc/gather_or.cu",
                 "hypergraphdb_tpu/ops/pallas_gather.py:95",
                 n_launch["gather_or"], k1_err, k1_ms, k1_plain, k1_bytes,
                 k1_ops),
        s.record("fused_hop", "hypergraphdb_tpu_torch/csrc/fused_hop.cu",
                 "hypergraphdb_tpu/ops/pallas_bfs.py:313",
                 n_launch["fused_hop"], k2_err, k2_ms, k2_plain, k2_bytes,
                 k2_ops),
    ]


def k3_case(rng, lb: int, m: int, lo: int, near_max: bool, empty_row: bool):
    """A sorted SENTINEL-padded base (Lb,) and others (M, Lo) with ragged
    real lengths; the others hold about half the base's values."""
    import numpy as np

    from hypergraphdb_tpu_torch.ops.setops import SENTINEL, pad_sorted

    span = 2 * (lb + lo) + 8
    top = int(SENTINEL)  # exclusive: values reach INT32_MAX - 1
    vmin = top - span if near_max else 0
    vals = rng.integers(vmin, min(vmin + span, top), size=lb)
    base = np.unique(vals)[: int(rng.integers(max(1, lb // 2), lb + 1))]
    others = np.full((m, lo), SENTINEL, np.int32)
    for j in range(m):
        if empty_row and j == m - 1:
            continue  # an all-SENTINEL row: nothing matches
        pick = base[rng.random(len(base)) < 0.5]
        extra = rng.integers(vmin, min(vmin + span, top), size=lo // 2 + 1)
        row = np.unique(np.concatenate([pick, extra]))
        others[j] = pad_sorted(row[: int(rng.integers(lo // 2, lo + 1))], lo)
    return pad_sorted(base, lb), others


def phase_k3(s: Smoke) -> None:
    import numpy as np

    from hypergraphdb_tpu_torch.ops.membership import membership_mask
    from hypergraphdb_tpu_torch.ops.setops import intersect_mask_many

    torch = s.torch
    rng = np.random.default_rng(4)
    hits = []
    for lb, m, lo, near_max, empty_row in K3_CASES:
        base, others = k3_case(rng, lb, m, lo, near_max, empty_row)
        b = torch.from_numpy(base).to(s.dev)
        o = torch.from_numpy(others).to(s.dev)
        got = membership_mask(b, o)
        torch.cuda.synchronize()
        want = intersect_mask_many(b, o)
        s.expect(torch.equal(got, want),
                 f"K3 != plain at Lb={lb} M={m} Lo={lo} near_max={near_max}")
        hits.append(int(want.sum()))
    s.log(f"K3 membership: bit-exact against plain on {len(K3_CASES)} "
          f"cases (matches per case {hits})")


def hub_rows(snap):
    """Atom ids and incidence rows of the hubs at :data:`HUB_RANKS`."""
    import numpy as np

    deg = np.diff(snap.inc_offsets[: snap.num_atoms + 1])
    order = np.argsort(-deg, kind="stable")
    ids = [int(order[r]) for r in HUB_RANKS]
    return ids, [snap.incidence_row(h) for h in ids]


def top_property_type(snap, info) -> int:
    """The property type with the most links (bench.py c3's ``th``)."""
    return int(max(info["property_types"],
                   key=lambda t: len(snap.type_set(t))))


def phase_intersect(s: Smoke, snap, info) -> int:
    """The planner's n-way intersection on the hub rows, through K3.
    Returns K3's launches on this path."""
    import numpy as np

    from hypergraphdb_tpu_torch.ops.setops import device_intersect_sorted

    ids, rows = hub_rows(snap)
    th = top_property_type(snap, info)
    s.log(f"hubs {ids}: incidence rows {[len(r) for r in rows]}; type {th}: "
          f"{len(snap.type_set(th))} links")
    cases = {
        "h1&h2": rows[:2],
        "h1&h2&h3": rows,
        "h1&type": [rows[0], snap.type_set(th)],
    }
    device_intersect_sorted(cases["h1&h2"], device=s.dev)  # warm
    secs = {k: [] for k in cases}

    def run(name):
        t0 = time.perf_counter()
        got = device_intersect_sorted(cases[name], device=s.dev)
        secs[name].append(time.perf_counter() - t0)
        return got

    reset_launches()
    results = {name: run(name) for name in cases}
    n = launches()["membership"]
    s.log(f"K3 launches on the intersection path: {n} for {len(cases)} "
          f"calls")
    for _ in range(TIMED_RUNS - 1):
        for name in cases:
            run(name)
    s.expect(n > 0, "intersection path never launched K3")
    for name, arrays in cases.items():
        want = arrays[0].astype(np.int64)
        for a in arrays[1:]:
            want = np.intersect1d(want, a)
        s.expect(np.array_equal(results[name], want),
                 f"device_intersect_sorted {name} != np.intersect1d")
        s.log(f"intersect {name}: {len(want)} ids, host to host "
              f"{[round(t * 1e3, 3) for t in secs[name]]} ms, median "
              f"{np.median(secs[name]) * 1e3:.3f} ms")
    s.profile_later("intersect h1&h2",
                    lambda: device_intersect_sorted(cases["h1&h2"], s.dev),
                    float(np.median(secs["h1&h2"])) * 1e3, reps=20)
    return n


def host_pattern(snap, pair, th):
    """Numpy truth of one c3 query: the two incidence rows intersected (a
    binary search of the shorter in the longer), then filtered by type."""
    import numpy as np

    small, big = sorted((snap.incidence_row(int(x)) for x in pair), key=len)
    pos = np.minimum(np.searchsorted(big, small), max(len(big) - 1, 0))
    got = small[big[pos] == small] if len(big) else small[:0]
    if th is not None:
        got = got[snap.type_of[got] == th]
    return got.astype(np.int64)


def phase_pattern(s: Smoke, snap, info) -> None:
    """bench.py c3 on the card: plan, execute and collect 1024 typed anchor
    pairs; then a few requests through the served pattern."""
    import numpy as np

    from hypergraphdb_tpu_torch.ops import setops
    from hypergraphdb_tpu_torch.ops.serving import (
        PATTERN_PAD,
        serve_pattern,
    )

    torch = s.torch
    th = top_property_type(snap, info)
    r = np.random.default_rng(PATTERN_SEED)
    cands = snap.type_set(th)
    links = cands[r.integers(0, len(cands), size=PATTERN_PAIRS)]
    starts = snap.tgt_offsets[links].astype(np.int64)
    pairs = np.stack([snap.tgt_flat[starts], snap.tgt_flat[starts + 1]],
                     axis=1).astype(np.int32)
    pool = ThreadPoolExecutor(max_workers=1)
    host = pool.submit(lambda: [host_pattern(snap, p, th) for p in pairs])

    t0 = time.perf_counter()
    ell = setops.ell_targets(snap, s.dev)
    snap.device(s.dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    plan = setops.plan_pattern(snap, pairs, th, device=s.dev)
    t2 = time.perf_counter()
    s.expect(ell is not None and plan.use_ell, "10M snapshot lost its ELL")
    s.log(f"pattern set-up: ELL {tuple(ell.shape)} and device snapshot "
          f"{t1 - t0:.2f} s, plan {t2 - t1:.3f} s; buckets (pad, queries) "
          f"{[(p, len(sel)) for sel, _, p in plan.buckets]}")

    def execute():
        return setops.execute_pattern(plan, top_r=PATTERN_TOP_R)

    setops.collect_pattern(plan, execute())  # warm
    torch.cuda.synchronize()
    reset_launches()
    results = setops.collect_pattern(plan, execute())
    s.log(f"launches on the pattern path: {launches()} (the reference's "
          f"pattern lane runs no TPU kernel either)")

    def window(collect: bool) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PATTERN_REPS):
            pending = execute()
            if collect:
                setops.collect_pattern(plan, pending)
        torch.cuda.synchronize()
        return PATTERN_PAIRS * PATTERN_REPS / (time.perf_counter() - t0)

    for collect, name in ((False, "execute-only"),
                          (True, "execute+collect")):
        qps = [window(collect) for _ in range(PATTERN_WINDOWS)]
        med = float(np.median(qps))
        s.log(f"pattern c3 {name}: {PATTERN_PAIRS} queries x "
              f"{PATTERN_REPS} per window, windows "
              f"{[round(q) for q in qps]} queries/s, median "
              f"{med:.1f} queries/s")
        s.profile_later(f"pattern c3 {name} window",
                        lambda c=collect: window(c),
                        PATTERN_PAIRS * PATTERN_REPS / med * 1e3)

    # the overflow re-run on the card: a window of 1 overflows every query
    # with two or more matches
    narrow = setops.collect_pattern(
        plan, setops.execute_pattern(plan, top_r=1))
    truth = host.result()
    pool.shutdown()
    sizes = np.array([len(t) for t in truth])
    for q in range(PATTERN_PAIRS):
        s.expect(np.array_equal(results[q], truth[q]),
                 f"pattern query {q}: differs from the host intersection")
        s.expect(np.array_equal(narrow[q], truth[q]),
                 f"pattern query {q}: overflow re-run differs")
    s.log(f"pattern c3: {PATTERN_PAIRS} queries equal the host "
          f"intersection (sizes {sizes.min()}..{sizes.max()}, "
          f"{int((sizes > 1).sum())} through the overflow re-run at top_r 1)")

    # served: a few requests padded to the 64 bucket, typed and untyped
    off = snap.inc_offsets
    base_len = np.minimum(off[pairs[:, 0] + 1] - off[pairs[:, 0]],
                          off[pairs[:, 1] + 1] - off[pairs[:, 1]])
    pick = np.nonzero(base_len <= PATTERN_PAD)[0][:SERVE_PATTERNS]
    s.expect(len(pick) == SERVE_PATTERNS, "too few c3 pairs fit the pad")
    types = [th if k % 2 == 0 else None for k in range(SERVE_PATTERNS)]
    untyped = setops.and_incident_pattern(snap, pairs[pick], None,
                                          device=s.dev)
    want = [results[q] if t is not None else u
            for q, t, u in zip(pick, types, untyped)]
    secs = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        counts, first_r = serve_pattern(snap, pairs[pick], types,
                                        SERVE_TOP_R, device=s.dev)
        secs.append(time.perf_counter() - t0)
    for k, w in enumerate(want):
        s.expect(int(counts[k]) == len(w), f"served pattern count lane {k}")
        win = np.full(SERVE_TOP_R, int(setops.SENTINEL), np.int64)
        win[: min(len(w), SERVE_TOP_R)] = w[:SERVE_TOP_R]
        s.expect(np.array_equal(first_r[k].astype(np.int64), win),
                 f"served pattern first_r lane {k}")
    s.log(f"served pattern: {SERVE_PATTERNS} requests in the 64 bucket, "
          f"pad {PATTERN_PAD}, top_r {SERVE_TOP_R}, runs "
          f"{[round(t * 1e3, 3) for t in secs]} ms (first one cold), match "
          f"the pattern path")


def phase_k3_timing(s: Smoke, snap, n_launches: int, records: dict) -> None:
    """K3 alone at the h1 ∩ h2 shape that ``device_intersect_sorted``
    gives it, beside its plain version and ``torch.isin``."""
    import math

    import numpy as np

    from hypergraphdb_tpu_torch.ops.membership import membership_mask
    from hypergraphdb_tpu_torch.ops.setops import (
        SENTINEL,
        _bucket,
        intersect_mask_many,
        pad_sorted,
    )

    torch = s.torch
    _, rows = hub_rows(snap)
    big, small = rows[0], rows[1]
    L = _bucket(len(big))
    b = torch.from_numpy(pad_sorted(small, L)).to(s.dev)
    o = torch.from_numpy(pad_sorted(big, L)[None]).to(s.dev)
    got = membership_mask(b, o)
    want = intersect_mask_many(b, o)
    lib = torch.isin(b, o[0])
    torch.cuda.synchronize()
    err = int((got.int() - want.int()).abs().max())
    s.expect(err == 0, "K3 != plain at the h1 & h2 shape")
    s.expect(torch.equal(lib & (b != int(SENTINEL)), got),
             "torch.isin disagrees with K3 on the real lanes")
    ms = s.time_ms(lambda: membership_mask(b, o), 50)
    plain = s.time_ms(lambda: intersect_mask_many(b, o), 10)
    lib_ms = s.time_ms(lambda: torch.isin(b, o[0]), 10)
    nbytes = b.numel() * 4 + o.numel() * 4 + b.numel()  # mask: 1 byte each
    # compares this data needs: one lower-bound search of the real row per
    # real base element (SENTINEL lanes stop at once)
    ops = len(small) * (math.ceil(math.log2(L)) + 1)
    s.log(f"K3 at h1 & h2: Lb {b.numel()} ({len(small)} real), Lo {L} "
          f"({len(big)} real), {ms:.4f} ms kernel, {plain:.4f} ms plain, "
          f"{lib_ms:.4f} ms torch.isin")
    records["kernels"].append(s.record(
        "membership", "hypergraphdb_tpu_torch/csrc/membership.cu",
        "hypergraphdb_tpu/ops/pallas_kernels.py:41", n_launches, err, ms,
        plain, nbytes, ops, library_ms=lib_ms))


def phase_profiles(s: Smoke) -> None:
    """The device's busy share of each path queued by the timed phases,
    from ``torch.profiler``: the kernels, copies and fills it records on
    the card, summed, against the path's unprofiled wall time. Runs after
    every timed phase, because once a profile has run the tracer stays
    attached and slows every later launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch = s.torch
    for name, fn, unprofiled_ms, reps in s.profiles:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        rows.sort(key=lambda e: -e.self_device_time_total)
        busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / reps
        n_ops = sum(e.count for e in rows) / reps
        top = "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} "
                        f"ms x{e.count}" for e in rows[:5])
        s.log(f"profile {name} ({reps} runs): device busy {busy_ms:.4f} ms "
              f"a run of {unprofiled_ms:.3f} ms wall unprofiled "
              f"({100 * busy_ms / unprofiled_ms:.1f} %), {n_ops:.1f} device "
              f"operations a run; top: {top}")


def main(argv: list[str]) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import hypergraphdb_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    card = _card()
    s = Smoke(torch, card)
    t_all = time.perf_counter()
    phase_build(s)
    phase_k1(s)
    phase_k2(s)
    phase_k3(s)
    records: dict = {"kernels": []}
    if "--quick" not in argv:
        snap, info = build_snapshot(s)
        phase_main(s, snap, info, records)
        n_k3 = phase_intersect(s, snap, info)
        phase_pattern(s, snap, info)
        phase_k3_timing(s, snap, n_k3, records)
        phase_profiles(s)
    s.log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(card)
    if records["kernels"]:
        print(json.dumps(records))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
