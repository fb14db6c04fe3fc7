#!/usr/bin/env python3
"""Card smoke run of the PyTorch / CUDA port (``hypergraphdb_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py            # every phase (under two minutes)
    python3 chip_smoke.py --quick    # build + kernel checks only

Phases, each of which raises (and the script exits non-zero) on a mismatch:

1. build: ``nvcc`` compiles every ``hypergraphdb_tpu_torch/csrc/*.cu`` for
   ``sm_90a``, in parallel, into ``build/cuda_kernels/``.
2. K1 gather-OR against its plain PyTorch version, bit for bit, on random
   shapes (512-byte rows and ragged widths).
3. K2 fused hop against its plain version, bit for bit, on a generated
   graph with zipf hubs (split hub rows included); then a small BFS on the
   card (both kernels) against the plain staged chain on the CPU.
4. The main path at full width: the DBpedia-shaped 10M-atom snapshot,
   K = 4096 seeds, 3 hops, through ``bfs_pull`` on the fused path (K2) and
   on the staged chain (K1). The two must agree exactly, the reach sets of 8
   seeds must equal a numpy host BFS, and both kernels must have launched.
5. Served path: 5 requests padded to the 64-seed bucket, checked against
   the main path's result.
6. Each kernel timed at the main path's shapes beside its plain version and
   its bound.

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


def phase_main(s: Smoke, records: dict) -> None:
    import numpy as np

    from hypergraphdb_tpu_torch.models import dbpedia_snapshot
    from hypergraphdb_tpu_torch.ops import ellbfs, fused_bfs
    from hypergraphdb_tpu_torch.ops.gather_or import gather_or, gather_or_plain
    from hypergraphdb_tpu_torch.ops.host_bfs import host_bfs
    from hypergraphdb_tpu_torch.ops.serving import serve_bfs

    torch = s.torch
    t0 = time.perf_counter()
    snap, info = dbpedia_snapshot()
    N = snap.num_atoms
    s.log(f"snapshot: {N} atoms, {snap.n_edges_tgt} target entries, "
          f"{snap.n_edges_inc} incidence entries in "
          f"{time.perf_counter() - t0:.2f} s")
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
    gather_or.launches = 0
    fused_bfs.fused_hop.launches = 0
    results = {fused: timed(fused) for fused in (True, False)}
    launches = {"gather_or": gather_or.launches,
                "fused_hop": fused_bfs.fused_hop.launches}
    for _ in range(TIMED_RUNS - 1):  # more runs, for the spread
        for fused in (True, False):
            timed(fused)
    res_f, res_s = results[True], results[False]
    s.expect(launches["fused_hop"] > 0, "main path never launched K2")
    s.expect(launches["gather_or"] > 0, "main path never launched K1")
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
    s.log(f"launches on the main path: {launches}")

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

    def record(name, src, replaces, n, err, ms, plain, nbytes, ops):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / ALU_OPS_PER_S * 1e3
        s.log(f"{name}: bound {max(bytes_ms, ops_ms):.3f} ms "
              f"({nbytes} bytes, {ops} ops)")
        return {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": n, "max_abs_err": err,
            "ms": ms, "plain_ms": plain,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        }

    records["kernels"] = [
        record("gather_or", "hypergraphdb_tpu_torch/csrc/gather_or.cu",
               "hypergraphdb_tpu/ops/pallas_gather.py:95",
               launches["gather_or"], k1_err, k1_ms, k1_plain, k1_bytes,
               k1_ops),
        record("fused_hop", "hypergraphdb_tpu_torch/csrc/fused_hop.cu",
               "hypergraphdb_tpu/ops/pallas_bfs.py:313",
               launches["fused_hop"], k2_err, k2_ms, k2_plain, k2_bytes,
               k2_ops),
    ]


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
    records: dict = {}
    if "--quick" not in argv:
        phase_main(s, records)
    s.log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(card)
    if records:
        print(json.dumps(records))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
