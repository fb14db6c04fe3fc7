#!/usr/bin/env python3
"""Card smoke run of the PyTorch / CUDA port (``hypergraphdb_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py            # every phase (a few minutes)
    python3 chip_smoke.py --quick    # build + kernel checks only

Phases, each of which raises (and the script exits non-zero) on a mismatch:

1. build: ``nvcc`` compiles every ``hypergraphdb_tpu_torch/csrc/*.cu`` for
   ``sm_90a``, in parallel, into ``build/cuda_kernels/``.
2. K1 gather-OR against its plain PyTorch version, bit for bit, on random
   shapes (512-byte rows and ragged widths); then with line masks (none,
   exact, all-set) on random, sparse and all-ones-heavy bitmaps at kw 2, 3,
   128 and 256, every emitted mask equal to ``line_mask`` of its output.
3. K2 fused hop against its plain version, bit for bit, on a generated
   graph with zipf hubs (split hub rows included), unmasked and with the
   masked cases of K1 plus a plan heavy with self entries; then a small BFS
   on the card (both kernels) against the plain staged chain on the CPU,
   and a 64-seed BFS whose every mask is audited.
   K3 sorted-set membership against its plain version, bit for bit,
   through both entries: :data:`K3_CASES` (M from 1 to 5, Lb up to about
   300K, ragged lengths under SENTINEL padding, all-SENTINEL rows, values
   near INT32_MAX - 1) padded through ``membership_mask`` and unpadded
   through ``membership_mask_ragged``; then the ragged cases of
   :func:`k3_ragged_cases`: a base of about 1,000 ids against a row of
   758K (windows past the search switch), windows of several chunks, an
   empty row, values near INT32_MAX, M = 1..5, a tile whose flags all clear
   at the first row, Lb not a multiple of the tile. Every ragged case also
   runs from a row buffer one int off 16-byte alignment.
4. The main path at full width: the DBpedia-shaped 10M-atom snapshot (built
   once, shared by every later phase), K = 4096 seeds, 3 hops, through
   ``bfs_pull`` on the fused path (K2) and on the staged chain (K1). The two
   must agree exactly, the reach sets of the seeds at :data:`HOST_LANES`
   (two in each 128-byte line of a bitmap row) must equal a numpy host
   BFS, and both kernels must have launched.
5. Served path: 5 requests padded to the 64-seed bucket, checked against
   the main path's result and the host BFS, timed over 10 warm calls.
6. The main path once more under a mask audit (the mask entering every hop,
   fused and staged, equal to ``line_mask`` of its bitmap), keeping the
   bitmap and mask entering each hop: K2 timed at each hop's input and K1
   at every level of each hop, with and without masks, each run into
   zeros and bit-exact with its plain version on the same input, every
   emitted mask equal to ``line_mask`` of its output; K2's plain output and
   the staged chain equal to the BFS's next bitmap. Beside each time, the
   bound of earlier versions (every used row read) and a data bound (what
   the masks and the saturation exit leave to read, counted on the card).
   Then both kernels, unmasked, on the final bitmap beside their plain
   versions and their bounds (the figure earlier versions reported).
7. The intersection path: ``device_intersect_sorted`` on the incidence rows
   of the hubs at :data:`HUB_RANKS` (h1 ∩ h2, h1 ∩ h2 ∩ h3, h1 ∩ the most
   common property type's links) and one skewed case, the incidence row of
   an atom of about :data:`SKEW_DEGREE` links that shares a link with h1,
   ∩ h1 (its tile takes the kernel's in-window search), each equal to
   ``np.intersect1d`` folded over the same arrays, timed host to host with
   the result compacted on the card (what the function does) and, in
   turns, after the same checks and staging, with the mask fetched and the
   base indexed on the host; every call must have launched K3 once.
8. The pattern path: bench.py c3's traffic (:data:`PATTERN_PAIRS` anchor
   pairs from ``default_rng(PATTERN_SEED)``, type filter ``th``) through
   ``plan_pattern`` / ``execute_pattern`` / ``collect_pattern``, every
   query equal to a numpy host intersection (also through the overflow
   re-run); queries/s of execute-only and execute+collect windows. Then
   :data:`SERVE_PATTERNS` requests, typed and untyped, through
   ``serve_pattern`` in the 64 bucket, equal to the pattern path.
9. K3 at the h1 ∩ h2 arrays, unpadded, held against its plain version (and
   the padded entry at PR 3's 2^20 shape against its own): its device time
   from a CUDA graph of 50 launches (not paced by the host), spaced
   launches between CUDA events at warm L2 (a call just before) and cold
   (256 MB written just before), and beside them the wrapper's host time per call (back to
   back, the figure PR 3 and PR 4 reported), the plain version and
   ``torch.isin`` warm and cold, the data bound of the real bytes and the
   earlier bound of the padded shape.
10. BFS served over a base snapshot plus a delta: the snapshot with its
    last :data:`DELTA_LINKS` links held back (their rows stay in the id
    space, empty), and those links fed in id order to a ``DeltaMemtable``
    (one full upload, then a tail upload). The fused route with the
    delta's overlay (K2 every hop, K1 every overlay level) must equal the
    whole graph served at the 5-request, 64- and 1024-lane batches, pad
    lanes included, and the host BFS; the dense route with tombstones (h1,
    base links, held-back links; a dead-only refresh) must equal a host BFS
    that drops dead links and atoms, h1's lane counting 0; without
    tombstones the dense route equals the fused one; a 10,000-link delta
    is checked the same way. A 1-hop freshness batch reaches every
    held-back partner with the overlay and none without. Overlay BFSs at
    64 and 1024 lanes run under the mask audit; K1 is held against its
    plain version at every overlay level and K2 at the 64-lane hop. Each
    served route is timed over 10 warm calls, the overlay's share by CUDA
    events, K1's launches per served batch counted, and the dense route's
    peak device memory at 1024 lanes read.
12. bench.py c7's joins (run before 11): the co-incidence CSR refused at
    the default pair budget (:data:`JOIN_PAIR_BUDGET` is over 2^28 at
    10M atoms), built on the card with it raised (seconds, peak memory)
    and :data:`JOIN_ROW_CHECKS` of its rows (h1's and the dummy row
    among them) equal to a host computation; c7's anchors (co width
    2..512, every neighbour's row within the pad cap: from the whole
    population, since c7's 8·K draws find none at 10M); triangle and
    2-path counts over :data:`JOIN_K` anchors in 16-lane dispatches
    (anchors/s, the first 128 lanes equal to a numpy host count); c7's
    hub-heavy batch through the degree split, the flat padded executor
    and the factorized relations (built on the card, timed), split and
    factorized counts equal and equal to the host; the 2-path once more
    with a value window (kind 0, ranks below :data:`JOIN_WINDOW_HI`) on
    the variable it binds last, counts equal to a windowed host count and
    at most the unwindowed ones; then ``execute_join`` on the card against
    the CPU on a 2,000-entity graph: triangle (also with value windows on
    both variables), 2-path, star3 (bushy), link_var (a dedupe step) and
    seeds mode, full binding tables equal. The join caches are freed at
    its end.
13. The value plane (run after 12, before 11): the device rank and kind
    columns and ``value_columns`` against numpy on sampled rows (h1, the
    dummy row, the last link); the kind-0 value index column built
    (seconds, the host sort and the upload timed alone, bytes), sorted
    and holding exactly the live atoms; bench.py c9's traffic
    (:data:`C9_REQUESTS` requests, windows of :data:`C9_WINDOW` + 1
    entity ranks, range and top-k both orders) through
    ``serve_range_batch`` in 1024-lane batches and one 64- and one
    256-lane batch, against a numpy oracle, requests/s host to host over
    10 warm windows; the same traffic over phase 10's held-back links in
    a delta column and the rest in the base; typed and anchored lanes
    (h1, phase 12's hub-heavy anchors) on the card against the CPU, the
    covered ones against numpy; bench.py c3's value leg
    (``incident_value_range`` over ranks [16, 48)) counts against numpy,
    ``incident_value_pattern``'s five ops against numpy on the first 128
    queries, the row pack against the columns, execute-only queries/s.
14. bench.py c5 on the port's graph layer (after 13): the graph through
    ``bulk_import``, the snapshot manager with c5's arguments, a writer
    thread streaming c5's batches beside the reader's dense batches, the
    final view against host BFS (see :func:`phase_ingest`).
15. The query front door (after 14): ``tools/calibrate_duality.py``'s two
    ``device_min_batch`` sweeps on the port (a 2-way intersection through
    K3 against the host's, and one ``And(incident(hub), value > 500)``
    through ``DeviceValueConjPlan`` against its host plan), logged beside
    the port's default; the reference's ``dbpedia_like`` at 4x its
    default scale (:data:`Q_ENTITIES` entities, :data:`Q_TRIPLES` links,
    seed 13) through ``bulk_import``, packed, its three longest incidence
    rows the hubs; bench.py c3's 1024 anchor pairs (``default_rng(42)``,
    links of the most common property) through ``graph.find_all`` one
    query at a time in two forms, ``And(AtomType(int), Incident,
    Incident)`` and ``And(Incident, Incident, AtomValue(p))``, each
    answer equal to numpy over the pack, queries/s; the hub queries (h1 ∩
    h2, h1 ∩ h2 ∩ h3, int ∩ h1 ∩ h2, h1's value window) at the port's
    default and on the host: equal to numpy and to each other, K3
    launching exactly once a device-branch run and never on the host,
    both timed host to host; the same after ``enable_incremental`` and a
    batch of adds and removes on the hubs (the value plan's memtable
    correction); then ``wordnet_like`` at its defaults:
    ``HGBreadthFirstTraversal`` from 64 seeds at 1, 2 and 3 hops equal to
    ``bfs_pull`` on the card (fused, K2; staged, K1), ``serve_bfs`` and
    ``find_all(bfs)``, unbounded DFS equal to BFS. K3's record gains its
    launches through ``find_all``; c3's two forms are profiled last.
16. The serve runtime (after 15), each leg at its bench's defaults on a
    graph of 200,000 entities and 400,000 links through ``bulk_import``:
    bench c6 (:func:`serve_c6`: the one-request baseline on the quiet
    graph, every batch on the fused route padded to 32 lanes; 4,096
    open-loop Poisson arrivals at 2,000/s, 2 hops, deadline 1.0 s, beside
    a writer of 20 x 10,000 links, starting at its first commit; K2 and K1
    (the overlay) launching in the window; then 64 seeds at lag 0 on the
    fused route and again with 50 links removed on the dense route, and a
    1024-lane batch at lag 0 on the fused route with the overlay, each
    equal to a host BFS over the live graph), bench c10 at its defaults
    (:func:`serve_c10`: 64 standing subscriptions through
    ``sub.SubscriptionManager``, patterns on the hubs and value windows
    over the ingest's values; 4,096 single-anchor requests at 1,000/s,
    deadline 2.0 s, beside 8 x 5,000 links into 16 hubs; the standing tier
    settled, its first 16 subscriptions' folded deltas equal to their full
    evaluation and to an independent truth, no eval, pump or listener
    error; 64 anchors and the hubs equal to ``find_all(Incident)`` through
    ``submit_pattern`` and ``submit_query``, before and after a compaction
    that puts the hubs' rows over ``pattern_pad``), bench c9 (:func:`serve_c9`: a closed-loop
    flood of 4,096 range requests, twice, every answer against the
    generator's own values; the host scan through ``find_all`` over 12
    windows, best of 2, each equal to the same values). Every leg fails
    on a breaker trip, a retry or an error, and on host fallbacks other
    than the routing rules'; each logs its requests/s, shed, batches,
    occupancy, percentiles and the wall time a batch spends in launch and
    in collect, and its 1024-lane batch alone.
17. The join lane (after 16): bench c11 at its defaults through
    ``ServeRuntime`` on the card (:func:`serve_c11`: 100,000 entities and
    300,000 locality-clustered links through ``bulk_import``, c11's
    manager, 2,048 Poisson arrivals of anchored triangles at 200/s,
    deadline 5.0 s, beside a writer of 8 x 2,000 links with a compaction
    awaited after each); then, each exact: (a) 64 fresh probes equal to
    ``join.host_join`` and to a numpy triangle count from the live
    graph's incidence; (b) on a quiet base, a small pure-add link (device
    dispatch, a partial correction), a dirty set past ``join_dirty_max``
    and a tombstone (both on the host), each batch equal to the host; (c)
    a hub-anchored batch through the degree split (hub dispatches > 0),
    equal to the host; (d) on phase 15's graph, ``find_all`` of
    co-incidence conjunctions over its hubs at the default
    ``QueryConfig``, on the host plan and on the device arm, equal, with
    the cost model's two estimates and the wall times. Fails on any
    breaker trip, retry or error, any host fallback outside the lane's
    routing rules, and any declined factorized build.
18. The bit-packed push BFS (``ops/bitfrontier.bfs_packed``, after 13):
    bench c2 at its defaults (``zipf_hypergraph`` of 80,000 nodes and
    40,000 links, 1,024 seeds, 2 hops; best of 3, edges/s beside the two
    host baselines, peak memory against ``bfs_memory_bytes``), then the
    10M snapshot with phase 4's first 1,024 seeds, 3 hops, 256-seed
    blocks; each run's visited words and edge counts equal the fused pull
    BFS and 16 lanes the host BFS; one 256-seed block with levels against
    the hop at which the staged chain first sets each bit.
19. Cold start and persistence (after 18): the 10M snapshot through
    ``save_snapshot(with_plans=True)`` and ``load_snapshot`` (every array
    equal, the pull plans attached with no build, the fused and staged
    BFS over it equal to phase 4's host truth, K2 and K1 launched); its
    plans through an ``AOTCache`` and ``HG_PLAN_CACHE`` over a fresh copy
    (disk hits, equal plans); the ``ckpt.save_plans`` crash point fired
    during a second save (the checkpoint still loads and serves); bench
    c6's cold-start probe in two fresh processes, the plan cache empty
    then full (the second with no miss and a disk hit), both answers
    equal to a host BFS.
11. The device's busy share of the main path (fused and staged), the
    h1 ∩ h2 intersection, the pattern windows, the two served delta
    routes, a join triangle window and a hub-heavy split dispatch, a
    1024-lane range batch and a window of c3's value leg, from
    ``torch.profiler``, after every timed phase; the join's binary
    searches are named ranges, their device time logged; one served
    1024-lane batch of each of phase 16's legs and one 256-lane join batch
    of phase 17; the packed BFS of c2 and of one 10M block.

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
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM device-memory rate, bytes/s (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores, the table's closest
#: entry for the kernels' 32-bit integer ORs, ops/s
ALU_OPS_PER_S = 67e12

N_SEEDS, HOPS = 4096, 3
#: seed lanes checked against the host BFS: the served requests' lanes
#: 0..4, and two in each 128-byte line of a 4096-seed bitmap row (lane k
#: lies in line k // 1024)
HOST_LANES = (0, 1, 2, 3, 4, 1100, 1500, 2200, 2600, 3300, 4095)
#: timed runs of each path (fused and staged alternate)
TIMED_RUNS = 5
SERVE_SEEDS, SERVE_TOP_R = 5, 16
#: warm calls of each served route timed host to host (median and spread)
SERVE_RUNS = 10

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
        #: phase 15's graph, its manager and hubs, for phase 17 (d)
        self.query_graph = None

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
                      reps: int = 1, setup=None, teardown=None) -> None:
        """Queue ``fn`` for :func:`phase_profiles`: ``reps`` runs under
        ``torch.profiler``, set against ``unprofiled_ms``, the wall time of
        one run without it; ``setup`` and ``teardown``, where given, run
        just before and after, outside the profile."""
        self.profiles.append((name, fn, unprofiled_ms, reps, setup, teardown))

    @staticmethod
    def bound_ms(nbytes: int, ops: int) -> float:
        """The larger of ``nbytes`` over the memory rate and ``ops`` over
        the ALU rate, in milliseconds."""
        return max(nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S) * 1e3

    def record(self, name, src, replaces, n, err, ms, plain, nbytes, ops,
               library_ms=None) -> dict:
        """One entry of the ``kernels`` JSON line; the bound is
        :meth:`bound_ms` of ``nbytes`` and ``ops``."""
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / ALU_OPS_PER_S * 1e3
        self.log(f"{name}: bound {max(bytes_ms, ops_ms):.6f} ms "
                 f"({nbytes} bytes, {ops} ops)")
        return {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": n, "max_abs_err": err,
            "ms": ms, "plain_ms": plain,
            "bound_ms": self.bound_ms(nbytes, ops),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
        }

    def rand_bits(self, rng, shape):
        import numpy as np

        words = rng.integers(0, 2**32, size=shape, dtype=np.uint64)
        return self.torch.from_numpy(
            words.astype(np.uint32).view(np.int32)).to(self.dev)

    def bitmap(self, rng, rows: int, kw: int, kind: str):
        """An (rows, kw) int32 bitmap on the card: ``random`` bits,
        ``sparse`` (random bits in 2 % of the 32-word lines, the rest zero)
        or ``ones`` (half the rows all ones, the rest random)."""
        import numpy as np

        words = rng.integers(0, 2**32, size=(rows, kw), dtype=np.uint64)
        words = words.astype(np.uint32)
        if kind == "sparse":
            live = rng.random((rows, -(-kw // 32))) < 0.02
            words[~np.repeat(live, 32, axis=1)[:, :kw]] = 0
        elif kind == "ones":
            words[rng.random(rows) < 0.5] = 0xFFFFFFFF
        return self.torch.from_numpy(words.view(np.int32)).to(self.dev)

    def masks(self, bm):
        """The input masks every kernel case runs with: none (every line
        live), the exact mask, and an all-set superset."""
        from hypergraphdb_tpu_torch.ops import linemask

        R, kw = bm.shape
        return (("none", None), ("exact", linemask.line_mask(bm)),
                ("full", linemask.full_mask(R, kw, self.dev)))


def phase_build(s: Smoke) -> None:
    from hypergraphdb_tpu_torch.ops import _cuda

    libs = _cuda.build_all()
    s.log(f"build: {len(libs)} kernels in {_cuda.last_build_seconds:.2f} s")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                s.log(f"ptxas {name}: {line.strip()}")


#: row widths (32-bit words) of the masked kernel cases: the served 64-seed
#: bucket, a ragged width, the main path's 4096 seeds (four 128-byte
#: lines) and eight lines
MASK_KWS = (2, 3, 128, 256)
BITMAP_KINDS = ("random", "sparse", "ones")


def phase_k1(s: Smoke) -> None:
    import numpy as np

    from hypergraphdb_tpu_torch.ops import linemask
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
    # output into a later section of the buffer it reads (pyramid levels),
    # which starts zeroed: out holds a subset of the result
    buf = s.rand_bits(rng, (600, 128))
    buf[400:] = 0
    idx = torch.from_numpy(
        rng.integers(0, 400, size=1600).astype(np.int32)).to(s.dev)
    want = gather_or_plain(buf, idx, 8)
    gather_or(buf, idx, 8, out=buf[400:600])
    torch.cuda.synchronize()
    s.expect(torch.equal(buf[400:600], want), "K1 != plain into a section")
    # masked: every bitmap kind and input mask, into a section of a buffer
    # whose mask is emitted at an offset; out starts as zeros or as another
    # subset of the result
    n_masked = 0
    S, n_out, w, row0 = 3000, 4001, 8, 5
    for kw in MASK_KWS:
        for kind in BITMAP_KINDS:
            values = s.bitmap(rng, S, kw, kind)
            values[0] = 0  # the zero row, a quarter of the entries
            ix = rng.integers(0, S, size=n_out * w)
            ix[rng.random(ix.shape[0]) < 0.25] = 0
            idx = torch.from_numpy(ix.astype(np.int32)).to(s.dev)
            want = gather_or_plain(values, idx, w)
            for mname, mask in s.masks(values):
                for oname in ("zeros", "subset"):
                    buf = torch.zeros((n_out + row0, kw), dtype=torch.int32,
                                      device=s.dev)
                    if oname == "subset":
                        buf[row0:] = want & s.rand_bits(rng, (n_out, kw))
                    bmask = linemask.empty_mask(n_out + row0, kw, s.dev)
                    gather_or(values, idx, w, out=buf[row0:], mask=mask,
                              out_mask=bmask, mask_row0=row0)
                    torch.cuda.synchronize()
                    what = f"kw={kw} {kind} mask={mname} out={oname}"
                    s.expect(torch.equal(buf[row0:], want), f"K1 != plain, {what}")
                    s.expect(torch.equal(bmask, linemask.line_mask(buf)),
                             f"K1 emitted mask != line_mask(out), {what}")
                    n_masked += 1
    s.log(f"K1 gather_or: bit-exact against plain on {len(cases) + 1} "
          f"unmasked and {n_masked} masked cases (kw {MASK_KWS}, bitmaps "
          f"{BITMAP_KINDS}, masks none/exact/full, out zeros/subset, "
          f"emitted masks exact)")


def phase_k2(s: Smoke) -> None:
    import numpy as np

    from hypergraphdb_tpu_torch.models import dbpedia_snapshot
    from hypergraphdb_tpu_torch.ops import ellbfs, fused_bfs, linemask

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
    # masked: every bitmap kind and input mask, on the plan and on a
    # self-heavy twin (40 % of its real entries the row's own id)
    chunk_row = torch.repeat_interleave(
        plan.item_row, plan.item_off[1:] - plan.item_off[:-1])
    entry_row = chunk_row.repeat_interleave(plan.w).to(torch.int32)
    heavy = (torch.from_numpy(rng.random(plan.idx.shape[0]) < 0.4).to(s.dev)
             & (plan.idx != geom.zero_row))
    plans = {"plan": plan,
             "self-heavy": plan._replace(idx=torch.where(heavy, entry_row,
                                                         plan.idx))}
    n_masked = 0
    for kw in MASK_KWS:
        for kind in BITMAP_KINDS:
            old = s.bitmap(rng, geom.n_rows, kw, kind)
            old[geom.zero_row] = 0
            for pname, p in plans.items():
                want = fused_bfs.fused_hop_plain(old, p)
                for mname, mask in s.masks(old):
                    for oname in ("zeros", "subset"):
                        out = torch.zeros_like(old) if oname == "zeros" \
                            else old & s.rand_bits(rng, old.shape)
                        om = linemask.full_mask(geom.n_rows, kw, s.dev)
                        got = fused_bfs.fused_hop(old, p, out=out, mask=mask,
                                                  out_mask=om)
                        torch.cuda.synchronize()
                        what = (f"kw={kw} {kind} {pname} mask={mname} "
                                f"out={oname}")
                        s.expect(torch.equal(got, want), f"K2 != plain, {what}")
                        s.expect(torch.equal(om, linemask.line_mask(got)),
                                 f"K2 emitted mask != line_mask(out), {what}")
                        n_masked += 1
    s.log(f"K2 fused_hop: bit-exact against plain ({geom.n_rows} rows, "
          f"{geom.n_chunks} chunks, {split_rows} split hub rows) unmasked "
          f"and on {n_masked} masked cases (kw {MASK_KWS}, bitmaps "
          f"{BITMAP_KINDS}, self-heavy plan, masks none/exact/full, out "
          f"zeros/subset, emitted masks exact)")

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
    audited = mask_audit(s, snap, torch.from_numpy(seeds[:64]).to(s.dev))
    s.log(f"mask audit, 64-seed BFS: {audited} masks entering hops (fused "
          f"and staged) equal line_mask of their bitmaps")


def mask_audit(s: Smoke, snap, seeds, keep=None) -> int:
    """Run ``seeds`` (a multiple of 32, on the card) through the fused and
    the staged BFS with a hook that holds the mask entering every hop, and
    the final one, against ``line_mask`` of its bitmap. ``keep(h, visited,
    mask)``, when given, also sees the fused path's. Returns the masks
    checked."""
    from hypergraphdb_tpu_torch.ops import ellbfs, fused_bfs, linemask

    n = [0]

    def hook(path, h, visited, mask):
        s.expect(s.torch.equal(mask, linemask.line_mask(visited)),
                 f"{path} BFS: mask entering hop {h} != line_mask")
        n[0] += 1
        if keep is not None and path == "fused":
            keep(h, visited, mask)

    plan, geom = fused_bfs.device_fused_plan(snap, s.dev)
    fused_bfs.bfs_fused(plan, seeds, geom, HOPS, count_edges=False,
                        clear_dummy=True,
                        hop_hook=lambda *a: hook("fused", *a))
    ellbfs._bfs_pull_device(ellbfs.device_plans(snap, s.dev),
                            ellbfs.plans_for(snap), seeds, HOPS,
                            ellbfs.PLAIN_CHUNK, False,
                            hop_hook=lambda *a: hook("staged", *a))
    s.torch.cuda.synchronize()
    return n[0]


def full_fields(torch, bitmap):
    """(R,) int64: per row of an (R, kw) int32 bitmap, the field of its
    lines whose every bit is set (where a saturated lane stops)."""
    import torch.nn.functional as F

    from hypergraphdb_tpu_torch.ops import linemask

    R, kw = bitmap.shape
    G, L = linemask.line_words(kw), linemask.n_lines(kw)
    lines = torch.arange(L, device=bitmap.device, dtype=torch.int64)
    out = torch.empty(R, dtype=torch.int64, device=bitmap.device)
    for s in range(0, R, linemask.ROW_BLOCK):
        blk = bitmap[s : s + linemask.ROW_BLOCK]
        if L * G != kw:
            blk = F.pad(blk, (0, L * G - kw), value=-1)
        full = (blk.reshape(blk.shape[0], L, G) == -1).all(-1)
        out[s : s + blk.shape[0]] = (full.to(torch.int64) << lines).sum(1)
    return out


def live_lines(bitmap) -> int:
    """The nonzero lines of an (R, kw) int32 bitmap."""
    from hypergraphdb_tpu_torch.ops import linemask

    f = linemask.row_fields_of(bitmap)
    return sum(int(((f >> l) & 1).sum())
               for l in range(linemask.n_lines(bitmap.shape[1])))


def data_need(torch, vals, vmask, idx, rows_of, n_out: int, own_full=None,
              block: int = 1 << 24) -> dict:
    """What one K1 or K2 launch on this data must read, counted on the
    card. ``vals`` is the bitmap the entries of ``idx`` point into, with
    its exact mask ``vmask``; ``rows_of(a, b)`` gives the output row of
    entries ``a..b-1`` (int64); ``own_full`` (K2) the full-line fields of
    each output row's own row, which K2 reads where its line is nonzero.
    An (output row, line) needs no source line if its own line is all
    ones, its first all-ones source line if it has one (the saturation
    exit), else every live source line; self entries (K2) add nothing.

    Returns the entries with a nonzero source (``live``), the (entry, line)
    pairs whose line is nonzero (``pairs``), the self entries (``self``),
    the index entries of rows not saturated from the start (``idx``), the
    line loads the data needs (``loads``) and the distinct lines of
    ``vals`` among them, own lines included (``lines``): each read once."""
    from hypergraphdb_tpu_torch.ops import linemask

    kw = vals.shape[1]
    L = linemask.n_lines(kw)
    dev = vals.device
    full = linemask.pack_fields(full_fields(torch, vals), kw)
    end = idx.shape[0]
    cnt = torch.zeros((L, n_out), dtype=torch.int64, device=dev)
    first = torch.full((L, n_out), end, dtype=torch.int64, device=dev)
    lines = torch.arange(L, device=dev, dtype=torch.int64)
    own = (torch.zeros((L, n_out), dtype=torch.bool, device=dev)
           if own_full is None
           else ((own_full[None, :] >> lines[:, None]) & 1).bool())
    got = {"live": 0, "pairs": 0, "idx": 0, "self": 0}

    def fields(s):
        """(entries, rows, live fields, full fields) of block ``s``, self
        entries' fields cleared."""
        ix = idx[s : s + block]
        r = rows_of(s, s + ix.shape[0])
        f = linemask.fields_at(vmask, ix, kw)
        u = linemask.fields_at(full, ix, kw)
        if own_full is not None:
            other = ix.to(torch.int64) != r
            f, u = f * other, u * other
        return ix, r, f, u

    for s in range(0, end, block):
        ix, r, f, u = fields(s)
        f0 = linemask.fields_at(vmask, ix, kw)
        got["live"] += int((f0 != 0).sum())
        got["pairs"] += sum(int(((f0 >> l) & 1).sum()) for l in range(L))
        if own_full is None:
            got["idx"] += ix.shape[0]
        else:
            got["self"] += int((ix.to(torch.int64) == r).sum())
            got["idx"] += int((own_full[r] != (1 << L) - 1).sum())
        e = torch.arange(s, s + ix.shape[0], device=dev, dtype=torch.int64)
        for l in range(L):
            cnt[l].index_add_(0, r, (f >> l) & 1)
            first[l].scatter_reduce_(0, r, torch.where(
                ((u >> l) & 1).bool(), e, end), "amin")
    sat = first < end
    got["loads"] = int(torch.where(own, 0, torch.where(sat, 1, cnt)).sum())
    used = torch.zeros((L, vals.shape[0]), dtype=torch.bool, device=dev)
    for l in range(L):
        pick = sat[l] & ~own[l]
        used[l, idx[first[l][pick]].long()] = True
    if own_full is not None:  # the own rows' nonzero lines
        f_own = linemask.fields_at(vmask, torch.arange(n_out, device=dev), kw)
        for l in range(L):
            used[l] |= ((f_own >> l) & 1).bool()
    for s in range(0, end, block):
        ix, r, f, _ = fields(s)
        for l in range(L):
            keep = ((f >> l) & 1).bool() & ~sat[l][r] & ~own[l][r]
            used[l, ix[keep].long()] = True
    got["lines"] = int(used.sum())
    return got


def phase_hops(s: Smoke, snap, seeds, final) -> dict:
    """Phase 6 at each hop's real input. The 4096-seed BFS runs once more on
    both paths under :func:`mask_audit` (every mask entering a hop, and the
    final one, equal to ``line_mask`` of its bitmap), keeping the fused
    path's bitmap and mask entering each hop. Then K2 is timed on each, and
    K1 at every level of each hop's staged chain, each with its mask and
    without one (every line live: the self skip and the saturation exit
    alone), each run into zeros and held against the kernel's plain
    version on the same inputs, with its emitted mask against ``line_mask``
    of its output. K2's plain output must also equal the next hop's input
    (``final`` after the last), and so must the staged chain's visited
    update. Returns, per kernel, the keys its ``kernels`` record gains: ms
    per hop (with and without masks) and per BFS; the bound of a BFS (the
    per-launch bound's definition, summed over the BFS's launches); and the
    data bound per hop and per BFS, from what :func:`data_need` counts."""
    from hypergraphdb_tpu_torch.ops import ellbfs, fused_bfs, linemask
    from hypergraphdb_tpu_torch.ops.gather_or import gather_or, gather_or_plain

    torch = s.torch
    hop_in = {}

    def keep(h, visited, mask):
        if h < HOPS:
            hop_in[h] = (visited.clone(), mask.clone())

    audited = mask_audit(s, snap, seeds, keep=keep)
    s.log(f"mask audit, {seeds.shape[0]}-seed BFS at full size: {audited} "
          f"masks entering hops (fused and staged) equal line_mask of their "
          f"bitmaps")
    n_pad, kw = final.shape
    row_bytes = kw * 4
    line_bytes = min(linemask.line_words(kw), kw) * 4
    line_ops = min(linemask.line_words(kw), kw)

    def expect_next(h, got, what):
        want = hop_in[h + 1][0] if h + 1 < HOPS else final
        s.expect(torch.equal(got[: want.shape[0]], want),
                 f"{what} at hop {h + 1}'s input != the BFS's next bitmap")

    def runs(what, sec, want, launch, masks):
        """Time ``launch(mask, out_mask)`` with each (name, mask, out_mask,
        times) of ``masks``, each into zeros, and hold ``sec`` against
        ``want`` after each."""
        for name, mask, om, times in masks:
            sec.zero_()
            times.append(s.time_ms(lambda: launch(mask, om), 3))
            s.expect(torch.equal(sec, want), f"{what}, {name}, != plain")

    # K2: one launch a hop
    dplan, geom = fused_bfs.device_fused_plan(snap, s.dev)
    k2_bound = s.bound_ms(
        2 * geom.n_rows * row_bytes + dplan.idx.numel() * 4
        + dplan.item_off.numel() * 8 + dplan.item_row.numel() * 4,
        (dplan.idx.numel() + geom.n_rows) * kw)
    chunk_row = torch.repeat_interleave(
        dplan.item_row, dplan.item_off[1:] - dplan.item_off[:-1]).long()
    w2 = dplan.w

    def fused_rows(a, b):
        return chunk_row[a // w2 : b // w2].repeat_interleave(w2)

    out = torch.zeros_like(hop_in[0][0])
    om, om_bare = (torch.empty_like(hop_in[0][1]) for _ in range(2))
    k2_ms, k2_bare, k2_data = [], [], []
    for h in range(HOPS):
        old, m = hop_in[h]
        want = fused_bfs.fused_hop_plain(old, dplan)
        expect_next(h, want, "K2's plain version")
        runs(f"K2 at hop {h + 1}'s input", out, want,
             lambda mask, o: fused_bfs.fused_hop(old, dplan, out=out,
                                                 mask=mask, out_mask=o),
             (("masked", m, om, k2_ms), ("unmasked", None, om_bare, k2_bare)))
        for name, o in (("masked", om), ("unmasked", om_bare)):
            s.expect(torch.equal(o, linemask.line_mask(want)),
                     f"K2 {name} mask at hop {h + 1} != line_mask")
        del want
        got = data_need(torch, old, m, dplan.idx, fused_rows, geom.n_rows,
                        own_full=full_fields(torch, old), block=w2 << 21)
        k2_data.append(s.bound_ms(
            got["idx"] * 4 + dplan.item_off.numel() * 8
            + dplan.item_row.numel() * 4 + 2 * m.numel() * 4
            + (got["lines"] + live_lines(out)) * line_bytes,
            got["loads"] * line_ops))
        n = dplan.idx.numel()
        s.log(f"K2 hop {h + 1}: {k2_ms[-1]:.3f} ms, {k2_bare[-1]:.3f} ms "
              f"without a mask (bound {k2_bound:.3f} ms, data bound "
              f"{k2_data[-1]:.3f} ms); of {n} entries {got['live'] / n:.4%} "
              f"have a nonzero source, {got['pairs'] / (4 * n):.4%} of "
              f"(entry, line) pairs are live, {got['self'] / n:.4%} are the "
              f"row itself; the data needs {got['idx']} index entries, "
              f"{got['loads']} line loads, {got['lines']} distinct lines")
    del out, om, om_bare, chunk_row

    # K1: every level of both stages, as _bfs_pull_device runs them
    plans = ellbfs.plans_for(snap)
    dp = ellbfs.device_plans(snap, s.dev)
    stages = []
    for levels, widths, rows in ((dp["levels1"], plans.stage1.widths,
                                  dp["rows1"]),
                                 (dp["levels2"], plans.stage2_widths,
                                  dp["rows2"])):
        buf = torch.zeros((rows, kw), dtype=torch.int32, device=s.dev)
        stages.append((levels, widths, buf,
                       linemask.empty_mask(rows, kw, s.dev),
                       linemask.empty_mask(rows, kw, s.dev)))
    level_bounds, k1_ms, k1_level_ms, k1_bare = [], [], [], []
    k1_data, k1_level_data = [], []
    for h in range(HOPS):
        visited = hop_in[h][0][:n_pad]
        vmask = linemask.line_mask(visited)
        src, smask = visited, vmask
        times, bare, data = [], [], []
        level0 = None
        for levels, widths, buf, bmask, bmask_bare in stages:
            buf[-1].zero_()
            bmask.zero_()
            bmask_bare.zero_()
            off = 0
            for i, (idx, w) in enumerate(zip(levels, widths)):
                n = idx.shape[0] // w
                sec = buf[off : off + n]
                if h == 0:  # each used row read once, the output written
                    used = torch.zeros(src.shape[0], dtype=torch.bool,
                                       device=s.dev)
                    used[idx.long()] = True
                    level_bounds.append(s.bound_ms(
                        int(used.sum()) * row_bytes + idx.numel() * 4
                        + n * row_bytes, idx.numel() * kw))
                    del used
                want = gather_or_plain(src, idx, w)
                runs(f"K1 at hop {h + 1}'s input, level {len(times)}", sec,
                     want,
                     lambda mask, o: gather_or(src, idx, w, out=sec,
                                               mask=mask, out_mask=o,
                                               mask_row0=off),
                     (("masked", smask, bmask, times),
                      ("unmasked", None, bmask_bare, bare)))
                del want
                got = data_need(torch, src, smask, idx,
                                lambda a, b: torch.arange(
                                    a, b, device=s.dev) // w, n)
                level0 = got if level0 is None else level0
                data.append(s.bound_ms(
                    got["idx"] * 4 + smask.numel() * 4
                    + -(-n * linemask.field_bits(kw) // 8)
                    + (got["lines"] + live_lines(sec)) * line_bytes,
                    got["loads"] * line_ops))
                off += n
                src, smask = buf, bmask
            for name, o in (("masked", bmask), ("unmasked", bmask_bare)):
                s.expect(torch.equal(o, linemask.line_mask(buf)),
                         f"K1 {name} stage mask at hop {h + 1} != line_mask")
        nxt, nmask = visited.clone(), vmask.clone()
        ellbfs._visited_update(nxt, nmask, stages[1][2], stages[1][3],
                               dp["out_map"], plans.n_atoms)
        expect_next(h, nxt, "K1 chain")
        s.expect(torch.equal(nmask, linemask.line_mask(nxt)),
                 f"visited mask after hop {h + 1} != line_mask")
        del nxt, nmask
        k1_ms.append(sum(times))
        k1_bare.append(sum(bare))
        k1_level_ms.append(times)
        k1_data.append(sum(data))
        k1_level_data.append(data)
        n = dp["levels1"][0].numel()
        s.log(f"K1 hop {h + 1}: {len(times)} levels "
              f"{[round(t, 4) for t in times]} ms, {k1_ms[-1]:.3f} ms, "
              f"{k1_bare[-1]:.3f} ms without masks (bound "
              f"{sum(level_bounds):.3f} ms, data bound {k1_data[-1]:.3f} ms, "
              f"per level {[round(t, 4) for t in data]}); level-0 entries "
              f"with a nonzero source {level0['live'] / n:.4%}, live (entry, "
              f"line) pairs {level0['pairs'] / (4 * n):.4%}")
    hop_in.clear()
    s.log(f"per BFS: K2 {sum(k2_ms):.3f} ms over {HOPS} launches "
          f"({sum(k2_bare):.3f} ms without masks; bound "
          f"{HOPS * k2_bound:.3f} ms, data bound {sum(k2_data):.3f} ms), K1 "
          f"{sum(k1_ms):.3f} ms over {HOPS * len(level_bounds)} launches "
          f"({sum(k1_bare):.3f} ms without masks; bound "
          f"{HOPS * sum(level_bounds):.3f} ms, data bound "
          f"{sum(k1_data):.3f} ms)")
    return {
        "fused_hop": {"hop_ms": k2_ms, "bfs_ms": sum(k2_ms),
                      "bfs_bound_ms": HOPS * k2_bound,
                      "hop_data_bound_ms": k2_data,
                      "bfs_data_bound_ms": sum(k2_data),
                      "hop_ms_no_mask": k2_bare},
        "gather_or": {"hop_ms": k1_ms, "bfs_ms": sum(k1_ms),
                      "bfs_bound_ms": HOPS * sum(level_bounds),
                      "hop_data_bound_ms": k1_data,
                      "bfs_data_bound_ms": sum(k1_data),
                      "hop_ms_no_mask": k1_bare,
                      "level_ms": k1_level_ms,
                      "level_bound_ms": level_bounds,
                      "level_data_bound_ms": k1_level_data},
    }


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


def served_ms(s: Smoke, fn, runs: int = SERVE_RUNS) -> list:
    """Host-to-host milliseconds of ``runs`` warm calls of ``fn`` (after
    one warm-up), each ending in a synchronise."""
    torch = s.torch
    fn()
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def spread(ms: list) -> str:
    import numpy as np

    return (f"median {float(np.median(ms)):.3f} ms (min {min(ms):.3f}, max "
            f"{max(ms):.3f}, {len(ms)} warm calls)")


def window(ids, top_r: int = SERVE_TOP_R):
    """The served ``first_r`` row of a sorted reach set: its ``top_r``
    smallest ids, SENTINEL-padded."""
    import numpy as np

    from hypergraphdb_tpu_torch.ops import fused_bfs

    want = np.full(top_r, int(fused_bfs.SENTINEL), np.int64)
    head = np.asarray(ids[:top_r], dtype=np.int64)
    want[: len(head)] = head
    return want


def phase_main(s: Smoke, snap, info, records: dict) -> dict:
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
    host = [pool.submit(host_bfs, snap, int(seeds[k]), HOPS)
            for k in HOST_LANES]

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
    s.log(f"host BFS of {len(HOST_LANES)} seeds done, waited "
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

    rows = ellbfs.visited_rows(res_f, N, lanes=HOST_LANES)
    reach = res_f.reach_counts.cpu().numpy()
    for k, got, (want, want_edges) in zip(HOST_LANES, rows, host_results):
        s.expect(np.array_equal(got, want),
                 f"seed lane {k}: reach set differs from the host BFS")
        s.expect(int(reach[k]) == len(want), f"seed lane {k}: reach count")
        s.expect(int(res_f.edges_touched[k]) == want_edges,
                 f"seed lane {k}: edge count differs from the host BFS")
    s.log(f"host BFS: seed lanes {HOST_LANES} agree (reach sizes "
          f"{[int(reach[k]) for k in HOST_LANES]})")

    # served path: a few requests padded to the 64-seed bucket; the first
    # call alone is what earlier versions of this script timed
    t0 = time.perf_counter()
    counts, first_r = serve_bfs(snap, seeds[:SERVE_SEEDS], HOPS, SERVE_TOP_R,
                                device=s.dev)
    first_ms = (time.perf_counter() - t0) * 1e3
    truth = dict(zip(HOST_LANES, host_results))
    for k in range(SERVE_SEEDS):
        s.expect(int(counts[k]) == int(reach[k]) == len(truth[k][0]),
                 f"served count lane {k}")
        s.expect(np.array_equal(first_r[k].astype(np.int64),
                                window(truth[k][0])),
                 f"served first_r lane {k}")
    serve_ms = served_ms(s, lambda: serve_bfs(
        snap, seeds[:SERVE_SEEDS], HOPS, SERVE_TOP_R, device=s.dev))
    s.log(f"served: {SERVE_SEEDS} requests in the 64 bucket, top_r "
          f"{SERVE_TOP_R}, match the main path and the host BFS; first "
          f"call {first_ms:.1f} ms; {spread(serve_ms)}, runs "
          f"{[round(t, 1) for t in serve_ms]}")

    # kernel timing at the main path's shapes (final visited bitmap as data)
    visited = res_s.visited_t
    kw = visited.shape[1]
    row_bytes = kw * 4
    del results, res_s, res_f
    per_hop = phase_hops(s, snap, torch.from_numpy(seeds).to(s.dev), visited)
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
    out_k = torch.zeros((n_out, kw), dtype=torch.int32, device=s.dev)
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
    s.log(f"K1 at stage-1 level 0 on the final bitmap, no mask: {n_out} "
          f"rows x {w1}, {k1_ms:.3f} ms "
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
    s.log(f"K2 one hop on the final bitmap, no mask: {geom.n_items} items, "
          f"{k2_ms:.3f} ms kernel, "
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
    for rec in records["kernels"][-2:]:
        rec.update(per_hop[rec["name"]])
    return {"seeds": seeds, "host": truth}


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


def ragged(others):
    """The real rows of a SENTINEL-padded (M, Lo) matrix, back to back:
    ``(flat, offsets)``."""
    import numpy as np

    from hypergraphdb_tpu_torch.ops.setops import SENTINEL

    rows = [row[row != SENTINEL] for row in others]
    offsets = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(r) for r in rows], out=offsets[1:])
    flat = np.concatenate(rows) if rows else np.zeros(0, np.int32)
    return flat.astype(np.int32), offsets


#: the kernel's tile, chunk and search switch (``csrc/membership.cu``
#: kTile, kChunk, kSearchRatio), to say which route a case takes
K3_TILE, K3_CHUNK, K3_SEARCH_RATIO = 1024, 2048, 16


def first_row_routes(base, row) -> dict:
    """Tiles of ``base`` by the route they take at their first row: window
    longer than one chunk and than K3_SEARCH_RATIO times the tile's live
    count (``search``), else ``stream``, and how many streamed tiles need
    more than one chunk."""
    import numpy as np

    from hypergraphdb_tpu_torch.ops.setops import SENTINEL

    out = {"search": 0, "stream": 0, "multi_chunk": 0}
    for t0 in range(0, len(base), K3_TILE):
        tile = base[t0 : t0 + K3_TILE]
        tile = tile[tile != SENTINEL]
        if not len(tile):
            continue
        w = (np.searchsorted(row, tile[-1], "right")
             - np.searchsorted(row, tile[0], "left"))
        if w > K3_CHUNK and w > K3_SEARCH_RATIO * len(tile):
            out["search"] += 1
        else:
            out["stream"] += 1
            out["multi_chunk"] += int(w > K3_CHUNK)
    return out


def k3_ragged_cases(rng):
    """Named ragged K3 cases: ``(base (Lb,) int32 with any SENTINEL tail,
    rows)``."""
    import numpy as np

    from hypergraphdb_tpu_torch.ops.setops import SENTINEL

    top = int(SENTINEL)

    def draw(lo, hi, n):
        return np.unique(rng.integers(lo, hi, size=n)).astype(np.int32)

    def mixed(base, lo, hi, n):
        """n draws in [lo, hi) plus about half of ``base``."""
        pick = base[rng.random(len(base)) < 0.5]
        return np.union1d(pick, draw(lo, hi, n)).astype(np.int32)

    hub = draw(0, 10_000_000, 800_000)[:758_572]
    short = np.union1d(hub[rng.random(len(hub)) < 0.0007],
                       draw(0, 10_000_000, 500))[:K3_TILE - 24]
    short = short.astype(np.int32)
    cases = {"short base x 758K row (search)": (short, [hub])}
    dense = draw(0, 1_000_000, 52_000)
    cases["windows of several chunks (stream)"] = (
        dense, [mixed(dense, 0, 1_000_000, 500_000)])
    b = draw(0, 400_000, 120_000)
    cases["an empty row"] = (b, [mixed(b, 0, 400_000, 90_000),
                                 np.zeros(0, np.int32),
                                 mixed(b, 0, 400_000, 50_000)])
    b = draw(top - 300_000, top, 100_000)
    cases["near INT32_MAX"] = (b, [mixed(b, top - 300_000, top, 80_000),
                                   mixed(b, top - 300_000, top, 150_000)])
    for m in range(1, 6):
        b = draw(0, 2_000_000, 90_000 + 7 * m)
        cases[f"M = {m}"] = (b, [mixed(b, 0, 2_000_000, 60_000 * (j + 1))
                                 for j in range(m)])
    b = draw(0, 300_000, 70_000)
    cases["all flags clear at the first row"] = (
        b, [np.arange(300_000, 400_000, dtype=np.int32),
            mixed(b, 0, 300_000, 90_000), mixed(b, 0, 300_000, 60_000)])
    b = draw(0, 400_000, 60_000)[: 37 * K3_TILE + 5]
    tail = np.full(301, SENTINEL, np.int32)
    cases["Lb not a multiple of the tile, SENTINEL tail"] = (
        np.concatenate([b, tail]), [mixed(b, 0, 400_000, 70_000)])
    return cases


def phase_k3(s: Smoke) -> None:
    """K3 through both entries, each held bit for bit against its plain
    version: the padded cases of :data:`K3_CASES` in both forms, then the
    ragged cases of :func:`k3_ragged_cases`, each also from a row buffer
    that is not 16-byte aligned (the kernel's 4-byte copy route)."""
    import numpy as np

    from hypergraphdb_tpu_torch.ops.membership import (
        membership_mask,
        membership_mask_ragged,
    )
    from hypergraphdb_tpu_torch.ops.setops import (
        intersect_mask_many,
        intersect_mask_ragged,
    )

    torch = s.torch
    rng = np.random.default_rng(4)

    def check_ragged(base, flat, offsets, what):
        b = torch.from_numpy(base).to(s.dev)
        want = None
        for shift in (0, 1):  # 16-byte aligned rows, then rows one int in
            buf = torch.zeros(len(flat) + shift, dtype=torch.int32,
                              device=s.dev)
            buf[shift:] = torch.from_numpy(flat).to(s.dev)
            f = buf[shift:]
            got = membership_mask_ragged(
                b, f, torch.from_numpy(offsets).to(s.dev),
                offsets_host=offsets)
            torch.cuda.synchronize()
            if want is None:
                want = intersect_mask_ragged(b, f, offsets)
            s.expect(torch.equal(got, want),
                     f"K3 ragged != plain: {what} (row shift {shift})")
        return want

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
        flat, offsets = ragged(others)
        want_r = check_ragged(base, flat, offsets, f"padded case Lb={lb}")
        s.expect(torch.equal(want_r, want), "ragged and padded plain differ")
        hits.append(int(want.sum()))
    s.log(f"K3 membership: bit-exact against plain on {len(K3_CASES)} "
          f"padded cases through both entries (matches per case {hits})")
    for name, (base, rows) in k3_ragged_cases(rng).items():
        flat, offsets = ragged(rows)
        want = check_ragged(base, flat, offsets, name)
        routes = first_row_routes(base, rows[0])
        if "(search)" in name:
            s.expect(routes["stream"] == 0, f"{name}: a tile streamed")
        if "(stream)" in name:
            s.expect(routes["search"] == 0 and routes["multi_chunk"] > 0,
                     f"{name}: routes {routes}")
        s.log(f"K3 ragged {name}: Lb {len(base)}, rows "
              f"{[len(r) for r in rows]}, {int(want.sum())} matches, "
              f"first-row routes {routes}; bit-exact against plain")


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


def skew_partner(snap, hub: int, degree: int) -> int:
    """The atom that shares a link with ``hub`` whose incidence row is
    nearest ``degree`` long: a mid-degree row whose intersection with the
    hub's is not empty."""
    import numpy as np

    links = snap.incidence_row(hub).astype(np.int64)
    starts, ends = snap.tgt_offsets[links], snap.tgt_offsets[links + 1]
    lens = ends - starts
    idx = np.repeat(starts - np.cumsum(lens) + lens, lens) + np.arange(
        lens.sum())
    targets = np.unique(snap.tgt_flat[idx])
    targets = targets[targets != hub]
    deg = snap.inc_offsets[targets + 1] - snap.inc_offsets[targets]
    return int(targets[np.argmin(np.abs(deg - degree))])


#: incidence-row length of the skewed intersection's short side
SKEW_DEGREE = 1000


def phase_intersect(s: Smoke, snap, info) -> int:
    """The planner's n-way intersection on the hub rows, through K3, with
    both ways to compact the result timed in turns, each after the same
    input checks and staging: on the card (what ``device_intersect_sorted``
    does) and by fetching the mask and indexing the base on the host.
    Returns K3's launches on this path."""
    import numpy as np

    from hypergraphdb_tpu_torch.ops.setops import (
        _check_sorted_ids,
        device_intersect_sorted,
        intersection_mask,
    )

    ids, rows = hub_rows(snap)
    th = top_property_type(snap, info)
    mid = skew_partner(snap, ids[0], SKEW_DEGREE)
    s.log(f"hubs {ids}: incidence rows {[len(r) for r in rows]}; type {th}: "
          f"{len(snap.type_set(th))} links; atom {mid}: "
          f"{len(snap.incidence_row(mid))} links")
    cases = {
        "h1&h2": rows[:2],
        "h1&h2&h3": rows,
        "h1&type": [rows[0], snap.type_set(th)],
        "mid&h1": [snap.incidence_row(mid), rows[0]],
    }
    routes = first_row_routes(cases["mid&h1"][0], rows[0])
    s.expect(routes["stream"] == 0, f"mid & h1 streamed a tile: {routes}")

    def host_compact(arrays):
        """The other compaction: ``device_intersect_sorted`` up to the
        mask, which is fetched to index the base on the host."""
        arrays = _check_sorted_ids(arrays)
        _, mask = intersection_mask(arrays, s.dev)
        return arrays[0][mask.cpu().numpy()].astype(np.int64)

    ways = {"card": lambda a: device_intersect_sorted(a, device=s.dev),
            "host": host_compact}
    for way in ways.values():  # warm
        way(cases["h1&h2"])
    secs = {(name, w): [] for name in cases for w in ways}

    def run(name, w):
        t0 = time.perf_counter()
        got = ways[w](cases[name])
        secs[name, w].append(time.perf_counter() - t0)
        return got

    reset_launches()
    results = {name: run(name, "card") for name in cases}
    n = launches()["membership"]
    s.log(f"K3 launches on the intersection path: {n} for {len(cases)} "
          f"calls")
    s.expect(n == len(cases), "an intersection call did not launch K3")
    alt = {name: run(name, "host") for name in cases}
    for i in range(TIMED_RUNS - 1):
        for name in cases:
            for w in (("card", "host") if i % 2 else ("host", "card")):
                run(name, w)
    for name, arrays in cases.items():
        want = arrays[0].astype(np.int64)
        for a in arrays[1:]:
            want = np.intersect1d(want, a)
        s.expect(np.array_equal(results[name], want),
                 f"device_intersect_sorted {name} != np.intersect1d")
        s.expect(np.array_equal(alt[name], want),
                 f"host compaction {name} != np.intersect1d")
        for w in ways:
            t = secs[name, w]
            s.log(f"intersect {name} (compact on the {w}): {len(want)} ids, "
                  f"host to host {[round(x * 1e3, 3) for x in t]} ms, "
                  f"median {np.median(t) * 1e3:.3f} ms")
    s.log(f"intersect mid&h1: first-row routes {routes}")
    s.profile_later("intersect h1&h2",
                    lambda: device_intersect_sorted(cases["h1&h2"], s.dev),
                    float(np.median(secs["h1&h2", "card"])) * 1e3, reps=20)
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


def c3_pairs(snap, info):
    """``(pairs, th)``: bench.py c3's anchor pairs (the first two targets of
    random links of the most common property type) and that type."""
    import numpy as np

    th = top_property_type(snap, info)
    r = np.random.default_rng(PATTERN_SEED)
    cands = snap.type_set(th)
    links = cands[r.integers(0, len(cands), size=PATTERN_PAIRS)]
    starts = snap.tgt_offsets[links].astype(np.int64)
    pairs = np.stack([snap.tgt_flat[starts], snap.tgt_flat[starts + 1]],
                     axis=1).astype(np.int32)
    return pairs, th


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
    pairs, th = c3_pairs(snap, info)
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


#: bytes written between launches for the cold-L2 times (the L2 is 50 MB)
FLUSH_BYTES = 256 << 20
#: K3 launches captured in one CUDA graph, graph replays, spaced launches
GRAPH_LAUNCHES, GRAPH_REPLAYS, SPACED_RUNS = 50, 5, 20
#: GPU cycles of the spacer before each spaced launch (about 1 ms), so the
#: host has queued the launch before the device reaches it
SPACER_CYCLES = 2_000_000


def spaced_ms(s: Smoke, fn, flush=None) -> float:
    """Mean device milliseconds of ``fn`` between a CUDA event pair. Each
    run follows a spacer kernel, during which the host queues the rest,
    then a warm-up call of ``fn`` (warm L2) or, given ``flush``, a write of
    that buffer (which evicts ``fn``'s inputs from the L2); either keeps
    the card busy up to the timed call."""
    torch = s.torch
    pairs = []
    for r in range(SPACED_RUNS):
        torch.cuda._sleep(SPACER_CYCLES)
        if flush is None:
            fn()
        else:
            flush.fill_(r)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / SPACED_RUNS


def graph_ms(s: Smoke, fn) -> float:
    """Device milliseconds a launch of ``fn``: GRAPH_LAUNCHES launches
    captured in one CUDA graph, replays timed by CUDA events, so the host
    does not pace them."""
    torch = s.torch
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (GRAPH_REPLAYS * GRAPH_LAUNCHES)


def phase_k3_timing(s: Smoke, snap, n_launches: int, records: dict) -> None:
    """K3 alone on the h1 ∩ h2 arrays as ``device_intersect_sorted`` gives
    them (ragged, unpadded): its device time (a CUDA graph of launches, and
    spaced event pairs at warm and cold L2), the wrapper's host time per
    call (back-to-back calls, what PR 3 and PR 4 reported), its plain
    version and ``torch.isin`` warm and cold, the data bound of the real
    bytes and the earlier bound of PR 3's padded shape (at which the padded
    entry is also held against its plain version)."""
    import math

    import numpy as np

    from hypergraphdb_tpu_torch.ops.membership import (
        membership_mask,
        membership_mask_ragged,
    )
    from hypergraphdb_tpu_torch.ops.setops import (
        _bucket,
        intersect_mask_many,
        intersect_mask_ragged,
        pad_sorted,
    )

    torch = s.torch
    _, rows = hub_rows(snap)
    big, small = rows[0], rows[1]
    b = torch.from_numpy(small.astype(np.int32)).to(s.dev)
    f = torch.from_numpy(big.astype(np.int32)).to(s.dev)
    off_host = np.array([0, len(big)], np.int64)
    off = torch.from_numpy(off_host).to(s.dev)

    def k3():
        return membership_mask_ragged(b, f, off, offsets_host=off_host)

    def plain():
        return intersect_mask_ragged(b, f, off_host)

    def lib():
        return torch.isin(b, f)

    got, want = k3(), plain()
    torch.cuda.synchronize()
    err = int((got.int() - want.int()).abs().max())
    s.expect(err == 0, "K3 != plain at the h1 & h2 shape")
    s.expect(torch.equal(lib(), got), "torch.isin disagrees with K3")
    L = _bucket(len(big))
    bp = torch.from_numpy(pad_sorted(small, L)).to(s.dev)
    op = torch.from_numpy(pad_sorted(big, L)[None]).to(s.dev)
    got_p = membership_mask(bp, op)
    s.expect(torch.equal(got_p, intersect_mask_many(bp, op)),
             "K3 padded != plain at PR 3's h1 & h2 shape")
    s.expect(torch.equal(got_p[: len(small)], got),
             "K3 padded and ragged differ at h1 & h2")
    del bp, op, got_p

    ms = graph_ms(s, k3)
    host_ms = s.time_ms(k3, 50)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=s.dev)
    fns = (("k3", k3), ("plain", plain), ("isin", lib), ("none", lambda: 0))
    warm = {n: spaced_ms(s, fn) for n, fn in fns}
    cold = {n: spaced_ms(s, fn, flush) for n, fn in fns}
    plain_ms = s.time_ms(plain, 10)
    lib_ms = s.time_ms(lib, 10)
    del flush
    # the data bound: the base, the offsets, the part of the row between
    # the base's first and last ids (what the windows cover), the mask
    window = int(np.searchsorted(big, small[-1], "right")
                 - np.searchsorted(big, small[0], "left"))
    nbytes = 4 * len(small) + off.numel() * 8 + 4 * window + len(small)
    earlier_bytes = 2 * 4 * L + L
    # compares: a search of one chunk in shared memory per base element
    ops = len(small) * (math.ceil(math.log2(K3_CHUNK)) + 1)
    s.log(f"K3 at h1 & h2: Lb {len(small)}, row {len(big)} ({window} in "
          f"the base's range); device {ms:.5f} ms a launch (CUDA graph of "
          f"{GRAPH_LAUNCHES}), spaced {warm['k3']:.5f} ms warm / "
          f"{cold['k3']:.5f} ms cold L2; wrapper host time {host_ms:.5f} ms "
          f"a call back to back; plain {plain_ms:.4f} ms back to back, "
          f"spaced {warm['plain']:.4f} warm / {cold['plain']:.4f} cold; "
          f"torch.isin {lib_ms:.4f} ms back to back, spaced "
          f"{warm['isin']:.4f} warm / {cold['isin']:.4f} cold; an empty "
          f"event pair {warm['none']:.5f} / {cold['none']:.5f}; routes "
          f"{first_row_routes(small, big)}")
    s.log(f"K3 bounds: data {Smoke.bound_ms(nbytes, 0):.6f} ms ({nbytes} "
          f"bytes), earlier (PR 3's padded shape) "
          f"{Smoke.bound_ms(earlier_bytes, 0):.6f} ms ({earlier_bytes} "
          f"bytes)")
    rec = s.record(
        "membership", "hypergraphdb_tpu_torch/csrc/membership.cu",
        "hypergraphdb_tpu/ops/pallas_kernels.py:41", n_launches, err, ms,
        plain_ms, nbytes, ops, library_ms=lib_ms)
    rec.update({"host_ms": host_ms, "spaced_warm_ms": warm["k3"],
                "spaced_cold_ms": cold["k3"],
                "plain_spaced_warm_ms": warm["plain"],
                "plain_spaced_cold_ms": cold["plain"],
                "library_spaced_warm_ms": warm["isin"],
                "library_spaced_cold_ms": cold["isin"],
                "empty_pair_ms": warm["none"],
                "earlier_bound_ms": Smoke.bound_ms(earlier_bytes, 0)})
    records["kernels"].append(rec)


#: links held back from the base snapshot, fed to the memtable in id order:
#: the delta (about 3.6M incidence entries, bucket 2^22), under 0.1 × the
#: base's edges (bench.py c5's compact_ratio)
DELTA_LINKS = 600_000
#: the memtables' bucket floor and the small delta's links: bench.py c5's
#: delta_bucket_min and one c5 ingest batch
DELTA_BUCKET_MIN, SMALL_DELTA_LINKS = 1 << 18, 10_000
#: held-back links fed after the delta's full upload: its tail upload
TAIL_LINKS = 10_000
#: tombstones of the dense route: h1, this many base links and held-back
#: links drawn by default_rng(DEAD_SEED)
DEAD_BASE_LINKS, DEAD_HELD_LINKS, DEAD_SEED = 1_000, 100, 11
#: the lane of the dense batches seeded at h1, and the host-checked lanes
H1_LANE = 5
#: lanes of the 1-hop freshness probe
FRESH_LANES, FRESH_SEED = 64, 5
#: the larger served bucket of the delta phase
BIG_BUCKET = 1024


def split_snapshot(snap, n_held: int):
    """``(base, records)``: ``snap`` with its last ``n_held`` links held
    back, their rows left in the id space with type -1, no link flag and
    arity 0 (what a pack with capacity headroom holds), and the held-back
    links as ``(handle, targets)`` records in id order."""
    import numpy as np

    from hypergraphdb_tpu_torch.ops.snapshot import CSRSnapshot

    N = snap.num_atoms
    off = snap.tgt_offsets[: N + 1].astype(np.int64)
    flat = snap.tgt_flat[: snap.n_edges_tgt]
    held = np.flatnonzero(snap.is_link[:N])[-n_held:]
    is_held = np.zeros(N, dtype=bool)
    is_held[held] = True
    lens = np.diff(off)
    base_off = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(np.where(is_held, 0, lens), out=base_off[1:])
    keep = ~np.repeat(is_held, lens)
    type_of = np.where(is_held, -1, snap.type_of[:N]).astype(np.int32)
    base = CSRSnapshot.from_tables(type_of, snap.is_link[:N] & ~is_held,
                                   base_off, flat[keep])
    return base, [(int(h), flat[off[h] : off[h + 1]]) for h in held]


def delta_csr(hd: dict, n1: int):
    """A memtable's entries (its ``host_delta()``) as host CSRs:
    ``(inc_off, inc_links, tgt_off, tgt_flat)``, incidence rows by atom and
    target rows by link."""
    import numpy as np

    out = []
    for row, col in (("inc_src", "inc_links"), ("tgt_src", "tgt_flat")):
        order = np.argsort(hd[row], kind="stable")
        off = np.zeros(n1 + 1, dtype=np.int64)
        np.cumsum(np.bincount(hd[row], minlength=n1), out=off[1:])
        out += [off, hd[col][order]]
    return tuple(out)


def host_bfs_delta(base, dcsr, dead, seed: int, max_hops: int):
    """Sorted ids one seed reaches over base ∪ delta (``dcsr`` from
    :func:`delta_csr`) within ``max_hops``, where dead links emit nothing
    and dead atoms are never reached (a dead seed reaches nothing): the
    dense route's semantics, one seed at a time on the host."""
    import numpy as np

    from hypergraphdb_tpu_torch.ops.host_bfs import gather_ragged

    N = base.num_atoms
    if dead[seed]:
        return np.empty(0, dtype=np.int64)
    d_inc_off, d_inc, d_tgt_off, d_tgt = dcsr
    inc_off = base.inc_offsets.astype(np.int64)
    tgt_off = base.tgt_offsets.astype(np.int64)

    def rows(flat, off, ids):
        return gather_ragged(flat, off[ids], off[ids + 1] - off[ids])

    visited = np.zeros(N + 1, dtype=bool)
    visited[seed] = True
    frontier = np.asarray([seed], dtype=np.int64)
    for _ in range(max_hops):
        hit = np.zeros(N + 1, dtype=bool)
        hit[rows(base.inc_links, inc_off, frontier)] = True
        hit[rows(d_inc, d_inc_off, frontier)] = True
        links = np.flatnonzero(hit & ~dead)
        hit = np.zeros(N + 1, dtype=bool)
        hit[rows(base.tgt_flat, tgt_off, links)] = True
        hit[rows(d_tgt, d_tgt_off, links)] = True
        hit[N] = False
        frontier = np.flatnonzero(hit & ~dead & ~visited)
        visited[frontier] = True
        if not len(frontier):
            break
    return np.flatnonzero(visited[:N])


def fresh_pairs(base, records, n: int):
    """``n`` pairs (a, b) of distinct targets of distinct held-back links,
    ``a`` not repeated, that share no base link (checked on the host): a
    1-hop BFS from ``a`` reaches ``b`` only through the delta."""
    import numpy as np

    rng = np.random.default_rng(FRESH_SEED)
    pairs, used = [], set()
    for i in rng.permutation(len(records)):
        ts = np.unique(records[i][1])
        if len(ts) < 2:
            continue
        a, b = int(ts[-1]), int(ts[-2])
        if a in used or np.intersect1d(base.incidence_row(a),
                                       base.incidence_row(b)).size:
            continue
        used.add(a)
        pairs.append((a, b))
        if len(pairs) == n:
            return pairs
    raise AssertionError(f"only {len(pairs)} freshness pairs found")


def lane_bits(torch, visited, rows, lanes):
    """Bit of lane ``lanes[i]`` in row ``rows[i]`` of a packed bitmap."""
    rows = torch.as_tensor(rows, device=visited.device, dtype=torch.int64)
    lanes = torch.as_tensor(lanes, device=visited.device, dtype=torch.int64)
    return ((visited[rows, lanes >> 5] >> (lanes & 31).to(torch.int32)) & 1
            ).bool()


def overlay_check(s: Smoke, visited, vmask, overlay) -> dict:
    """K1 through both pyramids of ``overlay`` from a BFS bitmap and its
    mask, every level held bit for bit against the plain version and every
    emitted mask against ``line_mask``; then each level's K1 launch timed
    (CUDA events, into its own section, which holds the result), the whole
    overlay share (``_overlay_reach``, events) and the plain share, beside
    the bound of the levels' bytes (each used source row and index read
    once, each output row written once)."""
    from hypergraphdb_tpu_torch.ops import fused_bfs, linemask
    from hypergraphdb_tpu_torch.ops.gather_or import gather_or, gather_or_plain

    torch = s.torch
    kw = visited.shape[1]
    bufs = fused_bfs._overlay_buffers(overlay, kw, s.dev)
    buf1, mask1, buf2, mask2 = bufs
    reach = fused_bfs._overlay_reach(visited, vmask, overlay, bufs)
    ov = overlay.arrays
    plain = [torch.zeros_like(buf1), torch.zeros_like(buf2)]

    def plain_reach():
        """Both pyramids by the plain version, as ``_apply_plan`` runs
        them: level 0 reads the stage's input, later levels its buffer."""
        src = visited
        for levels, widths, out in ((ov.levels1, overlay.widths1, plain[0]),
                                    (ov.levels2, overlay.widths2, plain[1])):
            off = 0
            for idx, w in zip(levels, widths):
                n = idx.shape[0] // w
                gather_or_plain(src, idx, w, out=out[off : off + n])
                off += n
                src = out
        return plain[1][ov.out_map]

    plain_reach()
    torch.cuda.synchronize()
    s.expect(torch.equal(buf1, plain[0]) and torch.equal(buf2, plain[1]),
             f"overlay K1 != plain at kw={kw}")
    s.expect(torch.equal(mask1, linemask.line_mask(buf1))
             and torch.equal(mask2, linemask.line_mask(buf2)),
             f"overlay K1 emitted masks != line_mask at kw={kw}")
    s.expect(torch.equal(reach, plain[1][ov.out_map]),
             f"overlay rows != plain at kw={kw}")
    level_ms, nbytes, ops = [], 0, 0
    stages = ((visited, vmask, ov.levels1, overlay.widths1, buf1, mask1),
              (buf1, mask1, ov.levels2, overlay.widths2, buf2, mask2))
    for src, smask, levels, widths, buf, bmask in stages:
        off = 0
        for idx, w in zip(levels, widths):
            n = idx.shape[0] // w
            level_ms.append(s.time_ms(
                lambda src=src, smask=smask, idx=idx, w=w, buf=buf,
                bmask=bmask, off=off, n=n: gather_or(
                    src, idx, w, out=buf[off : off + n], mask=smask,
                    out_mask=bmask, mask_row0=off), 10))
            nbytes += (int(torch.unique(idx).numel()) + n) * kw * 4 \
                + idx.numel() * 4
            ops += idx.numel() * kw
            off += n
            src, smask = buf, bmask
    reach_ms = s.time_ms(
        lambda: fused_bfs._overlay_reach(visited, vmask, overlay, bufs), 10)
    plain_ms = s.time_ms(plain_reach, 3)
    return {"kw": kw, "levels": len(level_ms), "level_ms": level_ms,
            "k1_ms": sum(level_ms), "reach_ms": reach_ms,
            "plain_reach_ms": plain_ms, "bound_ms": s.bound_ms(nbytes, ops),
            "bytes": nbytes, "rows1": ov.rows1, "rows2": ov.rows2,
            "atoms": int(ov.rows.numel())}


def phase_delta(s: Smoke, full, info, truth: dict, records: dict) -> None:
    """BFS served over a base snapshot plus a delta, by both routes."""
    import numpy as np

    from hypergraphdb_tpu_torch.ops import fused_bfs, linemask
    from hypergraphdb_tpu_torch.ops.incremental import DeltaMemtable
    from hypergraphdb_tpu_torch.ops.serving import (
        bfs_serve_batch,
        bfs_serve_batch_fused,
        serve_bfs,
    )

    torch = s.torch
    N = full.num_atoms
    seeds, host_full = truth["seeds"], truth["host"]
    sentinel = int(fused_bfs.SENTINEL)

    t0 = time.perf_counter()
    base, held = split_snapshot(full, DELTA_LINKS)
    t_base = time.perf_counter() - t0
    s.log(f"delta: base snapshot with the last {DELTA_LINKS} links held back "
          f"({base.n_edges_tgt} target / {base.n_edges_inc} incidence "
          f"entries, {full.n_edges_tgt - base.n_edges_tgt} held back) in "
          f"{t_base:.2f} s")

    big = DeltaMemtable(N, bucket_min=DELTA_BUCKET_MIN, device=s.dev)
    for h, ts in held[:-TAIL_LINKS]:
        big.add_link(h, ts)
    t0 = time.perf_counter()
    big.device()
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0
    for h, ts in held[-TAIL_LINKS:]:
        big.add_link(h, ts)
    t0 = time.perf_counter()
    delta = big.device()
    torch.cuda.synchronize()
    t_tail = time.perf_counter() - t0
    s.expect((big.full_uploads, big.tail_uploads) == (1, 1),
             f"memtable uploads {big.full_uploads}/{big.tail_uploads}, "
             f"want one full and one tail")
    small = DeltaMemtable(N, bucket_min=DELTA_BUCKET_MIN, device=s.dev)
    for h, ts in held[:SMALL_DELTA_LINKS]:
        small.add_link(h, ts)
    small_delta = small.device()
    s.log(f"delta: memtable of {DELTA_LINKS} links, {big.delta_edges} "
          f"entries a relation, bucket {delta.inc_links.shape[0]}: full "
          f"upload {t_full:.3f} s, tail of {TAIL_LINKS} links "
          f"{t_tail:.3f} s; small delta {SMALL_DELTA_LINKS} links, "
          f"{small.delta_edges} entries, bucket "
          f"{small_delta.inc_links.shape[0]}")

    # tombstones: h1, base links and held-back links (dead-only refresh)
    h1 = hub_rows(full)[0][0]
    rng = np.random.default_rng(DEAD_SEED)
    l0 = info["links"][0]
    held_ids = np.asarray([h for h, _ in held])
    dead_ids = np.concatenate([
        [h1], rng.choice(np.arange(l0, int(held_ids[0])), DEAD_BASE_LINKS,
                         replace=False),
        rng.choice(held_ids, DEAD_HELD_LINKS, replace=False)])
    for h in dead_ids:
        big.remove(int(h))
    dead_delta = big.device()
    s.expect(dead_delta.inc_links is delta.inc_links
             and (big.full_uploads, big.tail_uploads) == (1, 1),
             "a dead-only refresh re-uploaded the edge buffers")
    dead = np.zeros(N + 1, dtype=bool)
    dead[dead_ids] = True

    dense_seeds = seeds[:BIG_BUCKET].copy()
    dense_seeds[H1_LANE] = h1
    host_lanes = range(H1_LANE + 1)
    pool = ThreadPoolExecutor(max_workers=4)
    csr_big = delta_csr(big.host_delta(), N + 1)
    csr_small = delta_csr(small.host_delta(), N + 1)
    no_dead = np.zeros(N + 1, dtype=bool)
    host_dead = {k: pool.submit(host_bfs_delta, base, csr_big, dead,
                                int(dense_seeds[k]), HOPS)
                 for k in host_lanes}
    host_small = {k: pool.submit(host_bfs_delta, base, csr_small, no_dead,
                                 int(seeds[k]), HOPS)
                  for k in range(SERVE_SEEDS)}

    t0 = time.perf_counter()
    fused_bfs.fused_plans_for(base)
    t_plan = time.perf_counter() - t0
    plan, geom = fused_bfs.device_fused_plan(base, s.dev)
    t0 = time.perf_counter()
    overlay = fused_bfs.overlay_plan_for(delta, base, geom)
    t_ov = time.perf_counter() - t0
    ov = overlay.arrays
    s.log(f"delta: base fused plan {t_plan:.2f} s ({geom.n_chunks} chunks); "
          f"overlay plan {t_ov:.2f} s ({ov.rows.numel()} atoms gain edges, "
          f"{len(ov.levels1)} + {len(ov.levels2)} levels, widths "
          f"{overlay.widths1} / {overlay.widths2}, buffers {ov.rows1} + "
          f"{ov.rows2} rows)")
    fplan, fgeom = fused_bfs.device_fused_plan(full, s.dev)

    # the fused route with the overlay against the whole graph
    batches = {"5": seeds[:SERVE_SEEDS], "64": seeds[:64],
               str(BIG_BUCKET): seeds[:BIG_BUCKET]}
    want = {k: serve_bfs(full, x, HOPS, SERVE_TOP_R, device=s.dev)
            for k, x in batches.items()}
    reset_launches()
    serve_bfs.routes.update(fused=0, dense=0)
    got = {k: serve_bfs(base, x, HOPS, SERVE_TOP_R, delta=delta,
                        device=s.dev) for k, x in batches.items()}
    s.expect(serve_bfs.routes == {"fused": 3, "dense": 0},
             f"overlay batches took routes {serve_bfs.routes}")
    for k in batches:
        s.expect(np.array_equal(got[k][0], want[k][0])
                 and np.array_equal(got[k][1], want[k][1]),
                 f"fused route with the overlay != the whole graph, {k}")
    for k in range(SERVE_SEEDS):
        ids = host_full[k][0]
        s.expect(int(got["5"][0][k]) == len(ids)
                 and np.array_equal(got["5"][1][k].astype(np.int64),
                                    window(ids)),
                 f"fused route with the overlay != host BFS, lane {k}")
    # pad lanes included: the 5 requests' 64-lane batch, three ways
    padded = np.full(64, N, np.int32)
    padded[:SERVE_SEEDS] = seeds[:SERVE_SEEDS]
    pt = torch.from_numpy(padded).to(s.dev)
    a = bfs_serve_batch_fused(plan, pt, geom, HOPS, SERVE_TOP_R,
                              overlay=overlay)
    b = bfs_serve_batch_fused(fplan, pt, fgeom, HOPS, SERVE_TOP_R)
    c = bfs_serve_batch(base.device(s.dev), delta, pt, HOPS, SERVE_TOP_R)
    s.expect(all(torch.equal(x, y) and torch.equal(x, z)
                 for x, y, z in zip(a, b, c)),
             "64-lane batch with pad lanes: overlay, whole graph and dense "
             "differ")
    # the dense route with no dead set equals the fused route
    for k in ("64", str(BIG_BUCKET)):
        x = torch.from_numpy(batches[k]).to(s.dev)
        dc, df = bfs_serve_batch(base.device(s.dev), delta, x, HOPS,
                                 SERVE_TOP_R)
        s.expect(np.array_equal(dc.cpu().numpy(), got[k][0])
                 and np.array_equal(df.cpu().numpy(), got[k][1]),
                 f"dense route without tombstones != fused route, {k}")
    s.log(f"delta: fused route with the overlay == whole graph at 5 "
          f"requests, 64 and {BIG_BUCKET} lanes, lanes 0..4 == host BFS; "
          f"64-lane batch with 59 pad lanes == whole graph == dense; dense "
          f"without tombstones == fused at 64 and {BIG_BUCKET}")

    # the dense route with tombstones against the host truth
    serve_bfs.routes.update(fused=0, dense=0)
    c64, f64 = serve_bfs(base, dense_seeds[:64], HOPS, SERVE_TOP_R,
                         delta=dead_delta, device=s.dev)
    cbig, fbig = serve_bfs(base, dense_seeds, HOPS, SERVE_TOP_R,
                           delta=dead_delta, device=s.dev)
    s.expect(serve_bfs.routes == {"fused": 0, "dense": 2},
             f"tombstoned batches took routes {serve_bfs.routes}")
    s.expect(np.array_equal(c64, cbig[:64]) and np.array_equal(f64, fbig[:64]),
             "dense route: the 64 bucket != the 1024 bucket's first lanes")
    s.expect(int(c64[H1_LANE]) == 0 and (f64[H1_LANE] == sentinel).all(),
             "the lane seeded at h1 reached something")
    for k in host_lanes:
        ids = host_dead[k].result()
        s.expect(int(c64[k]) == len(ids)
                 and np.array_equal(f64[k].astype(np.int64), window(ids)),
                 f"dense route with tombstones != host BFS, lane {k}")
    s.log(f"delta: dense route with {len(dead_ids)} tombstones (h1 = {h1}) "
          f"== host BFS at lanes {list(host_lanes)} (reach "
          f"{[int(c64[k]) for k in host_lanes]}; h1's lane 0), 64 == first "
          f"64 of {BIG_BUCKET}")

    # the small delta: fused with its overlay == dense == host BFS
    serve_bfs.routes.update(fused=0, dense=0)
    cs, fs = serve_bfs(base, seeds[:64], HOPS, SERVE_TOP_R,
                       delta=small_delta, device=s.dev)
    s.expect(serve_bfs.routes == {"fused": 1, "dense": 0},
             "small delta left the fused route")
    dc, df = bfs_serve_batch(base.device(s.dev), small_delta,
                             torch.from_numpy(seeds[:64]).to(s.dev), HOPS,
                             SERVE_TOP_R)
    s.expect(np.array_equal(dc.cpu().numpy(), cs)
             and np.array_equal(df.cpu().numpy(), fs),
             "small delta: fused with the overlay != dense")
    for k in range(SERVE_SEEDS):
        ids = host_small[k].result()
        s.expect(int(cs[k]) == len(ids)
                 and np.array_equal(fs[k].astype(np.int64), window(ids)),
                 f"small delta != host BFS, lane {k}")
    pool.shutdown()
    n_launch = launches()
    s.expect(n_launch["gather_or"] > 0 and n_launch["fused_hop"] > 0,
             f"the delta path never launched K1 and K2: {n_launch}")
    s.log(f"delta: small delta fused == dense == host BFS at lanes 0..4; "
          f"launches on the delta path: {n_launch}")

    # freshness: 1 hop from one end of a held-back link reaches the other
    pairs = fresh_pairs(base, held, FRESH_LANES)
    fa = torch.tensor([p[0] for p in pairs], dtype=torch.int32, device=s.dev)
    lanes = list(range(FRESH_LANES))
    vis, _, _ = fused_bfs.bfs_fused(plan, fa, geom, 1, False, False,
                                    overlay=overlay)
    s.expect(bool(lane_bits(torch, vis, [p[1] for p in pairs], lanes).all()),
             "freshness: a held-back partner was not reached in 1 hop")
    vis, _, _ = fused_bfs.bfs_fused(plan, fa, geom, 1, False, False)
    s.expect(not bool(lane_bits(torch, vis, [p[1] for p in pairs],
                                lanes).any()),
             "freshness: a partner was reached without the overlay")
    s.log(f"delta: freshness, {FRESH_LANES} 1-hop lanes each reach their "
          f"held-back partner with the overlay and none without")

    # mask audit of overlay BFSs; keep the bitmaps entering hop 1
    kept = {}
    for k in (64, BIG_BUCKET):
        def hook(h, visited, mask, k=k):
            s.expect(torch.equal(mask, linemask.line_mask(visited)),
                     f"overlay BFS at {k} lanes: mask entering hop {h} != "
                     f"line_mask")
            if h == 1:
                kept[k] = (visited.clone(), mask.clone())

        fused_bfs.bfs_fused(plan, torch.from_numpy(seeds[:k]).to(s.dev),
                            geom, HOPS, False, False, hop_hook=hook,
                            overlay=overlay)
    s.log(f"delta: mask audit, overlay BFS at 64 and {BIG_BUCKET} lanes: "
          f"every mask entering a hop (and the last) == line_mask")

    # K1 at the overlay's shapes, K2 at the 64-lane hop
    ov_stats = {k: overlay_check(s, *kept[k], overlay) for k in kept}
    for k, st in ov_stats.items():
        s.log(f"delta: overlay K1 at {k} lanes (kw {st['kw']}): bit-exact "
              f"with plain over {st['levels']} levels ({st['rows1']} + "
              f"{st['rows2']} buffer rows, {st['atoms']} atoms); K1 "
              f"{st['k1_ms']:.4f} ms a hop (levels "
              f"{[round(t, 4) for t in st['level_ms']]}), overlay share "
              f"{st['reach_ms']:.4f} ms, plain {st['plain_reach_ms']:.4f} "
              f"ms, bound {st['bound_ms']:.4f} ms ({st['bytes']} bytes)")
    old, om = kept[64]
    out = torch.zeros_like(old)
    omask = linemask.full_mask(*old.shape, s.dev)
    got2 = fused_bfs.fused_hop(old, plan, out=out, mask=om, out_mask=omask)
    want2 = fused_bfs.fused_hop_plain(old, plan)
    torch.cuda.synchronize()
    s.expect(torch.equal(got2, want2)
             and torch.equal(omask, linemask.line_mask(got2)),
             "K2 at the 64-lane hop != plain")
    k2_ms = s.time_ms(lambda: fused_bfs.fused_hop(
        old, plan, out=out, mask=om, out_mask=omask), 5)
    s.log(f"delta: K2 at the 64-lane hop 1 (kw 2, base plan) bit-exact with "
          f"plain, masks exact; {k2_ms:.3f} ms")

    # served routes, host to host; K1 launches a served batch
    per_batch = {}
    for k in ("5", str(BIG_BUCKET)):
        x = batches[k]
        reset_launches()
        serve_bfs(base, x, HOPS, SERVE_TOP_R, delta=delta, device=s.dev)
        per_batch[k] = launches()
    route_ms = {
        "static 1024": served_ms(s, lambda: serve_bfs(
            full, batches[str(BIG_BUCKET)], HOPS, SERVE_TOP_R,
            device=s.dev)),
        "fused+overlay 5": served_ms(s, lambda: serve_bfs(
            base, batches["5"], HOPS, SERVE_TOP_R, delta=delta,
            device=s.dev)),
        "fused+overlay 1024": served_ms(s, lambda: serve_bfs(
            base, batches[str(BIG_BUCKET)], HOPS, SERVE_TOP_R, delta=delta,
            device=s.dev)),
        "dense+tombstones 64": served_ms(s, lambda: serve_bfs(
            base, dense_seeds[:64], HOPS, SERVE_TOP_R, delta=dead_delta,
            device=s.dev)),
        "dense+tombstones 1024": served_ms(s, lambda: serve_bfs(
            base, dense_seeds, HOPS, SERVE_TOP_R, delta=dead_delta,
            device=s.dev)),
    }
    for name, ms in route_ms.items():
        s.log(f"delta: served {name}: {spread(ms)}, runs "
              f"{[round(t, 1) for t in ms]}")
    s.log(f"delta: launches a served overlay batch: {per_batch}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    serve_bfs(base, dense_seeds, HOPS, SERVE_TOP_R, delta=dead_delta,
              device=s.dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    s.log(f"delta: dense route at {BIG_BUCKET} lanes: peak device memory "
          f"{peak / 2**30:.3f} GiB ({(peak - before) / 2**30:.3f} GiB above "
          f"the {before / 2**30:.3f} GiB held before the call)")
    s.profile_later("served fused+overlay 5", lambda: serve_bfs(
        base, batches["5"], HOPS, SERVE_TOP_R, delta=delta, device=s.dev),
        float(np.median(route_ms["fused+overlay 5"])))
    s.profile_later("served dense+tombstones 64", lambda: serve_bfs(
        base, dense_seeds[:64], HOPS, SERVE_TOP_R, delta=dead_delta,
        device=s.dev), float(np.median(route_ms["dense+tombstones 64"])))

    for rec in records["kernels"]:
        if rec["name"] in ("gather_or", "fused_hop"):
            rec["delta_path_launches"] = n_launch[rec["name"]]
            rec["launches_per_overlay_batch"] = {
                k: v[rec["name"]] for k, v in per_batch.items()}
        if rec["name"] == "gather_or":
            rec["overlay"] = {str(k): v for k, v in ov_stats.items()}
        if rec["name"] == "fused_hop":
            rec["hop_64_lanes_ms"] = k2_ms
    s.log("delta record " + json.dumps({
        "base_s": t_base, "fused_plan_s": t_plan, "overlay_plan_s": t_ov,
        "refresh_full_s": t_full, "refresh_tail_s": t_tail,
        "route_ms": route_ms, "dense_1024_peak_bytes": peak,
        "dense_1024_before_bytes": before, "overlay": ov_stats,
        "k2_hop_64_ms": k2_ms, "launches_per_overlay_batch": per_batch}))


#: bench.py c7's parameters (``bench_c7``): anchors drawn by
#: ``default_rng(JOIN_SEED)``, JOIN_K of them in JOIN_LANES-lane dispatches,
#: co width bound JOIN_MAX_DEG, executor caps JOIN_ROW_CAP / JOIN_PAD_CAP,
#: the host truth on the first JOIN_BASE_N anchors
JOIN_SEED, JOIN_K, JOIN_LANES = 43, 1024, 16
JOIN_MAX_DEG, JOIN_ROW_CAP, JOIN_PAD_CAP = 512, 1 << 20, 2048
JOIN_BASE_N = 128
#: timed windows of each shape and mode: c7 runs 8, cut to 2 for time
JOIN_REPS, C7_REPS = 2, 8
#: the pair budget the phase raises HG_JOIN_MAX_NBR_PAIRS to (the 10M
#: snapshot's co-incidence relation is over the default 2^28)
JOIN_PAIR_BUDGET = 1 << 29
#: co rows held against the incidence and target CSRs: random rows from
#: ``default_rng(JOIN_ROW_SEED)``, h1's and the dummy row
JOIN_ROW_CHECKS, JOIN_ROW_SEED = 1000, 5
#: the small graph the engine runs on the card and on the CPU alike
JOIN_SMALL = dict(n_entities=2_000, n_links=8_000)
#: the windowed 2-path: ranks below this on the variable bound last
JOIN_WINDOW_HI = 1_000_000


def join_pattern(shape: str, a0):
    """bench.py c7's two shapes through the anchor ``a0``: the triangle
    a–y, y–z, z–a and the 2-path a–y, y–z."""
    from hypergraphdb_tpu_torch.join import ConjunctivePattern, JoinAtom

    if shape == "triangle":
        atoms = (JoinAtom("co", "y", int(a0)), JoinAtom("co", "y", "z"),
                 JoinAtom("co", "z", int(a0)))
    else:
        atoms = (JoinAtom("co", "y", int(a0)), JoinAtom("co", "z", "y"))
    return ConjunctivePattern(vars=("y", "z"), atoms=atoms)


def join_host_counts(off64, flat, shape: str, aa, keep=None):
    """The numpy host truth over the same co-incidence CSR rows: a
    triangle counts, for each y in row(a), the members of row(a) found in
    row(y) (binary search, so a hub neighbour's row is not re-sorted); a
    2-path enumerates (y, z) with z in row(y) and z ≠ a, and, where
    ``keep`` (a flag per atom) is given, ``keep[z]``."""
    import numpy as np

    out = np.zeros(len(aa), dtype=np.int64)
    for i, a in enumerate(aa):
        row = flat[off64[a]: off64[a + 1]]
        if shape == "triangle":
            n = 0
            for y in row:
                ry = flat[off64[y]: off64[y + 1]]
                pos = np.minimum(np.searchsorted(ry, row), max(len(ry) - 1, 0))
                n += int((ry[pos] == row).sum()) if len(ry) else 0
            out[i] = n
        else:
            for y in row:
                z = flat[off64[y]: off64[y + 1]]
                ok = z != a
                if keep is not None:
                    ok &= keep[z]
                out[i] += int(ok.sum())
    return out


def co_row_from_targets(snap, u: int):
    """Atom ``u``'s co-incidence row computed on the host from the
    incidence and target CSRs: the sorted unique targets of the links
    that hold ``u``, ``u`` excluded."""
    import numpy as np

    links = snap.incidence_row(u).astype(np.int64)
    starts = snap.tgt_offsets[links].astype(np.int64)
    lens = snap.tgt_offsets[links + 1] - starts
    idx = np.repeat(starts - np.cumsum(lens) + lens, lens) + np.arange(
        lens.sum())
    row = np.unique(snap.tgt_flat[idx])
    return row[row != u]


def best_window(s: Smoke, fn, reps: int):
    """``(seconds, result)`` of the fastest of ``reps`` runs of ``fn``,
    each ended by a synchronise (c7's best-of-n)."""
    torch = s.torch
    best = None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if best is None or dt < best[0]:
            best = (dt, out)
    return best


def neighbour_max_width(s: Smoke, snap, all_w):
    """For every atom, the widest co row among its co-neighbours (0 for an
    empty row), from the cached co-incidence CSR, on the card."""
    import numpy as np

    from hypergraphdb_tpu_torch.ops import join as oj

    torch = s.torch
    N = snap.num_atoms
    off, flat = oj.neighbor_csr_device(snap, s.dev)
    off = off.long()
    n_e = int(snap._nbr_csr[0][N])
    owner = torch.repeat_interleave(torch.arange(N, device=s.dev),
                                    off[1: N + 1] - off[:N], output_size=n_e)
    w = torch.from_numpy(np.asarray(all_w, dtype=np.int64)).to(s.dev)
    out = torch.zeros(N, dtype=torch.int64, device=s.dev).scatter_reduce_(
        0, owner, w[flat[:n_e].long()], "amax")
    return out.cpu().numpy()


@contextmanager
def pair_budget(value):
    """``HG_JOIN_MAX_NBR_PAIRS`` set to ``value`` (unset for None) inside
    the block, and as it was after."""
    import os

    saved = os.environ.pop("HG_JOIN_MAX_NBR_PAIRS", None)
    if value is not None:
        os.environ["HG_JOIN_MAX_NBR_PAIRS"] = str(value)
    try:
        yield
    finally:
        os.environ.pop("HG_JOIN_MAX_NBR_PAIRS", None)
        if saved is not None:
            os.environ["HG_JOIN_MAX_NBR_PAIRS"] = saved


def rebuild_co(s: Smoke, snap) -> None:
    """The co-incidence CSR built again under the raised pair budget (the
    join phase frees it; a queued profile needs it)."""
    from hypergraphdb_tpu_torch.ops import join as oj

    with pair_budget(JOIN_PAIR_BUDGET):
        oj.neighbor_csr_device(snap, s.dev)


def lane_results(s: Smoke, exs):
    """Counts (int64) and trunc flags of a window's executions, host-side."""
    import numpy as np

    torch = s.torch
    counts = torch.cat([ex.counts for ex in exs]).cpu().numpy()
    return (counts.astype(np.int64),
            torch.cat([ex.trunc for ex in exs]).cpu().numpy())


def phase_join(s: Smoke, snap, info) -> dict:
    """bench.py c7 on the card: the co-incidence build (refused at the
    default pair budget, built with it raised and checked row by row),
    anchored triangle and 2-path counts over 1024 anchors, the hub-heavy
    batch in three modes, then the engine on the card against the CPU on
    a small graph. The join caches are freed at the end."""
    from hypergraphdb_tpu_torch.join import JoinUnsupported
    from hypergraphdb_tpu_torch.ops import join as oj

    K, lanes = JOIN_K, JOIN_LANES
    base_n = min(JOIN_BASE_N, K)
    pairs = oj.nbr_pair_count(snap)
    rec: dict = {"nbr_pairs": pairs, "default_budget": oj.NBR_MAX_PAIRS,
                 "budget": JOIN_PAIR_BUDGET,
                 "cuts": {"reps": [C7_REPS, JOIN_REPS]}}
    s.log(f"join: cut from bench c7: reps {C7_REPS} -> {JOIN_REPS}; K "
          f"{K}, {lanes} lanes, max_deg {JOIN_MAX_DEG}, row_cap "
          f"{JOIN_ROW_CAP}, pad_cap {JOIN_PAD_CAP}, base_n {base_n} as c7")
    try:
        with pair_budget(None):
            try:
                oj.neighbor_csr(snap, device=s.dev)
            except JoinUnsupported as e:
                s.log(f"join: the default budget refuses: {e}")
            else:
                raise AssertionError("the co-incidence build was not refused "
                                     f"at the default budget ({pairs} pairs)")
        with pair_budget(JOIN_PAIR_BUDGET):
            join_c7(s, snap, info, rec)
    finally:
        oj.release_join_caches(snap)
    s.log("join record " + json.dumps(rec))
    return rec


def join_c7(s: Smoke, snap, info, rec: dict) -> None:
    """Phase 12 under the raised pair budget: the build, its row check,
    the anchor pool, triangle and 2-path windows, the hub-heavy batch and
    the card-against-CPU cases, their numbers into ``rec``."""
    import numpy as np

    from hypergraphdb_tpu_torch.join import plan_join, split_constants
    from hypergraphdb_tpu_torch.ops import join as oj

    torch = s.torch
    N = snap.num_atoms
    K, lanes = JOIN_K, JOIN_LANES
    base_n = min(JOIN_BASE_N, K)
    pairs = rec["nbr_pairs"]

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    oj.neighbor_csr_device(snap, s.dev)
    torch.cuda.synchronize()
    rec["nbr_build_s"] = time.perf_counter() - t0
    rec["nbr_peak_above_bytes"] = torch.cuda.max_memory_allocated() \
        - before
    rec["resident_before_bytes"] = before
    off, flat = oj.neighbor_csr(snap, s.dev)
    off64 = off.astype(np.int64)
    rec["nbr_edges"] = int(off64[N])
    s.log(f"join: co-incidence CSR built on the card in "
          f"{rec['nbr_build_s']:.3f} s (host copy included): "
          f"{rec['nbr_edges']} entries from {pairs} pairs; peak "
          f"{rec['nbr_peak_above_bytes'] / 2**30:.3f} GiB above the "
          f"{before / 2**30:.3f} GiB resident")

    h1 = hub_rows(snap)[0][0]
    rows = np.concatenate([np.random.default_rng(JOIN_ROW_SEED).integers(
        0, N, JOIN_ROW_CHECKS - 2), [h1, N]])
    bad = [int(u) for u in rows
           if not np.array_equal(flat[off64[u]: off64[u + 1]],
                                 co_row_from_targets(snap, int(u)))]
    s.expect(not bad, f"co rows differ from the target CSR at {bad[:5]}")
    s.log(f"join: {len(rows)} co rows (h1 {h1} of "
          f"{off64[h1 + 1] - off64[h1]} entries, the dummy row) equal "
          f"their host computation")

    # the anchor rule of bench.py c7: bounded co rows whose
    # neighbours' rows also fit the pad. c7 scans only 8·K random
    # draws of the bounded entities (a host loop); at 10M atoms none
    # of them qualifies, so the same rule is applied to every bounded
    # entity, on the card, and the draw is kept for its count
    r = np.random.default_rng(JOIN_SEED)
    e0, l0 = info["entities"]
    all_w = off64[1: N + 1] - off64[:N]
    widths = all_w[e0:l0]
    bounded = np.flatnonzero(
        (widths >= 2) & (widths <= JOIN_MAX_DEG)) + e0
    drawn = bounded[r.integers(0, len(bounded),
                               size=min(8 * K, len(bounded)))]
    nbr_max = neighbour_max_width(s, snap, all_w)
    n_drawn_ok = int((nbr_max[drawn] <= JOIN_PAD_CAP).sum())
    cand = bounded[nbr_max[bounded] <= JOIN_PAD_CAP]
    rec["anchor_pool"] = {"bounded": len(bounded), "drawn": len(drawn),
                          "drawn_servable": n_drawn_ok,
                          "servable": len(cand)}
    s.log(f"join: anchor pool: {len(bounded)} entities of co width 2.."
          f"{JOIN_MAX_DEG}; of c7's {len(drawn)} draws {n_drawn_ok} "
          f"have every neighbour's row within {JOIN_PAD_CAP}; of all "
          f"{len(bounded)}, {len(cand)} do (the anchors are drawn "
          f"from these)")
    s.expect(len(cand) > 0, "c7: no device-servable anchors")
    anchors = cand[r.integers(0, len(cand), size=K)].astype(np.int64)

    def run(plan, consts, **kw):
        return oj.execute_join(snap, plan, consts, top_r=0,
                               count_only=True, row_cap=JOIN_ROW_CAP,
                               pad_cap=JOIN_PAD_CAP, var_pad_max=True,
                               device=s.dev, **kw)

    # the 2-path once more with a value window on the variable it binds
    # last: kind 0, ranks below JOIN_WINDOW_HI (entities only)
    win_of = {"path2_window": {"z": (0, 0, "gte", JOIN_WINDOW_HI, "lt")}}
    keep = (snap.value_rank < JOIN_WINDOW_HI) & (snap.value_kind == 0)
    counts_of = {}
    for shape, n_consts in (("triangle", 2), ("path2", 1),
                            ("path2_window", 1)):
        pat = join_pattern(shape, anchors[0])
        sig, c0 = split_constants(pat)
        plan = plan_join(snap, pat, sig, c0)
        vwin = win_of.get(shape)
        s.expect(vwin is None or plan.order[-1] in vwin,
                 f"join {shape}: the window is not on the last variable")
        consts = np.repeat(anchors[:, None], n_consts, axis=1).astype(
            np.int32)
        if K % lanes:
            consts = np.concatenate(
                [consts, np.repeat(consts[:1], lanes - K % lanes, 0)])

        def window(n=len(consts), plan=plan, consts=consts, vwin=vwin):
            return [run(plan, consts[i: i + lanes], value_windows=vwin)
                    for i in range(0, n, lanes)]

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lane_results(s, window(min(lanes, K)))
        warm_s = time.perf_counter() - t0
        dt, exs = best_window(s, window, JOIN_REPS)
        counts, trunc = lane_results(s, exs)
        counts, trunc = counts[:K], trunc[:K]
        counts_of[shape] = counts
        t0 = time.perf_counter()
        hc = join_host_counts(off64, flat, shape.split("_")[0],
                              anchors[:base_n],
                              keep=keep if vwin is not None else None)
        host_s = time.perf_counter() - t0
        exact = ~trunc[:base_n]
        agree = bool(np.array_equal(counts[:base_n][exact], hc[exact]))
        rec[shape] = {
            "device_anchors_per_sec": K / dt, "window_s": dt,
            "first_window_16_s": warm_s,
            "bindings_total": int(counts[~trunc].sum()),
            "n_truncated": int(trunc.sum()),
            "differential_equal": agree, "host_checked": int(base_n),
            "host_s": host_s, "plan": plan.describe(),
            "host_syncs": sum(ex.host_syncs for ex in exs),
        }
        s.log(f"join {shape}: {K / dt:.1f} anchors/s (best of "
              f"{JOIN_REPS} windows of {K} anchors, {dt:.4f} s; the "
              f"first 16 anchors {warm_s:.3f} s); bindings "
              f"{rec[shape]['bindings_total']}, truncated "
              f"{rec[shape]['n_truncated']}, plan {plan.describe()}; "
              f"equal to the host on {int(exact.sum())} of {base_n} "
              f"untruncated lanes: {agree} (host {host_s:.2f} s)")
        s.expect(agree, f"join {shape} differs from the host counts")
        if vwin is not None:
            rec[shape]["window"] = list(vwin["z"])
            s.expect(bool((counts <= counts_of["path2"]).all()),
                     "the windowed 2-path counts more than the 2-path")
            s.log(f"join path2 windowed: {K / dt:.1f} anchors/s against "
                  f"{rec['path2']['device_anchors_per_sec']:.1f} without "
                  f"the window; bindings {rec[shape]['bindings_total']} "
                  f"of {rec['path2']['bindings_total']}")
        if shape == "triangle":
            tri_ms = dt * 1e3
            s.profile_later(
                f"join triangle window ({K} anchors)", window, tri_ms,
                setup=lambda: rebuild_co(s, snap),
                teardown=lambda: oj.release_join_caches(snap))

    rec["hub_heavy"] = join_hub_heavy(s, snap, r, cand, off64, flat,
                                      all_w, e0, l0, run)
    rec["cuda_vs_cpu"] = join_cuda_cpu_check(s)


def join_hub_heavy(s: Smoke, snap, r, cand, off64, flat, all_w, e0, l0,
                   run) -> dict:
    """bench.py c7's hub-heavy batch: triangles through 8 anchors of co
    width in (max_deg, 4 max_deg] and 8 tail anchors, one 16-lane
    dispatch run three ways — the degree split, the flat padded executor
    (``hub_split=False``) and the split over the factorized relations."""
    import numpy as np

    from hypergraphdb_tpu_torch.join import plan_join, split_constants
    from hypergraphdb_tpu_torch.ops import join as oj

    torch = s.torch
    lanes = JOIN_LANES
    hub_thr = JOIN_MAX_DEG
    hub_cap = 4 * hub_thr
    n_hub = max(lanes // 2, 1)
    w_ent = all_w[e0:l0]
    hub_pool = np.flatnonzero((w_ent > hub_thr) & (w_ent <= hub_cap)) + e0
    s.expect(len(hub_pool) > 0, "c7: no hub anchors in the band")
    hub_anchors = hub_pool[r.integers(0, len(hub_pool), size=n_hub)]
    tail_anchors = cand[r.integers(0, len(cand), size=lanes - n_hub)]
    anchors = np.concatenate([hub_anchors, tail_anchors]).astype(np.int64)
    pat = join_pattern("triangle", anchors[0])
    sig, c0 = split_constants(pat)
    plan = plan_join(snap, pat, sig, c0)
    consts = np.repeat(anchors[:, None], 2, axis=1).astype(np.int32)

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fact = oj.factorized_relations(snap, s.dev)
    torch.cuda.synchronize()
    out = {
        "anchors": anchors.tolist(),
        "hub_threshold": hub_thr, "hub_lanes": n_hub,
        "tail_lanes": lanes - n_hub,
        "max_hub_width": int(all_w[hub_anchors].max()),
        "fact_build_s": time.perf_counter() - t0,
        "fact_peak_above_bytes": torch.cuda.max_memory_allocated() - before,
        "fact_entries": fact["co"].entries,
        "fact_entries_flat": fact["co"].entries_flat,
        "fact_groups": fact["co"].n_groups,
        "fact_tgt_groups": fact["tgt"].n_groups,
    }
    s.log(f"join hub-heavy: factorized relations built on the card in "
          f"{out['fact_build_s']:.3f} s (host copies included; peak "
          f"{out['fact_peak_above_bytes'] / 2**30:.3f} GiB above "
          f"{before / 2**30:.3f}): co {fact['co'].n_groups} groups, "
          f"{fact['co'].entries} entries for {fact['co'].entries_flat} "
          f"closed-row entries; tgt {fact['tgt'].n_groups} groups")

    modes = {
        "split": dict(hub_threshold=hub_thr, factorized=False),
        "pr10": dict(hub_split=False, factorized=False),
        "fact": dict(hub_threshold=hub_thr, factorized=True),
    }
    res = {}
    for mode, kw in modes.items():
        lane_results(s, [run(plan, consts, **kw)])          # warm
        dt, ex = best_window(s, lambda kw=kw: run(plan, consts, **kw),
                             JOIN_REPS)
        counts, trunc = lane_results(s, [ex])
        res[mode] = (counts, trunc)
        served = lanes - int(trunc.sum())
        out[f"{mode}_anchors_per_sec"] = served / dt
        out[f"{mode}_raw_per_sec"] = lanes / dt
        out[f"{mode}_truncated"] = int(trunc.sum())
        out[f"{mode}_hub_lanes_dispatched"] = ex.hub_lanes
        if mode == "split":
            s.profile_later("join hub-heavy split (16 lanes)",
                            lambda kw=kw: run(plan, consts, **kw), dt * 1e3,
                            setup=lambda: rebuild_co(s, snap),
                            teardown=lambda: oj.release_join_caches(snap))
        s.log(f"join hub-heavy {mode}: {served / dt:.1f} exactly served "
              f"anchors/s ({lanes / dt:.1f} raw, {dt * 1e3:.3f} ms the "
              f"dispatch), truncated {int(trunc.sum())}, hub lanes "
              f"{ex.hub_lanes}")
    (sc, st), (fc, ft) = res["split"], res["fact"]
    ok = ~(st | ft)
    out["n_truncated"] = int(st.sum())
    out["factorized_equal"] = bool(np.array_equal(sc[ok], fc[ok]))
    hc = join_host_counts(off64, flat, "triangle", anchors)
    exact = ~st
    out["differential_equal"] = bool(
        np.array_equal(sc[exact], hc[exact])) and bool(exact.any())
    s.log(f"join hub-heavy: split truncated {out['n_truncated']} (pr10 "
          f"{out['pr10_truncated']}); factorized equal to flat on "
          f"{int(ok.sum())} lanes: {out['factorized_equal']}; split equal "
          f"to the host on {int(exact.sum())} lanes: "
          f"{out['differential_equal']}")
    s.expect(out["factorized_equal"], "factorized counts differ from flat")
    s.expect(out["differential_equal"], "hub-heavy split differs from host")
    return out


def join_cuda_cpu_check(s: Smoke) -> dict:
    """The engine on the card against the same engine on the CPU, on the
    port's generator at a small size: the co-incidence CSR and the
    factorized relations built on each, then triangle, 2-path, star3
    (bushy forced), link_var (a dedupe step) and seeds mode under the
    default shapes, the degree split (hub and row-split steps), the
    factorized relations and truncating caps — full bindings, counts,
    trunc and ``top_r = 16`` tuples equal."""
    import numpy as np

    from hypergraphdb_tpu_torch.join import (
        ConjunctivePattern,
        JoinAtom,
        plan_join,
        split_constants,
    )
    from hypergraphdb_tpu_torch.models import dbpedia_snapshot
    from hypergraphdb_tpu_torch.ops import join as oj

    devs = (s.dev, "cpu")
    snaps, info = {}, None
    for d in devs:
        snaps[d], info = dbpedia_snapshot(**JOIN_SMALL)
    small = snaps["cpu"]
    N = small.num_atoms
    csr = {d: oj.neighbor_csr(snaps[d], device=d) for d in devs}
    fact = {d: oj.factorized_relations(snaps[d], device=d) for d in devs}
    for a, b in zip(*csr.values()):
        s.expect(np.array_equal(a, b), "co CSR differs, card vs CPU")
    for rel in ("co", "tgt"):
        for f in ("group_of", "offsets", "flat"):
            s.expect(np.array_equal(getattr(fact[s.dev][rel], f),
                                    getattr(fact["cpu"][rel], f)),
                     f"factorized {rel}.{f} differs, card vs CPU")
    off64 = csr["cpu"][0].astype(np.int64)
    w = off64[1: N + 1] - off64[:N]
    e0, l0 = info["entities"]
    ent = np.arange(e0, l0)
    ent = ent[w[e0:l0] >= 2]
    rng = np.random.default_rng(9)
    anchors = np.concatenate([[ent[np.argmax(w[ent])]],
                              rng.choice(ent, size=7, replace=False)])
    a0 = int(anchors[0])
    co = lambda v, k: JoinAtom("co", v, k)  # noqa: E731
    pats = {
        "triangle": (ConjunctivePattern(("y", "z"), (
            co("y", a0), co("y", "z"), co("z", a0))), {}),
        "path2": (ConjunctivePattern(("y", "z"), (
            co("y", a0), co("z", "y"))), {}),
        "star3": (ConjunctivePattern(("y", "z", "w"), (
            co("y", a0), co("z", a0), co("w", a0))), {"bushy": True}),
        "link_var": (ConjunctivePattern(("l", "y"), (
            JoinAtom("inc", "l", a0), JoinAtom("tgt", "y", "l"))), {}),
    }
    modes = {
        "default": dict(var_pad_max=True),
        "split": dict(hub_threshold=64, pad_cap=64, var_pad_max=True),
        "fact": dict(factorized=True, var_pad_max=True),
        "caps": dict(row_cap=64, pad_cap=16),
    }
    cases = []
    for name, (pat, plan_kw) in pats.items():
        sig, c0 = split_constants(pat)
        plan = plan_join(small, pat, sig, c0, **plan_kw)
        consts = np.repeat(anchors[:, None], sig.n_consts, axis=1).astype(
            np.int32)
        consts[-1] = N - 1                       # a pad lane's garbage
        for mode, kw in modes.items():
            cases.append((f"{name}/{mode}", plan, consts,
                          dict(n_real=len(anchors) - 1, **kw)))
        if name == "triangle":
            # value windows on both variables (entity ranks 0..1999)
            win = {"y": (0, 100, "gte", None, None),
                   "z": (0, None, None, 1000, "lt")}
            for mode in ("default", "split"):
                cases.append((f"{name}/{mode}/window", plan, consts,
                              dict(n_real=len(anchors) - 1,
                                   value_windows=win, **modes[mode])))
    tri = ConjunctivePattern(("x", "y", "z"), (
        co("x", "y"), co("y", "z"), co("z", "x")))
    cases.append(("seeds/triangle", plan_join(small, tri, seed_var="x"),
                  np.zeros((1, 0), np.int32),
                  dict(seeds=ent[:256].astype(np.int32), row_cap=1 << 18,
                       var_pad_max=True)))
    n_rows = 0
    for name, plan, consts, kw in cases:
        got = {}
        for d in devs:
            ex = oj.execute_join(snaps[d], plan, consts, top_r=16, full=True,
                                 device=d, **kw)
            got[d] = [t.cpu().numpy() for t in (
                ex.counts, ex.trunc, ex.tuples, ex.cols, ex.lanes, ex.valid)
            ] + [np.asarray([ex.hub_lanes, ex.host_syncs])]
        same = all(np.array_equal(a, b)
                   for a, b in zip(got[s.dev], got["cpu"]))
        s.expect(same, f"join {name}: the card differs from the CPU")
        n_rows += int(got["cpu"][5].sum())
    s.log(f"join: card equal to the CPU in all {len(cases)} cases (small "
          f"graph of {N} atoms, {n_rows} binding rows compared)")
    return {"cases": len(cases), "equal": True, "binding_rows": n_rows}


#: bench.py c9's traffic: C9_REQUESTS requests from default_rng(C9_SEED),
#: windows [lo, lo + C9_WINDOW] over the entity ranks, a third each range,
#: top-k ascending and top-k descending (limit C9_LIMIT), top_r C9_TOP_R
C9_REQUESTS, C9_SEED, C9_WINDOW, C9_LIMIT, C9_TOP_R = 4096, 29, 24, 8, 16
#: c9's bucket shapes: the main dispatch width and the other two
C9_BATCH, C9_OTHER_BATCHES = 1024, (64, 256)
#: warm windows of the whole traffic timed host to host
C9_WINDOWS = 10
#: bench.py c3's value leg: kind 0, ranks in [lo, hi) (property ids)
C3_VALUE_LO, C3_VALUE_HI = 16, 48
#: rows of the device rank and kind columns held against numpy
VALUE_ROW_CHECKS, VALUE_ROW_SEED = 1000, 13
#: typed lanes of the filter batch: entity windows this wide (covered)
FILTER_WIDTH, FILTER_LANES = 14, 16


def c9_requests(n_entities: int):
    """``(lo, kind)`` of c9's requests: ``kind`` 0 range, 1 top-k
    ascending, 2 top-k descending."""
    import numpy as np

    r = np.random.default_rng(C9_SEED)
    los = r.integers(0, n_entities - C9_WINDOW, size=C9_REQUESTS)
    return los, r.integers(0, 3, size=C9_REQUESTS)


def c9_batches(los, kinds, width: int):
    """Host bounds of the requests in ``width``-lane batches: ``[(first
    request, bounds)]``, windows ``[lo, lo + C9_WINDOW]`` gte/lte."""
    import numpy as np

    from hypergraphdb_tpu_torch.ops.value_index import lane_bounds

    out = []
    for i in range(0, len(los), width):
        lo = los[i: i + width].astype(np.uint64)
        n = len(lo)
        out.append((i, lane_bounds(
            width, lo, np.zeros(n, bool), lo + np.uint64(C9_WINDOW),
            np.ones(n, bool), desc=kinds[i: i + width] == 2)))
    return out


def range_oracle(h_rank, h_gid, lo: int, hi: int, desc: bool, upto: int,
                 win_pad: int):
    """``(window total, first upto gids)`` of an unfiltered ``[lo, hi]``
    window over the host column (``h_rank`` ascending, gids ascending
    within a rank): ascending, or by rank descending with gids ascending
    within a rank. Of a window wider than ``win_pad``, a descending lane
    sees its last ``win_pad`` entries only: a rank tie across that edge
    keeps the largest gids of the tie (at 10M atoms c9's windows hold no
    tie)."""
    import numpy as np

    a = int(np.searchsorted(h_rank, np.uint64(lo), "left"))
    b = int(np.searchsorted(h_rank, np.uint64(hi), "right"))
    if not desc:
        return b - a, h_gid[a: min(b, a + upto)]
    start = max(a, b - win_pad)
    seen = np.lexsort((h_gid[start:b], ~h_rank[start:b]))
    return b - a, h_gid[start:b][seen][:upto]


def first_r_row(head, top_r: int):
    import numpy as np

    from hypergraphdb_tpu_torch.ops.setops import SENTINEL

    row = np.full(top_r, int(SENTINEL), np.int64)
    row[: len(head)] = head
    return row


def serve_all(s: Smoke, snap, base, delta, batches, top_r=C9_TOP_R):
    """Every batch through ``serve_range_batch``, results on the host:
    ``[(first request, counts, first_r, covered, window_total)]``."""
    from hypergraphdb_tpu_torch.ops.value_index import serve_range_batch

    outs = [(i, serve_range_batch(snap, base, delta, b, top_r=top_r,
                                  device=s.dev)) for i, b in batches]
    return [(i, *(t.cpu().numpy() for t in o)) for i, o in outs]


def check_c9(s: Smoke, results, los, kinds, h_rank, h_gid, what: str):
    """Every real lane's window total, and first_r up to its limit, equal
    to the host column's oracle."""
    from hypergraphdb_tpu_torch.ops.value_index import range_win_pad

    for i, counts, first_r, covered, total in results:
        for j in range(min(len(counts), len(los) - i)):
            q = i + j
            upto = C9_TOP_R if kinds[q] == 0 else min(C9_LIMIT, C9_TOP_R)
            n, head = range_oracle(h_rank, h_gid, int(los[q]),
                                   int(los[q]) + C9_WINDOW, kinds[q] == 2,
                                   upto, range_win_pad(C9_TOP_R))
            s.expect(int(total[j]) == n,
                     f"{what}: request {q} window total {total[j]} != {n}")
            s.expect(list(first_r[j][:upto]) == list(first_r_row(head, upto)),
                     f"{what}: request {q} first_r differs from the oracle")


def phase_values(s: Smoke, snap, info, join_rec: dict) -> dict:
    """The value plane on the 10M snapshot: the device value columns, the
    kind-0 value index column, bench.py c9's range and top-k traffic,
    the same traffic over a base and a delta column, typed and anchored
    lanes on the card against the CPU, and c3's value leg."""
    import dataclasses

    import numpy as np

    from hypergraphdb_tpu_torch.ops import setops
    from hypergraphdb_tpu_torch.ops.snapshot import rank_words
    from hypergraphdb_tpu_torch.ops.value_index import (
        lane_bounds,
        range_win_pad,
        serve_range_batch,
    )
    from hypergraphdb_tpu_torch.storage import value_index as svi

    torch = s.torch
    t_phase = time.perf_counter()
    N = snap.num_atoms
    e0, l0 = info["entities"]
    rec: dict = {}

    # -- the columns
    dsnap = snap.device(s.dev)
    h1 = hub_rows(snap)[0][0]
    rows = np.concatenate([np.random.default_rng(VALUE_ROW_SEED).integers(
        0, N, VALUE_ROW_CHECKS - 3), [h1, N, N - 1]])
    rows_dev = torch.from_numpy(rows).to(s.dev)
    want_rank = rank_words(snap.value_rank[rows])
    vcols = setops.value_columns(snap, s.dev)
    s.expect(np.array_equal(dsnap.value_rank[rows_dev].cpu().numpy(),
                            want_rank)
             and np.array_equal(dsnap.value_kind[rows_dev].cpu().numpy(),
                                snap.value_kind[rows]),
             "device rank or kind column differs from numpy")
    packed = vcols[rows_dev].cpu().numpy()
    s.expect(np.array_equal(packed[:, 0], want_rank)
             and np.array_equal(packed[:, 1], snap.value_kind[rows]),
             "value_columns differs from numpy")

    live = np.flatnonzero((snap.value_kind[:N] == 0) & (snap.type_of[:N] >= 0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    col = svi.value_index_column(snap, 0, s.dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # the host sort alone, on the same triples (also the oracle's order)
    t0 = time.perf_counter()
    order = np.lexsort((live, np.zeros(len(live), np.uint64),
                        snap.value_rank[live]))
    sort_s = time.perf_counter() - t0
    h_rank, h_gid = snap.value_rank[live][order], live[order]
    host = [np.empty(col.rank.shape[0], np.int64),
            np.empty(col.rank.shape[0], np.int64),
            np.empty(col.gids.shape[0], np.int32)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in host:
        torch.from_numpy(a).to(s.dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    n = col.n
    col_bytes = sum(t.numel() * t.element_size()
                    for t in (col.rank, col.rank2, col.gids))
    r, r2, g = col.rank[:n], col.rank2[:n], col.gids[:n]
    sorted_ok = bool(((r[1:] > r[:-1]) | ((r[1:] == r[:-1]) & (
        (r2[1:] > r2[:-1]) | ((r2[1:] == r2[:-1]) & (g[1:] > g[:-1])))))
        .all())
    perm_ok = bool(torch.equal(torch.sort(g).values,
                               torch.from_numpy(live.astype(np.int32))
                               .to(s.dev)))
    pads_ok = bool((col.rank[n:] == int(svi.RANK_PAD)).all()
                   and (col.gids[n:] == int(svi.GID_PAD)).all())
    s.expect(sorted_ok and perm_ok and pads_ok and n == len(live),
             "value index column is not the sorted live atoms")
    s.expect(np.array_equal(col.gids[: min(n, 1 << 16)].cpu().numpy(),
                            h_gid[: 1 << 16]),
             "value index column's order differs from np.lexsort")
    rec["column"] = {"entries": n, "slots": int(col.rank.shape[0]),
                     "bytes": col_bytes, "build_s": build_s,
                     "host_sort_s": sort_s, "upload_s": upload_s}
    s.log(f"values: {len(rows)} rows of the device rank and kind columns "
          f"and value_columns ({tuple(vcols.shape)} int64) equal numpy "
          f"(h1 {h1}, the dummy row, the last link); kind-0 column built in "
          f"{build_s:.3f} s (host sort alone {sort_s:.3f} s, upload of its "
          f"{col_bytes} bytes alone {upload_s:.3f} s): {n} entries in "
          f"{col.rank.shape[0]} slots, sorted by (rank, rank2, gid), gids "
          f"the live atoms")

    # -- bench.py c9's traffic over the whole column, an empty delta
    empty = svi._sorted_device_column(0, np.zeros(0, np.uint64),
                                      np.zeros(0, np.int64), minimum=32,
                                      device=s.dev)
    los, kinds = c9_requests(l0 - e0)
    s.expect(range_win_pad(C9_TOP_R) == 16, "win_pad rule changed")
    main = c9_batches(los, kinds, C9_BATCH)
    whole = serve_all(s, snap, col, empty, main)
    check_c9(s, whole, los, kinds, h_rank, h_gid, "c9")
    for width in C9_OTHER_BATCHES:
        part = c9_batches(los[:width], kinds[:width], width)
        check_c9(s, serve_all(s, snap, col, empty, part), los, kinds,
                 h_rank, h_gid, f"c9 {width}-lane batch")
    secs = []
    serve_all(s, snap, col, empty, main)                 # warm
    for _ in range(C9_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve_all(s, snap, col, empty, main)
        secs.append(time.perf_counter() - t0)
    rps = [C9_REQUESTS / t for t in secs]
    rec["c9"] = {"requests": C9_REQUESTS, "batch": C9_BATCH,
                 "requests_per_s_median": float(np.median(rps)),
                 "min": min(rps), "max": max(rps),
                 "window_s": secs, "kinds": np.bincount(kinds).tolist()}
    s.log(f"values c9: {C9_REQUESTS} requests (range / top-k asc / top-k "
          f"desc {np.bincount(kinds).tolist()}) in {C9_BATCH}-lane "
          f"batches, and 64- and 256-lane batches, equal the numpy oracle; "
          f"{np.median(rps):.1f} requests/s host to host (median of "
          f"{C9_WINDOWS} warm windows, min {min(rps):.1f}, max "
          f"{max(rps):.1f})")
    one = main[0][1]

    def range_batch():
        out = serve_range_batch(snap, col, empty, one, top_r=C9_TOP_R,
                                device=s.dev)
        return [t.cpu() for t in out]

    batch_ms = served_ms(s, range_batch)
    s.log(f"values: one {C9_BATCH}-lane range batch host to host "
          f"{spread(batch_ms)}")
    s.profile_later(f"range batch ({C9_BATCH} lanes)", range_batch,
                    float(np.median(batch_ms)))

    # -- base + delta: phase 10's held-back links in the delta column
    held = np.flatnonzero(snap.is_link[:N])[-DELTA_LINKS:]
    is_held = np.zeros(N, dtype=bool)
    is_held[held] = True
    base_ids = live[~is_held[live]]
    t0 = time.perf_counter()
    base = svi._sorted_device_column(0, snap.value_rank[base_ids], base_ids,
                                     device=s.dev)
    delta = svi._sorted_device_column(0, snap.value_rank[held], held,
                                      minimum=32, device=s.dev)
    torch.cuda.synchronize()
    split_s = time.perf_counter() - t0
    split = serve_all(s, snap, base, delta, main)
    # a descending window past the gather pad whose last win_pad entries
    # start inside a rank tie: each column keeps the gids its own end
    # reached, so a split may change first_r there (none at 10M atoms)
    pad = range_win_pad(C9_TOP_R)
    a_idx = np.searchsorted(h_rank, los.astype(np.uint64), "left")
    b_idx = np.searchsorted(h_rank, (los + C9_WINDOW).astype(np.uint64),
                            "right")
    edge = np.maximum(b_idx - pad, 1)
    torn = (kinds == 2) & (b_idx - a_idx > pad) & (
        h_rank[edge - 1] == h_rank[np.minimum(edge, len(h_rank) - 1)])
    for (i, c1, f1, cov1, t1), (_, c2, f2, cov2, t2) in zip(whole, split):
        both = cov1 & cov2
        keep = ~np.concatenate([torn[i: i + C9_BATCH],
                                np.zeros(max(0, i + C9_BATCH - len(torn)),
                                         bool)])
        s.expect(np.array_equal(f1[keep], f2[keep])
                 and np.array_equal(t1, t2),
                 f"base + delta differs from the whole column at batch {i}")
        s.expect(np.array_equal(c1[both], c2[both]),
                 f"base + delta counts differ on covered lanes, batch {i}")
    # one-rank windows over the link ranks meet both columns; ascending
    # only: past the gather pad a descending tie keeps the gids each
    # column's end reached, which a split moves (as in the reference)
    lo_links = np.arange(64, dtype=np.uint64)
    wide = lane_bounds(64, lo_links, np.zeros(64, bool), lo_links,
                       np.ones(64, bool))
    (_, *wa), = serve_all(s, snap, col, empty, [(0, wide)])
    (_, *wb), = serve_all(s, snap, base, delta, [(0, wide)])
    s.expect(np.array_equal(wa[1], wb[1]) and np.array_equal(wa[3], wb[3]),
             "base + delta differs on the link ranks 0..63")
    rec["delta"] = {"held_links": len(held), "torn": int(torn.sum()),
                    "base_entries": base.n,
                    "delta_entries": delta.n, "build_s": split_s}
    s.log(f"values base + delta: {base.n} base and {delta.n} delta entries "
          f"(phase 10's held-back links; built in {split_s:.3f} s); c9's "
          f"{C9_REQUESTS} requests ({int(torn.sum())} descending windows "
          f"torn at a rank tie left out of the first_r check) and 64 "
          f"one-rank link windows give the whole column's first_r and "
          f"window totals, counts equal where both are covered")

    # -- filters: typed entity windows (covered), typed and anchored lanes
    # over c3's link window (wide): the card against the CPU
    th = top_property_type(snap, info)
    no_entity_type = 1                      # a property type: links only
    anchors = [h1] + [int(a) for a in join_rec["hub_heavy"]["anchors"]]
    k = FILTER_LANES
    f_lo = np.concatenate([los[:2 * k].astype(np.uint64),
                           np.full(2 * len(anchors) + 2, C3_VALUE_LO,
                                   np.uint64)])
    f_hi = np.concatenate([los[:2 * k].astype(np.uint64)
                           + np.uint64(FILTER_WIDTH),
                           np.full(2 * len(anchors) + 2, C3_VALUE_HI,
                                   np.uint64)])
    n_f = len(f_lo)
    type_vec = np.concatenate([np.zeros(k), np.full(k, no_entity_type),
                               np.full(len(anchors), -1),
                               np.full(len(anchors), th), [th, -1]])
    anchor = np.concatenate([np.full(2 * k, -1), anchors, anchors,
                             [-1, -1]])
    hi_right = np.concatenate([np.ones(2 * k, bool),
                               np.zeros(n_f - 2 * k, bool)])
    fb = lane_bounds(setops._bucket(n_f, minimum=64), f_lo,
                     np.zeros(n_f, bool), f_hi,
                     hi_right, type_vec=type_vec, anchor=anchor,
                     desc=np.arange(n_f) % 2 == 1)
    card = [t.cpu().numpy() for t in serve_range_batch(
        snap, col, empty, fb, top_r=C9_TOP_R, device=s.dev)]
    cpu_col = dataclasses.replace(col, rank=col.rank.cpu(),
                                  rank2=col.rank2.cpu(), gids=col.gids.cpu())
    cpu_empty = dataclasses.replace(empty, rank=empty.rank.cpu(),
                                    rank2=empty.rank2.cpu(),
                                    gids=empty.gids.cpu())
    cpu = [t.numpy() for t in serve_range_batch(
        snap, cpu_col, cpu_empty, fb, top_r=C9_TOP_R, device="cpu")]
    for a, b, name in zip(card, cpu, ("counts", "first_r", "covered",
                                      "window_total")):
        s.expect(a.dtype == b.dtype and np.array_equal(a, b),
                 f"filter batch: {name} differs, card vs CPU")
    counts, first_r, covered, total = card
    n_cov = 0
    for j in range(n_f):
        if not covered[j]:
            continue
        n_cov += 1
        lo_j, hi_j = int(f_lo[j]), int(f_hi[j])
        a = int(np.searchsorted(h_rank, np.uint64(lo_j), "left"))
        b = int(np.searchsorted(h_rank, np.uint64(hi_j),
                                "right" if hi_right[j] else "left"))
        ids = h_gid[a:b]
        if type_vec[j] >= 0:
            ids = ids[snap.type_of[ids] == type_vec[j]]
        if anchor[j] >= 0:
            ids = ids[np.isin(ids, snap.incidence_row(int(anchor[j])))]
        if j % 2 == 1:   # descending; every entity rank is distinct
            ids = ids[::-1]
        s.expect(int(counts[j]) == len(ids) and list(first_r[j]) == list(
            first_r_row(ids[:C9_TOP_R], C9_TOP_R)),
                 f"filter lane {j} differs from numpy")
    s.expect(n_cov >= 2 * k and not covered[2 * k: n_f].any(),
             "filter batch: unexpected covered lanes")
    rec["filters"] = {"lanes": n_f, "covered": n_cov,
                      "anchors": len(anchors), "type": th}
    s.log(f"values filters: {n_f} lanes ({2 * k} typed entity windows of "
          f"width {FILTER_WIDTH + 1}, type 0 and type {no_entity_type}; "
          f"{n_f - 2 * k} typed and anchored lanes at h1 and c7's "
          f"{len(anchors) - 1} hub-heavy anchors over [{C3_VALUE_LO}, "
          f"{C3_VALUE_HI}), type {th}) equal on the card and the CPU, all "
          f"four outputs; the {n_cov} covered lanes equal numpy")
    del cpu_col, cpu_empty

    # -- bench.py c3's value leg on the pattern phase's plan
    pairs, _ = c3_pairs(snap, info)
    plan = setops.plan_pattern(snap, pairs, None, device=s.dev)
    ell = setops.ell_targets(snap, s.dev)

    def value_exec(vc=None):
        return [setops.incident_value_range(
            dsnap, ell, anchors_dev, pad, 0, C3_VALUE_LO, C3_VALUE_HI,
            "gte", "lt", True, None, vc) for _, anchors_dev, pad in
            plan.buckets]

    outs = value_exec()
    outs_v = value_exec(vcols)
    for (rw, kp, tie, cnt), (rv, kv, tv, cv) in zip(outs, outs_v):
        s.expect(torch.equal(rw, rv) and torch.equal(kp, kv)
                 and torch.equal(cnt, cv) and not tie.any() and not tv.any(),
                 "c3 value leg: the row pack differs from the columns")
    got = np.zeros(PATTERN_PAIRS, np.int64)
    for (sel, _, _), (_, _, _, cnt) in zip(plan.buckets, outs):
        got[sel] = cnt.cpu().numpy()
    in_win = (snap.value_rank >= C3_VALUE_LO) & (snap.value_rank < C3_VALUE_HI)
    want = np.asarray([int(in_win[host_pattern(snap, p, None)].sum())
                       for p in pairs])
    s.expect(np.array_equal(got, want), "c3 value leg counts differ "
             "from numpy")
    # each op at rank C3_VALUE_LO: the masks of the first 128 queries
    n_masks = 0
    for sel, anchors_dev, pad in plan.buckets:
        pick = np.flatnonzero(sel < 128)
        if not len(pick):
            continue
        av = anchors_dev.cpu().numpy()
        masks = {op: setops.incident_value_pattern(
            dsnap, ell, anchors_dev, pad, 0, C3_VALUE_LO, op, True)
            for op in setops.VALUE_OPS}
        rows0 = masks["eq"][0].cpu().numpy()
        for j in pick:
            row = rows0[j]
            other = snap.incidence_row(int(av[j, 1]))
            pos = np.minimum(np.searchsorted(other, row),
                             max(len(other) - 1, 0))
            ok = (row != int(setops.SENTINEL)) & (
                other[pos] == row if len(other) else False)
            v = snap.value_rank[np.where(ok, row, N)].astype(np.int64)
            want_of = {"eq": v == C3_VALUE_LO, "lt": v < C3_VALUE_LO,
                       "lte": v <= C3_VALUE_LO, "gt": v > C3_VALUE_LO,
                       "gte": v >= C3_VALUE_LO}
            for op, (_, definite, tie) in masks.items():
                s.expect(not bool(tie[j].any()) and np.array_equal(
                    definite[j].cpu().numpy(), ok & want_of[op]),
                    f"c3 value pattern {op}: query {sel[j]} differs")
                n_masks += 1

    def value_window():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PATTERN_REPS):
            last = value_exec(vcols)
        torch.cuda.synchronize()
        return PATTERN_PAIRS * PATTERN_REPS / (time.perf_counter() - t0), last

    value_window()                                         # warm
    qps = [value_window()[0] for _ in range(PATTERN_WINDOWS)]
    med = float(np.median(qps))
    rec["c3_value"] = {"queries_per_s": qps, "median": med,
                       "bindings": int(got.sum())}
    s.log(f"values c3 value leg: {PATTERN_PAIRS} queries, kind 0 ranks "
          f"[{C3_VALUE_LO}, {C3_VALUE_HI}) exact, counts equal numpy "
          f"({int(got.sum())} links in all), row pack equal to the columns, "
          f"{len(setops.VALUE_OPS)} ops' masks equal numpy on {n_masks} "
          f"query rows; execute-only {med:.1f} queries/s (windows of "
          f"{PATTERN_REPS} executions: {[round(q) for q in qps]})")
    s.profile_later(f"c3 value leg window ({PATTERN_REPS} executions)",
                    lambda: value_window(),
                    PATTERN_PAIRS * PATTERN_REPS / med * 1e3)
    rec["phase_s"] = time.perf_counter() - t_phase
    s.log(f"values phase: {rec['phase_s']:.1f} s in all; record "
          + json.dumps({k: v for k, v in rec.items() if k != "c9"}))
    return rec


# ------------------------------------------------ 18. the packed push BFS

#: bench.py c2 (:294) at its defaults (BASELINE config 2, a WordNet-scale
#: lexical graph): ``zipf_hypergraph`` of 80,000 nodes and 40,000 links of
#: arity 2..5 (seed 7), K = 1,024 distinct seeds from default_rng(123), 2
#: hops, edge chunks of 2^17; one warm call, then the best of 3; the host
#: baselines over 64 (vectorized) and 16 (Python) seeds, best of 2
C2_NODES, C2_LINKS, C2_ARITY, C2_SEED = 80_000, 40_000, 5, 7
C2_K, C2_HOPS, C2_CHUNK, C2_SEEDS_SEED = 1024, 2, 1 << 17, 123
C2_HOST_VEC, C2_HOST_PY = 64, 16
#: the 10M leg: phase 4's first 1,024 seeds, its 3 hops, 256-seed blocks,
#: edge chunks of 2^19; the lanes held against the host BFS (phase 4's
#: HOST_LANES below 1,024, topped up to 16); the first block once more
#: with levels, held against the staged chain's hop-by-hop bitmaps
P10_K, P10_BLOCK, P10_CHUNK = 1024, 256, 1 << 19
P10_HOST_LANES = tuple(k for k in HOST_LANES if k < 1024) + (
    100, 200, 300, 400, 500, 600, 700, 800, 900, 1000, 1023)


def packed_equals_pull(torch, vis, vt, n1: int, step: int = 1 << 16) -> bool:
    """Whether the packed BFS's (K, W) seed-major words and the pull
    BFS's (n_pad, K/32) transposed words hold the same bits for atoms
    0..n1-1, compared in blocks of ``step`` atoms (a multiple of 32)."""
    K = vis.shape[0]
    shifts = torch.arange(32, dtype=torch.int32, device=vis.device)
    for a0 in range(0, n1, step):
        a1 = min(a0 + step, n1)
        w0, w1 = a0 // 32, -(-a1 // 32)
        mine = ((vis[:, w0:w1, None] >> shifts) & 1).to(torch.bool)
        mine = mine.reshape(K, -1)[:, : a1 - a0]
        pull = ((vt[a0:a1, :, None] >> shifts) & 1).to(torch.bool)
        pull = pull.reshape(a1 - a0, -1)[:, :K]
        if not torch.equal(mine, pull.T):
            return False
    return True


def packed_lane(torch, vis, k: int, n: int):
    """Lane ``k``'s reached atom ids (sorted numpy) from packed words."""
    from hypergraphdb_tpu_torch.ops.bitfrontier import unpack_bits

    return torch.nonzero(unpack_bits(vis[k])[:n]).flatten().cpu().numpy()


def host_bfs_python(g, seeds, max_hops: int):
    """bench.py's pointer-chasing host engine (per-atom incidence fetch,
    per-link target iteration): returns (edges/s, edges)."""
    t0 = time.perf_counter()
    edges = 0
    for seed in seeds:
        visited, frontier = {seed}, [seed]
        for _ in range(max_hops):
            nxt = []
            for a in frontier:
                inc = g.get_incidence_set(a).array()
                edges += len(inc)
                for lk in inc.tolist():
                    for t in g.get_targets(lk):
                        t = int(t)
                        if t not in visited:
                            visited.add(t)
                            nxt.append(t)
            frontier = nxt
    dt = time.perf_counter() - t0
    return edges / dt, edges


def host_bfs_rate(snap, seeds, max_hops: int):
    """The vectorized host BFS (``ops/host_bfs``) over ``seeds``: (edges/s,
    edges)."""
    from hypergraphdb_tpu_torch.ops.host_bfs import host_bfs

    t0 = time.perf_counter()
    edges = sum(host_bfs(snap, int(x), max_hops)[1] for x in seeds)
    return edges / (time.perf_counter() - t0), edges


def packed_c2(s: Smoke) -> None:
    """18 (a): bench c2 at its defaults, uncut."""
    import numpy as np

    from hypergraphdb_tpu_torch.core.graph import HyperGraph
    from hypergraphdb_tpu_torch.models import zipf_hypergraph
    from hypergraphdb_tpu_torch.ops.bitfrontier import (
        bfs_memory_bytes,
        bfs_packed,
    )
    from hypergraphdb_tpu_torch.ops.ellbfs import bfs_pull
    from hypergraphdb_tpu_torch.ops.host_bfs import host_bfs

    torch = s.torch
    g = HyperGraph()
    t0 = time.perf_counter()
    nodes, _ = zipf_hypergraph(g, n_nodes=C2_NODES, n_links=C2_LINKS,
                               max_arity=C2_ARITY, seed=C2_SEED)
    snap = g.snapshot()
    build_s = time.perf_counter() - t0
    r = np.random.default_rng(C2_SEEDS_SEED)
    seeds = (r.choice(len(nodes), size=C2_K, replace=False)
             + int(nodes[0])).astype(np.int32)

    def run():
        return bfs_packed(snap, seeds, C2_HOPS, k_block=C2_K,
                          edge_chunk=C2_CHUNK, device=s.dev)

    run()  # warm: the device twin, the allocator
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vis, cnt, _ = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - base
    best = min(times)
    edges = int(cnt.sum())
    plan = bfs_memory_bytes(snap.num_atoms, snap.n_edges_inc,
                            snap.n_edges_tgt, k_block=C2_K,
                            edge_chunk=C2_CHUNK)
    vec_eps = max(host_bfs_rate(snap, seeds[:C2_HOST_VEC], C2_HOPS)[0]
                  for _ in range(2))
    py_eps = max(host_bfs_python(g, seeds[:C2_HOST_PY].tolist(), C2_HOPS)[0]
                 for _ in range(2))
    n_chunks = C2_HOPS * (-(-snap.n_edges_inc // C2_CHUNK)
                          - (-snap.n_edges_tgt // C2_CHUNK))
    s.log(f"packed c2: {snap.num_atoms} atoms ({snap.n_edges_inc} "
          f"incidence, {snap.n_edges_tgt} target entries) built in "
          f"{build_s:.2f} s; {C2_K} seeds x {C2_HOPS} hops, {edges} edges; "
          f"runs {[round(t * 1e3, 3) for t in times]} ms, best "
          f"{best * 1e3:.3f} ms, {edges / best:.4e} edges/s; host "
          f"vectorized {vec_eps:.4e} edges/s ({C2_HOST_VEC} seeds), Python "
          f"{py_eps:.4e} ({C2_HOST_PY} seeds); peak {peak / 2**30:.3f} GiB "
          f"over the resident, plan {plan['total'] / 2**30:.3f} GiB; "
          f"{n_chunks} relation chunks a run")

    pull = bfs_pull(snap, seeds, C2_HOPS, k_block=C2_K, device=s.dev)
    s.expect(packed_equals_pull(torch, vis, pull.visited_t,
                                snap.num_atoms + 1),
             "packed c2: visited rows differ from the fused pull BFS")
    s.expect(np.array_equal(cnt.cpu().numpy(), pull.edges_touched),
             "packed c2: edges_touched differ from the fused pull BFS")
    lanes = np.linspace(0, C2_K - 1, 16).astype(int)
    for k in lanes.tolist():
        want, want_edges = host_bfs(snap, int(seeds[k]), C2_HOPS)
        s.expect(np.array_equal(packed_lane(torch, vis, k, snap.num_atoms),
                                want) and int(cnt[k]) == want_edges,
                 f"packed c2: lane {k} differs from the host BFS")
    s.log(f"packed c2: visited rows and edge counts equal the fused pull "
          f"BFS; lanes {lanes.tolist()} equal the host BFS")
    s.profile_later("packed BFS c2 (1024 seeds, 2 hops)", run, best * 1e3)
    g.close()


def packed_10m(s: Smoke, snap, truth: dict) -> None:
    """18 (b): the packed BFS over the 10M snapshot: phase 4's first 1,024
    seeds, 3 hops, 256-seed blocks."""
    import numpy as np

    from hypergraphdb_tpu_torch.ops import ellbfs
    from hypergraphdb_tpu_torch.ops.bitfrontier import (
        bfs_memory_bytes,
        bfs_packed,
    )
    from hypergraphdb_tpu_torch.ops.host_bfs import host_bfs

    torch = s.torch
    N = snap.num_atoms
    seeds = truth["seeds"][:P10_K]
    extra = [k for k in P10_HOST_LANES if k not in truth["host"]]
    pool = ThreadPoolExecutor(max_workers=4)
    host = {k: pool.submit(host_bfs, snap, int(seeds[k]), HOPS)
            for k in extra}
    snap.device(s.dev)  # the device twin, outside the timed run
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vis, cnt, _ = bfs_packed(snap, seeds, HOPS, k_block=P10_BLOCK,
                             edge_chunk=P10_CHUNK, device=s.dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    plan = bfs_memory_bytes(N, snap.n_edges_inc, snap.n_edges_tgt,
                            k_block=P10_BLOCK, edge_chunk=P10_CHUNK)
    edges = int(cnt.sum())
    n_chunks = (P10_K // P10_BLOCK) * HOPS * (
        -(-snap.n_edges_inc // P10_CHUNK) - (-snap.n_edges_tgt // P10_CHUNK))
    s.log(f"packed 10M: {P10_K} seeds x {HOPS} hops in {P10_BLOCK}-seed "
          f"blocks, {edges} edges in {secs:.3f} s ({edges / secs:.4e} "
          f"edges/s); peak {peak / 2**30:.3f} GiB over the resident "
          f"{base / 2**30:.3f} GiB, bfs_memory_bytes {plan['total'] / 2**30:.3f}"
          f" GiB ({ {k: round(v / 2**30, 3) for k, v in plan.items()} }); "
          f"{n_chunks} relation chunks")

    pull = ellbfs.bfs_pull(snap, seeds, HOPS, k_block=P10_K, device=s.dev)
    s.expect(packed_equals_pull(torch, vis, pull.visited_t, N + 1),
             "packed 10M: visited rows differ from the fused pull BFS")
    s.expect(np.array_equal(cnt.cpu().numpy(), pull.edges_touched),
             "packed 10M: edges_touched differ from the fused pull BFS")
    del pull
    want = dict(truth["host"])
    want.update({k: f.result() for k, f in host.items()})
    pool.shutdown()
    for k in P10_HOST_LANES:
        reach, edges_k = want[k]
        s.expect(np.array_equal(packed_lane(torch, vis, k, N), reach)
                 and int(cnt[k]) == edges_k,
                 f"packed 10M: lane {k} differs from the host BFS")
    s.log(f"packed 10M: visited rows and edge counts equal the fused pull "
          f"BFS (phase 4's path); lanes {list(P10_HOST_LANES)} equal the "
          f"host BFS")
    del vis, cnt

    # one block with levels against the staged chain's bitmaps: a bit set
    # after h hops of the chain is an atom at level <= h
    block = seeds[:P10_BLOCK]
    t0 = time.perf_counter()
    _, _, lev = bfs_packed(snap, block, HOPS, k_block=P10_BLOCK,
                           edge_chunk=P10_CHUNK, with_levels=True,
                           device=s.dev)
    torch.cuda.synchronize()
    lev_s = time.perf_counter() - t0
    lev_t = lev.T  # (N+1, K)
    shifts = torch.arange(32, dtype=torch.int32, device=s.dev)
    checked = []

    def hook(h, visited, vmask):
        step = 1 << 18
        for a0 in range(0, N + 1, step):
            a1 = min(a0 + step, N + 1)
            bits = ((visited[a0:a1, :, None] >> shifts) & 1).reshape(
                a1 - a0, -1)[:, :P10_BLOCK].to(torch.bool)
            lv = lev_t[a0:a1]
            s.expect(torch.equal(bits, (lv >= 0) & (lv <= h)),
                     f"packed 10M levels: hop {h}, atoms {a0}..{a1} differ "
                     f"from the staged chain")
        checked.append(h)

    ellbfs._bfs_pull_device(ellbfs.device_plans(snap, s.dev),
                            ellbfs.plans_for(snap),
                            torch.from_numpy(block).to(s.dev), HOPS,
                            ellbfs.PLAIN_CHUNK, False, hop_hook=hook)
    s.expect(checked == list(range(HOPS + 1)), f"levels checked {checked}")
    s.log(f"packed 10M: one {P10_BLOCK}-seed block with levels in "
          f"{lev_s:.3f} s; levels equal the staged chain's hop at which "
          f"each bit is first set (hops 0..{HOPS})")
    del lev, lev_t
    torch.cuda.empty_cache()
    one = seeds[:P10_BLOCK]
    s.profile_later(
        f"packed BFS 10M, one {P10_BLOCK}-seed block",
        lambda: bfs_packed(snap, one, HOPS, k_block=P10_BLOCK,
                           edge_chunk=P10_CHUNK, device=s.dev),
        secs * 1e3 * P10_BLOCK / P10_K)


def phase_packed(s: Smoke, snap, truth: dict) -> None:
    """Phase 18: the bit-packed push BFS (``ops/bitfrontier``): bench c2
    uncut, then the 10M snapshot."""
    t0 = time.perf_counter()
    packed_c2(s)
    packed_10m(s, snap, truth)
    s.log(f"packed: phase 18 in {time.perf_counter() - t0:.1f} s")


# ------------------------------------------- 19. cold start and persistence

#: where phase 19 writes its checkpoint and its plan caches (git-ignored)
PERSIST_DIR = ROOT / "build" / "chip_smoke_persist"
#: lanes of phase 4's truth the reloaded checkpoint is held against
PERSIST_LANES = tuple(k for k in HOST_LANES if k < 1024)
#: bench.py c6's cold-start probe (:1001-1072) at its defaults: 20,000
#: entities, 20,000 links from default_rng(3), buckets 64/256/1024,
#: top_r 16, one 2-hop BFS from the first entity, each run in a fresh
#: process: first with the cache directory empty, then full
COLD_ENTITIES, COLD_TIMEOUT_S = 20_000, 600
COLD_CHILD = """
import json, sys, time
import numpy as np
sys.path.insert(0, {root!r})
from hypergraphdb_tpu_torch.core.graph import HyperGraph
from hypergraphdb_tpu_torch.ops import _cuda
from hypergraphdb_tpu_torch.serve import ServeConfig, ServeRuntime

g = HyperGraph()
r = np.random.default_rng(3)
ents = g.bulk_import(values=np.arange({n}).tolist())
e0 = int(ents[0])
subj = r.integers(0, {n}, size={n})
obj = r.integers(0, {n}, size={n})
g.bulk_import(values=[int(x) for x in range({n})],
              target_lists=[[e0 + int(a), e0 + int(b)]
                            for a, b in zip(subj, obj)])
t0 = time.perf_counter()
rt = ServeRuntime(g, ServeConfig(buckets=(64, 256, 1024),
                                 max_linger_s=0.002, top_r=16,
                                 aot_cache_dir={cache!r}))
res = rt.submit_bfs(e0, max_hops=2).result(timeout=600)
dt = time.perf_counter() - t0
s = rt.stats_snapshot()
print("COLD_RESULT " + json.dumps({{
    "first_result_s": dt, "aot": s.get("aot"), "seed": e0,
    "count": int(res.count), "matches": res.matches.tolist(),
    "served_by": res.served_by,
    "prewarm": rt.executor.prewarm_counts,
    "build_s": _cuda.last_build_seconds}}), flush=True)
rt.close()
g.close()
"""


def snapshot_equal(a, b) -> list:
    """The fields in which two host snapshots differ (empty: equal)."""
    import numpy as np

    bad = [f for f in ("version", "num_atoms", "n_edges_inc", "n_edges_tgt")
           if getattr(a, f) != getattr(b, f)]
    for f in ("inc_offsets", "inc_links", "inc_src", "tgt_offsets",
              "tgt_flat", "tgt_src", "type_of", "is_link", "arity",
              "value_rank", "value_kind", "value_rank2", "value_ambig"):
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            bad.append(f)
    if sorted(a.by_type) != sorted(b.by_type) or not all(
            np.array_equal(a.by_type[k], b.by_type[k]) for k in a.by_type):
        bad.append("by_type")
    return bad


def fresh_copy(snap):
    """The snapshot's arrays in a new object, without its memoized plans
    and device twins."""
    return type(snap)(**{k: v for k, v in vars(snap).items()
                         if not k.startswith("_")})


def plans_equal(a, b) -> bool:
    import numpy as np

    from dataclasses import asdict

    def flat(p):
        out = []

        def walk(x):
            if isinstance(x, dict):
                for k in sorted(x):
                    walk(x[k])
            elif isinstance(x, (tuple, list)):
                for v in x:
                    walk(v)
            else:
                out.append(np.asarray(x))
        walk(asdict(p))
        return out

    fa, fb = flat(a), flat(b)
    return len(fa) == len(fb) and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(fa, fb))


def served_lanes(s: Smoke, snap, truth: dict, what: str) -> dict:
    """The fused and the staged pull BFS over ``snap`` on phase 4's seeds
    at :data:`PERSIST_LANES` (a 1,024-seed block), each lane equal to
    phase 4's host truth. Returns the launches of the two runs."""
    import numpy as np

    from hypergraphdb_tpu_torch.ops import ellbfs

    seeds = truth["seeds"][:1024]
    reset_launches()
    for fused in (True, False):
        res = ellbfs.bfs_pull(snap, seeds, HOPS, k_block=1024, fused=fused,
                              device=s.dev)
        rows = ellbfs.visited_rows(res, snap.num_atoms, lanes=PERSIST_LANES)
        for k, got in zip(PERSIST_LANES, rows):
            want, want_edges = truth["host"][k]
            s.expect(np.array_equal(got, want)
                     and int(res.edges_touched[k]) == want_edges,
                     f"{what}: {'fused' if fused else 'staged'} lane {k} "
                     f"differs from phase 4's host BFS")
    n = launches()
    s.expect(n["fused_hop"] > 0 and n["gather_or"] > 0,
             f"{what}: K2 or K1 never launched: {n}")
    return n


def persist_checkpoint(s: Smoke, snap, truth: dict):
    """19 (a): ``save_snapshot(with_plans=True)`` of the 10M snapshot and
    its fused plan into the plan cache beside it (both plans were built in
    phase 4); then ``load_snapshot``: every array equal, the pull plans
    attached, the fused plan read from the cache, no plan built; the
    fused and staged BFS over the reloaded snapshot equal to phase 4's
    truth with K2 and K1 launched."""
    import os

    from hypergraphdb_tpu_torch.ops import aot_cache, checkpoint, ellbfs
    from hypergraphdb_tpu_torch.ops import fused_bfs

    path = str(PERSIST_DIR / "snap10m.npz")
    root = str(PERSIST_DIR / "aot")
    t0 = time.perf_counter()
    checkpoint.save_snapshot(snap, path, with_plans=True)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fp = ellbfs.snapshot_fingerprint(snap)
    fp_s = time.perf_counter() - t0
    c1 = aot_cache.AOTCache(root, content_key=fp, device=s.dev)
    t0 = time.perf_counter()
    fused_bfs.fused_plans_for(snap, aot=c1)   # phase 4's plan, handed over
    store_s = time.perf_counter() - t0
    sizes = {f: os.path.getsize(PERSIST_DIR / f)
             for f in sorted(os.listdir(PERSIST_DIR)) if f.endswith(".npz")}
    builds = {"pull": 0, "fused": 0}
    real = ellbfs.build_pull_plans, fused_bfs.build_fused_plan

    def counted(kind, fn):
        def wrapper(*a, **k):
            builds[kind] += 1
            return fn(*a, **k)
        return wrapper

    ellbfs.build_pull_plans = counted("pull", real[0])
    fused_bfs.build_fused_plan = counted("fused", real[1])
    try:
        t0 = time.perf_counter()
        loaded = checkpoint.load_snapshot(path)
        load_s = time.perf_counter() - t0
        bad = snapshot_equal(loaded, snap)
        s.expect(not bad, f"checkpoint: reloaded fields differ: {bad}")
        s.expect(getattr(loaded, "_pull_plans", None) is not None,
                 "checkpoint: the pull plans were not attached")
        s.expect(plans_equal(loaded._pull_plans, ellbfs.plans_for(snap)),
                 "checkpoint: the reloaded pull plans differ")
        s.expect(ellbfs.snapshot_fingerprint(loaded) == fp,
                 "checkpoint: the reloaded fingerprint differs")
        c2 = aot_cache.AOTCache(root, content_key=fp, device=s.dev)
        t0 = time.perf_counter()
        fused_bfs.fused_plans_for(loaded, aot=c2)
        read_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        n = served_lanes(s, loaded, truth, "checkpoint")
        serve_s = time.perf_counter() - t0
    finally:
        ellbfs.build_pull_plans, fused_bfs.build_fused_plan = real
    st = c2.stats.as_dict()
    s.expect(builds == {"pull": 0, "fused": 0},
             f"checkpoint: plans built after the load: {builds}")
    s.expect(st["disk_hits"] == 1 and st["misses"] == 0,
             f"checkpoint: the fused plan was not read from the cache: {st}")
    s.log(f"checkpoint 10M: save {save_s:.2f} s (files {sizes} bytes), "
          f"the fused plan into the plan cache {store_s:.2f} s "
          f"(fingerprint {fp_s:.2f} s); load {load_s:.2f} s with the pull "
          f"plans attached, the fused plan read from the cache in "
          f"{read_s:.2f} s ({st}); plans built after the load {builds} "
          f"(phase 4's 'plans:' line gives the build times this avoided); "
          f"every array equal; fused and staged BFS over the reloaded "
          f"snapshot {serve_s:.2f} s, equal to phase 4's host truth at "
          f"lanes {list(PERSIST_LANES)}, launches {n}")
    return loaded, path, fp


def persist_plan_cache(s: Smoke, loaded, fp: str) -> None:
    """19 (b): a second ``plans_for`` and ``fused_plans_for`` over a fresh
    copy of the reloaded arrays through a fresh cache keyed by its
    fingerprint (disk hits, no build, equal plans); and the pull plans
    through ``HG_PLAN_CACHE`` the same way."""
    import os

    from hypergraphdb_tpu_torch.ops import aot_cache, ellbfs, fused_bfs

    root = str(PERSIST_DIR / "aot")
    c1 = aot_cache.AOTCache(root, content_key=fp, device=s.dev)
    t0 = time.perf_counter()
    ellbfs.plans_for(loaded, aot=c1)          # the sidecar's, handed over
    store_s = time.perf_counter() - t0
    copy = fresh_copy(loaded)
    c2 = aot_cache.AOTCache(root, content_key=fp, device=s.dev)
    t0 = time.perf_counter()
    got_pull = ellbfs.plans_for(copy, aot=c2)
    got_fused = fused_bfs.fused_plans_for(copy, aot=c2)
    read_s = time.perf_counter() - t0
    st = c2.stats.as_dict()
    s.expect(st["disk_hits"] == 2 and st["misses"] == 0,
             f"plan cache: the fresh copy did not hit the disk: {st}")
    s.expect(plans_equal(got_pull, loaded._pull_plans)
             and plans_equal(got_fused, loaded._fused_plan),
             "plan cache: plans read from disk differ from the originals")
    entries = {f.split("__")[0]: os.path.getsize(os.path.join(c2.dir, f))
               for f in os.listdir(c2.dir)}

    env = os.environ.get(ellbfs.PLAN_CACHE_ENV)
    os.environ[ellbfs.PLAN_CACHE_ENV] = str(PERSIST_DIR / "plancache")
    real = ellbfs.build_pull_plans
    builds = []
    try:
        t0 = time.perf_counter()
        ellbfs.plans_for(fresh_copy(loaded))     # builds and stores
        build_s = time.perf_counter() - t0
        ellbfs.build_pull_plans = lambda *a, **k: builds.append(1)
        t0 = time.perf_counter()
        side = ellbfs.plans_for(fresh_copy(loaded))
        side_s = time.perf_counter() - t0
    finally:
        ellbfs.build_pull_plans = real
        if env is None:
            del os.environ[ellbfs.PLAN_CACHE_ENV]
        else:
            os.environ[ellbfs.PLAN_CACHE_ENV] = env
    s.expect(not builds and plans_equal(side, loaded._pull_plans),
             "plan cache: HG_PLAN_CACHE rebuilt or differs")
    s.log(f"plan cache 10M: the pull plans stored in {store_s:.2f} s; both "
          f"plans read back over a fresh copy in {read_s:.2f} s, stats "
          f"{st}, entries {entries} bytes; HG_PLAN_CACHE: built and stored "
          f"in {build_s:.2f} s, read in {side_s:.2f} s with no build; all "
          f"equal")


def persist_crash(s: Smoke, snap, path: str, truth: dict) -> None:
    """19 (c): ``ckpt.save_plans`` armed as a crash during a second save:
    the checkpoint on disk still loads (plans attached) and serves."""
    import os

    from hypergraphdb_tpu_torch.fault import InjectedCrash, global_faults
    from hypergraphdb_tpu_torch.ops import checkpoint

    f = global_faults()
    f.reset()
    f.enable(seed=0)
    f.arm("ckpt.save_plans", at={1}, error=InjectedCrash)
    crashed = False
    t0 = time.perf_counter()
    try:
        checkpoint.save_snapshot(snap, path, with_plans=True)
    except InjectedCrash:
        crashed = True
    finally:
        f.reset()
        f.disable()
    crash_s = time.perf_counter() - t0
    plans_tmp = checkpoint._plans_path(path) + ".tmp"
    s.expect(crashed and os.path.exists(plans_tmp),
             "crash: the armed save did not die between write and publish")
    back = checkpoint.load_snapshot(path)
    bad = snapshot_equal(back, snap)
    s.expect(not bad and getattr(back, "_pull_plans", None) is not None,
             f"crash: the checkpoint after the crash: fields {bad}, plans "
             f"{getattr(back, '_pull_plans', None) is not None}")
    n = served_lanes(s, back, truth, "crash")
    s.log(f"crash safety: ckpt.save_plans fired {crash_s:.2f} s into a "
          f"second save (its tmp left behind, as a kill would); the "
          f"checkpoint loads with its plans and serves phase 4's truth, "
          f"launches {n}")


def cold_start(s: Smoke) -> None:
    """19 (d): bench c6's cold-start probe at its defaults, in two fresh
    processes that import only the port: the plan cache empty, then full.
    The warm run must read every plan (no miss, a disk hit) and both
    answers must equal a host BFS over the same graph."""
    import shutil

    import numpy as np

    from hypergraphdb_tpu_torch.core.graph import HyperGraph

    cache = PERSIST_DIR / "coldstart"
    shutil.rmtree(cache, ignore_errors=True)
    code = COLD_CHILD.format(root=str(ROOT), n=COLD_ENTITIES,
                             cache=str(cache))

    def run_once(what: str) -> dict:
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True, cwd=str(ROOT),
                              timeout=COLD_TIMEOUT_S)
        for line in proc.stdout.splitlines():
            if line.startswith("COLD_RESULT "):
                return json.loads(line[len("COLD_RESULT "):])
        raise AssertionError(f"cold start ({what}) failed, rc "
                             f"{proc.returncode}:\n{proc.stderr[-3000:]}")

    absent = run_once("cache empty")
    present = run_once("cache full")
    # the same graph here, for the host truth
    g = HyperGraph()
    r = np.random.default_rng(3)
    e0 = int(g.bulk_import(values=np.arange(COLD_ENTITIES).tolist())[0])
    subj = r.integers(0, COLD_ENTITIES, size=COLD_ENTITIES)
    obj = r.integers(0, COLD_ENTITIES, size=COLD_ENTITIES)
    g.bulk_import(values=[int(x) for x in range(COLD_ENTITIES)],
                  target_lists=[[e0 + int(a), e0 + int(b)]
                                for a, b in zip(subj, obj)])
    want = graph_bfs(g, e0, 2)
    g.close()
    for what, res in (("empty", absent), ("full", present)):
        s.expect(res["seed"] == e0 and res["count"] == len(want)
                 and res["matches"] == want[:16],
                 f"cold start ({what}): count {res['count']}, matches "
                 f"{res['matches'][:8]}; the host {len(want)}, {want[:8]}")
    warm = present["aot"]
    s.expect(warm["misses"] == 0 and warm["disk_hits"] >= 1,
             f"cold start: the warm run missed the cache: {warm}")
    s.expect(present["prewarm"]["built"] == 0,
             f"cold start: the warm run built plans: {present['prewarm']}")
    s.log(f"cold start (bench c6's probe, {COLD_ENTITIES} entities): "
          f"first_result_s {absent['first_result_s']:.3f} with the cache "
          f"empty (aot {absent['aot']}, prewarm {absent['prewarm']}, "
          f"kernel build {absent['build_s']:.3f} s), "
          f"{present['first_result_s']:.3f} with it full (aot {warm}, "
          f"prewarm {present['prewarm']}, kernel build "
          f"{present['build_s']:.3f} s); both answers equal the host BFS "
          f"({len(want)} atoms, served by {absent['served_by']} / "
          f"{present['served_by']})")


def phase_persist(s: Smoke, snap, truth: dict) -> None:
    """Phase 19: cold start and persistence: the 10M checkpoint, the plan
    caches, a crash during a save, bench c6's cold-start probe."""
    import shutil

    t0 = time.perf_counter()
    shutil.rmtree(PERSIST_DIR, ignore_errors=True)
    PERSIST_DIR.mkdir(parents=True)
    try:
        loaded, path, fp = persist_checkpoint(s, snap, truth)
        persist_plan_cache(s, loaded, fp)
        del loaded
        persist_crash(s, snap, path, truth)
        cold_start(s)
    finally:
        shutil.rmtree(PERSIST_DIR, ignore_errors=True)
    s.torch.cuda.empty_cache()
    s.log(f"persist: phase 19 in {time.perf_counter() - t0:.1f} s")


#: bench.py c5's configuration (``bench_c5``, BASELINE config 5): entities
#: and links built through ``bulk_import`` in chunks, the stream's batches,
#: the reader's seeds and hops, ``default_rng(C5_SEED)`` for all of it
C5_ENTITIES, C5_LINKS, C5_LOAD_CHUNK = 200_000, 400_000, 100_000
C5_BATCHES, C5_BATCH_LINKS = 40, 10_000
C5_K, C5_HOPS, C5_SEED = 256, 2, 11
#: c5's ``enable_incremental`` arguments
C5_MANAGER = dict(headroom=1.8, background=True, delta_bucket_min=1 << 18,
                  compact_ratio=0.1, pack_pad_multiple=1 << 19)
#: the compactions that must land inside the timed window (c5's reason
#: for compact_ratio 0.1)
C5_MIN_LIVE_COMPACTIONS = 2
#: bounds of the phase's waits, seconds: the timed window (the reader stops
#: reading), the writer's join after it, the final wait_compacted
C5_WINDOW_LIMIT_S, C5_JOIN_S, C5_COMPACT_WAIT_S = 600.0, 60.0, 300.0
#: batches after a swap whose whole bitmap is held against a host BFS over
#: their pinned view; lanes of the final view checked against a host BFS
#: over the graph's own incidence sets
C5_SWAP_CHECKS, C5_HOST_SEEDS = 2, 8
#: the final view's range batch: C5_RANGE_LANES lanes, the first half over
#: the stream's values (each held by about 42 atoms, in base and delta),
#: windows [lo, lo + C9_WINDOW]; the rest over base-only link values (one
#: atom each), windows [lo, lo + C5_NARROW] that fit the gather pad;
#: ascending ranges and top-k (limit C9_LIMIT) alternate;
#: default_rng(C5_RANGE_SEED)
C5_RANGE_LANES, C5_RANGE_SEED, C5_NARROW = 256, 31, 8


def c5_links(r, e0: int, m: int):
    """One of c5's link batches: ``m`` random entity pairs as target
    lists."""
    subj = r.integers(0, C5_ENTITIES, size=m)
    obj = r.integers(0, C5_ENTITIES, size=m)
    return [[e0 + int(a), e0 + int(b)] for a, b in zip(subj, obj)]


def graph_bfs(g, seed: int, max_hops: int):
    """Sorted ids one seed reaches within ``max_hops`` through the graph's
    own incidence sets and target tuples (not a pack)."""
    visited, frontier = {seed}, [seed]
    for _ in range(max_hops):
        nxt = set()
        for a in frontier:
            for link in g.get_incidence_set(a).array().tolist():
                nxt.update(g.get_targets(link))
        frontier = [x for x in nxt if x not in visited]
        visited.update(frontier)
    return sorted(visited)


def view_bitmap(s: Smoke, view, seeds, max_hops: int):
    """The (K, N+1) bool bitmap a host BFS over a pinned view (its base
    plus its host delta, dead links and atoms dropped) gives, on the
    card."""
    import numpy as np

    torch = s.torch
    n1 = view.base.num_atoms + 1
    dead = np.zeros(n1, dtype=bool)
    dead[view.host_delta["dead"]] = True
    dcsr = delta_csr(view.host_delta, n1)
    lanes, ids = [], []
    for k, seed in enumerate(seeds.tolist()):
        reach = host_bfs_delta(view.base, dcsr, dead, int(seed), max_hops)
        lanes.append(np.full(len(reach), k))
        ids.append(reach)
    want = torch.zeros((len(seeds), n1), dtype=torch.bool, device=s.dev)
    want[torch.from_numpy(np.concatenate(lanes)).to(s.dev),
         torch.from_numpy(np.concatenate(ids)).to(s.dev)] = True
    return want


def lane_words(torch, visited):
    """A (K, R) bool bitmap as the fused path's (R, K/32) int32 words (bit
    b of word w is lane 32·w + b)."""
    K, R = visited.shape
    words = torch.zeros((R, K // 32), dtype=torch.int32,
                        device=visited.device)
    for b in range(32):
        words |= visited[b::32].T.to(torch.int32) << b
    return words


def int_value_oracle(g):
    """The graph's int values from its by-value index: ``(ranks uint64,
    gids int64)`` sorted by rank, then gid."""
    import numpy as np

    from hypergraphdb_tpu_torch.core.graph import IDX_BY_VALUE
    from hypergraphdb_tpu_torch.utils.ordered_bytes import rank64

    ranks, gids = [], []
    for key, hs in g.backend.get_index(IDX_BY_VALUE).bulk_items(lo=b"i"):
        if key[:1] != b"i":
            break
        ranks.append(np.full(len(hs), rank64(key[1:]), dtype=np.uint64))
        gids.append(hs)
    ranks, gids = np.concatenate(ranks), np.concatenate(gids)
    order = np.lexsort((gids, ranks))
    return ranks[order], gids[order]


def phase_ingest(s: Smoke) -> dict:
    """bench.py c5 on the port's graph layer: the build through
    ``bulk_import``, the snapshot manager with c5's arguments, a writer
    thread streaming c5's batches while the reader runs c5's dense batches
    on ``mgr.device(max_lag_edges)``, then the final view's checks."""
    import threading

    import numpy as np

    from hypergraphdb_tpu_torch.core.graph import HyperGraph
    from hypergraphdb_tpu_torch.ops import fused_bfs, linemask
    from hypergraphdb_tpu_torch.ops.incremental import bfs_levels_delta
    from hypergraphdb_tpu_torch.ops.serving import bfs_serve_batch, serve_bfs
    from hypergraphdb_tpu_torch.ops.value_index import (
        lane_bounds,
        serve_range_batch,
    )
    from hypergraphdb_tpu_torch.storage.value_index import value_index_column

    torch = s.torch
    t_phase = time.perf_counter()
    g = HyperGraph()
    r = np.random.default_rng(C5_SEED)
    t0 = time.perf_counter()
    e0 = int(g.bulk_import(values=np.arange(C5_ENTITIES).tolist())[0])
    for st in range(0, C5_LINKS, C5_LOAD_CHUNK):
        m = min(C5_LOAD_CHUNK, C5_LINKS - st)
        g.bulk_import(values=list(range(st, st + m)),
                      target_lists=c5_links(r, e0, m))
    build_s = time.perf_counter() - t0
    base_atoms = C5_ENTITIES + C5_LINKS
    t0 = time.perf_counter()
    mgr = g.enable_incremental(device=s.dev, **C5_MANAGER)
    enable_s = time.perf_counter() - t0
    at_start = mgr.compactions
    s.log(f"ingest: c5 graph of {base_atoms} atoms ({g.handles.peek} ids) "
          f"through bulk_import in {build_s:.2f} s "
          f"({base_atoms / build_s:.0f} atoms/s); first pack and upload "
          f"{enable_s:.2f} s: {mgr.base.num_atoms} ids, "
          f"{mgr.base.n_edges_inc} incidence entries")

    ingested = {"atoms": 0, "s": 0.0, "errors": []}
    done = threading.Event()

    def writer():
        try:
            t_w = time.perf_counter()
            for _ in range(C5_BATCHES):
                g.bulk_import(values=list(range(C5_BATCH_LINKS)),
                              target_lists=c5_links(r, e0, C5_BATCH_LINKS))
                ingested["atoms"] += C5_BATCH_LINKS
            ingested["s"] = time.perf_counter() - t_w
        except Exception as e:  # noqa: BLE001 - failed below
            ingested["errors"].append(repr(e))
        finally:
            done.set()

    seeds = (e0 + r.integers(0, C5_ENTITIES, size=C5_K)).astype(np.int32)

    def idle_batch():
        dev, delta = mgr.device()
        _, vis = bfs_levels_delta(dev, delta,
                                  torch.from_numpy(seeds).to(s.dev), C5_HOPS,
                                  with_levels=False)
        return bool(vis[0, 0])

    idle_batch()  # warm-up, before the clock
    idle_ms = served_ms(s, idle_batch, runs=3)  # no writer, no compaction

    staleness, latencies, epochs, swap_checks = [], [], [], []
    fresh = {"probes": 0, "hits": 0, "missed": []}
    wt = threading.Thread(target=writer, name="c5-writer", daemon=True)
    t0 = time.perf_counter()
    wt.start()
    last_epoch = mgr.compactions
    trace = []  # per batch: seconds into the window, epoch, compacting
    while not done.is_set() and time.perf_counter() - t0 < C5_WINDOW_LIMIT_S:
        staleness.append(mgr.delta_edges)
        tq = time.perf_counter()
        trace.append((round(tq - t0, 3), mgr.compactions, mgr._compacting,
                      staleness[-1], ingested["atoms"]))
        view = None
        if mgr.compactions != last_epoch and len(swap_checks) < C5_SWAP_CHECKS:
            view = mgr.pinned_view(max_lag_edges=0, host_delta=True)
            dev, delta = view.device, view.delta
        else:
            dev, delta = mgr.device(max_lag_edges=C5_BATCH_LINKS)
        last_epoch = mgr.compactions if view is None else view.epoch
        # c5's freshness probe: one end of a link added after the base
        # pack, whose edges the device delta holds, seeds lane 0; the
        # other end must come back visited
        probe = None
        for h in mgr.device_visible_new_atoms():
            rec = g.store.get_link(h)
            if rec is not None and len(rec) >= 5:
                a, b = int(rec[3]), int(rec[4])
                if a != b and a < dev.num_atoms and b < dev.num_atoms:
                    seeds[0], probe = a, b
                    break
        batch = seeds.copy()
        _, visited = bfs_levels_delta(dev, delta,
                                      torch.from_numpy(batch).to(s.dev),
                                      C5_HOPS, with_levels=False)
        hit = bool(visited[0, probe or 0])  # one scalar back per batch
        latencies.append(time.perf_counter() - tq)
        epochs.append(mgr.compactions)
        if probe is not None:
            fresh["probes"] += 1
            fresh["hits"] += hit
            if not hit:
                fresh["missed"].append((int(batch[0]), probe))
        if view is not None:
            # held (the view's tensors with it) and checked after the
            # window: a host BFS here would stall the reader
            swap_checks.append((len(latencies) - 1, view, batch, visited))
        del view, dev, delta, visited
    window_s = time.perf_counter() - t0
    live = mgr.compactions - at_start
    wt.join(timeout=C5_JOIN_S)
    for i, (b, view, batch, visited) in enumerate(swap_checks):
        want = view_bitmap(s, view, batch, C5_HOPS)
        swap_checks[i] = {
            "batch": b, "epoch": view.epoch,
            "delta_edges": int(len(view.host_delta["inc_links"])),
            "equal": bool(torch.equal(visited, want)),
            "reached": int(want.sum())}
        del view, visited, want
    ingest_s = ingested["s"] or window_s  # a writer that never finished
    lat_ms = np.asarray(latencies) * 1e3
    swaps = [i for i in range(1, len(epochs)) if epochs[i] != epochs[i - 1]]
    stats = mgr.compaction_stats[1:]
    rec = {
        "base_atoms": base_atoms, "build_s": build_s,
        "build_atoms_per_s": base_atoms / build_s, "enable_s": enable_s,
        "ingest_atoms": ingested["atoms"], "ingest_s": ingest_s,
        "ingest_atoms_per_s": ingested["atoms"] / ingest_s,
        "idle_batch_ms": idle_ms,
        "window_s": window_s, "query_batches": len(latencies),
        "query_batches_per_s": len(latencies) / window_s,
        "latency_ms_p50": float(np.percentile(lat_ms, 50)),
        "latency_ms_p95": float(np.percentile(lat_ms, 95)),
        "latency_ms_max": float(lat_ms.max()),
        "swap_crossings": len(swaps),
        "latency_ms_over_swap_max": (float(max(lat_ms[i] for i in swaps))
                                     if swaps else None),
        "staleness_mean": float(np.mean(staleness)),
        "staleness_max": int(np.max(staleness)),
        "fresh_probes": fresh["probes"], "fresh_hits": fresh["hits"],
        "compactions": mgr.compactions, "live_compactions": live,
        "compaction_stats": stats,
        "full_uploads": mgr.full_uploads, "tail_uploads": mgr.tail_uploads,
        "swap_checks": swap_checks, "trace": trace,
    }
    s.log(f"ingest: {rec['ingest_atoms']} atoms streamed in "
          f"{rec['ingest_s']:.2f} s ({rec['ingest_atoms_per_s']:.0f} "
          f"atoms/s) beside {rec['query_batches']} dense batches of "
          f"{C5_K} seeds, {C5_HOPS} hops ({rec['query_batches_per_s']:.3f} "
          f"batches/s; a batch alone {spread(idle_ms)}); latency p50 {rec['latency_ms_p50']:.2f} ms, p95 "
          f"{rec['latency_ms_p95']:.2f} ms, max {rec['latency_ms_max']:.2f} "
          f"ms, over a swap max {rec['latency_ms_over_swap_max']} ms "
          f"({len(swaps)} crossings); staleness mean "
          f"{rec['staleness_mean']:.0f}, max {rec['staleness_max']} delta "
          f"entries; freshness {fresh['hits']}/{fresh['probes']}; "
          f"compactions {mgr.compactions} ({live} in the window), extract "
          f"s {[round(c['extract_s'], 3) for c in stats]}, assemble+swap s "
          f"{[round(c['assemble_swap_s'], 3) for c in stats]}; memtable "
          f"uploads {mgr.full_uploads} full, {mgr.tail_uploads} tail; "
          f"swap checks {swap_checks}; per batch (s, epoch, compacting, "
          f"delta entries, atoms streamed) {trace}")

    s.expect(not wt.is_alive(),
             f"ingest: deadlock, the writer was not joined within "
             f"{C5_WINDOW_LIMIT_S + C5_JOIN_S:.0f} s of the window's start")
    s.expect(not ingested["errors"], f"ingest: writer failed: "
             f"{ingested['errors']}")
    s.expect(fresh["probes"] > 0 and not fresh["missed"],
             f"ingest: freshness probes {fresh['hits']}/{fresh['probes']}, "
             f"missed (seed, target) {fresh['missed'][:5]}")
    s.expect(live >= C5_MIN_LIVE_COMPACTIONS,
             f"ingest: {live} compactions in the timed window, want "
             f"{C5_MIN_LIVE_COMPACTIONS}")
    s.expect(len(swap_checks) > 0 and all(c["equal"] for c in swap_checks),
             f"ingest: swap-straddling batches against host BFS: "
             f"{swap_checks}")

    # -- the final view: one more c5 batch in its memtable, so the fused
    # route's overlay has rows
    s.expect(mgr.wait_compacted(timeout=C5_COMPACT_WAIT_S),
             f"ingest: compaction still running after {C5_COMPACT_WAIT_S} s")
    g.bulk_import(values=list(range(C5_BATCH_LINKS)),
                  target_lists=c5_links(r, e0, C5_BATCH_LINKS))
    view = mgr.pinned_view()
    N = view.base.num_atoms
    seeds_t = torch.from_numpy(seeds).to(s.dev)
    _, dense = bfs_levels_delta(view.device, view.delta, seeds_t, C5_HOPS,
                                with_levels=False)
    for k in range(C5_HOST_SEEDS):
        got = torch.nonzero(dense[k]).flatten().cpu().numpy()
        s.expect(got.tolist() == graph_bfs(g, int(seeds[k]), C5_HOPS),
                 f"ingest: final view's dense lane {k} != host BFS over the "
                 f"graph's incidence sets")
    fk = fused_bfs.serve_fused_kwargs(view.base, view.delta, C5_K, s.dev)
    s.expect(not isinstance(fk, str), f"ingest: fused path declined: {fk}")
    s.expect(fk["overlay"] is not None, "ingest: the final delta is empty")
    ova = fk["overlay"].arrays
    levels = sum(idx.shape[0] // w > 0 for lv, wd in (
        (ova.levels1, fk["overlay"].widths1),
        (ova.levels2, fk["overlay"].widths2)) for idx, w in zip(lv, wd))
    # the served batch alone is counted: its route and its launches
    reset_launches()
    serve_bfs.routes.update(fused=0, dense=0)
    counts, first_r = serve_bfs(view.base, seeds, C5_HOPS, SERVE_TOP_R,
                                delta=view.delta, device=s.dev)
    n_launch, routes = launches(), dict(serve_bfs.routes)
    want_launch = {"gather_or": C5_HOPS * levels, "fused_hop": C5_HOPS,
                   "membership": 0}
    s.expect(routes == {"fused": 1, "dense": 0},
             f"ingest: the final view's batch took routes {routes}")
    s.expect(n_launch == want_launch,
             f"ingest: the final view's batch launched {n_launch}, want "
             f"{want_launch} ({C5_HOPS} hops, {levels} overlay levels)")
    dc, df = bfs_serve_batch(view.device, view.delta, seeds_t, C5_HOPS,
                             SERVE_TOP_R)
    s.expect(np.array_equal(counts, dc.cpu().numpy())
             and np.array_equal(first_r, df.cpu().numpy())
             and np.array_equal(counts, dense.sum(1).cpu().numpy()),
             "ingest: served fused route != served dense route")
    # outside the counted batch: the fused bitmap itself, under a mask audit
    kept = {}

    def hook(h, visited, mask):
        s.expect(torch.equal(mask, linemask.line_mask(visited)),
                 f"ingest: fused mask entering hop {h} != line_mask")
        if h == 1:
            kept["hop1"] = (visited.clone(), mask.clone())

    fused, _, _ = fused_bfs.bfs_fused(fk["plan"], seeds_t, fk["geom"],
                                      C5_HOPS, False, True, hop_hook=hook,
                                      overlay=fk["overlay"])
    words = lane_words(torch, dense)
    s.expect(torch.equal(fused[: N + 1], words)
             and not bool(fused[N + 1:].any()),
             "ingest: fused route (K2 + K1 overlay) != dense route")
    ov = overlay_check(s, *kept["hop1"], fk["overlay"])
    old, om = kept["hop1"]
    out = torch.zeros_like(old)
    omask = linemask.full_mask(*old.shape, s.dev)
    got2 = fused_bfs.fused_hop(old, fk["plan"], out=out, mask=om,
                               out_mask=omask)
    s.expect(torch.equal(got2, fused_bfs.fused_hop_plain(old, fk["plan"]))
             and torch.equal(omask, linemask.line_mask(got2)),
             "ingest: K2 at the final view's hop 1 != plain")
    s.log(f"ingest: final view (epoch {view.epoch}, {N} ids, "
          f"{view.delta.inc_links.shape[0]}-entry delta bucket, "
          f"{len(view.new_atoms)} new atoms): dense == host BFS over the "
          f"graph's incidence sets at lanes 0..{C5_HOST_SEEDS - 1}; fused "
          f"(K2 + K1 overlay) == dense on all {C5_K} lanes bit for bit; "
          f"served fused (routes {routes}, launches {n_launch}) == served "
          f"dense; overlay K1 "
          f"bit-exact with plain over {ov['levels']} levels "
          f"({ov['k1_ms']:.4f} ms a hop); K2 at hop 1 == plain")

    # the value plane over the final view: base column + value delta
    t0 = time.perf_counter()
    col_d = mgr.value_delta(view, ord("i"))
    delta_col_s = time.perf_counter() - t0
    col_b = value_index_column(view.base, ord("i"), s.dev)
    s.expect(col_d.covered == len(view.new_atoms)
             and col_d.n == len(view.new_atoms) and col_d.device_exact,
             f"ingest: value delta covers {col_d.covered} of "
             f"{len(view.new_atoms)} new atoms, {col_d.n} entries")
    rr = np.random.default_rng(C5_RANGE_SEED)
    half = C5_RANGE_LANES // 2
    los = np.concatenate([
        rr.integers(0, C5_BATCH_LINKS - C9_WINDOW, size=half),
        rr.integers(C5_ENTITIES, C5_LINKS - C9_WINDOW, size=half)])
    width = np.repeat([C9_WINDOW, C5_NARROW], half).astype(np.uint64)
    topk = np.arange(C5_RANGE_LANES) % 2 == 1
    # an int's rank is its payload, the value with the sign bit flipped
    lo_r = los.astype(np.uint64) + np.uint64(1 << 63)
    bounds = lane_bounds(C5_RANGE_LANES, lo_r,
                         np.zeros(C5_RANGE_LANES, bool), lo_r + width,
                         np.ones(C5_RANGE_LANES, bool),
                         desc=np.zeros(C5_RANGE_LANES, bool))
    counts, first_r, covered, total = (
        t.cpu().numpy() for t in serve_range_batch(
            view.base, col_b, col_d, bounds, top_r=C9_TOP_R, device=s.dev))
    h_rank, h_gid = int_value_oracle(g)
    n_covered = 0
    for q in range(C5_RANGE_LANES):
        upto = min(C9_LIMIT, C9_TOP_R) if topk[q] else C9_TOP_R
        n, head = range_oracle(h_rank, h_gid, int(lo_r[q]),
                               int(lo_r[q] + width[q]), False, upto,
                               C9_TOP_R)
        s.expect(int(total[q]) == n and list(first_r[q][:upto])
                 == list(first_r_row(head, upto)),
                 f"ingest: range lane {q} (values {los[q]}..) != oracle")
        if n <= C9_TOP_R:
            n_covered += 1
            s.expect(bool(covered[q]) and int(counts[q]) == n,
                     f"ingest: range lane {q} not covered or miscounted")
    s.expect(n_covered == C5_RANGE_LANES - half,
             f"ingest: {n_covered} covered range lanes, want "
             f"{C5_RANGE_LANES - half}")
    s.log(f"ingest: value delta of kind 'i' over {col_d.n} new atoms in "
          f"{delta_col_s:.3f} s; {C5_RANGE_LANES}-lane range batch over "
          f"base ({col_b.n} entries) + delta == numpy oracle over the "
          f"graph's int values ({n_covered} covered lanes, "
          f"{int(total[:half].sum())} entries in the stream-value windows)")
    rec.update(final_epoch=view.epoch, final_ids=N,
               final_new_atoms=len(view.new_atoms), launches=n_launch,
               overlay_k1_ms=ov["k1_ms"], value_delta_s=delta_col_s,
               value_delta_entries=col_d.n, range_covered_lanes=n_covered)
    del view, dense, fused, words, kept, fk, col_b, col_d
    g.close()
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    s.log(f"ingest phase: {rec['phase_s']:.1f} s in all; record "
          + json.dumps(rec))
    return rec


#: phase 15: bench.py c3's query shape through the front door, on the
#: reference's ``dbpedia_like`` at 4x its default scale (2.4M atoms;
#: BASELINE config 3's shape), ``default_rng(Q_SEED)``
Q_ENTITIES, Q_TRIPLES, Q_PROPERTIES, Q_SEED = 400_000, 2_000_000, 64, 13
#: build seconds past which the next run halves Q_TRIPLES (logged)
Q_BUILD_LIMIT_S = 120.0
#: the hub value window of (d) and (e): link values (property ids) in
#: [lo, hi), c3's value leg
Q_WINDOW = (16, 48)
#: host-to-host runs of each hub query, at the default and on the host
Q_REPS = 5
#: (e): links added on h1 and h2 (values cycling through the properties),
#: h1 links removed, default_rng(Q_EDIT_SEED)
Q_NEW_LINKS, Q_DEAD_LINKS, Q_EDIT_SEED = 2_000, 50, 5
#: (f): ``wordnet_like`` at its defaults (BASELINE config 1's shape), the
#: traversal seeds (64 synsets from default_rng(WN_SEED)), the seeds also
#: queried through find_all, and the seeds of the unbounded DFS vs BFS
WN_SEEDS, WN_SEED, WN_FIND_SEEDS, WN_DFS_SEEDS = 64, 17, 16, 4
#: the calibration sweeps (tools/calibrate_duality.py's, on the port)
CAL_SIZES = (64, 256, 1_024, 4_096, 16_384, 65_536, 262_144)
CAL_HUBS = (1_024, 8_192, 65_536, 262_144)
CAL_ID_SPACE = 10_000_000


def _host_ms(s: Smoke, fn, reps: int = 5) -> float:
    """Mean host-to-host milliseconds of ``fn`` over ``reps`` runs after
    one warm run (``tools/calibrate_duality._time``)."""
    fn()
    s.torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    s.torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _first_win(rows: dict):
    """The first size whose device time beats its host time, or None."""
    return next((n for n in sorted(rows)
                 if rows[n]["device_ms"] < rows[n]["host_ms"]), None)


def query_calibration(s: Smoke) -> dict:
    """``tools/calibrate_duality.py``'s two ``device_min_batch`` sweeps on
    the port: a 2-way intersection (an 8x larger partner) through
    ``device_intersect_sorted`` (K3) against the host's
    ``intersect_sorted``, and one ad-hoc ``And(incident(hub), value >
    500)`` through ``DeviceValueConjPlan`` on the device against its host
    plan, by hub size."""
    import numpy as np

    from hypergraphdb_tpu_torch.core.config import (
        HGConfiguration,
        QueryConfig,
    )
    from hypergraphdb_tpu_torch.core.graph import HyperGraph
    from hypergraphdb_tpu_torch.ops.setops import device_intersect_sorted
    from hypergraphdb_tpu_torch.query import compiler as qc
    from hypergraphdb_tpu_torch.query import dsl as q

    rng = np.random.default_rng(11)

    def sample(n):
        return np.unique(rng.integers(0, CAL_ID_SPACE, size=int(n * 1.1))
                         )[:n].astype(np.int64)

    inter = {}
    for n in CAL_SIZES:
        a, b = sample(n), sample(min(n * 8, 8_000_000))
        want = np.intersect1d(a, b)
        s.expect(np.array_equal(
            device_intersect_sorted([a, b], device=s.dev), want),
            f"calibration: device intersection at {n} != np.intersect1d")
        inter[n] = {
            "host_ms": _host_ms(s, lambda: qc.intersect_sorted(None, a, b)),
            "device_ms": _host_ms(
                s, lambda: device_intersect_sorted([a, b], device=s.dev))}
    cross_i = _first_win(inter)

    g = HyperGraph(HGConfiguration(query=QueryConfig(device=str(s.dev))))
    rng = np.random.default_rng(3)
    spokes = list(g.add_nodes_bulk([f"s{i}" for i in range(1024)]))
    hubs = {}
    for n in CAL_HUBS:
        hub = g.add(f"hub{n}")
        g.bulk_import(
            values=[int(x) for x in rng.integers(0, 1000, size=n)],
            target_lists=[[int(hub), int(spokes[i % 1024])]
                          for i in range(n)])
        hubs[n] = hub
    g.snapshot()  # the resident base
    value = {}
    for n, hub in hubs.items():
        cq = qc.compile_query(g, q.and_(q.incident(hub), q.value(500, "gt")))
        s.expect(isinstance(cq.plan, qc.DeviceValueConjPlan),
                 f"calibration: {cq.plan.describe()} is no value pushdown")
        g.config.query.device_min_batch = 0          # the device
        on_dev = cq.plan.run(g)
        dev_ms = _host_ms(s, lambda: cq.plan.run(g), reps=3)
        g.config.query.device_min_batch = 1 << 60    # the host plan
        s.expect(np.array_equal(on_dev, cq.plan.run(g)),
                 f"calibration: value pushdown at {n} != its host plan")
        value[n] = {"host_ms": _host_ms(s, lambda: cq.plan.run(g), reps=3),
                    "device_ms": dev_ms}
    g.close()
    cross_v = _first_win(value)
    default = QueryConfig().device_min_batch
    # where the device never wins a sweep, the default stays 262,144
    measured = (262_144 if cross_i is None or cross_v is None
                else max(cross_i, cross_v))
    for what, rows in (("intersection", inter), ("value conjunction",
                                                 value)):
        s.log(f"calibration, {what}: " + "; ".join(
            f"{n}: host {r['host_ms']:.4f} ms, device {r['device_ms']:.4f} "
            f"ms" for n, r in rows.items()))
    s.log(f"calibration: crossovers intersection {cross_i}, value "
          f"conjunction {cross_v}: device_min_batch {measured} by this run, "
          + ("equal to" if measured == default else "not equal to")
          + f" the port's default {default}")
    return {"intersection": inter, "value_conj": value,
            "crossover_intersection": cross_i,
            "crossover_value_conj": cross_v, "default": default}


def _device_runs(g, plan, dmb: int) -> int:
    """K3 launches one run of ``plan`` makes at ``device_min_batch``
    ``dmb``: one for an intersection whose smallest child's estimate
    reaches it, none otherwise."""
    from hypergraphdb_tpu_torch.query.compiler import IntersectPlan

    if not isinstance(plan, IntersectPlan) or len(plan.children) < 2:
        return 0
    small = min(p.estimate(g) for p in plan.children)
    return int(g.config.query.prefer_device and small >= dmb)


def _values_of(g, n_properties: int):
    """(ids + 1,) int64 array of each link's int value (-1 elsewhere),
    from the by-value index."""
    import numpy as np

    from hypergraphdb_tpu_torch.core.graph import IDX_BY_VALUE
    from hypergraphdb_tpu_torch.utils.ordered_bytes import encode_int

    out = np.full(g.handles.peek + 1, -1, dtype=np.int64)
    idx = g.backend.get_index(IDX_BY_VALUE)
    for p in range(n_properties):
        out[idx.find(b"i" + encode_int(p)).array()] = p
    return out


def hub_queries(s: Smoke, g, hubs, rows, vals, what: str) -> dict:
    """The hub queries of (d) through ``find_all`` at the graph's
    ``device_min_batch`` and on the host, each against numpy over
    ``rows`` (the hubs' incidence rows) and ``vals``: K3 must launch
    exactly once a device-branch run and never on the host. Returns the
    launches and times."""
    import numpy as np

    from hypergraphdb_tpu_torch.query import dsl as hg
    from hypergraphdb_tpu_torch.query.compiler import (
        DeviceValueConjPlan,
        compile_query,
    )

    h1, h2, h3 = hubs
    lo, hi = Q_WINDOW

    def fold(*rs):
        out = rs[0]
        for r in rs[1:]:
            out = np.intersect1d(out, r)
        return out.astype(np.int64)

    r1, r2, r3 = rows
    v1 = vals[r1]
    cases = {
        "h1&h2": (hg.and_(hg.incident(h1), hg.incident(h2)), fold(r1, r2)),
        "h1&h2&h3": (hg.and_(hg.incident(h1), hg.incident(h2),
                             hg.incident(h3)), fold(r1, r2, r3)),
        # an atom with an int value is an int atom
        "int&h1&h2": (hg.and_(hg.type_("int"), hg.incident(h1),
                              hg.incident(h2)),
                      fold(r1, r2)[vals[fold(r1, r2)] >= 0]),
        "h1&window": (hg.and_(hg.incident(h1), hg.gte(lo), hg.lt(hi)),
                      r1[(v1 >= lo) & (v1 < hi)].astype(np.int64)),
    }
    cfg = g.config.query
    dmb = cfg.device_min_batch
    out = {"launches": 0, "device_runs": 0}
    for name, (cond, want) in cases.items():
        plan = compile_query(g, cond).plan
        dev_runs = _device_runs(g, plan, dmb)
        reset_launches()
        got = np.asarray(g.find_all(cond), dtype=np.int64)
        n = launches()["membership"]
        s.expect(n == dev_runs, f"{what} {name}: K3 launched {n} times, "
                 f"{dev_runs} device-branch runs")
        s.expect(np.array_equal(got, want), f"{what} {name}: find_all != "
                 "numpy")
        out["launches"] += n
        out["device_runs"] += dev_runs
        cfg.device_min_batch = 1 << 60
        try:
            reset_launches()
            host = np.asarray(g.find_all(cond), dtype=np.int64)
            s.expect(launches()["membership"] == 0,
                     f"{what} {name}: K3 launched on the host plan")
            s.expect(np.array_equal(host, got),
                     f"{what} {name}: the host plan != the default plan")
            t_host = served_ms(s, lambda: g.find_all(cond), runs=Q_REPS)
        finally:
            cfg.device_min_batch = dmb
        t_dev = served_ms(s, lambda: g.find_all(cond), runs=Q_REPS)
        est = sorted(round(p.estimate(g)) for p in getattr(
            plan, "children", [plan]))
        lane = ("; the value lane on the device" if isinstance(
            plan, DeviceValueConjPlan) and plan.estimate(g) >= dmb else "")
        s.log(f"{what} {name}: {len(got)} ids == numpy; plan "
              f"{plan.describe()} (estimates {est}{lane}); at "
              f"device_min_batch {dmb}: {dev_runs} device-branch run(s), "
              f"K3 launches {n}, "
              f"host to host median {np.median(t_dev):.3f} ms "
              f"({[round(t, 3) for t in t_dev]}); host plan median "
              f"{np.median(t_host):.3f} ms ({[round(t, 3) for t in t_host]})")
        out[name] = {"ids": len(got), "device_runs": dev_runs,
                     "launches": n, "ms": float(np.median(t_dev)),
                     "host_ms": float(np.median(t_host))}
    return out


def phase_query(s: Smoke, records: dict) -> dict:
    """Phase 15: the query front door (``find_all``) on the port's graph
    layer. (b) the ``device_min_batch`` calibration; (a) a DBpedia-shaped
    graph through ``dbpedia_like`` and its pack; (c) c3's 1024 anchor pairs,
    one ``find_all`` each in two forms, against numpy; (d) the hub queries
    at the port's default and on the host; (e) the same under incremental
    mode after a batch of adds and removes; (f) the traversals on a
    WordNet-shaped graph against the card's BFS."""
    import numpy as np

    from hypergraphdb_tpu_torch.core.config import (
        HGConfiguration,
        QueryConfig,
    )
    from hypergraphdb_tpu_torch.core.graph import HyperGraph
    from hypergraphdb_tpu_torch.models import dbpedia_like
    from hypergraphdb_tpu_torch.query import dsl as hg

    t_phase = time.perf_counter()
    rec = {"calibration": query_calibration(s)}

    # -- (a) the graph ------------------------------------------------------
    g = HyperGraph(HGConfiguration(query=QueryConfig(device=str(s.dev))))
    t0 = time.perf_counter()
    ents, first_link = dbpedia_like(g, n_entities=Q_ENTITIES,
                                    n_triples=Q_TRIPLES,
                                    n_properties=Q_PROPERTIES, seed=Q_SEED)
    build_s = time.perf_counter() - t0
    n_atoms = Q_ENTITIES + Q_TRIPLES
    t0 = time.perf_counter()
    snap = g.snapshot()
    pack_s = time.perf_counter() - t0
    deg = np.diff(snap.inc_offsets[: snap.num_atoms + 1])
    hubs = [int(h) for h in np.argsort(-deg, kind="stable")[:3]]
    rows = [snap.incidence_row(h).astype(np.int64) for h in hubs]
    s.log(f"query graph: dbpedia_like({Q_ENTITIES}, {Q_TRIPLES}, "
          f"{Q_PROPERTIES}, seed {Q_SEED}): {n_atoms} atoms "
          f"({g.handles.peek} ids) in {build_s:.2f} s "
          f"({n_atoms / build_s:.0f} atoms/s"
          + (f"; over the {Q_BUILD_LIMIT_S:.0f} s limit: halve Q_TRIPLES"
             if build_s > Q_BUILD_LIMIT_S else "")
          + f"); pack {pack_s:.2f} s ({snap.n_edges_inc} incidence "
          f"entries); hubs {hubs}: rows {[len(r) for r in rows]}")
    rec.update(build_s=build_s, atoms_per_s=n_atoms / build_s,
               pack_s=pack_s, hubs=hubs, hub_rows=[len(r) for r in rows])
    vals = _values_of(g, Q_PROPERTIES)
    int_t = int(g.typesystem.handle_of("int"))

    # -- (c) c3's anchor pairs, one find_all each ---------------------------
    counts = np.bincount(vals[vals >= 0], minlength=Q_PROPERTIES)
    p = int(np.argmax(counts))
    cands = np.flatnonzero(vals == p)
    r = np.random.default_rng(PATTERN_SEED)
    links = cands[r.integers(0, len(cands), size=PATTERN_PAIRS)]
    starts = snap.tgt_offsets[links].astype(np.int64)
    pairs = np.stack([snap.tgt_flat[starts], snap.tgt_flat[starts + 1]],
                     axis=1).astype(np.int64)
    forms = {
        "typed": lambda a, b: hg.and_(hg.type_("int"), hg.incident(a),
                                      hg.incident(b)),
        "valued": lambda a, b: hg.and_(hg.incident(a), hg.incident(b),
                                       hg.eq(p)),
    }
    for form, make in forms.items():
        conds = [make(int(a), int(b)) for a, b in pairs]
        # the first query builds what later ones reuse (the type column)
        t0 = time.perf_counter()
        g.find_all(conds[0])
        first_s = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        got = [g.find_all(c) for c in conds]
        s.torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k3 = launches()["membership"]
        for (a, b), res in zip(pairs.tolist(), got):
            want = np.intersect1d(snap.incidence_row(a),
                                  snap.incidence_row(b)).astype(np.int64)
            want = want[(snap.type_of[want] == int_t) if form == "typed"
                        else (vals[want] == p)]
            s.expect(np.array_equal(np.asarray(res, dtype=np.int64), want),
                     f"c3 {form} ({a}, {b}): find_all != numpy")
        qps = PATTERN_PAIRS / wall
        s.log(f"c3 through find_all, {form} form: {PATTERN_PAIRS} queries "
              f"== numpy ({sum(map(len, got))} ids; property {p}, "
              f"{len(cands)} links), {qps:.1f} queries/s host to host after "
              f"a first query of {first_s:.3f} s, K3 launches {k3}")
        rec[f"c3_{form}_qps"] = qps
        s.profile_later(f"c3 find_all, {form} form ({PATTERN_PAIRS} queries)",
                        lambda conds=conds: [g.find_all(c) for c in conds],
                        wall * 1e3)

    # -- (d) the hub queries at the port's default ----------------------------
    hub = hub_queries(s, g, hubs, rows, vals, "hub query")
    s.expect(hub["device_runs"] >= 1,
             f"no hub query reached the device branch at the default "
             f"device_min_batch {g.config.query.device_min_batch}")
    rec["hub"] = hub

    # -- (e) incremental mode: adds and removes, the memtable correction ----
    mgr = g.enable_incremental(device=s.dev)
    h1, h2 = hubs[:2]
    r = np.random.default_rng(Q_EDIT_SEED)
    new = g.bulk_import(
        values=[i % Q_PROPERTIES for i in range(Q_NEW_LINKS)],
        target_lists=[[h1, h2] if i % 2 else [h1, int(ents[i])]
                      for i in range(Q_NEW_LINKS)])
    dead = r.choice(rows[0], size=Q_DEAD_LINKS, replace=False)
    for link in dead.tolist():
        g.remove(int(link))
    rows_now = [g.get_incidence_set(h).array() for h in hubs]
    vals = _values_of(g, Q_PROPERTIES)
    s.log(f"incremental: {len(new)} links added on h1 and h2, "
          f"{Q_DEAD_LINKS} h1 links removed; {mgr.delta_edges} delta "
          f"entries, {len(mgr.correction()[0])} dead, compactions "
          f"{mgr.compactions}")
    inc = hub_queries(s, g, hubs, rows_now, vals, "incremental")
    s.expect(mgr.compactions == 1, "a compaction folded the edits into the "
             "base before the queries read them: no memtable correction")
    rec["incremental"] = inc
    n_find_all = hub["launches"] + inc["launches"]

    # -- (f) the traversals against the card's BFS --------------------------
    rec["traversals"] = query_traversals(s)
    for k in records["kernels"]:
        if k["name"] == "membership":
            k["find_all_launches"] = n_find_all
    s.log(f"K3 launches through find_all: {n_find_all} ((d) "
          f"{hub['launches']}, (e) {inc['launches']})")

    def close():
        mgr.close()
        g.close()

    # the c3 profiles queued above run last (phase_profiles): the graph
    # closes after the last of them
    name, fn, ms, reps, setup, _ = s.profiles[-1]
    s.profiles[-1] = (name, fn, ms, reps, setup, close)
    # phase 17 (d) runs the join pushdown on this graph before it closes
    s.query_graph = (g, mgr, hubs)
    rec["phase_s"] = time.perf_counter() - t_phase
    s.log(f"query phase: {rec['phase_s']:.1f} s in all; record "
          + json.dumps({k: v for k, v in rec.items()
                        if k not in ("calibration",)}))
    return rec


def query_traversals(s: Smoke) -> dict:
    """(f): ``wordnet_like`` at its defaults; ``HGBreadthFirstTraversal``
    from sampled seeds at 1, 2 and 3 hops against ``bfs_pull`` on the
    card, fused (K2) and staged (K1), and ``serve_bfs``; ``find_all(bfs)``
    on some seeds; unbounded DFS against unbounded BFS."""
    import numpy as np

    from hypergraphdb_tpu_torch.algorithms.traversals import (
        HGBreadthFirstTraversal,
        HGDepthFirstTraversal,
    )
    from hypergraphdb_tpu_torch.core.config import (
        HGConfiguration,
        QueryConfig,
    )
    from hypergraphdb_tpu_torch.core.graph import HyperGraph
    from hypergraphdb_tpu_torch.models import wordnet_like
    from hypergraphdb_tpu_torch.ops.ellbfs import bfs_pull, visited_rows
    from hypergraphdb_tpu_torch.ops.serving import serve_bfs
    from hypergraphdb_tpu_torch.query import dsl as hg

    g = HyperGraph(HGConfiguration(query=QueryConfig(device=str(s.dev))))
    t0 = time.perf_counter()
    syn, _ = wordnet_like(g)
    build_s = time.perf_counter() - t0
    snap = g.snapshot()
    seeds = np.asarray(syn, dtype=np.int64)[np.random.default_rng(
        WN_SEED).integers(0, len(syn), size=WN_SEEDS)].astype(np.int32)
    out = {"build_s": build_s}
    reach3 = []
    for hops in (1, 2, 3):
        t0 = time.perf_counter()
        host = [sorted(a for _, a in HGBreadthFirstTraversal(
            g, int(x), max_distance=hops)) for x in seeds.tolist()]
        host_s = time.perf_counter() - t0
        reset_launches()
        fused = bfs_pull(snap, seeds, hops, device=s.dev)
        staged = bfs_pull(snap, seeds, hops, fused=False, device=s.dev)
        s.torch.cuda.synchronize()
        n = launches()
        s.expect(n["fused_hop"] > 0 and n["gather_or"] > 0,
                 f"traversal {hops} hops: K1/K2 did not launch: {n}")
        for res, how in ((fused, "fused"), (staged, "staged")):
            got = visited_rows(res, snap.num_atoms, list(range(WN_SEEDS)))
            for x, row, want in zip(seeds.tolist(), got, host):
                s.expect(row[row != x].tolist() == want,
                         f"traversal {hops} hops from {x}: bfs_pull "
                         f"({how}) != HGBreadthFirstTraversal")
        cnt, first = serve_bfs(snap, seeds[:SERVE_SEEDS], hops,
                               SERVE_TOP_R, device=s.dev)
        for x, c, f, want in zip(seeds.tolist(), cnt, first, host):
            full = sorted(want + [x])
            s.expect(int(c) == len(full) and f[: min(len(full),
                                                     SERVE_TOP_R)].tolist()
                     == full[:SERVE_TOP_R],
                     f"traversal {hops} hops from {x}: serve_bfs != host")
        for x, want in list(zip(seeds.tolist(), host))[:WN_FIND_SEEDS]:
            s.expect(sorted(g.find_all(hg.bfs(x, max_distance=hops)))
                     == want, f"find_all(bfs({x}, {hops})) != traversal")
        s.log(f"traversal {hops} hops: {WN_SEEDS} seeds, mean reach "
              f"{np.mean([len(h) for h in host]):.1f}; HGBreadthFirst"
              f"Traversal {host_s:.3f} s == bfs_pull fused and staged "
              f"(launches {n}) == serve_bfs ({SERVE_SEEDS} requests) == "
              f"find_all(bfs) ({WN_FIND_SEEDS} seeds)")
        out[f"hops{hops}"] = {"mean_reach": float(np.mean(
            [len(h) for h in host])), "host_s": host_s, "launches": n}
        reach3 = host
    widest = np.argsort([-len(h) for h in reach3], kind="stable")
    for i in widest[:WN_DFS_SEEDS].tolist():
        x = int(seeds[i])
        b = {a for _, a in HGBreadthFirstTraversal(g, x)}
        d = [a for _, a in HGDepthFirstTraversal(g, x)]
        s.expect(len(d) == len(set(d)) and set(d) == b,
                 f"DFS from {x} != BFS ({len(d)} vs {len(b)})")
    s.log(f"traversal: wordnet_like build {build_s:.2f} s "
          f"({g.handles.peek} ids); unbounded DFS == BFS from "
          f"{WN_DFS_SEEDS} seeds")
    g.close()
    return out


# ------------------------------------------------------ 16. the serve runtime

#: the three legs' graphs: bench.py c6, c9 and c10's scale, uncut
SV_ENTITIES, SV_LINKS, SV_LOAD_CHUNK = 200_000, 400_000, 100_000
#: bench.py c6 (:805): seed 17, its manager, 4,096 open-loop Poisson
#: arrivals at 2,000 requests/s, 2 hops, deadline 1.0 s, beside a writer
#: of 20 x 10,000 links; the one-dispatch-a-request baseline of 256
C6_SEED = 17
C6_MANAGER = dict(headroom=1.8, background=True, delta_bucket_min=1 << 18,
                  compact_ratio=0.25, pack_pad_multiple=1 << 19)
C6_REQUESTS, C6_QPS, C6_DEADLINE_S, C6_HOPS = 4096, 2000.0, 1.0, 2
C6_BATCHES, C6_BATCH_LINKS, C6_BASELINE_N = 20, 10_000, 256
#: c6's checks after the writer: seeds through the runtime at lag 0 (with
#: fresh links in the memtable, so the overlay has rows), then again with
#: links removed (the dense route)
C6_CHECK_SEEDS, C6_FRESH_LINKS, C6_REMOVED = 64, 200, 50
#: bench.py c10 (:1760) at its defaults: seed 31, link values from
#: 1,000,000, its manager, 64 standing subscriptions (pattern queries on
#: the hubs for even i, value windows over the ingest's fresh values for
#: odd i), 4,096 single-anchor patterns at 1,000 requests/s, deadline
#: 2.0 s, a writer of 8 x 5,000 links into 16 hubs (values from
#: 10,000,000); the standing tier settled within 120 s, its first 16
#: subscriptions checked the wire way
C10_SEED, C10_V0, C10_INGEST_V0 = 31, 1_000_000, 10_000_000
C10_MANAGER = dict(headroom=1.8, background=True, delta_bucket_min=1 << 14,
                   pack_pad_multiple=1 << 17)
C10_REQUESTS, C10_QPS, C10_DEADLINE_S = 4096, 1000.0, 2.0
C10_HUBS, C10_BATCHES, C10_BATCH_LINKS, C10_CHECK_ANCHORS = 16, 8, 5_000, 64
C10_SUBS, C10_PROBES, C10_SETTLE_S = 64, 16, 120.0
#: bench.py c9 (:1596): seed 29, link values from 1,000,000, its manager,
#: a closed-loop flood of 4,096 range requests over windows of 24 (range /
#: top-8 ascending / top-8 descending), every answer (c9's 64 probes among
#: them) against the generator's own values. The host scan, one
#: ``graph.find_all`` a window, over 12 windows (best of 2), not c9's 128:
#: at 600,000 atoms each costs about 2 s, most of it the planner's capped
#: count of the window's open half-range
C9_SEED = 29
C9_MANAGER = dict(headroom=1.8, delta_bucket_min=1 << 14,
                  pack_pad_multiple=1 << 17)
C9_REQUESTS, C9_SV_WINDOW, C9_TOPK = 4096, 24, 8
C9_HOST_N = 12
SV_TOP_R, SV_WAIT_S = 16, 300.0


def serve_graph(s: Smoke, what: str, seed: int, link_v0, manager: dict):
    """A leg's graph as the bench builds it: the entities' int values
    0..N-1, then the links in chunks of 100,000, random entity pairs (link
    values ``link_v0 + i``, or the chunk's positions for c6), through
    ``bulk_import``; then the snapshot manager on the card. Returns the
    graph, the generator, the first entity's handle and the manager."""
    import numpy as np

    from hypergraphdb_tpu_torch.core.graph import HyperGraph

    g = HyperGraph()
    r = np.random.default_rng(seed)
    t0 = time.perf_counter()
    e0 = int(g.bulk_import(values=np.arange(SV_ENTITIES).tolist())[0])
    for st in range(0, SV_LINKS, SV_LOAD_CHUNK):
        m = min(SV_LOAD_CHUNK, SV_LINKS - st)
        subj = r.integers(0, SV_ENTITIES, size=m)
        obj = r.integers(0, SV_ENTITIES, size=m)
        v0 = st if link_v0 is None else link_v0 + st
        g.bulk_import(values=[int(v0 + x) for x in range(m)],
                      target_lists=[[e0 + int(a), e0 + int(b)]
                                    for a, b in zip(subj, obj)])
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mgr = g.enable_incremental(device=s.dev, **manager)
    s.log(f"serve {what}: {SV_ENTITIES + SV_LINKS} atoms through "
          f"bulk_import in {build_s:.2f} s, first pack and upload "
          f"{time.perf_counter() - t0:.2f} s")
    return g, r, e0, mgr


def open_loop(rt, submit, gaps, deadline_s: float):
    """Open-loop arrivals (bench c6/c10): request ``i`` submitted at the
    sum of the first ``i + 1`` gaps, not paced by completions; then every
    future waited on. Returns (indices served, shed, wall seconds)."""
    from hypergraphdb_tpu_torch.serve import DeadlineExceeded

    futs = []
    t0 = time.perf_counter()
    next_t = t0
    for i, gap in enumerate(gaps):
        next_t += gap
        pause = next_t - time.perf_counter()
        if pause > 0:
            time.sleep(pause)
        futs.append(submit(i, deadline_s))
    served, shed = [], 0
    for i, f in enumerate(futs):
        try:
            if f.result(timeout=SV_WAIT_S).count >= 0:
                served.append(i)
        except DeadlineExceeded:
            shed += 1
    return served, shed, time.perf_counter() - t0


def serve_report(s: Smoke, what: str, rt, wall: float, n: int,
                 served: int, shed: int) -> dict:
    """The runtime's numbers after a window, logged; fails on a breaker
    trip or a retry (a device failure the ladder would mask)."""
    st = rt.stats_snapshot()
    lat = st["latency_ms"]
    ex = rt.executor
    timing = {kind: {"batches": t["batches"], **{
        f"{k[:-2]}_ms_a_batch": round(v * 1e3 / t["batches"], 3)
        for k, v in t.items() if k.endswith("_s")}}
        for kind, t in ex.timing.items()}
    rec = {"requests": n, "served": served, "shed_deadline": shed,
           "wall_s": wall, "served_qps": served / wall,
           "batches": st["batches"],
           "device_dispatches": st["device_dispatches"],
           "batch_occupancy": st["batch_occupancy"],
           "p50_ms": lat["p50"], "p95_ms": lat["p95"], "p99_ms": lat["p99"],
           "host_fallbacks": st["host_fallbacks"],
           "breaker_trips": st["breaker_trips"], "retries": st["retries"],
           "errors": st["errors"], "bfs_routes": dict(ex.routes),
           "overlay_batches": getattr(ex, "overlay_batches", 0),
           "declined": dict(ex.declined), "timing": timing}
    s.log(f"serve {what}: {served} served, {shed} shed of {n} in "
          f"{wall:.3f} s ({rec['served_qps']:.1f} requests/s); "
          f"{rec['batches']} batches, {rec['device_dispatches']} device "
          f"dispatches, occupancy {rec['batch_occupancy']}; latency p50 "
          f"{lat['p50']} ms, p95 {lat['p95']} ms, p99 {lat['p99']} ms; host "
          f"fallbacks {rec['host_fallbacks']}, breaker trips "
          f"{rec['breaker_trips']}, retries {rec['retries']}, errors "
          f"{rec['errors']}; BFS routes {rec['bfs_routes']} (with an "
          f"overlay {rec['overlay_batches']}; declined {rec['declined']}); "
          f"ms a batch per kind {timing}")
    s.expect(rec["breaker_trips"] == 0 and rec["retries"] == 0
             and rec["errors"] == 0,
             f"serve {what}: breaker trips {rec['breaker_trips']}, retries "
             f"{rec['retries']}, errors {rec['errors']}: a device failure")
    s.expect(served + shed == n, f"serve {what}: {served} served + {shed} "
             f"shed != {n} requests")
    return rec


def compact_now(s: Smoke, mgr, what: str) -> None:
    """A compaction of everything committed so far: after any pass in
    flight (whose extract may predate the last writes), one more, so the
    memtable comes out empty."""
    s.expect(mgr.wait_compacted(timeout=SV_WAIT_S),
             f"serve {what}: compaction still running")
    mgr._request_compact()
    s.expect(mgr.wait_compacted(timeout=SV_WAIT_S),
             f"serve {what}: compaction still running")
    dead, new, revalued = mgr.correction()
    s.expect(not (dead or new or revalued),
             f"serve {what}: the memtable holds {len(dead)} dead, {len(new)} "
             f"new and {len(revalued)} revalued atoms after a compaction")


def drain(rt) -> None:
    while rt.step(drain=True):
        pass


def check_results(s: Smoke, what: str, futs, truths, top_r: int) -> None:
    """Each future's (count, matches) equal to its sorted host truth's
    (length, first ``top_r``)."""
    for i, (f, want) in enumerate(zip(futs, truths)):
        res = f.result(timeout=SV_WAIT_S)
        s.expect(res.count == len(want)
                 and res.matches.tolist() == list(want[:top_r]),
                 f"serve {what}: request {i} gave count {res.count}, "
                 f"matches {res.matches.tolist()[:8]}; the host "
                 f"{len(want)}, {list(want[:8])}")


def pattern_host_rule(mgr, anchors, pad: int, top_r: int) -> tuple:
    """How many single-anchor patterns the routing rules send to the host
    on the manager's current view: ``(sure, truncated)``, where ``sure``
    counts anchors outside the base and base rows over ``pad``, and
    ``truncated`` the rows over ``top_r`` (a window the memtable
    correction cannot extend, sent to the host while the memtable holds
    anything)."""
    view = mgr.pinned_view(sync_delta=False)
    off, n = view.base.inc_offsets, view.base.num_atoms
    sure = trunc = 0
    for a in anchors:
        if a >= n:
            sure += 1
            continue
        w = int(off[a + 1]) - int(off[a])
        sure += w > pad
        trunc += top_r < w <= pad
    return sure, trunc


def serve_c6(s: Smoke) -> None:
    """Bench c6: BFS serving through ``ServeRuntime`` under concurrent
    ingest, with the one-dispatch-a-request baseline, then its checks."""
    import threading

    import numpy as np

    from hypergraphdb_tpu_torch.serve import ServeConfig, ServeRuntime

    g, r, e0, mgr = serve_graph(s, "c6", C6_SEED, None, C6_MANAGER)
    s.log("serve c6: c6's cold-start probe (a fresh process's first "
          "dispatch from the plan cache) runs in phase 19")
    seeds = (e0 + r.integers(0, SV_ENTITIES, size=C6_REQUESTS)).astype(
        np.int64)
    # the baseline: the same requests one dispatch each (the 1-lane
    # bucket, padded to one 32-lane word on the fused route) on the
    # quiet graph
    t0 = time.perf_counter()
    rt1 = ServeRuntime(g, ServeConfig(buckets=(1,), max_linger_s=0.0,
                                      max_lag_edges=C6_BATCH_LINKS,
                                      top_r=SV_TOP_R))
    prewarm_s = time.perf_counter() - t0
    try:
        rt1.submit_bfs(int(seeds[0]), max_hops=C6_HOPS).result(
            timeout=SV_WAIT_S)
        t0 = time.perf_counter()
        futs = [rt1.submit_bfs(int(x), max_hops=C6_HOPS)
                for x in seeds[:C6_BASELINE_N]]
        for f in futs:
            f.result(timeout=SV_WAIT_S)
        base_qps = C6_BASELINE_N / (time.perf_counter() - t0)
    finally:
        rt1.close()
    routes1 = dict(rt1.executor.routes)
    s.expect(routes1 == {"fused": C6_BASELINE_N + 1, "dense": 0},
             f"serve c6: the 1-lane baseline took routes {routes1}; every "
             f"batch should ride the fused route padded to 32 lanes")

    cfg = ServeConfig(buckets=(64, 256, 1024), max_queue=8192,
                      max_linger_s=0.005, max_lag_edges=C6_BATCH_LINKS,
                      top_r=SV_TOP_R)
    t0 = time.perf_counter()
    rt = ServeRuntime(g, cfg)
    prewarm_s = (prewarm_s, time.perf_counter() - t0)
    ingested = {"atoms": 0, "s": 0.0, "errors": []}

    def writer():
        try:
            t_w = time.perf_counter()
            for _ in range(C6_BATCHES):
                subj = r.integers(0, SV_ENTITIES, size=C6_BATCH_LINKS)
                obj = r.integers(0, SV_ENTITIES, size=C6_BATCH_LINKS)
                g.bulk_import(values=list(range(C6_BATCH_LINKS)),
                              target_lists=[[e0 + int(a), e0 + int(b)]
                                            for a, b in zip(subj, obj)])
                ingested["atoms"] += C6_BATCH_LINKS
            ingested["s"] = time.perf_counter() - t_w
        except Exception as e:  # noqa: BLE001 - failed below
            ingested["errors"].append(repr(e))

    try:
        for b in cfg.buckets:
            warm = [rt.submit_bfs(int(seeds[j % C6_REQUESTS]),
                                  max_hops=C6_HOPS) for j in range(b)]
            for f in warm:
                f.result(timeout=SV_WAIT_S)
        rt.stats.reset()
        rt.executor.timing.clear()
        rt.executor.routes.update(fused=0, dense=0)
        rt.executor.overlay_batches = 0
        gaps = r.exponential(1.0 / C6_QPS, size=C6_REQUESTS)
        epoch0 = mgr.compactions
        wt = threading.Thread(target=writer, name="c6-writer", daemon=True)
        reset_launches()
        wt.start()
        # arrivals start once the writer's first batch has committed: the
        # window's batches then read a delta past max_lag_edges (K1's
        # overlay), as in steady streaming, whatever few of them run
        t_w = time.perf_counter()
        while (ingested["atoms"] < C6_BATCH_LINKS and not ingested["errors"]
               and time.perf_counter() - t_w < SV_WAIT_S):
            time.sleep(0.001)
        lead_s = time.perf_counter() - t_w
        served, shed, wall = open_loop(
            rt, lambda i, dl: rt.submit_bfs(int(seeds[i]), max_hops=C6_HOPS,
                                            deadline_s=dl),
            gaps, C6_DEADLINE_S)
        wt.join(timeout=SV_WAIT_S)
        rt.close(drain=True, timeout=SV_WAIT_S)
        n_k = launches()
    finally:
        rt.close(drain=False, timeout=SV_WAIT_S)
    s.expect(not wt.is_alive() and not ingested["errors"],
             f"serve c6: writer {ingested['errors'] or 'not joined'}")
    rec = serve_report(s, "c6", rt, wall, C6_REQUESTS, len(served), shed)
    s.log(f"serve c6: baseline {base_qps:.1f} requests/s ({C6_BASELINE_N} "
          f"one-request dispatches, routes {routes1}); batched/baseline "
          f"{rec['served_qps'] / base_qps:.2f}; ingest "
          f"{ingested['atoms'] / ingested['s']:.0f} atoms/s beside the "
          f"window; {mgr.compactions - epoch0} compactions; arrivals began "
          f"{lead_s:.3f} s after the writer, at its first commit; launches "
          f"in the window {n_k}; prewarm s (baseline, batched) {prewarm_s}")
    s.expect(rec["host_fallbacks"] == 0,
             f"serve c6: {rec['host_fallbacks']} host fallbacks; every seed "
             f"is in the base, the routing rules send none")
    # K2 runs each hop of every fused batch, K1 the overlay of each
    s.expect(n_k["fused_hop"] >= C6_HOPS * rec["bfs_routes"]["fused"] > 0
             and rec["overlay_batches"] > 0 and n_k["gather_or"] > 0,
             f"serve c6: launches in the window {n_k} for routes "
             f"{rec['bfs_routes']}, {rec['overlay_batches']} with an overlay")

    # -- exactness after the writer: lag 0 on the fused route (fresh links
    # in the memtable ride the overlay), then tombstones on the dense one
    s.expect(mgr.wait_compacted(timeout=SV_WAIT_S),
             "serve c6: compaction still running")
    subj = r.integers(0, SV_ENTITIES, size=C6_FRESH_LINKS)
    obj = r.integers(0, SV_ENTITIES, size=C6_FRESH_LINKS)
    g.bulk_import(values=list(range(C6_FRESH_LINKS)),
                  target_lists=[[e0 + int(a), e0 + int(b)]
                                for a, b in zip(subj, obj)])
    check = [int(x) for x in seeds[-C6_CHECK_SEEDS:]]
    rtx = ServeRuntime(g, ServeConfig(buckets=(C6_CHECK_SEEDS,),
                                      max_linger_s=0.0, max_lag_edges=0,
                                      top_r=SV_TOP_R, manual=True))
    try:
        reset_launches()
        futs = [rtx.submit_bfs(x, max_hops=C6_HOPS) for x in check]
        drain(rtx)
        n_fused = launches()
        check_results(s, "c6 lag 0", futs,
                      [graph_bfs(g, x, C6_HOPS) for x in check], SV_TOP_R)
        s.expect(rtx.executor.routes == {"fused": 1, "dense": 0}
                 and n_fused["fused_hop"] == C6_HOPS
                 and n_fused["gather_or"] > 0,
                 f"serve c6 lag 0: routes {rtx.executor.routes}, launches "
                 f"{n_fused}; want the fused route, K2 {C6_HOPS}, K1 > 0")
        gone = []
        for x in check:
            inc = g.get_incidence_set(x).array().tolist()
            if inc and inc[0] not in gone:
                gone.append(int(inc[0]))
            if len(gone) == C6_REMOVED:
                break
        for h in gone:
            g.remove(h)
        reset_launches()
        futs = [rtx.submit_bfs(x, max_hops=C6_HOPS) for x in check]
        drain(rtx)
        n_dense = launches()
        check_results(s, "c6 tombstones", futs,
                      [graph_bfs(g, x, C6_HOPS) for x in check], SV_TOP_R)
        s.expect(rtx.executor.routes == {"fused": 1, "dense": 1}
                 and rtx.stats.host_fallbacks == 0,
                 f"serve c6 tombstones: routes {rtx.executor.routes}, host "
                 f"fallbacks {rtx.stats.host_fallbacks}")
    finally:
        rtx.close()
    s.log(f"serve c6: lag 0 ({C6_FRESH_LINKS} fresh links) and "
          f"{len(gone)} removed links: {C6_CHECK_SEEDS} seeds equal to the "
          f"host BFS over the live graph on the fused route (launches "
          f"{n_fused}) and the dense route (launches {n_dense})")

    # one served 1024-lane batch, fused with an overlay (kw 32, the width
    # of the window's batches): the tombstones compacted away, fresh links
    # in the memtable; its answers held against the host BFS, then timed
    # and profiled
    compact_now(s, mgr, "c6")
    g.bulk_import(values=list(range(C6_FRESH_LINKS)),
                  target_lists=[[e0 + int(a), e0 + int(b)]
                                for a, b in zip(subj, obj)])
    rtp = ServeRuntime(g, ServeConfig(buckets=(1024,), max_linger_s=0.0,
                                      max_lag_edges=0, top_r=SV_TOP_R,
                                      manual=True))

    def one_batch():
        futs = [rtp.submit_bfs(int(x), max_hops=C6_HOPS)
                for x in seeds[:1024]]
        drain(rtp)
        futs[-1].result(timeout=SV_WAIT_S)
        return futs

    reset_launches()
    futs = one_batch()
    n_1024 = launches()
    check_results(s, "c6 lag 0, 1024 lanes", futs,
                  [graph_bfs(g, int(x), C6_HOPS) for x in seeds[:1024]],
                  SV_TOP_R)
    s.expect(rtp.executor.routes == {"fused": 1, "dense": 0}
             and rtp.executor.overlay_batches == 1
             and n_1024["fused_hop"] == C6_HOPS and n_1024["gather_or"] > 0,
             f"serve c6 lag 0, 1024 lanes: routes {rtp.executor.routes}, "
             f"{rtp.executor.overlay_batches} with an overlay, launches "
             f"{n_1024}; want the fused route, K2 {C6_HOPS}, K1 > 0")
    s.log(f"serve c6: lag 0, one 1024-lane batch: 1024 seeds equal to the "
          f"host BFS over the live graph on the fused route with the "
          f"overlay (launches {n_1024})")
    ms = served_ms(s, one_batch, runs=3)
    rtq = ServeRuntime(g, ServeConfig(buckets=(64,), max_linger_s=0.0,
                                      max_lag_edges=0, top_r=SV_TOP_R,
                                      manual=True))

    def small_batch():
        futs = [rtq.submit_bfs(int(x), max_hops=C6_HOPS) for x in seeds[:33]]
        drain(rtq)
        futs[-1].result(timeout=SV_WAIT_S)

    ms64 = served_ms(s, small_batch, runs=3)
    rtq.close()
    s.log(f"serve c6: one served 64-lane batch of 33 requests alone "
          f"{spread(ms64)}; ms a batch {rtq.executor.timing}")
    s.expect(rtp.executor.routes["dense"] == 0,
             f"serve c6: the profiled batch took {rtp.executor.routes} "
             f"(declined {rtp.executor.declined})")
    s.log(f"serve c6: one served 1024-lane batch (fused, overlay) "
          f"{spread(ms)}")

    def close():
        rtp.close()
        g.close()

    s.profile_later("serve c6 1024-lane BFS batch (fused, overlay)",
                    one_batch, float(np.median(ms)), reps=3, teardown=close)


class PerfTap:
    """bench c10's recording perf feed: the standing tier's dirty →
    notified seconds, by lane (``ServeConfig.perf`` is duck-typed)."""

    def __init__(self):
        import threading

        self.lanes: dict = {}
        self.lock = threading.Lock()

    def observe(self, kind, latency_s, path="device", t=None):
        with self.lock:
            self.lanes.setdefault(kind, []).append(float(latency_s))

    def observe_batch(self, *a, **k):
        pass

    def maybe_tick(self):
        return None


def c10_subscribe(subs, hubs) -> list:
    """bench c10's standing queries (:1853-1866): a pattern on a hub for
    even ``i``, a value window over the ingest's fresh values for odd
    ``i``. Returns ``(id, kind, anchor or window, initial matches)``."""
    span = C10_BATCHES * C10_BATCH_LINKS
    out = []
    for i in range(C10_SUBS):
        if i % 2 == 0:
            key = hubs[i % C10_HUBS]
            resp = subs.subscribe("pattern", {"anchors": [key]})
        else:
            key = (C10_INGEST_V0 + (i * span) // C10_SUBS,
                   C10_INGEST_V0 + ((i + 2) * span) // C10_SUBS)
            resp = subs.subscribe("range", {"lo": key[0], "hi": key[1]})
        out.append((resp["id"], resp["kind"], key,
                    {int(h) for h in resp["matches"]}))
    return out


def settle_subs(subs, limit_s: float) -> float:
    """Keep the standing tier's rounds turning (beside the dispatch
    thread's) until no subscription is dirty or in flight; returns the
    seconds it took."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < limit_s:
        subs.pump()
        with subs._lock:
            busy = any(x.dirty or x.inflight is not None
                       for x in subs.subs.all())
        if not busy:
            break
        time.sleep(0.01)
    return time.perf_counter() - t0


def check_c10_subs(s: Smoke, g, subs, folded, links) -> None:
    """bench c10's differential verdict, the wire way (:1938-1960): for
    the first :data:`C10_PROBES` subscriptions, the initial snapshot plus
    the folded polled deltas must equal ``_full_eval`` at settle, and an
    independent truth: the live graph's incidence set of the hub, or the
    writer's own (handle, value) pairs inside the window."""
    import numpy as np

    for sid, kind, key, matches in folded[:C10_PROBES]:
        while True:
            env = subs.poll(sid, max_notes=64, timeout_s=0.0)
            if env["what"] == "resync":
                matches = {int(h) for h in env["matches"]}
                break
            for note in env["notes"]:
                matches.difference_update(int(h) for h in note["removed"])
                matches.update(int(h) for h in note["added"])
            if not env["more"] and not env["notes"]:
                break
        want = subs._full_eval(subs.subs.get(sid))
        if kind == "pattern":
            truth = {int(h) for h in g.get_incidence_set(key).array()}
        else:
            lo, hi = key
            truth = set()
            for hs, v0 in links:
                a, b = max(lo - v0, 0), min(hi - v0 + 1, len(hs))
                if a < b:
                    truth.update(int(h) for h in np.asarray(hs)[a:b])
        s.expect(matches == want == truth,
                 f"serve c10: subscription {sid} ({kind} {key}): folded "
                 f"{len(matches)}, full evaluation {len(want)}, truth "
                 f"{len(truth)}")
    s.log(f"serve c10: the first {C10_PROBES} subscriptions' folded "
          f"deltas equal their full evaluation and the independent truth "
          f"(hub incidence sets; the writer's values in each window)")


def serve_c10(s: Smoke) -> None:
    """Bench c10 at its defaults through ``ServeRuntime``: its 64 standing
    subscriptions attached (``sub.SubscriptionManager``), its ad-hoc
    pattern traffic beside its writer, the standing tier settled and its
    probes checked; then the ad-hoc checks: through the device lane with
    the memtable correction, through ``submit_query``, and after a
    compaction with the hubs' rows over ``pattern_pad``."""
    import threading

    import numpy as np

    from hypergraphdb_tpu_torch.query import conditions as qc
    from hypergraphdb_tpu_torch.serve import ServeConfig, ServeRuntime
    from hypergraphdb_tpu_torch.sub import SubscriptionManager

    g, r, e0, mgr = serve_graph(s, "c10", C10_SEED, C10_V0, C10_MANAGER)
    tap = PerfTap()
    cfg = ServeConfig(buckets=(64, 256, 1024), max_queue=8192,
                      max_linger_s=0.002, top_r=SV_TOP_R, prewarm_aot=False,
                      perf=tap)
    rt = ServeRuntime(g, cfg)
    subs = SubscriptionManager(g, rt)
    rt.attach_subscriptions(subs)
    # the bench's draw order: the hubs, then the ad-hoc anchors
    hubs = [e0 + int(h) for h in r.integers(0, SV_ENTITIES, size=C10_HUBS)]
    t0 = time.perf_counter()
    folded = c10_subscribe(subs, hubs)
    subscribe_s = time.perf_counter() - t0
    seeds = [e0 + int(x) for x in r.integers(0, SV_ENTITIES,
                                              size=C10_REQUESTS)]
    ingested = {"atoms": 0, "s": 0.0, "errors": [], "links": []}

    def writer():
        try:
            t_w = time.perf_counter()
            v = C10_INGEST_V0
            for _ in range(C10_BATCHES):
                obj = r.integers(0, SV_ENTITIES, size=C10_BATCH_LINKS)
                hs = g.bulk_import(values=[int(v + x)
                                           for x in range(C10_BATCH_LINKS)],
                                   target_lists=[[hubs[int(o) % C10_HUBS],
                                                  e0 + int(o)] for o in obj])
                ingested["links"].append((hs, v))
                v += C10_BATCH_LINKS
                ingested["atoms"] += C10_BATCH_LINKS
            ingested["s"] = time.perf_counter() - t_w
        except Exception as e:  # noqa: BLE001 - failed below
            ingested["errors"].append(repr(e))

    futs = []

    def submit(i, dl):
        futs.append(rt.submit_pattern([seeds[i]], deadline_s=dl))
        return futs[-1]

    try:
        for b in cfg.buckets:
            warm = [rt.submit_pattern([seeds[j % C10_REQUESTS]])
                    for j in range(b)]
            for f in warm:
                f.result(timeout=SV_WAIT_S)
        rt.stats.reset()
        rt.executor.timing.clear()
        gaps = r.exponential(1.0 / C10_QPS, size=C10_REQUESTS)
        epoch0 = mgr.compactions
        wt = threading.Thread(target=writer, name="c10-writer", daemon=True)
        wt.start()
        served, shed, wall = open_loop(rt, submit, gaps, C10_DEADLINE_S)
        wt.join(timeout=SV_WAIT_S)
        settle_s = settle_subs(subs, C10_SETTLE_S)
        sub_stats = subs.stats.snapshot()
        health = subs.health_section()
        if not (wt.is_alive() or ingested["errors"]):
            check_c10_subs(s, g, subs, folded, ingested["links"])
        subs.close()
        rt.close(drain=True, timeout=SV_WAIT_S)
    finally:
        subs.close()
        rt.close(drain=False, timeout=SV_WAIT_S)
    s.expect(not wt.is_alive() and not ingested["errors"],
             f"serve c10: writer {ingested['errors'] or 'not joined'}")
    rec = serve_report(s, "c10", rt, wall, C10_REQUESTS, len(served),
                       shed)
    lat = sorted(tap.lanes.get("sub") or ())
    pct = (lambda q: round(1e3 * lat[min(len(lat) - 1,
                                         int(q * len(lat)))], 3)
           if lat else None)
    s.log(f"serve c10: {C10_SUBS} standing subscriptions in "
          f"{subscribe_s:.2f} s; settled {settle_s:.2f} s after the window; "
          f"sub.eval_rounds {sub_stats['sub.eval_rounds']}, evals "
          f"{sub_stats['sub.evals']}, dirty_skipped "
          f"{sub_stats['sub.dirty_skipped']}, full_fallbacks "
          f"{sub_stats['sub.full_fallbacks']}, notified "
          f"{sub_stats['sub.notified']}, shed {sub_stats['sub.shed']}, "
          f"eval_errors {sub_stats['sub.eval_errors']}, pump_errors "
          f"{sub_stats['sub.pump_errors']}, listener_errors "
          f"{sub_stats['sub.listener_errors']}; dirty to notified p50 "
          f"{pct(0.50)} ms, p99 {pct(0.99)} ms over {len(lat)} "
          f"notifications; health {health}; served "
          f"{rec['served_qps']:.1f} requests/s, p50 {rec['p50_ms']} ms "
          f"(c10 without subscriptions: 822.2-952.0 requests/s on an H100 80GB HBM3 at 700 W)")
    s.expect(sub_stats["sub.eval_errors"] == 0
             and sub_stats["sub.pump_errors"] == 0
             and sub_stats["sub.listener_errors"] == 0,
             f"serve c10: the standing tier failed: {sub_stats}")
    s.expect(health["dirty"] == 0 and health["inflight"] == 0,
             f"serve c10: the standing tier did not settle in "
             f"{C10_SETTLE_S} s: {health}")
    s.expect(sub_stats["sub.notified"] > 0,
             "serve c10: no standing subscription was notified")
    # the routing rules' count over the window's one epoch: c10's ingest
    # stays under the manager's thresholds, so no compaction ran in it
    s.expect(mgr.compactions == epoch0,
             f"serve c10: {mgr.compactions - epoch0} compactions in the "
             f"window")
    sure, trunc = pattern_host_rule(mgr, [seeds[i] for i in served],
                                    cfg.pattern_pad, cfg.top_r)
    adhoc_host = sum(futs[i].result(timeout=0).served_by == "host"
                     for i in served)
    s.log(f"serve c10: ingest {ingested['atoms'] / ingested['s']:.0f} "
          f"atoms/s into "
          f"{C10_HUBS} hubs; host fallbacks {rec['host_fallbacks']} "
          f"({adhoc_host} ad-hoc, the rest standing evaluations); the "
          f"routing rules over the served requests: {sure} rows over "
          f"pattern_pad, {trunc} truncated windows (host once the memtable "
          f"holds anything)")
    s.expect(sure <= adhoc_host <= sure + trunc,
             f"serve c10: {adhoc_host} ad-hoc host fallbacks, the "
             f"routing rules send {sure} to {sure + trunc}")

    anchors = seeds[:C10_CHECK_ANCHORS] + hubs

    def checks(what: str):
        cfg_x = ServeConfig(buckets=(128,), max_linger_s=0.0,
                            top_r=SV_TOP_R, prewarm_aot=False, manual=True)
        truths = [sorted(int(h) for h in g.find_all(qc.Incident(a)))
                  for a in anchors]
        sure, trunc = pattern_host_rule(mgr, anchors, cfg_x.pattern_pad,
                                        cfg_x.top_r)
        view = mgr.pinned_view(sync_delta=False)
        dirty = bool(view.dead or view.revalued or view.new_atoms)
        want = sure + (trunc if dirty else 0)
        got = []
        for via in ("submit_pattern", "submit_query"):
            rtx = ServeRuntime(g, cfg_x)
            try:
                futs = [rtx.submit_pattern([a]) if via == "submit_pattern"
                        else rtx.submit_query(qc.Incident(a))
                        for a in anchors]
                drain(rtx)
                check_results(s, f"c10 {what} {via}", futs, truths,
                              SV_TOP_R)
            finally:
                rtx.close()
            got.append(rtx.stats.host_fallbacks)
            s.expect(rtx.stats.host_fallbacks == want,
                     f"serve c10 {what} {via}: {rtx.stats.host_fallbacks} "
                     f"host fallbacks, the routing rules send {want}")
        s.log(f"serve c10 {what}: {len(anchors)} anchors ({C10_HUBS} hubs, "
              f"{max(len(t) for t in truths[-C10_HUBS:])} links at most) "
              f"equal to find_all(Incident) through submit_pattern and "
              f"submit_query; host fallbacks {got} (the rules: {want})")
        return want

    checks("memtable")
    compact_now(s, mgr, "c10")
    n_host = checks("compacted")
    s.expect(n_host >= C10_HUBS - 1,
             f"serve c10: after the compaction the hubs' rows should be "
             f"over pattern_pad: {n_host} go to the host")

    rtp = ServeRuntime(g, ServeConfig(buckets=(1024,), max_linger_s=0.0,
                                      top_r=SV_TOP_R, prewarm_aot=False,
                                      manual=True))

    def one_batch():
        futs = [rtp.submit_pattern([a]) for a in seeds[:1024]]
        drain(rtp)
        futs[-1].result(timeout=SV_WAIT_S)

    ms = served_ms(s, one_batch, runs=3)
    s.log(f"serve c10: one served 1024-lane pattern batch {spread(ms)}")

    def close():
        rtp.close()
        g.close()

    s.profile_later("serve c10 1024-lane pattern batch", one_batch,
                    float(np.median(ms)), reps=3, teardown=close)


def serve_c9(s: Smoke) -> None:
    """Bench c9: the range lane through ``ServeRuntime``: the closed-loop
    flood, the host-scan baseline, every answer against the generator's
    own values."""
    import numpy as np

    from hypergraphdb_tpu_torch.query import conditions as qc
    from hypergraphdb_tpu_torch.serve import ServeConfig, ServeRuntime

    g, r, e0, mgr = serve_graph(s, "c9", C9_SEED, C10_V0, C9_MANAGER)
    cfg = ServeConfig(buckets=(64, 256, 1024), max_linger_s=0.002,
                      top_r=SV_TOP_R, prewarm_aot=False)
    los = r.integers(0, SV_ENTITIES - C9_SV_WINDOW, size=C9_REQUESTS)
    kinds = r.integers(0, 3, size=C9_REQUESTS)

    def limit_of(i):
        return None if kinds[i] == 0 else C9_TOPK

    def submit(rt, i):
        lo = int(los[i])
        return rt.submit_range(lo=lo, hi=lo + C9_SV_WINDOW,
                               limit=limit_of(i), desc=bool(kinds[i] == 2))

    rt = ServeRuntime(g, cfg)
    try:
        for b in cfg.buckets:
            for f in [submit(rt, j % C9_REQUESTS) for j in range(b)]:
                f.result(timeout=SV_WAIT_S)
        rt.stats.reset()
        rt.executor.timing.clear()
        t0 = time.perf_counter()
        futs = [submit(rt, i) for i in range(C9_REQUESTS)]
        results = [f.result(timeout=SV_WAIT_S) for f in futs]
        wall = time.perf_counter() - t0
        rec = serve_report(s, "c9", rt, wall, C9_REQUESTS, len(results), 0)
        # the same flood once more: how far one run's rate is from the next
        t0 = time.perf_counter()
        futs = [submit(rt, i) for i in range(C9_REQUESTS)]
        again = [f.result(timeout=SV_WAIT_S) for f in futs]
        rec["again_qps"] = C9_REQUESTS / (time.perf_counter() - t0)
        rt.close(drain=True, timeout=SV_WAIT_S)
    finally:
        rt.close(drain=False, timeout=SV_WAIT_S)
    st = rt.stats_snapshot()
    s.log(f"serve c9: the same flood again {rec['again_qps']:.1f} requests/s")
    s.expect(st["breaker_trips"] == 0 and st["retries"] == 0
             and st["errors"] == 0 and st["host_fallbacks"] == 0,
             f"serve c9: after the second flood {st}")
    s.expect(all(a.count == b.count and a.matches.tolist()
                 == b.matches.tolist() for a, b in zip(results, again)),
             "serve c9: the second flood's answers differ from the first's")
    s.expect(rec["host_fallbacks"] == 0,
             f"serve c9: {rec['host_fallbacks']} host fallbacks; exact int "
             f"bounds, limits under top_r and a quiet memtable send none")

    # the truth from the generator's own values: entity e0 + i holds the
    # int i and every link a value from C10_V0 up, above every window, so
    # window [lo, lo + 24] holds the 25 entities from e0 + lo, one value
    # each (no tie for the descending rule to break)
    s.expect(C10_V0 > SV_ENTITIES, "serve c9: link values inside a window")

    def truth(i: int) -> list:
        lo = e0 + int(los[i])
        hs = list(range(lo, lo + C9_SV_WINDOW + 1))
        return hs[::-1] if kinds[i] == 2 else hs

    found = {}

    def host_window():
        times = []
        for i in range(C9_HOST_N):
            lo = int(los[i])
            t0 = time.perf_counter()
            found[i] = g.find_all(qc.And(
                qc.AtomValue(lo, "gte"),
                qc.AtomValue(lo + C9_SV_WINDOW, "lte")))
            times.append(time.perf_counter() - t0)
        return times

    passes = [host_window() for _ in range(2)]
    rates = [C9_HOST_N / sum(t) for t in passes]
    win_ms = [1e3 * t for p in passes for t in p]
    for i, hs in found.items():
        s.expect(sorted(int(h) for h in hs) == sorted(truth(i)),
                 f"serve c9: find_all over window {int(los[i])} != the "
                 f"generator's values")
    bad = []
    for i, res in enumerate(results):
        want = truth(i)
        lim = limit_of(i)
        upto = min(lim if lim is not None else SV_TOP_R, SV_TOP_R)
        if res.count != len(want) or res.matches.tolist() != want[:upto]:
            bad.append((int(los[i]), int(kinds[i]), res.count, len(want)))
    s.log(f"serve c9: host scan {max(rates):.3f} requests/s over "
          f"{C9_HOST_N} windows through find_all, best of 2 (the passes "
          f"{rates[0]:.3f}, {rates[1]:.3f}; a window {min(win_ms):.1f} to "
          f"{max(win_ms):.1f} ms; each equal to the generator's values); "
          f"runtime/host {rec['served_qps'] / max(rates):.2f}; the "
          f"{C9_REQUESTS} requests (c9 probes the first 64) against the "
          f"generator's values, {len(bad)} differ")
    s.expect(not bad, f"serve c9: requests differ from the generator's "
             f"values (lo, kind, count, want): {bad[:5]}")

    rtp = ServeRuntime(g, ServeConfig(buckets=(1024,), max_linger_s=0.0,
                                      top_r=SV_TOP_R, prewarm_aot=False,
                                      manual=True))

    def one_batch():
        futs = [submit(rtp, i) for i in range(1024)]
        drain(rtp)
        futs[-1].result(timeout=SV_WAIT_S)

    ms = served_ms(s, one_batch, runs=3)
    s.log(f"serve c9: one served 1024-lane range batch {spread(ms)}")

    def close():
        rtp.close()
        g.close()

    s.profile_later("serve c9 1024-lane range batch", one_batch,
                    float(np.median(ms)), reps=3, teardown=close)


def phase_serve(s: Smoke) -> None:
    """Phase 16: the serve runtime driven by bench c6, c10 (ad-hoc
    patterns) and c9's traffic at their defaults (see the legs)."""
    t0 = time.perf_counter()
    serve_c6(s)
    serve_c10(s)
    serve_c9(s)
    s.log(f"serve: phase 16 in {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------ 17. the join lane

#: bench.py c11 (:2045) at its defaults: seed 37, 100,000 entities, 300,000
#: locality-clustered links (objects within 16 ids of their subject, link
#: values from 1,000,000), its manager, anchors drawn from the co-degree
#: band 2..64, 2,048 Poisson arrivals of anchored triangles at 200/s,
#: deadline 5.0 s, its ServeConfig; the writer: 8 x 2,000 links (values
#: from 10,000,000), a compaction requested and awaited after each, a 0.2 s
#: gap; 64 fresh probes and the 64-anchor host baseline (best of 2)
C11_SEED, C11_ENTITIES, C11_LINKS, C11_WINDOW = 37, 100_000, 300_000, 16
C11_MIN_DEG, C11_MAX_DEG, C11_V0, C11_INGEST_V0 = 2, 64, 1_000_000, 10_000_000
C11_MANAGER = dict(headroom=1.8, background=True, delta_bucket_min=1 << 14,
                   pack_pad_multiple=1 << 16)
C11_REQUESTS, C11_QPS, C11_DEADLINE_S = 2048, 200.0, 5.0
C11_BATCHES, C11_BATCH_LINKS, C11_GAP_S = 8, 2_000, 0.2
C11_BUCKETS, C11_TOP_R, C11_BASE_N = (16, 64, 256), 16, 64
#: (b): links of the dirty set past ``join_dirty_max`` (16 atoms)
C11_DIRTY_LINKS = 10


def c11_spec(a: int) -> dict:
    """bench c11's anchored triangle through ``a``: a–y, y–z, z–a."""
    from hypergraphdb_tpu_torch.query import conditions as qc
    from hypergraphdb_tpu_torch.query.variables import var

    return {"y": qc.And(qc.CoIncident(a), qc.CoIncident(var("z"))),
            "z": qc.CoIncident(a)}


def c11_links(r, e0: int, m: int) -> list:
    """``m`` locality-clustered links as c11 draws them: a uniform
    subject, an object 1..16 ids after it."""
    import numpy as np

    subj = r.integers(0, C11_ENTITIES, size=m)
    obj = (subj + r.integers(1, C11_WINDOW + 1, size=m)) % C11_ENTITIES
    return [[e0 + int(a), e0 + int(b)] for a, b in zip(subj, obj)], \
        np.concatenate([subj, obj])


def live_co_row(g, u: int):
    """``u``'s co-incidence row from the live graph: the targets of the
    links in its incidence set, ``u`` excluded — not through ``join/``."""
    import numpy as np

    row = set()
    for link in g.get_incidence_set(u).array().tolist():
        row.update(int(t) for t in g.get_targets(int(link)))
    row.discard(int(u))
    return np.asarray(sorted(row), dtype=np.int64)


def live_triangles(g, a: int) -> int:
    """Ordered (y, z) with y, z in row(a) and z in row(y): the anchored
    triangle's count by numpy over the live graph."""
    import numpy as np

    row = live_co_row(g, a)
    return int(sum(len(np.intersect1d(live_co_row(g, int(y)), row,
                                      assume_unique=True)) for y in row))


def check_joins(s: Smoke, what: str, g, anchors, futs, top_r: int,
                numpy_counts: bool = False) -> list:
    """Each join answer against ``join.host_join`` on the live graph:
    count and the first ``top_r`` tuples (and, with ``numpy_counts``,
    the count against :func:`live_triangles`). Returns the results."""
    from hypergraphdb_tpu_torch import join

    out = []
    for a, f in zip(anchors, futs):
        res = f.result(timeout=SV_WAIT_S)
        want = join.host_join(g, join.extract_pattern(g, c11_spec(a)))
        got = [tuple(int(v) for v in row) for row in res.tuples]
        s.expect(res.count == len(want) and got == want[:top_r],
                 f"join {what}: anchor {a} gave count {res.count}, "
                 f"{got[:4]}; the host {len(want)}, {want[:4]}")
        if numpy_counts:
            n = live_triangles(g, a)
            s.expect(res.count == n, f"join {what}: anchor {a} gave count "
                     f"{res.count}, numpy over the live graph {n}")
        out.append(res)
    return out


def join_route_check(s: Smoke, what: str, rt) -> dict:
    """Every host fallback of the join lane came from a routing rule (a
    dirty set marked "full", anchors beyond the base, truncated windows)
    and no factorized build was declined."""
    ex = rt.executor
    jr = dict(ex.join_routes)
    ruled = jr["dirty"] + jr["beyond_base"] + jr["truncated"] + jr["prefix"]
    s.expect(rt.stats.host_fallbacks == ruled
             and jr["declined"] == jr["correction"] == 0,
             f"join {what}: {rt.stats.host_fallbacks} host fallbacks, the "
             f"routing rules account for {ruled}; routes {jr}")
    n_declined = sum(ex.declined.values())
    s.expect(n_declined == 0,
             f"join {what}: declined builds {ex.declined}")
    return jr


def serve_c11(s: Smoke) -> None:
    """Bench c11: anchored triangles through ``ServeRuntime`` beside a
    compaction-paced writer, then (a) the differential, (b) the dirty
    memtable's three routes, (c) the hub batch."""
    import threading

    import numpy as np

    from hypergraphdb_tpu_torch import join
    from hypergraphdb_tpu_torch.core.graph import HyperGraph
    from hypergraphdb_tpu_torch.ops.join import neighbor_csr
    from hypergraphdb_tpu_torch.serve import ServeConfig, ServeRuntime

    g = HyperGraph()
    r = np.random.default_rng(C11_SEED)
    t0 = time.perf_counter()
    e0 = int(g.bulk_import(values=np.arange(C11_ENTITIES).tolist())[0])
    deg = np.zeros(C11_ENTITIES, dtype=np.int64)
    for st in range(0, C11_LINKS, SV_LOAD_CHUNK):
        m = min(SV_LOAD_CHUNK, C11_LINKS - st)
        tl, ends = c11_links(r, e0, m)
        g.bulk_import(values=[int(C11_V0 + st + x) for x in range(m)],
                      target_lists=tl)
        np.add.at(deg, ends, 1)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mgr = g.enable_incremental(device=s.dev, **C11_MANAGER)
    s.log(f"join c11: {C11_ENTITIES + C11_LINKS} atoms through bulk_import "
          f"in {build_s:.2f} s, first pack and upload "
          f"{time.perf_counter() - t0:.2f} s")
    cand = np.flatnonzero((deg >= C11_MIN_DEG) & (deg <= C11_MAX_DEG))
    anchors = [e0 + int(a)
               for a in cand[r.integers(0, len(cand), size=C11_REQUESTS)]]
    cfg = ServeConfig(buckets=C11_BUCKETS, max_queue=8192,
                      max_linger_s=0.002, top_r=C11_TOP_R,
                      prewarm_aot=False)
    rt = ServeRuntime(g, cfg)
    ingested = {"atoms": 0, "s": 0.0, "errors": []}

    def writer():
        try:
            t_w = time.perf_counter()
            v = C11_INGEST_V0
            for _ in range(C11_BATCHES):
                tl, _ = c11_links(r, e0, C11_BATCH_LINKS)
                g.bulk_import(values=[int(v + x)
                                      for x in range(C11_BATCH_LINKS)],
                              target_lists=tl)
                v += C11_BATCH_LINKS
                ingested["atoms"] += C11_BATCH_LINKS
                mgr._request_compact()
                mgr.wait_compacted(timeout=120)
                time.sleep(C11_GAP_S)
            ingested["s"] = time.perf_counter() - t_w
        except Exception as e:  # noqa: BLE001 - failed below
            ingested["errors"].append(repr(e))

    try:
        t0 = time.perf_counter()
        for b in cfg.buckets:
            warm = [rt.submit_join(c11_spec(anchors[j % C11_REQUESTS]))
                    for j in range(b)]
            for f in warm:
                f.result(timeout=SV_WAIT_S)
        warm_s = time.perf_counter() - t0
        rt.stats.reset()
        rt.executor.timing.clear()
        rt.executor.join_routes.update(dict.fromkeys(rt.executor.join_routes,
                                                     0))
        gaps = r.exponential(1.0 / C11_QPS, size=C11_REQUESTS)
        epoch0 = mgr.compactions
        wt = threading.Thread(target=writer, name="c11-writer", daemon=True)
        wt.start()
        served, shed, wall = open_loop(
            rt, lambda i, dl: rt.submit_join(c11_spec(anchors[i]),
                                             deadline_s=dl),
            gaps, C11_DEADLINE_S)
        wt.join(timeout=SV_WAIT_S)
        s.expect(not wt.is_alive() and not ingested["errors"],
                 f"join c11: writer {ingested['errors'] or 'not joined'}")
        rec = serve_report(s, "c11", rt, wall, C11_REQUESTS, len(served),
                           shed)
        jr = join_route_check(s, "c11", rt)
        t = rt.executor.timing.get("join", {})
        n_dev = max(rec["device_dispatches"], 1)
        s.log(f"join c11: partial corrections "
              f"{rt.stats.join_partial_corrections}, hub dispatches "
              f"{rt.stats.join_hub_dispatches}; lanes by route {jr}; "
              f"execute_join host syncs {t.get('host_syncs', 0)} in "
              f"{rec['device_dispatches']} dispatches "
              f"({t.get('host_syncs', 0) / n_dev:.2f} a dispatch); "
              f"planning in launch {t.get('plan_s', 0.0):.3f} s in all; "
              f"ingest "
              f"{ingested['atoms'] / ingested['s']:.0f} atoms/s beside the "
              f"window ({ingested['s']:.2f} s with its compactions); "
              f"{mgr.compactions - epoch0} compactions; warm-up "
              f"{warm_s:.2f} s")

        # -- (a) the differential: fresh probes after the window settled
        compact_now(s, mgr, "c11")
        probes = anchors[:C11_BASE_N]
        futs = [rt.submit_join(c11_spec(a)) for a in probes]
        check_joins(s, "c11 probes", g, probes, futs, C11_TOP_R,
                    numpy_counts=True)
        s.log(f"join c11 (a): {C11_BASE_N} fresh probes equal to host_join "
              f"(count and first {C11_TOP_R} tuples) and to numpy's "
              f"triangle count over the live graph")
        rt.close(drain=True, timeout=SV_WAIT_S)
    finally:
        rt.close(drain=False, timeout=SV_WAIT_S)

    def host_window():
        t0 = time.perf_counter()
        for a in anchors[:C11_BASE_N]:
            join.host_join(g, join.extract_pattern(g, c11_spec(a)))
        return C11_BASE_N / (time.perf_counter() - t0)

    host_qps = max(host_window() for _ in range(2))
    s.log(f"join c11: served {rec['served_qps']:.1f} requests/s against "
          f"the host baseline's {host_qps:.1f} (host_join, {C11_BASE_N} "
          f"anchors, best of 2)")

    # -- one batch alone on the quiet base, 16 and 256 lanes
    cfg_x = dict(max_linger_s=0.0, top_r=C11_TOP_R, prewarm_aot=False,
                 manual=True)
    alone = {}
    for width in (16, 256):
        rtb = ServeRuntime(g, ServeConfig(buckets=(width,), **cfg_x))

        def one_batch(rtb=rtb, width=width):
            futs = [rtb.submit_join(c11_spec(a)) for a in anchors[:width]]
            drain(rtb)
            futs[-1].result(timeout=SV_WAIT_S)
            return futs

        futs = one_batch()
        check_joins(s, f"c11 {width} lanes alone", g, anchors[:width],
                    futs, C11_TOP_R)
        rtb.executor.timing.clear()
        ms = served_ms(s, one_batch, runs=3)
        t = rtb.executor.timing["join"]
        alone[width] = (ms, rtb)
        s.log(f"join c11: one {width}-lane batch alone {spread(ms)}; a "
              f"batch's launch {t['launch_s'] * 1e3 / t['batches']:.3f} ms "
              f"(dispatch {t['dispatch_s'] * 1e3 / t['batches']:.3f}, of "
              f"it planning {t['plan_s'] * 1e3 / t['batches']:.3f}), "
              f"collect {t['collect_s'] * 1e3 / t['batches']:.3f} ms (wait "
              f"{t.get('wait_s', 0.0) * 1e3 / t['batches']:.3f}), host "
              f"syncs {t['host_syncs'] / t['batches']:.1f} a batch; equal "
              f"to host_join")
    rtb = alone[16][1]
    rtb.close()

    # -- (b) the dirty memtable on a quiet base: three routes
    rtx = ServeRuntime(g, ServeConfig(buckets=(16,), **cfg_x))
    batch = anchors[:16]

    def dirty_case(what: str, edit, route: str) -> None:
        edit()
        before = dict(rtx.executor.join_routes)
        n_dev = rtx.stats.device_dispatches
        n_part = rtx.stats.join_partial_corrections
        futs = [rtx.submit_join(c11_spec(a)) for a in batch]
        drain(rtx)
        res = check_joins(s, f"c11 (b) {what}", g, batch, futs, C11_TOP_R)
        moved = {k: v - before[k] for k, v in rtx.executor.join_routes.items()
                 if v != before[k]}
        part = rtx.stats.join_partial_corrections - n_part
        dev = rtx.stats.device_dispatches - n_dev
        by = sorted({r_.served_by for r_ in res})
        if route == "device":
            ok = dev == 1 and part >= 1 and moved.get("device", 0) >= 1
        else:
            ok = dev == 0 and part == 0 and moved == {route: len(batch)}
        s.expect(ok, f"join c11 (b) {what}: device dispatches {dev}, partial "
                 f"corrections {part}, lanes by route {moved}; want the "
                 f"{route} route")
        s.log(f"join c11 (b) {what}: 16 anchors equal to host_join; device "
              f"dispatches {dev}, partial corrections {part}, lanes by route "
              f"{moved}, served by {by}")

    def partner(a: int, k: int) -> int:
        return e0 + (a - e0 + k) % C11_ENTITIES

    try:
        a0 = batch[0]
        dirty_case("one fresh link", lambda: g.add_link(
            (a0, partner(a0, C11_WINDOW + 1)), value=C11_INGEST_V0 - 1),
            "device")
        dirty_case(f"{C11_DIRTY_LINKS} fresh links", lambda: [
            g.add_link((a, partner(a, 1)), value=C11_INGEST_V0 - 2)
            for a in batch[1: C11_DIRTY_LINKS + 1]], "dirty")
        compact_now(s, mgr, "c11 (b)")
        dirty_case("a tombstone", lambda: g.remove(
            int(g.get_incidence_set(a0).array()[0])), "dirty")
        join_route_check(s, "c11 (b)", rtx)
    finally:
        rtx.close()

    # -- (c) hub anchors through the degree split
    compact_now(s, mgr, "c11 (c)")
    base = mgr.base
    off = neighbor_csr(base, s.dev)[0].astype(np.int64)
    pool = np.asarray(sorted(set(anchors)), dtype=np.int64)
    width = off[pool + 1] - off[pool]
    widest = pool[np.argsort(-width, kind="stable")[:16]].tolist()
    threshold = int(np.sort(width)[-16]) - 1
    rth = ServeRuntime(g, ServeConfig(buckets=(16,), join_hub_threshold=
                                      threshold, **cfg_x))
    try:
        futs = [rth.submit_join(c11_spec(a)) for a in widest]
        drain(rth)
        check_joins(s, "c11 (c) hub anchors", g, widest, futs, C11_TOP_R)
        s.expect(rth.stats.join_hub_dispatches > 0
                 and rth.stats.device_dispatches == 1,
                 f"join c11 (c): hub dispatches "
                 f"{rth.stats.join_hub_dispatches}, device dispatches "
                 f"{rth.stats.device_dispatches}")
        join_route_check(s, "c11 (c)", rth)
    finally:
        rth.close()
    s.log(f"join c11 (c): the 16 widest anchors (co rows "
          f"{int(np.sort(width)[-16])}..{int(width.max())}) at hub threshold "
          f"{threshold}: {rth.stats.join_hub_dispatches} lanes through the "
          f"hub chain, equal to host_join")

    ms256, rtp = alone[256]

    def one_batch():
        futs = [rtp.submit_join(c11_spec(a)) for a in anchors[:256]]
        drain(rtp)
        futs[-1].result(timeout=SV_WAIT_S)

    def close():
        rtp.close()
        mgr.close()
        g.close()

    s.profile_later("serve c11 256-lane join batch", one_batch,
                    float(np.median(ms256)), reps=3, teardown=close)


def join_pushdown(s: Smoke) -> None:
    """(d): ``find_all`` of co-incidence conjunctions over phase 15's hubs
    (after a compaction folds its edits) at the default ``QueryConfig``,
    on the host plan (``prefer_device=False``) and on the device arm
    (``host_cost_bytes`` pinned open, as the reference's tests reach it),
    all equal; the arm the default took, the cost model's two estimates
    and the wall times. Fails unless some query ran on the device arm."""
    import numpy as np

    from hypergraphdb_tpu_torch.join import planner
    from hypergraphdb_tpu_torch.query import conditions as qc
    from hypergraphdb_tpu_torch.query.compiler import compile_query

    g, mgr, hubs = s.query_graph
    compact_now(s, mgr, "pushdown")
    h1, h2, h3 = hubs
    conds = {
        "co(h1) & co(h2)": qc.And(qc.CoIncident(h1), qc.CoIncident(h2)),
        "co(h1) & inc(h2)": qc.And(qc.CoIncident(h1), qc.Incident(h2)),
        "co(h2) & co(h3)": qc.And(qc.CoIncident(h2), qc.CoIncident(h3)),
        "co(h1) & co(h2) & co(h3)": qc.And(
            qc.CoIncident(h1), qc.CoIncident(h2), qc.CoIncident(h3)),
    }
    cfg = g.config.query

    def arms():
        return {k: v for k, v in g.metrics.counters.items()
                if k.startswith("query.join.")}

    def run(cond):
        before = arms()
        s.torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = np.asarray(sorted(int(h) for h in g.find_all(cond)))
        s.torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        arm = [k for k, v in arms().items() if v != before.get(k, 0)]
        return got, ms, (arm[0].rsplit(".", 1)[1] if arm
                         else "host under device_min_batch")

    device_runs = 0
    rec = {}
    for name, cond in conds.items():
        plan = compile_query(g, cond).plan
        s.expect(type(plan).__name__ == "DeviceJoinPlan",
                 f"pushdown {name}: planned {plan.describe()}")
        cfg.prefer_device = False
        try:
            host, host_ms, _ = run(cond)
            host_ms = min(host_ms, run(cond)[1])
        finally:
            cfg.prefer_device = True
        base = mgr.base
        t0 = time.perf_counter()
        jp = planner.plan_join(base, plan.pattern, plan.sig, plan.consts)
        plan_ms = (time.perf_counter() - t0) * 1e3
        dev_cost, host_cost = plan.costs(g, base, jp, s.dev)
        got, ms, arm = run(cond)
        s.expect(np.array_equal(got, host),
                 f"pushdown {name}: default arm {arm} gave {len(got)} ids, "
                 f"the host plan {len(host)}")
        device_runs += arm == "device"
        saved = planner.host_cost_bytes
        planner.host_cost_bytes = lambda *_: float("inf")
        try:
            forced = [run(cond) for _ in range(3)]
        finally:
            planner.host_cost_bytes = saved
        for fgot, _, farm in forced:
            s.expect(farm == "device" and np.array_equal(fgot, host),
                     f"pushdown {name}: the device arm ({farm}) gave "
                     f"{len(fgot)} ids, the host plan {len(host)}")
        dev_ms = [f[1] for f in forced]
        device_runs += 1
        rec[name] = dict(ids=len(host), default_arm=arm, default_ms=ms,
                         host_ms=host_ms, device_ms=dev_ms,
                         plan_join_ms=plan_ms, device_cost=dev_cost,
                         host_cost=host_cost)
        s.log(f"pushdown {name}: {len(host)} ids equal on every arm; the "
              f"default took {arm} ({ms:.3f} ms); cost model: device "
              f"{dev_cost:.0f} bytes, host {host_cost:.0f} bytes (probe "
              f"bytes {planner.PROBE_BYTES}, device_min_batch "
              f"{cfg.device_min_batch}); host plan {host_ms:.3f} ms, device "
              f"arm {', '.join(f'{x:.3f}' for x in dev_ms)} ms (the first "
              f"pays the co-incidence build if none was on the card); "
              f"plan_join alone {plan_ms:.3f} ms")
    n_default = sum(r_["default_arm"] == "device" for r_ in rec.values())
    note = ""
    if not n_default:
        # none qualified at the default: the first query once more with
        # device_min_batch lowered to 0, so the cost compare alone decides
        name, cond = next(iter(conds.items()))
        dmb = cfg.device_min_batch
        cfg.device_min_batch = 0
        try:
            got, ms, arm = run(cond)
        finally:
            cfg.device_min_batch = dmb
        s.expect(np.array_equal(got, np.asarray(sorted(
            int(h) for h in g.find_all(cond)))),
            f"pushdown {name}: device_min_batch 0 changed the answer")
        note = (f"; with device_min_batch 0 {name} took {arm} ({ms:.3f} "
                f"ms); the device arm was reached with the host cost "
                f"pinned open")
    s.log(f"pushdown: {n_default} of {len(rec)} queries took the device arm "
          f"at the default QueryConfig{note}; record " + json.dumps(rec))
    s.expect(device_runs > 0, "pushdown: no query ran on the device arm")


def phase_join_serve(s: Smoke) -> None:
    """Phase 17: the join lane, driven by bench c11 (see
    :func:`serve_c11`), and the front door's join pushdown
    (:func:`join_pushdown`)."""
    t0 = time.perf_counter()
    serve_c11(s)
    join_pushdown(s)
    s.log(f"join: phase 17 in {time.perf_counter() - t0:.1f} s")


def phase_profiles(s: Smoke) -> None:
    """The device's busy share of each path queued by the timed phases,
    from ``torch.profiler``: the kernels, copies and fills it records on
    the card, summed, against the path's unprofiled wall time. Runs after
    every timed phase, because once a profile has run the tracer stays
    attached and slows every later launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch = s.torch
    for name, fn, unprofiled_ms, reps, setup, teardown in s.profiles:
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        if teardown is not None:
            teardown()
        events = prof.key_averages()
        # a named range shows on the device timeline too, spanning its
        # kernels and the gaps between them: not an operation of its own
        rows = [e for e in events if e.device_type == DeviceType.CUDA
                and not e.key.startswith("join.")]
        rows.sort(key=lambda e: -e.self_device_time_total)
        busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / reps
        n_ops = sum(e.count for e in rows) / reps
        top = "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} "
                        f"ms x{e.count}" for e in rows[:8])
        s.log(f"profile {name} ({reps} runs): device busy {busy_ms:.4f} ms "
              f"a run of {unprofiled_ms:.3f} ms wall unprofiled "
              f"({100 * busy_ms / unprofiled_ms:.1f} %), {n_ops:.1f} device "
              f"operations a run; top: {top}")
        # named ranges (the join's binary searches): device time of the
        # operations launched inside each
        ranges = [e for e in events if e.key.startswith("join.")
                  and e.device_type == DeviceType.CPU]
        if ranges:
            s.log(f"profile {name}: " + "; ".join(
                f"{e.key} {e.device_time_total / 1e3 / reps:.3f} ms a run "
                f"({100 * e.device_time_total / 1e3 / reps / busy_ms:.1f} % "
                f"of busy) x{e.count / reps:.0f}" for e in ranges))


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
        truth = phase_main(s, snap, info, records)
        n_k3 = phase_intersect(s, snap, info)
        phase_pattern(s, snap, info)
        phase_k3_timing(s, snap, n_k3, records)
        phase_delta(s, snap, info, truth, records)
        join_rec = phase_join(s, snap, info)
        phase_values(s, snap, info, join_rec)
        phase_packed(s, snap, truth)
        phase_persist(s, snap, truth)
        phase_ingest(s)
        phase_query(s, records)
        phase_serve(s)
        phase_join_serve(s)
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
