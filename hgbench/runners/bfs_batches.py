"""``runner: bfs_batches``: closed loop, one caller. Batches of ``batch``
seeds drawn from the entities, each a new draw, through
``ellbfs.bfs_pull`` (fused, one ``k_block`` block, ``hops`` hops); each
batch's reach counts and edge totals to the host. The window closes at
the first batch end past ``--seconds``; ``traversals_per_s`` is the lanes
completed over the window. With tracing, the window is ``trace_batches``
batches under the profiler.

``correct``: after the window, ``check_lanes_per_warp`` lanes in every 32
of a batch, each from a batch drawn from the seed, have their reach count
and edge total compared, and ``check_sets`` lanes of the last batch, one
in each block of ``batch / check_sets``, their whole reach sets, against
the plain reference (:func:`check`).
"""

from __future__ import annotations

import time

import numpy as np

from hgbench import judge, traffic
from hgbench.reference import bfs as ref_bfs
from hgbench.run_state import Run, free_device

#: the lanes the program handles together in a warp
WARP = 32


def sample(seed: int, mix: dict, n_batches: int) -> tuple:
    """(batch and lane of each lane whose count and edge total are
    checked, the lanes of the last batch whose reach sets are)."""
    K = mix["batch"]
    lanes = traffic.spread_lanes(seed, K, WARP, mix["check_lanes_per_warp"],
                                 traffic.SAMPLE)
    batches = traffic.stream(seed, traffic.SAMPLE, 1).integers(
        0, n_batches, size=len(lanes))
    sets = traffic.spread_lanes(seed, K, max(1, K // mix["check_sets"]), 1,
                                traffic.SETS)
    return list(zip(batches.tolist(), lanes.tolist())), sets.tolist()


def check(tables: dict, hops: int, lane_seeds, counts, edges, set_seeds,
          set_words: np.ndarray, answer=ref_bfs.answer) -> list:
    """The comparison a run makes: the answers given (``counts`` and
    ``edges`` of the lanes seeded ``lane_seeds``; the reach sets of the
    lanes seeded ``set_seeds`` as the bits of ``set_words``, lane ``j``
    bit ``j``) against ``answer``'s, the plain reference."""
    m = len(set_seeds)
    want = answer(tables, np.concatenate([np.asarray(set_seeds, np.int64),
                                          np.asarray(lane_seeds, np.int64)]),
                  hops)
    mask = np.uint64((1 << m) - 1)
    return (judge.lanes(counts, edges, want.counts[m:], want.edges[m:])
            + judge.reach_sets(set_words, want.seen[0] & mask))


def _set_words(visited_t, n_atoms: int, lanes: list) -> np.ndarray:
    """The reach sets of ``lanes`` of a transposed (rows, K/32) bitmap as
    one ``uint64`` word an atom, lane ``lanes[j]`` at bit ``j``."""
    import torch

    acc = torch.zeros(n_atoms, dtype=torch.int64, device=visited_t.device)
    for j, k in enumerate(lanes):
        bit = (visited_t[:n_atoms, k >> 5] >> (k & 31)) & 1
        acc |= bit.to(torch.int64) << j
    return acc.cpu().numpy().view(np.uint64)


def run(r: Run) -> None:
    from hypergraphdb_tpu_torch.ops import ellbfs, fused_bfs

    cfg, mix = r.cell.config, r.cell.mix
    hops, K = mix["hops"], mix["batch"]
    with r.span("setup.build"):
        tables = r.cell.generator().draw(cfg, r.seed)
        snap = r.cell.system().build(cfg, tables)
    with r.span("setup.plans"):
        fused_bfs.device_fused_plan(snap, r.dev)
    e0, e1 = tables["entities"]
    N = tables["n_atoms"]

    def batch(seeds):
        res = ellbfs.bfs_pull(snap, seeds, hops, k_block=mix["k_block"],
                              fused=True, device=r.dev)
        with r.tracer.span("counts_to_host"):
            counts = res.reach_counts.cpu().numpy()
        return res, counts, np.asarray(res.edges_touched)

    with r.span("setup.warm"):
        batch(traffic.batch_seeds(r.seed, 0, K, e0, e1, traffic.WARM))
    r.setup_done()

    done = []  # (seeds, counts, edges) a batch
    res = None
    n_batches = mix["trace_batches"] if r.tracer.enabled else None
    with r.tracer.window(r.sync):
        t0 = time.perf_counter()
        while (len(done) < n_batches if n_batches
               else time.perf_counter() - t0 < r.seconds):
            seeds = traffic.batch_seeds(r.seed, len(done), K, e0, e1)
            res = None  # the last batch's bitmap goes before the next
            with r.tracer.span("batch"):
                res, counts, edges = batch(seeds)
            done.append((seeds, counts, edges))
        elapsed = time.perf_counter() - t0
    r.attempted = len(done) * K
    r.e2e["traversals_per_s"] = len(done) * K / elapsed
    r.note(f"{len(done)} batches of {K} seeds x {hops} hops in "
           f"{elapsed:.3f} s; edges {int(sum(d[2].sum() for d in done))}")
    r.read_peak()
    r.counters["batches"] = len(done)
    r.counters["hops"] = hops
    if r.tracer.enabled:
        r.counters["k2_bound_ms"] = _k2_bound(r, snap, done[0][0], hops)

    lanes, sets = sample(r.seed, mix, len(done))
    last = done[-1][0]
    words = _set_words(res.visited_t, N, sets)
    del res, snap
    free_device()

    t_ref = time.perf_counter()
    r.checks += check(
        tables, hops, [done[b][0][k] for b, k in lanes],
        [done[b][1][k] for b, k in lanes], [done[b][2][k] for b, k in lanes],
        last[sets], words)
    r.note(f"reference: {len(lanes)} lanes and {len(sets)} reach sets in "
           f"{time.perf_counter() - t_ref:.1f} s")


def control(cell, seed: int, answer) -> list:
    """The comparison of a run, with ``answer`` (the reference with a
    guarantee broken) in the program's place, over the lanes of a window
    of the mix's ``control_batches`` batches."""
    cfg, mix = cell.config, cell.mix
    K, hops = mix["batch"], mix["hops"]
    tables = cell.generator().draw(cfg, seed)
    e0, e1 = tables["entities"]
    n_batches = mix["control_batches"]
    lanes, sets = sample(seed, mix, n_batches)
    draws = {b: traffic.batch_seeds(seed, b, K, e0, e1)
             for b in {b for b, _ in lanes} | {n_batches - 1}}
    lane_seeds = [draws[b][k] for b, k in lanes]
    set_seeds = draws[n_batches - 1][sets]
    m = len(set_seeds)
    got = answer(tables, np.concatenate([set_seeds, lane_seeds]), hops)
    return check(tables, hops, lane_seeds, got.counts[m:], got.edges[m:],
                 set_seeds, got.seen[0] & np.uint64((1 << m) - 1))


def _k2_bound(r: Run, snap, seeds, hops: int) -> float:
    """The data bound, in ms, of the K2 launches of one BFS over
    ``seeds``: the traced window's first batch, run again with a hook
    that counts each hop's need (``roofline/k2.py``) from the bitmap
    entering it and the one it produced."""
    import torch

    from hypergraphdb_tpu_torch.ops import fused_bfs

    from hgbench.roofline import k2

    plan, geom = fused_bfs.device_fused_plan(snap, r.dev)
    prev, total = [None], [0.0]

    def hook(h, visited, mask):
        if prev[0] is not None:
            old, old_mask = prev[0]
            ms, _ = k2.hop_bound_ms(old, old_mask, visited, plan.idx,
                                    plan.item_off, plan.item_row, plan.w)
            total[0] += ms
        prev[0] = (visited, mask)

    fused_bfs.bfs_fused(plan, torch.from_numpy(seeds).to(r.dev), geom,
                        hops, False, True, hop_hook=hook)
    return total[0]
