"""``runner: serve_closed``: ``clients`` clients in a closed loop, each
sending its next ``submit_bfs`` (``hops`` hops, a fresh seed) when its
last one completes; completion callbacks hand the client back to one
submitting thread. No deadline. ``served_rps``: answers completed inside
the window over its length. With tracing, the window is
``trace_seconds`` under the profiler.

Set-up builds the configuration's served system and sends every bucket
of its ``serve`` settings one full batch before the window.

``correct``: every request of the window answered, none failed, and a
sample of the answers kept (a seeded :data:`KEEP_SHARE` of them):
``check_requests`` drawn from the seed and the largest reach among them,
against the plain reference (:func:`check`).
"""

from __future__ import annotations

import queue
import time

import numpy as np

from hgbench import judge, traffic
from hgbench.reference import bfs as ref_bfs
from hgbench.run_state import Run, free_device

#: seconds past the window's close that an answer may still come in
LATE_S = 60.0
#: the share of a window's answers kept for the reference to check (a
#: seeded draw); the rest are read as they complete and dropped, so the
#: benchmark holds no Python object a request and adds nothing to the
#: collector's passes over the program's heap
KEEP_SHARE = 1 / 64
#: the most answers a second a window makes room for
MAX_RPS = 40_000
#: a request's outcome: not yet, answered, failed
PENDING, OK, ERROR = 0, 1, 2


def keep_mask(seed: int, n: int) -> np.ndarray:
    """Which of a window's first ``n`` requests keep their answers."""
    return traffic.stream(seed, traffic.KEEP).random(n) < KEEP_SHARE


def pick(seed: int, counts: list, n: int) -> list:
    """Positions among the kept answers that the reference checks: ``n``
    drawn from the seed, and the one with the largest reach."""
    out = traffic.sample(seed, len(counts), n).tolist()
    if counts:
        big = int(np.argmax(counts))
        if big not in out:
            out.append(big)
    return out


def check(tables: dict, hops: int, top_r: int, seeds, got: list, e0: int,
          answer=ref_bfs.answer) -> list:
    """The comparison a run makes: the answers given (``count``,
    ``truncated``, ``matches`` in handles, the first entity's ``e0``) to
    requests from the entities ``seeds`` against ``answer``'s, the plain
    reference."""
    want = answer(tables, seeds, hops)
    return judge.answers(
        got, [e0 + want.reach_set(i) for i in range(len(seeds))], top_r)


class _Requests:
    """Every request of a window as numpy columns: completion time, seed
    (an entity index) and outcome; the answers of the kept share."""

    def __init__(self, seed: int, capacity: int):
        self.n = 0
        self.done = np.full(capacity, np.nan)
        self.seed = np.zeros(capacity, dtype=np.int64)
        self.outcome = np.zeros(capacity, dtype=np.int8)
        self.keep = keep_mask(seed, capacity)
        self.kept: dict = {}  # i -> (count, truncated, matches)
        self.first_error = None

    def add(self, seed: int, fut, on_done) -> None:
        i = self.n
        if i == len(self.seed):
            raise RuntimeError(f"more than {i} requests in one window")
        self.seed[i] = seed
        self.n += 1
        fut.add_done_callback(lambda f: self._finished(i, f, on_done))

    def _finished(self, i: int, f, on_done) -> None:
        self.done[i] = time.perf_counter()
        exc = f.exception()
        if exc is None:
            if self.keep[i]:
                r = f.result()
                self.kept[i] = (int(r.count), bool(r.truncated),
                                np.asarray(r.matches, dtype=np.int64))
            code = OK
        else:
            self.first_error = self.first_error or repr(exc)
            code = ERROR
        # the outcome last: a request with one has its time and answer
        self.outcome[i] = code
        on_done(i)

    def wait(self, deadline: float) -> None:
        """Until every request has an outcome, or ``deadline``."""
        while ((self.outcome[: self.n] == PENDING).any()
               and time.perf_counter() < deadline):
            time.sleep(0.005)


def answered_by(done: np.ndarray, outcome: np.ndarray, end: float) -> int:
    """How many requests were answered at or before ``end``."""
    return int(((outcome == OK) & (done <= end)).sum())


def _setup(r: Run):
    cfg, mix = r.cell.config, r.cell.mix
    with r.span("setup.build"):
        tables = r.cell.generator().draw(cfg, r.seed)
        sv = r.cell.system().build(cfg, tables, r.dev)
    with r.span("setup.serve"):
        sv.serve(cfg, r.dev)
    with r.span("setup.warm"):
        warm = traffic.Requests(r.seed, *tables["entities"], traffic.WARM)
        for b in cfg["serve"]["buckets"]:
            futs = [sv.rt.submit_bfs(int(h), max_hops=mix["hops"])
                    for h in sv.handles(warm.take(b))]
            for f in futs:
                f.result(timeout=LATE_S)
    sv.rt.stats.reset()
    sv.executor_timing_reset()
    r.setup_done()
    return tables, sv


def _counters(r: Run, sv) -> None:
    occ = sv.rt.stats.occupancy()
    r.counters["occupancy"] = None if occ is None else 100.0 * occ
    t = dict(sv.rt.executor.timing.get("bfs", {}))
    n = t.get("batches", 0)
    r.counters["batches"] = n
    for key in ("launch", "collect"):
        if n and f"{key}_s" in t:
            r.counters[f"{key}_ms"] = t[f"{key}_s"] * 1e3 / n


def run(r: Run) -> None:
    cfg, mix = r.cell.config, r.cell.mix
    tables, sv = _setup(r)
    seeds = traffic.Requests(r.seed, *tables["entities"])
    seconds = (min(r.seconds, mix["trace_seconds"]) if r.tracer.enabled
               else r.seconds)
    reqs = _Requests(r.seed, int(MAX_RPS * seconds) + mix["clients"])
    back: queue.SimpleQueue = queue.SimpleQueue()

    def submit() -> None:
        s = seeds.next()
        reqs.add(s, sv.rt.submit_bfs(int(sv.e0 + s), max_hops=mix["hops"]),
                 back.put)

    with r.tracer.window(r.sync):
        end = time.perf_counter() + seconds
        for _ in range(mix["clients"]):
            submit()
        while True:
            left = end - time.perf_counter()
            if left <= 0:
                break
            try:
                back.get(timeout=left)
            except queue.Empty:
                break
            submit()
        reqs.wait(end + LATE_S)
    _counters(r, sv)
    out = reqs.outcome[: reqs.n]
    served = answered_by(reqs.done[: reqs.n], out, end)
    r.e2e["served_rps"] = served / seconds
    r.attempted = reqs.n
    r.failed = int((out != OK).sum())
    r.note(f"{served} answered in the {seconds:.1f} s window, "
           f"{reqs.n} submitted, {r.failed} failed")
    if reqs.first_error:
        r.note(f"request failed: {reqs.first_error}")
    r.read_peak()
    r.checks += judge.outcomes((out == ERROR).sum(), (out == PENDING).sum())

    kept = sorted(reqs.kept)
    chosen = [kept[j] for j in pick(r.seed, [reqs.kept[i][0] for i in kept],
                                    mix["check_requests"])]
    e0 = sv.e0
    sv.close()
    free_device()
    t_ref = time.perf_counter()
    r.checks += check(tables, mix["hops"], cfg["serve"]["top_r"],
                      reqs.seed[chosen], [reqs.kept[i] for i in chosen], e0)
    r.note(f"reference: {len(chosen)} answers in "
           f"{time.perf_counter() - t_ref:.1f} s")


def control(cell, seed: int, answer) -> list:
    """The comparison of a run, with ``answer`` (the reference with a
    guarantee broken) answering in the program's place, over the kept
    answers of a window of the mix's ``control_requests`` requests."""
    cfg, mix = cell.config, cell.mix
    hops, top_r = mix["hops"], cfg["serve"]["top_r"]
    tables = cell.generator().draw(cfg, seed)
    seeds = traffic.Requests(seed, *tables["entities"]).take(
        mix["control_requests"])
    seeds = seeds[keep_mask(seed, len(seeds))]
    got = answer(tables, seeds, hops)
    given = judge.served_as([got.reach_set(i) for i in range(len(seeds))],
                            top_r)
    chosen = pick(seed, [g[0] for g in given], mix["check_requests"])
    return (judge.outcomes(0, 0)
            + check(tables, hops, top_r, seeds[chosen],
                    [given[i] for i in chosen], 0))
