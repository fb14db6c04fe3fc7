"""The serve plane's failure paths, port against reference: every case of
``tests/test_serve_fault.py`` (transient retries, exponential capped
backoff with seeded jitter, permanent failures, deadline-aware backoff,
breaker trips to the host path and half-open recovery, collect recovery,
the fault-off dispatch order) runs as one scenario through both packages'
``ServeRuntime``: manual mode, one :class:`FakeClock` shared by the
runtime and an injected sleeper (sleeping advances the clock), and a
scripted :class:`FlakyExecutor`. The records — the executor's events,
every future's outcome, the backoff sleeps, the breaker's states, the
stats — must be equal; under one ``retry_seed`` the sleep sequences are
equal to the last bit. Then the real executor's fault sites on a small
graph: an armed ``serve.launch`` retries, an armed ``serve.collect``
re-serves the batch on the host under the same epoch, and the breaker's
host path answers exactly. No threads; tolerance: exact equality."""

from __future__ import annotations

import numpy as np
import pytest

from tests.test_torch_serve_runtime import (
    PKGS,
    FakeClock,
    FakeExecutor,
    outcome,
    package,
    run_both,
    view,
)


class FlakyExecutor:
    """Scripted failures: the first ``fail_launches`` device launches and
    the first ``fail_collects`` device collects raise ``error``. Honors
    ``batch.force_host`` and implements the ``collect_host`` hook."""

    def __init__(self, P, fail_launches=0, fail_collects=0, error=None):
        self.P = P
        self.fail_launches = fail_launches
        self.fail_collects = fail_collects
        self.error = error or P.fault.TransientFault
        self.events: list[tuple] = []
        self.batches: list = []

    def _results(self, batch, served_by):
        return [(t, self.P.types.ServeResult(
            t.request.kind, 0, np.empty(0, dtype=np.int64), False, 0,
            served_by)) for t in batch.tickets]

    def launch(self, batch):
        if batch.force_host:
            self.events.append(("host", len(self.batches)))
            self.batches.append(batch)
            return ("host", batch)
        if self.fail_launches > 0:
            self.fail_launches -= 1
            self.events.append(("launch_fail",))
            raise self.error("device fell over at launch")
        self.events.append(("launch", len(self.batches)))
        self.batches.append(batch)
        return ("device", batch)

    def collect(self, token):
        kind, batch = token
        if kind == "device" and self.fail_collects > 0:
            self.fail_collects -= 1
            self.events.append(("collect_fail",))
            raise self.error("device fell over at collect")
        self.events.append(("collect", kind))
        return self._results(batch, "fake" if kind == "device" else "host")

    def collect_host(self, token):
        _, batch = token
        self.events.append(("collect_host",))
        return self._results(batch, "host")


def make_runtime(P, ex=None, linger=0.0, **kw):
    clock = FakeClock()
    sleeps: list[float] = []

    def sleep(dt):
        sleeps.append(dt)
        clock.advance(dt)

    kw.setdefault("retry_base_s", 0.01)
    kw.setdefault("retry_max_s", 0.08)
    cfg = P.serve.ServeConfig(buckets=(4, 16), max_linger_s=linger,
                              clock=clock, manual=True, sleep=sleep, **kw)
    ex = ex if ex is not None else FlakyExecutor(P)
    rt = P.serve.ServeRuntime(graph=None, config=cfg, executor=ex)
    return rt, ex, clock, sleeps


def identity(rt) -> bool:
    """The accounting identity with the queue drained: submitted ==
    completed + shed + cancelled + errors."""
    s = rt.stats
    return (s.submitted == s.completed + s.shed_deadline + s.cancelled
            + s.errors and rt.queue.depth() == 0)


def record(rt, ex, sleeps, *futs, keys=(("bfs", 2),)):
    return {"outcomes": [outcome(f) for f in futs], "sleeps": sleeps,
            "breaker": [rt.breaker.state_of(k) for k in keys],
            "identity": identity(rt), **view(rt, ex)}


# ---------------------------------------------------------------- scenarios


def transient_retry(P):
    rt, ex, clock, sleeps = make_runtime(P, FlakyExecutor(P, 1))
    fut = rt.submit_bfs(1)
    rt.step(drain=True)
    return record(rt, ex, sleeps, fut)


def backoff_exponential_capped(P):
    rt, ex, clock, sleeps = make_runtime(P, FlakyExecutor(P, 3),
                                         max_retries=5, breaker_threshold=99)
    fut = rt.submit_bfs(1)
    rt.step(drain=True)
    return record(rt, ex, sleeps, fut)


def jitter_seeded(P):
    def sleeps_for(seed):
        rt, ex, clock, sleeps = make_runtime(
            P, FlakyExecutor(P, 2), retry_seed=seed, max_retries=5,
            breaker_threshold=99)
        rt.submit_bfs(1)
        rt.step(drain=True)
        return sleeps

    return sleeps_for(4), sleeps_for(4), sleeps_for(5)


def permanent_no_retry(P):
    rt, ex, clock, sleeps = make_runtime(
        P, FlakyExecutor(P, 5, error=P.fault.PermanentFault))
    fut = rt.submit_bfs(1)
    rt.step(drain=True)
    return record(rt, ex, sleeps, fut)


def retry_budget_exhausted(P):
    rt, ex, clock, sleeps = make_runtime(P, FlakyExecutor(P, 10),
                                         max_retries=2, breaker_threshold=99)
    fut = rt.submit_bfs(1)
    rt.step(drain=True)
    return record(rt, ex, sleeps, fut)


def backoff_sheds_past_deadline(P):
    rt, ex, clock, sleeps = make_runtime(
        P, FlakyExecutor(P, 10), retry_base_s=1.0, retry_max_s=2.0,
        max_retries=5, breaker_threshold=99)
    fut = rt.submit_bfs(1, deadline_s=0.5)
    rt.step(drain=True)
    return record(rt, ex, sleeps, fut)


def backoff_keeps_live(P):
    rt, ex, clock, sleeps = make_runtime(
        P, FlakyExecutor(P, 1), retry_base_s=1.0, retry_max_s=2.0,
        retry_jitter=0.0, max_retries=5, breaker_threshold=99)
    doomed = rt.submit_bfs(1, deadline_s=0.5)
    live = rt.submit_bfs(2, deadline_s=10.0)
    rt.step(drain=True)
    rec = record(rt, ex, sleeps, doomed, live)
    rec["seeds"] = [t.request.seed for t in ex.batches[0].tickets]
    return rec


def breaker_trips_and_recovers(P):
    rt, ex, clock, sleeps = make_runtime(
        P, FlakyExecutor(P, 2), breaker_threshold=2, breaker_cooldown_s=1.0,
        max_retries=5)
    steps = []
    futs = []
    for seed, advance in ((1, 0.0), (2, 0.0), (3, 1.5), (4, 0.0)):
        clock.advance(advance)
        futs.append(rt.submit_bfs(seed))
        rt.step(drain=True)
        steps.append((rt.breaker.state_of(("bfs", 2)),
                      rt.stats.snapshot()["breaker_state"],
                      rt.stats.breaker_trips))
    rec = record(rt, ex, sleeps, *futs)
    rec["steps"] = steps
    rec["key_states"] = rt.stats.breaker_key_states()
    return rec


def breaker_probe_failure(P):
    rt, ex, clock, sleeps = make_runtime(
        P, FlakyExecutor(P, 10), breaker_threshold=1,
        breaker_cooldown_s=1.0, max_retries=0)
    f1 = rt.submit_bfs(1)
    rt.step(drain=True)
    clock.advance(1.5)
    f2 = rt.submit_bfs(2)
    rt.step(drain=True)
    return record(rt, ex, sleeps, f1, f2)


def breaker_per_key(P):
    rt, ex, clock, sleeps = make_runtime(P, FlakyExecutor(P, 1),
                                         breaker_threshold=1, max_retries=0)
    fb = rt.submit_bfs(1)
    rt.step(drain=True)
    fp = rt.submit_pattern([1, 2])
    rt.step(drain=True)
    return record(rt, ex, sleeps, fb, fp,
                  keys=(("bfs", 2), ("pattern", 2)))


def collect_recovers_on_host(P):
    rt, ex, clock, sleeps = make_runtime(P, FlakyExecutor(P, 0, 1))
    fut = rt.submit_bfs(1)
    rt.step(drain=True)
    return record(rt, ex, sleeps, fut)


class NoHookExecutor(FakeExecutor):
    """Fails its first collect and has no ``collect_host`` hook."""

    boom = True

    def collect(self, token):
        if self.boom:
            self.boom = False
            raise self.P.fault.TransientFault("collect fell over")
        return super().collect(token)


def collect_without_hook(P):
    rt, ex, clock, sleeps = make_runtime(P, NoHookExecutor(P))
    f1 = rt.submit_bfs(1)
    rt.step(drain=True)
    f2 = rt.submit_bfs(2)
    rt.step(drain=True)
    return record(rt, ex, sleeps, f1, f2)


def permanent_collect_failure(P):
    rt, ex, clock, sleeps = make_runtime(
        P, FlakyExecutor(P, 0, 1, error=P.fault.PermanentFault))
    fut = rt.submit_bfs(1)
    rt.step(drain=True)
    return record(rt, ex, sleeps, fut)


def faults_off_order(P):
    """With the fault layer disabled the dispatch order is the pipeline's
    and the registry is never entered (its ``check`` is poisoned)."""
    reg = P.fault.FaultRegistry()

    def boom(name, **ctx):
        raise AssertionError(f"fault check {name!r} reached while disabled")

    reg.check = boom
    clock = FakeClock()
    cfg = P.serve.ServeConfig(buckets=(4, 16), max_linger_s=0.010,
                              clock=clock, manual=True, faults=reg)
    ex = FakeExecutor(P)
    rt = P.serve.ServeRuntime(graph=None, config=cfg, executor=ex)
    enabled = rt.faults.enabled
    rt.submit_bfs(1)
    rt.submit_bfs(2)
    rt.pump(drain=True)
    rt.submit_pattern([1, 2])
    rt.submit_bfs(3, max_hops=5)
    clock.advance(0.02)
    while rt.pump(drain=True):
        pass
    rt.close(drain=True)
    return enabled, identity(rt), view(rt, ex)


class SiteExecutor(FakeExecutor):
    """A fake executor that honors the executor-site idiom."""

    def __init__(self, P, faults):
        super().__init__(P)
        self.faults = faults

    def launch(self, batch):
        if self.faults.enabled:
            self.faults.check("serve.launch", kind=batch.key[0])
        return super().launch(batch)


def injected_registry(P):
    faults = P.fault.FaultRegistry().enable(seed=0)
    faults.arm("serve.launch", times=1)
    clock = FakeClock()
    sleeps = []

    def sleep(dt):
        sleeps.append(dt)
        clock.advance(dt)

    cfg = P.serve.ServeConfig(buckets=(4,), max_linger_s=0.0, clock=clock,
                              manual=True, faults=faults, sleep=sleep,
                              retry_base_s=0.001)
    ex = SiteExecutor(P, faults)
    rt = P.serve.ServeRuntime(graph=None, config=cfg, executor=ex)
    fut = rt.submit_bfs(1)
    rt.step(drain=True)
    return (record(rt, ex, sleeps, fut), faults.fired("serve.launch"),
            faults.journal)


SCENARIOS = {
    "transient_retry": transient_retry,
    "backoff_exponential_capped": backoff_exponential_capped,
    "jitter_seeded": jitter_seeded,
    "permanent_no_retry": permanent_no_retry,
    "retry_budget_exhausted": retry_budget_exhausted,
    "backoff_sheds_past_deadline": backoff_sheds_past_deadline,
    "backoff_keeps_live": backoff_keeps_live,
    "breaker_trips_and_recovers": breaker_trips_and_recovers,
    "breaker_probe_failure": breaker_probe_failure,
    "breaker_per_key": breaker_per_key,
    "collect_recovers_on_host": collect_recovers_on_host,
    "collect_without_hook": collect_without_hook,
    "permanent_collect_failure": permanent_collect_failure,
    "faults_off_order": faults_off_order,
    "injected_registry": injected_registry,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fault_scenario_matches_reference(name):
    run_both(SCENARIOS[name])


def test_scenarios_show_what_they_test():
    """The reference suite's own assertions, on the port's records."""
    P = package(PKGS[1])
    r = transient_retry(P)
    assert r["outcomes"] == [("ok", "bfs", 0, "fake", False)]
    assert len(r["sleeps"]) == 1 and 0.01 <= r["sleeps"][0] <= 0.015
    assert r["events"][0] == ("launch_fail",) and r["identity"]
    r = backoff_exponential_capped(P)
    assert [b <= dt <= 1.5 * b for dt, b in
            zip(r["sleeps"], (0.01, 0.02, 0.04))] == [True] * 3
    a, a2, b = jitter_seeded(P)
    assert a == a2 and a != b
    assert permanent_no_retry(P)["sleeps"] == []
    assert retry_budget_exhausted(P)["stats"]["retries"] == 2
    r = backoff_sheds_past_deadline(P)
    assert r["sleeps"] == [] and r["outcomes"] == [
        ("raise", "DeadlineExceeded")]
    r = backoff_keeps_live(P)
    assert r["sleeps"] == [1.0] and r["seeds"] == [2]
    r = breaker_trips_and_recovers(P)
    assert [o[3] for o in r["outcomes"]] == ["host", "host", "fake", "fake"]
    assert r["steps"][0] == ("open", 2, 1) and r["steps"][2] == (
        "closed", 0, 1)
    assert r["stats"]["completed"] == 4 and r["identity"]
    r = breaker_per_key(P)
    assert [o[3] for o in r["outcomes"]] == ["host", "fake"]
    assert r["breaker"] == ["open", "closed"]
    assert ("collect_host",) in collect_recovers_on_host(P)["events"]
    enabled, ident, v = faults_off_order(P)
    assert enabled is False and ident and v["events"] == [
        ("launch", 0), ("launch", 1), ("collect", 0), ("launch", 2),
        ("collect", 1), ("collect", 2)]
    rec, fired, journal = injected_registry(P)
    assert fired == 1 and journal == [("serve.launch", 1)]
    assert rec["stats"]["retries"] == 1


# ------------------------------------------------ the real executor's sites


def small_graph(pkg):
    """The same small graph in both packages (the reference's random
    hypergraph fixture), incremental on the CPU."""
    from tests.conftest import make_random_hypergraph
    from tests.test_torch_graph import new_graph

    g = new_graph(pkg)
    nodes, links = make_random_hypergraph(g, n_nodes=60, n_links=120,
                                          max_arity=3, seed=5)
    kw = {"device": "cpu"} if pkg == PKGS[1] else {}
    g.enable_incremental(background=False, compact_ratio=100.0, **kw)
    return g, [int(n) for n in nodes]


def real_runtime(pkg, faults, **kw):
    P = package(pkg)
    g, nodes = small_graph(pkg)
    if pkg == PKGS[1]:
        kw["device"] = "cpu"
    cfg = P.serve.ServeConfig(buckets=(64,), max_linger_s=0.0, manual=True,
                              top_r=512, faults=faults, sleep=lambda dt: None,
                              **kw)
    return g, nodes, P.serve.ServeRuntime(g, cfg)


@pytest.mark.parametrize("point", ["serve.launch", "serve.collect"])
def test_real_executor_fault_sites_match_reference(point):
    """One armed transient fault at the executor's site: at launch the
    ladder retries the device (one retry); at collect the batch re-serves
    on the host under the pinned epoch. Either way every answer equals the
    reference runtime's under the same fault."""
    got = {}
    for pkg in PKGS:
        P = package(pkg)
        faults = P.fault.FaultRegistry().enable(seed=0)
        faults.arm(point, times=1, when=lambda ctx: ctx["kind"] == "bfs")
        g, nodes, rt = real_runtime(pkg, faults)
        try:
            futs = [rt.submit_bfs(n, max_hops=2) for n in nodes[:5]]
            futs += [rt.submit_pattern([nodes[0]])]
            while rt.step(drain=True):
                pass
            out = [(r.count, r.matches.tolist(), r.served_by)
                   for r in (f.result(timeout=0) for f in futs)]
            st = rt.stats_snapshot()
            got[pkg] = (out, st["retries"], st["host_fallbacks"],
                        st["breaker_trips"], faults.fired(point))
        finally:
            rt.close()
            g.close()
    assert got[PKGS[1]] == got[PKGS[0]]
    out, retries, host, trips, fired = got[PKGS[1]]
    assert retries == 1 and fired == 1 and trips == 0
    assert [o[2] for o in out[:5]] == (
        ["device"] * 5 if point == "serve.launch" else ["host"] * 5)


def test_breaker_host_path_answers_exactly_like_the_device():
    """Three device failures trip the ("bfs", 2) breaker: the tripping
    batch and the next one serve on the host, their answers equal to the
    device lane's and the reference's."""
    got = {}
    for pkg in PKGS:
        P = package(pkg)
        faults = P.fault.FaultRegistry().enable(seed=0)
        g, nodes, rt = real_runtime(pkg, faults, breaker_threshold=1,
                                    max_retries=0)
        try:
            clean = [rt.submit_bfs(n) for n in nodes[:8]]
            while rt.step(drain=True):
                pass
            faults.arm("serve.launch", times=1)
            tripped = [rt.submit_bfs(n) for n in nodes[:8]]
            while rt.step(drain=True):
                pass
            res = [[(r.count, r.matches.tolist(), r.served_by)
                    for r in (f.result(timeout=0) for f in fs)]
                   for fs in (clean, tripped)]
            got[pkg] = (res, rt.stats.breaker_trips,
                        rt.breaker.state_of(("bfs", 2)))
        finally:
            rt.close()
            g.close()
    assert got[PKGS[1]] == got[PKGS[0]]
    (clean, tripped), trips, state = got[PKGS[1]]
    assert trips == 1 and state == "open"
    assert [c[:2] for c in clean] == [t[:2] for t in tripped]
    assert {t[2] for t in tripped} == {"host"}
