"""The port's serving runtime against the reference's, without a device:
every case of ``tests/test_serve_runtime.py`` runs as one scenario through
both packages' ``ServeRuntime`` with ``ServeConfig(manual=True)`` (no
thread; the block-policy case starts one submitter), one :class:`FakeClock`
and a fake executor whose results are each package's own
``ServeResult``. A scenario returns what a caller and an operator can see
— the executor's launch/collect order, each future's outcome, the stats
snapshot, the queue — and the two records must be equal. Then the port's
own surface: the join entry points reach the executor, the planner and
EXPLAIN entry points refuse what the reference refuses, the sharding
options pick the executor the reference's pick, and
``ServeRuntime(graph)`` asks for the card.

Every future is read with ``timeout=0`` (or a bounded wait in the
threaded case); every thread is joined with a timeout. Tolerance: exact
equality."""

from __future__ import annotations

import importlib
import threading
from types import SimpleNamespace

import numpy as np
import pytest

PKGS = ("hypergraphdb_tpu", "hypergraphdb_tpu_torch")


def package(pkg) -> SimpleNamespace:
    imp = importlib.import_module
    return SimpleNamespace(
        name=pkg, serve=imp(f"{pkg}.serve"), types=imp(f"{pkg}.serve.types"),
        fault=imp(f"{pkg}.fault"))


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class FakeExecutor:
    """Records launch/collect ordering; completes every ticket with a stub
    result of its package."""

    def __init__(self, P):
        self.P = P
        self.events: list[tuple] = []
        self.batches: list = []

    def result(self, t, served_by):
        return self.P.types.ServeResult(
            t.request.kind, 0, np.empty(0, dtype=np.int64), False, 0,
            served_by)

    def launch(self, batch):
        self.events.append(("launch", len(self.batches)))
        self.batches.append(batch)
        return (len(self.batches) - 1, batch)

    def collect(self, token):
        idx, batch = token
        self.events.append(("collect", idx))
        return [(t, self.result(t, "fake")) for t in batch.tickets]


def make_runtime(P, clock=None, buckets=(4, 16), max_queue=64,
                 policy="block", linger=0.010, executor=None, **kw):
    cfg = P.serve.ServeConfig(buckets=buckets, max_queue=max_queue,
                              policy=policy, max_linger_s=linger,
                              clock=clock or FakeClock(), manual=True, **kw)
    ex = executor if executor is not None else FakeExecutor(P)
    return P.serve.ServeRuntime(graph=None, config=cfg, executor=ex), ex, \
        cfg.clock


def outcome(fut):
    """A future's outcome as plain data: its result's shape, or the class
    of what it raised."""
    try:
        r = fut.result(timeout=0)
    except BaseException as e:  # noqa: BLE001 - the class is the outcome
        return ("raise", type(e).__name__)
    return ("ok", r.kind, r.count, r.served_by, bool(r.truncated))


def raises(fn):
    try:
        fn()
    except BaseException as e:  # noqa: BLE001 - the class is the outcome
        return type(e).__name__
    return None


def view(rt, ex=None) -> dict:
    """What an operator sees after a scenario."""
    out = {"stats": rt.stats_snapshot(), "depth": rt.queue.depth()}
    if ex is not None:
        out["events"] = list(ex.events)
        out["batches"] = [(b.key, b.bucket, len(b.tickets), b.force_host)
                          for b in ex.batches]
    return out


# ---------------------------------------------------------------- scenarios


def bucket_for(P):
    bf = P.serve.bucket_for
    return ([bf(n, (64, 256, 1024)) for n in (1, 64, 65, 1024)],
            raises(lambda: bf(1025, (64, 256, 1024))))


def deadline_sheds(P):
    rt, ex, clock = make_runtime(P)
    fut = rt.submit_bfs(1, max_hops=2, deadline_s=0.5)
    clock.advance(1.0)
    return rt.step(drain=True), outcome(fut), view(rt, ex)


def expired_shed_live_dispatch(P):
    rt, ex, clock = make_runtime(P)
    dead = rt.submit_bfs(1, deadline_s=0.5)
    live = rt.submit_bfs(2, deadline_s=10.0)
    clock.advance(1.0)
    stepped = rt.step(drain=True)
    return (stepped, outcome(dead), outcome(live),
            [t.request.seed for t in ex.batches[0].tickets], view(rt, ex))


def already_expired_submit(P):
    rt, ex, clock = make_runtime(P, policy="block", max_queue=1)
    rt.submit_bfs(1)
    fut = rt.submit_bfs(2, deadline_s=0.0)
    return outcome(fut), view(rt, ex)


def result_eq_and_hash(P):
    R = P.types.ServeResult
    r1 = R("bfs", 2, np.asarray([1, 2]), False, 0)
    r2 = R("bfs", 2, np.asarray([1, 2]), False, 0)
    return (r1 == r2, r1 == r1, isinstance(hash(r1), int), len({r1, r2}))


def fail_fast_queue_full(P):
    rt, ex, _ = make_runtime(P, policy="fail", max_queue=2)
    rt.submit_bfs(1)
    rt.submit_bfs(2)
    return raises(lambda: rt.submit_bfs(3)), view(rt, ex)


def block_until_space(P):
    rt, ex, clock = make_runtime(P, policy="block", max_queue=1, linger=0.0)
    rt.submit_bfs(1)
    admitted = threading.Event()

    def submit_second():
        rt.submit_bfs(2)
        admitted.set()

    t = threading.Thread(target=submit_second, daemon=True)
    t.start()
    try:
        blocked = not admitted.wait(0.15)
        stepped = rt.step(drain=True)
        done = admitted.wait(10.0)
    finally:
        t.join(10.0)
    return blocked, stepped, done, t.is_alive(), rt.queue.depth()


def flush_on_full(P):
    rt, ex, clock = make_runtime(P, linger=1e9)
    futs = [rt.submit_bfs(i) for i in range(16)]
    stepped = rt.step()
    return stepped, [outcome(f) for f in futs], view(rt, ex)


def linger_then_flush(P):
    rt, ex, clock = make_runtime(P, linger=0.010)
    fut = rt.submit_bfs(7)
    early = rt.step()
    n_early = len(ex.batches)
    clock.advance(0.011)
    return early, n_early, rt.step(), outcome(fut), view(rt, ex)


def group_by_key(P):
    rt, ex, clock = make_runtime(P, linger=0.0)
    futs = [rt.submit_bfs(1, max_hops=2), rt.submit_pattern([1, 2]),
            rt.submit_bfs(2, max_hops=2), rt.submit_bfs(3, max_hops=3)]
    steps = [rt.step() for _ in range(4)]
    return (steps, [[getattr(t.request, "seed", None) for t in b.tickets]
                    for b in ex.batches],
            [outcome(f) for f in futs], view(rt, ex))


def pump_order(P):
    rt, ex, clock = make_runtime(P, linger=0.0)
    rt.submit_bfs(1)
    a = rt.pump()
    rt.submit_bfs(2)
    b = rt.pump()
    c = rt.pump()
    return a, b, c, view(rt, ex)


def close_drains(P):
    rt, ex, clock = make_runtime(P, linger=1e9)
    futs = [rt.submit_bfs(i) for i in range(6)]
    futs.append(rt.submit_pattern([1, 2]))
    rt.pump(drain=True)
    rt.close(drain=True)
    return ([outcome(f) for f in futs], raises(lambda: rt.submit_bfs(99)),
            view(rt, ex))


def close_without_drain(P):
    rt, ex, clock = make_runtime(P, linger=1e9)
    futs = [rt.submit_bfs(i) for i in range(3)]
    rt.close(drain=False)
    return [outcome(f) for f in futs], view(rt, ex)


def context_manager(P):
    clock = FakeClock()
    cfg = P.serve.ServeConfig(buckets=(4,), clock=clock, manual=True,
                              max_linger_s=1e9)
    ex = FakeExecutor(P)
    with P.serve.ServeRuntime(graph=None, config=cfg, executor=ex) as rt:
        fut = rt.submit_bfs(1)
    return outcome(fut), view(rt, ex)


def stats_surface(P):
    rt, ex, clock = make_runtime(P, linger=0.0)
    rt.submit_bfs(1)
    clock.advance(0.004)
    rt.step(drain=True)
    return view(rt, ex), rt.stats.snapshot_namespaced()


def request_validation(P):
    T = P.types
    return (raises(lambda: T.PatternRequest(())),
            T.PatternRequest((np.int64(3), 4)).anchors,
            T.BFSRequest(1, 2).batch_key, T.BFSRequest(1, 3).batch_key,
            T.PatternRequest((1, 2)).batch_key,
            T.PatternRequest((1, 2, 3)).batch_key,
            raises(lambda: T.RangeRequest(105, 1, 2, lo_op="lt")),
            raises(lambda: T.RangeRequest(105, 1, 2, limit=0)),
            T.RangeRequest(105, 1, 2).batch_key)


def batcher_validation(P):
    S = P.serve
    q = S.AdmissionQueue(4)
    return (raises(lambda: S.Batcher(q, buckets=(16, 4))),
            raises(lambda: S.Batcher(q, buckets=())),
            raises(lambda: S.AdmissionQueue(4, policy="bogus")))


def cancelled_future(P):
    rt, ex, clock = make_runtime(P, linger=0.0)
    f1 = rt.submit_bfs(1)
    f2 = rt.submit_bfs(2)
    cancelled = f1.cancel()
    stepped = rt.step(drain=True)
    f3 = rt.submit_bfs(3)
    rt.step(drain=True)
    return cancelled, stepped, outcome(f2), outcome(f3), view(rt, ex)


class ExplodingExecutor(FakeExecutor):
    """Fails the FIRST launch, then behaves."""

    exploded = False

    def launch(self, batch):
        if not self.exploded:
            self.exploded = True
            raise RuntimeError("device fell over")
        return super().launch(batch)


def launch_error(P):
    clock = FakeClock()
    cfg = P.serve.ServeConfig(buckets=(4,), clock=clock, manual=True,
                              max_linger_s=0.0)
    ex = ExplodingExecutor(P)
    rt = P.serve.ServeRuntime(graph=None, config=cfg, executor=ex)
    f1 = rt.submit_bfs(1)
    stepped = rt.step(drain=True)
    f2 = rt.submit_bfs(2)
    rt.step(drain=True)
    rt.close()
    return stepped, outcome(f1), outcome(f2), view(rt, ex)


def priorities(P):
    rt, ex, clock = make_runtime(P, linger=0.0)
    futs = [rt.submit_bfs(1), rt.submit_pattern([1, 2], priority=5),
            rt.submit_bfs(2, max_hops=3, priority=1), rt.submit_bfs(3)]
    while rt.step():
        pass
    return [b.key for b in ex.batches], [outcome(f) for f in futs]


def admission_gate(P):
    reasons = iter(["lagging", None])
    rt, ex, clock = make_runtime(P, linger=0.0,
                                 admission_gate=lambda: next(reasons))
    first = raises(lambda: rt.submit_bfs(1))
    fut = rt.submit_bfs(2)
    rt.step()
    return first, outcome(fut), view(rt, ex)


def join_requests(P):
    """Join requests batch by signature like the reference's: through
    ``submit`` and ``submit_join`` with a prebuilt request."""
    rt, ex, clock = make_runtime(P, linger=0.0)
    JoinRequest = P.types.JoinRequest
    futs = [rt.submit(JoinRequest("tri", (1,))),
            rt.submit_join(JoinRequest("tri", (2,))),
            rt.submit_join(JoinRequest("path", (3, 4)), priority=1)]
    while rt.step(drain=True):
        pass
    return [outcome(f) for f in futs], view(rt, ex), \
        [[t.request.consts for t in b.tickets] for b in ex.batches]


SCENARIOS = {
    "bucket_for": bucket_for,
    "deadline_sheds": deadline_sheds,
    "expired_shed_live_dispatch": expired_shed_live_dispatch,
    "already_expired_submit": already_expired_submit,
    "result_eq_and_hash": result_eq_and_hash,
    "fail_fast_queue_full": fail_fast_queue_full,
    "block_until_space": block_until_space,
    "flush_on_full": flush_on_full,
    "linger_then_flush": linger_then_flush,
    "group_by_key": group_by_key,
    "pump_order": pump_order,
    "close_drains": close_drains,
    "close_without_drain": close_without_drain,
    "context_manager": context_manager,
    "stats_surface": stats_surface,
    "request_validation": request_validation,
    "batcher_validation": batcher_validation,
    "cancelled_future": cancelled_future,
    "launch_error": launch_error,
    "priorities": priorities,
    "admission_gate": admission_gate,
    "join_requests": join_requests,
}


def run_both(fn):
    ref = fn(package(PKGS[0]))
    port = fn(package(PKGS[1]))
    assert port == ref
    return port


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_runtime_scenario_matches_reference(name):
    run_both(SCENARIOS[name])


def test_scenarios_show_what_they_test():
    """The reference suite's own assertions, on the port's records."""
    P = package(PKGS[1])
    stepped, out, v = deadline_sheds(P)
    assert stepped is False and out == ("raise", "DeadlineExceeded")
    assert v["batches"] == [] and v["stats"]["shed_deadline"] == 1
    assert pump_order(P)[3]["events"] == [
        ("launch", 0), ("launch", 1), ("collect", 0), ("collect", 1)]
    early, n_early, late, out, v = linger_then_flush(P)
    assert (early, n_early, late) == (False, 0, True)
    assert v["batches"] == [(("bfs", 2), 4, 1, False)]
    assert v["stats"]["batch_occupancy"] == pytest.approx(0.25)
    assert block_until_space(P) == (True, True, True, False, 1)
    v, _ = stats_surface(P)
    assert v["stats"]["latency_ms"]["p50"] == pytest.approx(4.0)
    assert group_by_key(P)[1] == [[1, 2], [None], [3]]
    outs, closed, v = close_drains(P)
    assert closed == "RuntimeClosed" and v["stats"]["completed"] == 7
    assert launch_error(P)[1] == ("raise", "RuntimeError")
    assert priorities(P)[0] == [("pattern", 2), ("bfs", 3), ("bfs", 2)]
    assert admission_gate(P)[0] == "AdmissionGated"
    outs, v, consts = join_requests(P)
    assert [b[0] for b in v["batches"]] == [("join", "path"), ("join", "tri")]
    assert consts == [[(3, 4)], [(1,), (2,)]]
    assert outs == [("ok", "join", 0, "fake", False)] * 3


# ------------------------------------------------------ the port's surface


def port():
    return package(PKGS[1])


@pytest.mark.parametrize("case", [
    "explain", "join_explain", "submit_planned", "attach_planner"])
def test_planner_and_explain_refuse_as_the_reference(case):
    """The planner and EXPLAIN entry points refuse exactly what the
    reference refuses — ``explain=True`` without a tracer,
    ``submit_planned`` without an attached planner, ``attach_planner`` of
    an object that is not a planner — with the same exception class, and
    touch no queue state."""
    outs = []
    for pkg in PKGS:
        P = package(pkg)
        rt, ex, clock = make_runtime(P, linger=0.0)
        calls = {
            "explain": lambda: rt.submit_bfs(1, explain=True),
            "join_explain": lambda: rt.submit_join(
                P.types.JoinRequest(None, (1,)), explain=True),
            "submit_planned": lambda: rt.submit_planned(None),
            "attach_planner": lambda: rt.attach_planner(object()),
        }
        with pytest.raises(Exception) as info:
            calls[case]()
        assert rt.queue.depth() == 0 and ex.events == []
        assert rt.stats.submitted == 0
        outs.append(type(info.value).__name__)
    assert outs[1] == outs[0]
    assert outs[1] == ("AttributeError" if case == "attach_planner"
                       else "Unservable")


@pytest.mark.parametrize("field,value,n_dev", [
    ("sharded", True, 8), ("hbm_budget_bytes", 1 << 30, 8)])
def test_out_of_slice_options_raise_naming_their_item(field, value, n_dev,
                                                      monkeypatch):
    """Once refused, the sharding options now pick the executor as the
    reference's do: with ``n_dev`` visible devices (the reference's forced
    CPU devices; the port's visible devices patched to the CPU ``n_dev``
    times) ``sharded=True`` takes the sharded executor over all of them,
    and AUTO with a budget the small base fits stays on one device."""
    import torch

    from hypergraphdb_tpu_torch.serve import sharded as port_sharded

    monkeypatch.setattr(port_sharded, "visible_devices",
                        lambda config: [torch.device("cpu")] * n_dev)
    picks = []
    for pkg in PKGS:
        P = package(pkg)
        g = importlib.import_module(f"{pkg}.core.graph").HyperGraph()
        try:
            g.add_link([g.add("a"), g.add("b")])
            kw = {"device": "cpu"} if pkg == PKGS[1] else {}
            rt = P.serve.ServeRuntime(g, P.serve.ServeConfig(
                manual=True, **kw, **{field: value}))
            ex = rt.executor
            mesh = getattr(ex, "mesh", None)
            picks.append((type(ex).__name__, None if mesh is None else (
                mesh.n_dev if pkg == PKGS[1] else int(mesh.devices.size))))
            assert g.incremental is not None
            rt.close()
        finally:
            g.close()
    assert picks[1] == picks[0]
    assert picks[0] == (("ShardedExecutor", n_dev) if field == "sharded"
                        else ("DeviceExecutor", None))


class FakeManager:
    """A subscription manager that records when the dispatch cycle runs
    its evaluator rounds, in the fake executor's event log."""

    def __init__(self, ex):
        self.ex = ex

    def pump(self):
        self.ex.events.append(("sub.pump",))


def subscription_rounds(P):
    """Where ``step`` and ``pump`` run the attached manager's rounds: one
    before batch formation, one after each finalize."""
    rt, ex, clock = make_runtime(P, linger=0.0)
    rt.attach_subscriptions(FakeManager(ex))
    assert rt.subscriptions is not None
    futs = [rt.submit_bfs(1), rt.submit_bfs(2)]
    rt.step(drain=True)
    futs.append(rt.submit_bfs(3))
    rt.pump(drain=True)
    rt.pump(drain=True)
    rt.step(drain=True)                   # nothing queued: one round
    return [outcome(f) for f in futs], view(rt, ex)


def test_attach_subscriptions_drives_rounds_as_on_the_reference():
    """The entry point that waited for the subscription tier now wires a
    manager into the dispatch cycle: its rounds run at the same points of
    ``step`` and ``pump`` as on the reference."""
    ref, prt = (subscription_rounds(package(p)) for p in PKGS)
    assert prt == ref
    events = prt[1]["events"]
    assert events[:4] == [("sub.pump",), ("launch", 0), ("collect", 0),
                          ("sub.pump",)]
    assert events.count(("sub.pump",)) == 6


def test_aot_cache_dir_opens_the_plan_cache_as_on_the_reference(tmp_path):
    """The option that waited for item 6 now opens the cache: keyed by the
    same content fingerprint as the reference's on the same graph, and
    ``stats_snapshot()["aot"]`` carries the reference's counter names."""
    from tests.conftest import make_random_hypergraph

    got = {}
    for pkg in PKGS:
        imp = importlib.import_module
        kw, cfg = {}, {"manual": True, "aot_cache_dir": str(tmp_path / pkg),
                       "prewarm_aot": False}
        if pkg == PKGS[1]:
            kw = {"query": imp(f"{pkg}.core.config").QueryConfig(
                device="cpu")}
            cfg["device"] = "cpu"
        g = imp(f"{pkg}.core.graph").HyperGraph(
            imp(f"{pkg}.core.config").HGConfiguration(**kw))
        make_random_hypergraph(g, n_nodes=40, n_links=80, seed=5)
        rt = imp(f"{pkg}.serve").ServeRuntime(
            g, imp(f"{pkg}.serve").ServeConfig(**cfg))
        aot = rt.executor.aot
        got[pkg] = (aot.content_key, aot.dir.startswith(str(tmp_path / pkg)),
                    rt.stats_snapshot()["aot"])
        rt.close()
        g.close()
    assert got[PKGS[1]] == got[PKGS[0]]
    assert got[PKGS[1]][0]                # a real fingerprint, not ""


@pytest.mark.parametrize("case", ["submit_join", "join_request"])
def test_join_entry_points_reach_the_executor(case):
    """The two entry points that waited for the join lane now admit their
    request: it rides one ``("join", signature)`` batch to the executor,
    as on the reference (the ``join_requests`` scenario)."""
    P = port()
    rt, ex, clock = make_runtime(P, linger=0.0)
    req = P.types.JoinRequest("sig", (1,))
    fut = (rt.submit_join(req) if case == "submit_join"
           else rt.submit(req))
    assert rt.queue.depth() == 1
    rt.step(drain=True)
    assert outcome(fut) == ("ok", "join", 0, "fake", False)
    assert [b.key for b in ex.batches] == [("join", "sig")]


def test_prewarm_join_nbr_builds_the_join_relations():
    """``prewarm_join_nbr`` builds the co-incidence CSR and the factorized
    relations of the manager's base before the first request, equal array
    for array to the reference's prewarm on the same graph; without it
    nothing is built."""
    from tests.conftest import make_random_hypergraph

    got = {}
    for pkg in PKGS:
        imp = importlib.import_module
        kw = {}
        if pkg == PKGS[1]:
            kw = {"query": imp(f"{pkg}.core.config").QueryConfig(
                device="cpu")}
        g = imp(f"{pkg}.core.graph").HyperGraph(
            imp(f"{pkg}.core.config").HGConfiguration(**kw))
        make_random_hypergraph(g, n_nodes=40, n_links=80, seed=5)
        inc = {"background": False}
        cfg = {"manual": True, "prewarm_join_nbr": True}
        if pkg == PKGS[1]:
            inc["device"] = cfg["device"] = "cpu"
        g.enable_incremental(**inc)
        rt = imp(f"{pkg}.serve").ServeRuntime(
            g, imp(f"{pkg}.serve").ServeConfig(**cfg))
        base = rt.executor.mgr.base
        nbr = getattr(base, "_nbr_csr", None)
        fact = getattr(base, "_fact_rels", None)
        got[pkg] = (
            [np.asarray(a).tolist() for a in nbr[:2]],
            {rel: (np.asarray(fr.group_of).tolist(),
                   np.asarray(fr.offsets).tolist(),
                   np.asarray(fr.flat).tolist()) for rel, fr in fact.items()})
        rt.close()
        g.close()
    assert got[PKGS[1]] == got[PKGS[0]]
    from hypergraphdb_tpu_torch.core.graph import HyperGraph

    g = HyperGraph()
    make_random_hypergraph(g, n_nodes=40, n_links=80, seed=5)
    g.enable_incremental(background=False, device="cpu")
    rt = port().serve.ServeRuntime(
        g, port().serve.ServeConfig(manual=True, device="cpu"))
    assert getattr(rt.executor.mgr.base, "_nbr_csr", None) is None
    rt.close()
    g.close()


def pattern_runtime(pkg, tmp_path, **cfg):
    """A manual runtime of ``pkg`` over the seeded 40-node graph, the port
    on the CPU, with a plan cache under ``tmp_path``; and a link's two
    targets."""
    from tests.conftest import make_random_hypergraph

    imp = importlib.import_module
    kw = {}
    cfg = {"manual": True, "buckets": (4, 8), "top_r": 8,
           "aot_cache_dir": str(tmp_path / pkg), **cfg}
    if pkg == PKGS[1]:
        kw = {"query": imp(f"{pkg}.core.config").QueryConfig(device="cpu")}
        cfg["device"] = "cpu"
    g = imp(f"{pkg}.core.graph").HyperGraph(
        imp(f"{pkg}.core.config").HGConfiguration(**kw))
    _, links = make_random_hypergraph(g, n_nodes=40, n_links=80, seed=5)
    pair = next(t[:2] for t in (g.get(int(h)).targets for h in links)
                if len(set(t[:2])) == 2)
    rt = imp(f"{pkg}.serve").ServeRuntime(
        g, imp(f"{pkg}.serve").ServeConfig(**cfg))
    return g, rt, [int(x) for x in pair]


def served_pattern(rt, anchors):
    fut = rt.submit_pattern(anchors)
    while rt.step(drain=True):
        pass
    res = fut.result(timeout=0)
    return res.count, np.asarray(res.matches).tolist(), res.served_by


@pytest.mark.parametrize("arities", [(1, 2), ()])
def test_prewarm_pattern_arities_builds_the_pattern_lane(tmp_path, arities):
    """With a plan cache and ``prewarm_pattern_arities`` the port's
    runtime builds the pattern lane's ELL targets at construction (one
    more plan in ``prewarm_counts["built"]``, the base's ELL cache holding
    the device before the first request); with ``()`` the first pattern
    flush builds it. The pattern request then answers as the reference's
    runtime on the same graph: count, window, served on the device."""
    g, rt, pair = pattern_runtime(PKGS[0], tmp_path, prewarm_aot=False)
    want = served_pattern(rt, pair)
    rt.close()
    g.close()
    g, rt, pair = pattern_runtime(PKGS[1], tmp_path,
                                  prewarm_pattern_arities=arities)
    base = rt.executor.mgr.base
    try:
        assert ("cpu" in (getattr(base, "_tgt_ell", None) or {})) == bool(
            arities)
        built = rt.executor.prewarm_counts["built"]
        got = served_pattern(rt, pair)
        assert "cpu" in base._tgt_ell
    finally:
        rt.close()
        g.close()
    g, rt, _ = pattern_runtime(PKGS[1], tmp_path / "none",
                               prewarm_pattern_arities=())
    assert rt.executor.prewarm_counts["built"] == built - bool(arities)
    rt.close()
    g.close()
    assert got == want and want[2] == "device" and want[0] > 0


def test_runtime_without_a_device_asks_for_the_card():
    """``ServeRuntime(graph)`` resolves ``ServeConfig.device`` ("cuda" by
    default): without CUDA it raises instead of serving on the CPU."""
    import torch

    from hypergraphdb_tpu_torch.core.graph import HyperGraph

    P = port()
    assert P.serve.ServeConfig().device == "cuda"
    g = HyperGraph()
    try:
        if torch.cuda.is_available():
            with P.serve.ServeRuntime(g) as rt:
                assert rt.executor.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                P.serve.ServeRuntime(g, P.serve.ServeConfig(manual=True))
    finally:
        g.close()


def test_serve_exports_match_reference_but_the_sharded_executor():
    """The sharded executor, once left out, is exported now: the two
    packages' ``serve`` exports are equal."""
    ref, prt = (importlib.import_module(f"{p}.serve") for p in PKGS)
    assert set(prt.__all__) == set(ref.__all__)
    assert "ShardedExecutor" in prt.__all__
    for name in prt.__all__:
        assert getattr(prt, name).__name__ == getattr(ref, name).__name__
