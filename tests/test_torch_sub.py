"""The port's subscription tier against the reference's: every case of
``tests/test_sub.py`` runs as one scenario on both packages (a small live
graph, a ``ServeRuntime`` in manual mode, the port's on ``device="cpu"``,
and an attached ``SubscriptionManager``), with the reference test's own
assertions on each; the records a consumer and an operator can see
(envelopes, polled deltas, resyncs, the ``sub.*`` counters but the
staleness gauge) must be equal. The dispatch cycle is driven by
``runtime.step`` from the test thread, so both runs are deterministic.
Then the port's own surface: a failing evaluator round and a failing
listener are counted, never dropped.

Tolerance: exact equality. Every parked poll is bounded and every thread
joined with a timeout."""

from __future__ import annotations

import importlib
import threading
import time
from types import SimpleNamespace

import pytest

PKGS = ("hypergraphdb_tpu", "hypergraphdb_tpu_torch")
#: the port's counters beyond the reference's namespace
PORT_ONLY = ("sub.pump_errors", "sub.listener_errors")


def package(pkg) -> SimpleNamespace:
    imp = importlib.import_module
    return SimpleNamespace(
        name=pkg, port=pkg == PKGS[1],
        graph=imp(f"{pkg}.core.graph"), config=imp(f"{pkg}.core.config"),
        serve=imp(f"{pkg}.serve"), types=imp(f"{pkg}.serve.types"),
        sub=imp(f"{pkg}.sub"), wire=imp(f"{pkg}.sub.wire"),
        registry=imp(f"{pkg}.sub.registry"), stats=imp(f"{pkg}.sub.stats"),
        c=imp(f"{pkg}.query.conditions"),
        traversals=imp(f"{pkg}.algorithms.traversals"))


def new_graph(P):
    kw = {}
    if P.port:
        kw["query"] = P.config.QueryConfig(device="cpu")
    return P.graph.HyperGraph(P.config.HGConfiguration(**kw))


def serve_cfg(P, **kw):
    kw.setdefault("buckets", (4,))
    kw.setdefault("max_linger_s", 0.001)
    kw.setdefault("prewarm_aot", False)
    kw.setdefault("manual", True)
    if P.port:
        kw["device"] = "cpu"
    return P.serve.ServeConfig(**kw)


class Rig(SimpleNamespace):
    def settle(self, limit: int = 200) -> None:
        """Step the runtime (each step runs the evaluator rounds) until
        nothing is dirty or in flight."""
        for _ in range(limit):
            self.rt.step(drain=True)
            with self.mgr._lock:
                busy = any(s.dirty or s.inflight is not None
                           for s in self.mgr.subs.all())
            if not busy:
                return
        raise AssertionError("subscriptions never settled")

    def close(self) -> None:
        self.mgr.close()
        self.rt.close(drain=False)
        self.g.close()


def make_rig(P) -> Rig:
    """A small live graph + a manual serving runtime + attached manager
    (the reference test's ``rig``)."""
    g = new_graph(P)
    nodes = [int(g.add(i)) for i in range(8)]
    links = [int(g.add_link((nodes[0], nodes[k]), value=100 + k))
             for k in (1, 2, 3)]
    rt = P.serve.ServeRuntime(g, serve_cfg(P))
    mgr = P.sub.SubscriptionManager(g, rt)
    rt.attach_subscriptions(mgr)
    return Rig(P=P, g=g, rt=rt, mgr=mgr, nodes=nodes, links=links)


def counters(mgr) -> dict:
    """The ``sub.*`` snapshot both packages share, but the wall-clock
    staleness gauge; the port's own error counters must read zero."""
    snap = dict(mgr.stats.snapshot())
    for name in PORT_ONLY:
        assert snap.pop(name, 0) == 0, name
    snap.pop("sub.staleness_seconds")
    return snap


def fold(P, matches, notes):
    """Client-side delta fold, asserting the chain and the digest."""
    out = set(matches)
    for n in notes:
        assert n["what"] == "notification"
        out.difference_update(int(h) for h in n["removed"])
        out.update(int(h) for h in n["added"])
        assert n["digest"] == P.registry.match_digest(out)
    return out


def raises(fn):
    try:
        fn()
    except BaseException as e:  # noqa: BLE001 - the class is the outcome
        return type(e).__name__
    return None


def on_both(scenario) -> dict:
    """Run ``scenario(rig)`` on each package's rig; returns the two
    records after asserting they are equal."""
    out = {}
    for pkg in PKGS:
        rig = make_rig(package(pkg))
        try:
            out[pkg] = scenario(rig)
        finally:
            rig.close()
    assert out[PKGS[1]] == out[PKGS[0]]
    return out


# --------------------------------------------------------------- envelopes


def test_subscribe_envelope_is_the_exact_initial_snapshot():
    def scenario(r):
        P, g, mgr, nodes = r.P, r.g, r.mgr, r.nodes
        resp = mgr.subscribe("pattern", {"anchors": [nodes[0]]})
        assert resp["what"] == "subscribed" and resp["kind"] == "pattern"
        assert resp["id"].startswith("sub-")
        want = {int(h) for h in g.find_all(P.c.Incident(nodes[0]))}
        assert set(resp["matches"]) == want == set(r.links)
        assert resp["digest"] == P.registry.match_digest(want)
        assert resp["window"] == P.sub.SubConfig().default_window
        out = mgr.unsubscribe(resp["id"])
        assert out == {"what": "unsubscribed", "id": resp["id"]}
        gone = raises(lambda: mgr.poll(resp["id"], timeout_s=0.0))
        assert gone == "Unservable"
        return resp, out, gone, counters(mgr)

    on_both(scenario)


def test_typed_refusals():
    def scenario(r):
        mgr, nodes = r.mgr, r.nodes
        out = [
            raises(lambda: mgr.subscribe("tensor", {})),
            raises(lambda: mgr.subscribe(
                "pattern", {"anchors": [nodes[0]]}, window=0)),
            raises(lambda: mgr.subscribe(
                "range", {"lo": 1, "hi": 9, "limit": 4})),
            raises(lambda: mgr.subscribe(
                "range", {"lo": 1, "hi": 9, "desc": True})),
            raises(lambda: mgr.poll("sub-999", timeout_s=0.0)),
            raises(lambda: mgr.unsubscribe("sub-999")),
        ]
        assert out == ["Unservable"] * 6
        return out, counters(mgr)

    on_both(scenario)


def test_capacity_is_queue_full():
    def scenario(r):
        r.mgr.config.max_subscriptions = 1
        first = r.mgr.subscribe("pattern", {"anchors": [r.nodes[0]]})
        err = raises(lambda: r.mgr.subscribe(
            "pattern", {"anchors": [r.nodes[1]]}))
        assert err == "QueueFull"
        return first, err, counters(r.mgr)

    on_both(scenario)


def test_closed_manager_refuses_subscribe():
    def scenario(r):
        r.mgr.close()
        err = raises(lambda: r.mgr.subscribe(
            "pattern", {"anchors": [r.nodes[0]]}))
        assert err == "RuntimeClosed"
        return err

    on_both(scenario)


# ------------------------------------------------------ incremental deltas


def test_pattern_delta_chains_adds_and_removals():
    def scenario(r):
        P, g, mgr, nodes = r.P, r.g, r.mgr, r.nodes
        resp = mgr.subscribe("pattern", {"anchors": [nodes[0]]})
        sid = resp["id"]
        fresh = int(g.add_link((nodes[0], nodes[4]), value=999))
        r.settle()
        env = mgr.poll(sid, timeout_s=0.0)
        assert env["what"] == "notifications" and not env["more"]
        (note,) = env["notes"]
        assert note["seq_from"] == resp["seq"]
        assert note["added"] == [fresh] and note["removed"] == []
        folded = fold(P, resp["matches"], [note])
        g.remove(fresh)
        r.settle()
        env2 = mgr.poll(sid, timeout_s=0.0)
        (note2,) = env2["notes"]
        assert note2["seq_from"] == note["seq_to"]
        assert note2["removed"] == [fresh] and note2["added"] == []
        folded = fold(P, folded, [note2])
        assert folded == {int(h) for h in g.find_all(P.c.Incident(nodes[0]))}
        return resp, env, env2, counters(mgr)

    on_both(scenario)


def test_irrelevant_ingest_never_fires():
    def scenario(r):
        g, mgr, nodes = r.g, r.mgr, r.nodes
        sid = mgr.subscribe("pattern", {"anchors": [nodes[0]]})["id"]
        evals_before = mgr.stats.evals
        g.add_link((nodes[5], nodes[6]), value=777)  # misses the anchor
        r.settle()
        env = mgr.poll(sid, timeout_s=0.0)
        assert env["notes"] == [] and not env["more"]
        assert mgr.stats.evals == evals_before
        return env, counters(mgr)

    on_both(scenario)


def test_range_window_movement():
    def scenario(r):
        g, mgr = r.g, r.mgr
        resp = mgr.subscribe("range", {"lo": 100, "hi": 150})
        sid = resp["id"]
        assert set(resp["matches"]) == set(r.links)  # values 101..103
        inside = int(g.add(120))
        g.add(4242)                                  # outside the window
        r.settle()
        env = mgr.poll(sid, timeout_s=0.0)
        assert [n["added"] for n in env["notes"]] == [[inside]]
        g.replace(inside, 9999)      # the value moves OUT of the window
        r.settle()
        env2 = mgr.poll(sid, timeout_s=0.0)
        (note,) = env2["notes"]
        assert note["removed"] == [inside]
        return resp, env, env2, counters(mgr)

    on_both(scenario)


def test_bfs_removal_uses_precommit_targets():
    def scenario(r):
        P, g, mgr, nodes = r.P, r.g, r.mgr, r.nodes
        resp = mgr.subscribe("bfs", {"seed": nodes[0], "max_hops": 1})
        sid = resp["id"]
        assert nodes[1] in set(resp["matches"])
        # the removed link's targets are readable only BEFORE the commit
        g.remove(r.links[0])
        r.settle()
        env = mgr.poll(sid, timeout_s=0.0)
        folded = fold(P, resp["matches"], env["notes"])
        want = {int(nbr) for _, nbr in P.traversals.HGBreadthFirstTraversal(
            g, nodes[0], max_distance=1)}
        assert folded == want and nodes[1] not in folded
        return resp, env, counters(mgr)

    on_both(scenario)


# ------------------------------------------------- backpressure / delivery


def test_slow_consumer_sheds_to_resync_fast_stays_current():
    def scenario(r):
        P, g, mgr, nodes = r.P, r.g, r.mgr, r.nodes
        slow = mgr.subscribe("pattern", {"anchors": [nodes[0]]}, window=1)
        fast = mgr.subscribe("pattern", {"anchors": [nodes[0]]}, window=64)
        folded = set(fast["matches"])
        fast_envs = []
        for k in range(3):            # 3 deltas > the slow window of 1
            g.add_link((nodes[0], nodes[4 + k]), value=500 + k)
            r.settle()
            env = mgr.poll(fast["id"], timeout_s=0.0)
            fast_envs.append(env)
            folded = fold(P, folded, env["notes"])
        want = {int(h) for h in g.find_all(P.c.Incident(nodes[0]))}
        assert folded == want
        env = mgr.poll(slow["id"], timeout_s=0.0)
        assert env["what"] == "resync"
        assert set(env["matches"]) == want
        assert env["digest"] == P.registry.match_digest(want)
        assert mgr.stats.shed > 0
        assert mgr.stats.snapshot()["sub.resyncs"] == 1
        g.add_link((nodes[0], nodes[7]), value=909)
        r.settle()
        env2 = mgr.poll(slow["id"], timeout_s=0.0)
        assert env2["what"] == "notifications"
        assert env2["notes"][0]["seq_from"] >= env["seq"]
        return slow, fast, fast_envs, env, env2, counters(mgr)

    on_both(scenario)


def test_long_poll_parks_until_a_delta_arrives():
    def scenario(r):
        g, mgr, nodes = r.g, r.mgr, r.nodes
        sid = mgr.subscribe("pattern", {"anchors": [nodes[0]]})["id"]
        out = {}

        def park():
            out["env"] = mgr.poll(sid, timeout_s=10.0)

        t = threading.Thread(target=park)
        t.start()
        time.sleep(0.05)
        g.add_link((nodes[0], nodes[5]), value=321)
        r.settle()
        t.join(timeout=10)
        assert not t.is_alive()
        assert out["env"]["notes"], "parked poll never woke on the delta"
        return out["env"], counters(mgr)

    on_both(scenario)


def test_close_wakes_parked_pollers():
    def scenario(r):
        mgr = r.mgr
        sid = mgr.subscribe("pattern", {"anchors": [r.nodes[0]]})["id"]
        out = {}

        def park():
            out["err"] = raises(lambda: mgr.poll(sid, timeout_s=30.0))

        t = threading.Thread(target=park)
        t.start()
        time.sleep(0.05)
        mgr.close()
        t.join(timeout=10)
        assert not t.is_alive() and out["err"] == "Unservable"
        return out

    on_both(scenario)


def test_poll_batches_and_reports_more():
    def scenario(r):
        g, mgr, nodes = r.g, r.mgr, r.nodes
        sid = mgr.subscribe("pattern", {"anchors": [nodes[0]]},
                            window=16)["id"]
        for k in range(3):
            g.add_link((nodes[0], nodes[4 + k]), value=600 + k)
            r.settle()                 # one delta per settled round
        env = mgr.poll(sid, max_notes=2, timeout_s=0.0)
        assert len(env["notes"]) == 2 and env["more"]
        env2 = mgr.poll(sid, max_notes=2, timeout_s=0.0)
        assert len(env2["notes"]) == 1 and not env2["more"]
        assert env2["notes"][0]["seq_from"] == env["notes"][-1]["seq_to"]
        return env, env2, counters(mgr)

    on_both(scenario)


# ----------------------------------------------------- seq / health / perf


def test_seq_source_anchors_notifications():
    def scenario(r):
        g, mgr, nodes = r.g, r.mgr, r.nodes
        ext = {"seq": 41}
        mgr._seq_source = lambda: ext["seq"]
        resp = mgr.subscribe("pattern", {"anchors": [nodes[0]]})
        assert resp["seq"] >= 41
        ext["seq"] = 57
        g.add_link((nodes[0], nodes[6]), value=808)
        r.settle()
        env = mgr.poll(resp["id"], timeout_s=0.0)
        (note,) = env["notes"]
        assert note["seq_to"] >= 57
        assert note["seq_from"] == resp["seq"]
        return resp, env, counters(mgr)

    on_both(scenario)


def test_health_section_shape():
    def scenario(r):
        mgr = r.mgr
        mgr.subscribe("pattern", {"anchors": [r.nodes[0]]})
        h = mgr.health_section()
        assert h["active"] == 1 and h["violating"] is False
        assert h["bound_s"] == mgr.config.staleness_bound_s
        assert {"dirty", "inflight", "staleness_s", "notified_total",
                "shed_total"} <= set(h)
        if r.P.port:
            assert h.pop("pump_errors") == h.pop("listener_errors") == 0
        return h

    on_both(scenario)


def test_manager_feeds_the_perf_sentinel_sub_lane():
    def scenario(r):
        g, mgr, nodes = r.g, r.mgr, r.nodes
        samples = []

        class Tap:
            def observe(self, kind, latency_s, path="device", t=None):
                samples.append((kind, latency_s))

        r.rt.perf = Tap()
        sid = mgr.subscribe("pattern", {"anchors": [nodes[0]]})["id"]
        g.add_link((nodes[0], nodes[4]), value=111)
        r.settle()
        env = mgr.poll(sid, timeout_s=0.0)
        assert env["notes"]
        subs = [(k, lat) for k, lat in samples if k == "sub"]
        assert len(subs) == 1 and subs[0][1] >= 0.0
        return env, [k for k, _ in samples], counters(mgr)

    on_both(scenario)


def test_metrics_namespace_no_drift():
    """Each package's snapshot has exactly its committed names; the
    port's are the reference's plus its two error counters."""
    ref, prt = (package(p) for p in PKGS)
    for P in (ref, prt):
        assert set(P.stats.SubStats().snapshot()) == set(
            P.stats.DOTTED_NAMES)
    assert set(prt.stats.DOTTED_NAMES) == (
        set(ref.stats.DOTTED_NAMES) | set(PORT_ONLY))


# ------------------------------------------------------------ wire decoding


def test_wire_subscribe_and_poll_payloads():
    def scenario(r):
        g, mgr, nodes, wire = r.g, r.mgr, r.nodes, r.P.wire
        resp = wire.subscribe_payload(mgr, {
            "what": "subscribe", "kind": "pattern", "anchors": [nodes[0]],
            "window": 8,
        })
        assert resp["what"] == "subscribed" and resp["window"] == 8
        g.add_link((nodes[0], nodes[5]), value=222)
        r.settle()
        env = wire.poll_payload(mgr, {"id": resp["id"], "timeout_s": "0",
                                      "max": "16"})
        assert env["what"] == "notifications" and env["notes"]
        out = wire.subscribe_payload(mgr, {"what": "unsubscribe",
                                           "id": resp["id"]})
        assert out["what"] == "unsubscribed"
        return resp, env, out, counters(mgr)

    on_both(scenario)


def test_wire_refusals_are_typed():
    def scenario(r):
        mgr, wire = r.mgr, r.P.wire
        out = [
            raises(lambda: wire.subscribe_payload(mgr, {"what": "subscribe"})),
            raises(lambda: wire.subscribe_payload(
                mgr, {"what": "subscribe", "kind": "pattern"})),
            raises(lambda: wire.subscribe_payload(
                mgr, {"what": "subscribe", "kind": "bfs"})),
            raises(lambda: wire.subscribe_payload(mgr, {"what": "frobnicate"})),
            raises(lambda: wire.poll_payload(mgr, {})),
            raises(lambda: wire.poll_payload(
                mgr, {"id": "sub-1", "timeout_s": "soon"})),
        ]
        assert out == ["Unservable"] * 6
        return out

    on_both(scenario)


def test_wire_poll_timeout_is_clamped():
    def scenario(r):
        mgr, wire = r.mgr, r.P.wire
        sid = wire.subscribe_payload(mgr, {
            "what": "subscribe", "kind": "pattern", "anchors": [r.nodes[0]],
        })["id"]
        t0 = time.monotonic()
        env = wire.poll_payload(mgr, {"id": sid, "timeout_s": 9999},
                                max_timeout_s=0.05)
        assert time.monotonic() - t0 < 5.0
        assert env["notes"] == []
        return env

    on_both(scenario)


# ------------------------------------------------------ the port's surface


def port_rig() -> Rig:
    return make_rig(package(PKGS[1]))


def test_pump_error_is_counted_and_dispatch_goes_on():
    """An evaluator round that raises on the dispatch cycle does not stop
    it: the error is counted in ``sub.pump_errors`` and the health
    section, the batch still serves, and the next round recovers."""
    r = port_rig()
    try:
        sid = r.mgr.subscribe("pattern", {"anchors": [r.nodes[0]]})["id"]
        real = r.mgr._submit_dirty
        calls = {"n": 0}

        def broken(now):
            calls["n"] += 1
            raise RuntimeError("evaluator fault")

        r.mgr._submit_dirty = broken
        fresh = int(r.g.add_link((r.nodes[0], r.nodes[4]), value=999))
        fut = r.rt.submit_pattern([r.nodes[0]])
        assert r.rt.step(drain=True)
        assert fut.result(timeout=0).count == 4
        assert calls["n"] == 2            # before formation, after finalize
        assert r.mgr.stats.pump_errors == 2
        assert r.mgr.health_section()["pump_errors"] == 2
        r.mgr._submit_dirty = real
        r.settle()
        (note,) = r.mgr.poll(sid, timeout_s=0.0)["notes"]
        assert note["added"] == [fresh]
        assert r.mgr.stats.pump_errors == 2
    finally:
        r.close()


def test_listener_error_is_counted_and_dirties_every_subscription():
    """A graph listener that raises never breaks the write: it is counted
    in ``sub.listener_errors`` and marks every subscription dirty, so the
    next round re-evaluates them and no delta is lost."""
    r = port_rig()
    try:
        a = r.mgr.subscribe("pattern", {"anchors": [r.nodes[0]]})["id"]
        b = r.mgr.subscribe("range", {"lo": 100, "hi": 150})["id"]
        real = r.mgr._relevant

        def broken(*args):
            raise RuntimeError("predicate fault")

        r.mgr._relevant = broken
        fresh = int(r.g.add_link((r.nodes[0], r.nodes[4]), value=120))
        assert r.g.get(fresh).value == 120    # the write went through
        assert r.mgr.stats.listener_errors == 1
        assert all(s.dirty for s in r.mgr.subs.all())
        r.mgr._relevant = real
        r.settle()
        for sid in (a, b):
            (note,) = r.mgr.poll(sid, timeout_s=0.0)["notes"]
            assert note["added"] == [fresh]
        assert r.mgr.health_section()["listener_errors"] == 1
    finally:
        r.close()


def test_seq_source_failure_raises_to_the_caller():
    """A failing external seq is not papered over with the internal
    counter: ``subscribe`` raises it."""
    r = port_rig()
    try:
        def dead():
            raise ConnectionError("replication layer gone")

        r.mgr._seq_source = dead
        with pytest.raises(ConnectionError):
            r.mgr.subscribe("pattern", {"anchors": [r.nodes[0]]})
    finally:
        r.close()
