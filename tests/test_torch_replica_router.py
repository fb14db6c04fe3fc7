"""The port's front door (``hypergraphdb_tpu_torch.replica.router``)
against the reference's: every case of ``tests/test_replica_router.py``
runs as one scenario on both packages with the reference test's own
assertions — placement (round-robin within the least-lagged group, the
load tiebreak, the breaker penalty, shard-free), the per-replica breaker
and re-admission, typed HTTP refusals, the primary fallback, the router's
``/healthz``, concurrent health sweeps, the unknown-gid split, the
half-open peek, and the chaos failover soak with the reference's seed 7
(two replicas, one killed under load, a seeded wire-drop schedule, the
rejoin by resume, the redelivery journal against its replay). Each
scenario returns the door's counters, breaker states, placement order
and answers (counts and ``match_gids``); the port's records must equal
the reference's, as must every peer's record (the harness of
``tests/test_torch_replica.py``). Then the port's own rules: a failing
health poll is counted (``router.poll_errors``) and the poll lives on,
and every typed serve refusal maps to its own HTTP status.

Left out of the comparison, because thread timing decides them: in the
soak, every peer's record (the concurrent ingest writes on a clock, so
the atom maps, op logs, digests and counters of all nodes are
timing-bound); the soak compares its answers (counts and
``match_gids``), its placement order, the door's counters and breaker
states, and checks each replica's content against the primary's inside
the scenario. The other cases build no peer.

Tolerance: exact equality.
"""

from __future__ import annotations

import random
import threading
import time

import pytest

from tests.test_torch_replica import both, faults, serve_cfg  # noqa: F401


class FakeBackend:
    """Scripted backend: submit returns a tagged dict or raises what the
    script says; health is injectable."""

    def __init__(self, backend_id, lag=0, healthy=True, queue_depth=0,
                 breaker_worst=0):
        self.id = backend_id
        self.lag = lag
        self.healthy = healthy
        self.queue_depth = queue_depth
        self.breaker_worst = breaker_worst
        self.fail_with = None
        self.calls = 0

    def submit(self, payload, timeout):
        self.calls += 1
        if self.fail_with is not None:
            raise self.fail_with
        return {"answered_by": self.id}

    def health(self):
        if not self.healthy:
            raise ConnectionError("down")
        return True, {"replication_lag": self.lag,
                      "queue_depth": self.queue_depth,
                      "breaker_worst": self.breaker_worst}


def door_record(fd, *backends) -> dict:
    """What a door observed: its counters, each backend's breaker state
    and the calls each fake backend took."""
    return {"counters": dict(fd.metrics.counters),
            "breakers": {b.id: fd.breaker.state_of(b.id) for b in backends},
            "calls": {b.id: getattr(b, "calls", None) for b in backends}}


def make_router(replicas, **cfg_kw):
    cfg_kw.setdefault("poll_interval_s", 0)     # lazy refresh (tests)
    cfg_kw.setdefault("health_refresh_s", 0.0)  # always fresh
    primary = FakeBackend("primary")
    fd = FrontDoor(primary, replicas, RouterConfig(**cfg_kw))
    return fd, primary


def sc_placement_spreads_across_equal_lag_replicas():
    r1, r2 = FakeBackend("r1"), FakeBackend("r2")
    fd, primary = make_router([r1, r2])
    order = [fd.submit({"kind": "x"})["routed_to"] for _ in range(6)]
    routed = set(order)
    assert routed == {"r1", "r2"}          # round-robin within the group
    assert primary.calls == 0
    return dict(door_record(fd, r1, r2, primary), order=order)


def sc_placement_prefers_lower_lag():
    fresh, stale = FakeBackend("fresh", lag=0), FakeBackend("stale", lag=50)
    fd, _ = make_router([stale, fresh])
    for _ in range(4):
        assert fd.submit({"kind": "x"})["routed_to"] == "fresh"
    return door_record(fd, stale, fresh)


def sc_placement_load_tiebreak_at_equal_lag():
    """ROADMAP 3c: two equally-lagged replicas, one with a deep
    admission queue — the idle one wins every placement; load never
    overrides a LAG difference."""
    idle = FakeBackend("idle", lag=0, queue_depth=0)
    busy = FakeBackend("busy", lag=0, queue_depth=500)
    fd, _ = make_router([busy, idle])
    for _ in range(6):
        assert fd.submit({"kind": "x"})["routed_to"] == "idle"
    # lag-first stays the primary key: a fresher-but-busy replica still
    # beats a laggier idle one
    busy.lag, idle.lag = 0, 10
    fd.refresh_health()
    assert fd.submit({"kind": "x"})["routed_to"] == "busy"
    return door_record(fd, busy, idle)


def sc_placement_breaker_penalty_sheds_degraded_replica():
    """A replica whose OWN serve breaker reports non-closed loses an
    equal-lag, equal-queue tie to a clean sibling."""
    clean = FakeBackend("clean", lag=0)
    degraded = FakeBackend("degraded", lag=0, breaker_worst=2)
    fd, _ = make_router([degraded, clean])
    for _ in range(6):
        assert fd.submit({"kind": "x"})["routed_to"] == "clean"
    # the load score rides the router's own health payload
    _, payload = fd.health_probe()()
    assert payload["backends"]["degraded"]["load_score"] > \
        payload["backends"]["clean"]["load_score"]
    return dict(door_record(fd, degraded, clean), health=payload)


def sc_dead_replica_trips_breaker_and_reroutes_with_zero_errors():
    r1, r2 = FakeBackend("r1"), FakeBackend("r2")
    fd, primary = make_router([r1, r2], breaker_threshold=2,
                              breaker_cooldown_s=60.0)
    r1.fail_with = TransientFault("dead")
    for _ in range(12):
        out = fd.submit({"kind": "x"})     # never raises
        assert out["routed_to"] in ("r2", "primary")
    # bounded probes: r1 ate exactly `threshold` failed submits, then
    # its OPEN gate re-routed everything without touching it
    assert r1.calls == 2
    assert fd.breaker.state_of("r1") == OPEN
    assert fd.metrics.counters.get("router.errors", 0) == 0
    assert fd.metrics.counters.get("router.rerouted", 0) == 2
    return door_record(fd, r1, r2, primary)


def sc_health_poll_readmits_rejoined_replica():
    r1, r2 = FakeBackend("r1"), FakeBackend("r2")
    fd, _ = make_router([r1, r2], breaker_threshold=1,
                        breaker_cooldown_s=60.0)
    # the death: health still answers while the first submit fails —
    # the breaker trips on that submit; the next poll sees it DOWN
    r1.fail_with = TransientFault("dying")
    for _ in range(4):                 # round-robin probes r1 within 2
        fd.submit({"kind": "x"})
        if r1.calls:
            break
    assert fd.breaker.state_of("r1") == OPEN
    r1.healthy = False
    fd.refresh_health()
    # rejoin: the unhealthy→healthy EDGE resets the gate immediately
    # (no cooldown wait — it was set to 60 s on purpose)
    r1.fail_with = None
    r1.healthy = True
    fd.refresh_health()
    assert fd.breaker.state_of("r1") == CLOSED
    assert fd.metrics.counters.get("router.readmissions", 0) == 1
    order = [fd.submit({"kind": "x"})["routed_to"] for _ in range(4)]
    assert "r1" in set(order)
    return dict(door_record(fd, r1, r2), order=order)


def sc_http_deadline_exceeded_propagates_unstruck():
    """Over HTTP a 504 body must map back to typed DeadlineExceeded —
    read as TransientFault it would strike a healthy replica's breaker
    and retry a dead-on-arrival request across the whole tier."""
    def expired(payload):
        raise DeadlineExceeded("budget spent in the queue")

    with SubmitServer(expired,
                      health=lambda: (True, {"replication_lag": 0})) as srv:
        be = HTTPBackend("r1", srv.url)
        with pytest.raises(DeadlineExceeded):
            be.submit({"kind": "bfs", "seed": 1}, timeout=10.0)
        fd = FrontDoor(FakeBackend("primary"), [be],
                       RouterConfig(poll_interval_s=0,
                                    health_refresh_s=0.0))
        with pytest.raises(DeadlineExceeded):
            fd.submit({"kind": "bfs", "seed": 1})
        # un-struck: the breaker stays CLOSED, nothing fell back
        assert fd.breaker.state_of("r1") == CLOSED
        assert fd.metrics.counters.get("router.rerouted", 0) == 0
        assert fd.metrics.counters.get("router.primary_fallbacks", 0) == 0
        assert fd.metrics.counters.get("router.errors", 0) == 1
        return door_record(fd, be)


def sc_all_replicas_down_primary_answers():
    r1 = FakeBackend("r1", healthy=False)
    fd, primary = make_router([r1])
    out = fd.submit({"kind": "x"})
    assert out["routed_to"] == "primary"
    assert fd.metrics.counters.get("router.primary_fallbacks", 0) == 1
    return door_record(fd, r1, primary)


# --------------------------------------------------------- the chaos soak


class NodeBackend:
    """A LocalBackend whose node can be REPLACED (the rejoin path: a
    killed node's successor serves under the same backend id)."""

    def __init__(self, backend_id, get_node):
        self.id = backend_id
        self._get = get_node

    def submit(self, payload, timeout):
        return submit_payload(self._get().runtime, payload, timeout)

    def health(self):
        return self._get().health_probe()()


def bfs_truth_gids(g, seed_h, hops):
    reached = {int(a) for _, a in HGBreadthFirstTraversal(
        g, seed_h, max_distance=hops)}
    reached.add(int(seed_h))
    return {transfer.existing_gid(g, h) for h in reached}


def pattern_truth_gids(g, anchor_h):
    return {transfer.existing_gid(g, int(h))
            for h in g.find_all(c.Incident(int(anchor_h)))}


def wait_for(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def sc_chaos_failover_soak(faults, tmp_path):
    SEED = 7
    rng = random.Random(SEED)
    net = LoopbackNetwork()

    # -- primary: a fixed main cluster (truths) + its own serve runtime
    gp = hg.HyperGraph()
    pp = HyperGraphPeer.loopback(gp, net, identity="primary")
    pp.replication.debounce_s = 0.005
    pp.replication.send_backoff_s = 0.001
    pp.replication.redelivery_interval_s = 0.01
    pp.replication.max_redeliveries = 2          # exhaustable budget
    # bound the dead-replica backlog: each queued message costs a probe
    # ladder to drop, and the soak's settle barriers must stay fast
    pp.replication.max_redelivery_backlog = 500
    pp.replication.journal_path = str(tmp_path / "primary.redelivery.jsonl")
    pp.start()
    nodes = [int(gp.add(f"m{i}")) for i in range(24)]
    for j in range(36):
        a, b = rng.sample(nodes, 2)
        gp.add_link((a, b), value=f"me{j}")

    # -- two serving replicas
    def new_replica(ident):
        gr = hg.HyperGraph()
        pr = HyperGraphPeer.loopback(gr, net, identity=ident)
        pr.replication.debounce_s = 0.005
        node = ReplicaNode(gr, pr, ReplicaConfig(
            primary="primary", anti_entropy_interval_s=0.1,
            serve=serve_cfg()))
        node.start()
        return node

    n1, n2 = new_replica("r1"), new_replica("r2")
    current = {"r1": n1, "r2": n2}
    assert pp.replication.flush()
    assert n1.wait_converged(timeout=30) and n2.wait_converged(timeout=30)
    assert wait_for(lambda: transfer.content_digest(gp)
                    == transfer.content_digest(n1.graph))
    assert wait_for(lambda: transfer.content_digest(gp)
                    == transfer.content_digest(n2.graph))

    # gid-addressed requests + truths (main cluster only, so the
    # concurrent ingest below can never invalidate them)
    gid_of = {h: transfer.gid_of(gp, h, "primary") for h in nodes}
    requests = []
    for _ in range(45):
        h = rng.choice(nodes)
        if rng.random() < 0.5:
            hops = rng.choice((1, 2))
            requests.append((
                {"kind": "bfs", "seed_gid": gid_of[h], "max_hops": hops,
                 "gids": True, "deadline_s": 10.0},
                lambda h=h, hops=hops: bfs_truth_gids(gp, h, hops),
            ))
        else:
            requests.append((
                {"kind": "pattern", "anchor_gids": [gid_of[h]],
                 "gids": True, "deadline_s": 10.0},
                lambda h=h: pattern_truth_gids(gp, h),
            ))

    prt = ServeRuntime(gp, serve_cfg())
    fd = FrontDoor(
        LocalBackend("primary", prt, runtime_health(prt), role="primary"),
        [NodeBackend("r1", lambda: current["r1"]),
         NodeBackend("r2", lambda: current["r2"])],
        # deterministic soak: NO background poll — the kill must be
        # discovered by failing submits (the breaker path), the rejoin
        # by an explicit health refresh (the re-admission edge)
        RouterConfig(breaker_threshold=2, breaker_cooldown_s=3600.0,
                     poll_interval_s=0, health_refresh_s=3600.0),
    ).start()

    # concurrent ingest into a DISCONNECTED fresh cluster (truths hold)
    stop_ingest = threading.Event()

    def ingest():
        prev = None
        while not stop_ingest.is_set():
            h = gp.add(f"fresh-{time.monotonic_ns()}")
            if prev is not None:
                gp.add_link([prev, h], value="fresh-e")
            prev = int(h)
            time.sleep(0.01)

    ing = threading.Thread(target=ingest, daemon=True)
    ing.start()

    answered = []
    answers = []
    try:
        def fire(req, truth_fn):
            out = fd.submit(dict(req))
            answered.append(out["routed_to"])
            answers.append((out["count"], sorted(
                g for g in out["match_gids"] if g is not None)))
            if not out["truncated"]:
                got = {g for g in out["match_gids"] if g is not None}
                assert got == truth_fn(), f"wrong answer via " \
                    f"{out['routed_to']} for {req}"

        # phase 1: healthy tier — load spreads over the replicas
        for req, truth in requests[:15]:
            fire(req, truth)
        assert set(answered) <= {"r1", "r2"}
        assert len(set(answered)) == 2

        # phase 2: KILL r2 mid-load (no drain — a death, not a drain)
        n2.stop(drain=False)
        for req, truth in requests[15:30]:
            fire(req, truth)         # zero caller-visible errors
        assert fd.metrics.counters.get("router.errors", 0) == 0
        assert {a for a in answered[15:]} <= {"r1", "primary"}
        # the dead replica cost exactly `threshold` probes, then its
        # OPEN gate re-routed the rest without touching it
        assert fd.breaker.state_of("r2") == OPEN
        assert fd.metrics.counters.get("router.rerouted", 0) == 2
        fd.refresh_health()          # the poll observes the death

        # quiesce the open-loop ingest so the flush barriers below can
        # actually settle (an unbounded writer never lets flush() see
        # an empty pipeline)
        stop_ingest.set()
        ing.join(timeout=10)

        # the wire-drop schedule: eat ALL replication traffic to r1 so
        # pushes drop past the (size-2) redelivery budget, then heal —
        # contiguity tracking must detect the hole and repair it
        faults.enable(seed=SEED)
        faults.arm("peer.transport.send", prob=1.0,
                   when=lambda ctx: (ctx.get("target") == "r1" and
                                     ctx.get("activity") == "replication"))
        lost = gp.add("lost-under-drops")
        assert pp.replication.flush(timeout=30)
        faults.disarm("peer.transport.send")
        gp.add("after-drops")        # the later push that exposes the hole
        assert pp.replication.flush(timeout=30)
        assert wait_for(lambda: n1.graph.metrics.counters.get(
            "peer.gaps_detected", 0) >= 1)
        assert int(lost) > 0

        # phase 3: r2 REJOINS (same graph + identity, resume bootstrap)
        gr2 = n2.graph
        pr2b = HyperGraphPeer.loopback(gr2, net, identity="r2")
        pr2b.replication.debounce_s = 0.005
        n2b = ReplicaNode(gr2, pr2b, ReplicaConfig(
            primary="primary", anti_entropy_interval_s=0.1,
            serve=serve_cfg()))
        n2b.start()
        assert n2b.bootstrap_mode == "resume"
        current["r2"] = n2b
        assert n2b.wait_converged(timeout=30)  # lag back to 0 → the
        # placement's least-lagged group holds BOTH replicas again
        # the next health poll sees the unhealthy→healthy edge and
        # re-admits immediately (cooldown is 1 h on purpose: only the
        # edge reset can close the gate here)
        fd.refresh_health()
        assert fd.breaker.state_of("r2") == CLOSED
        assert fd.metrics.counters.get("router.readmissions", 0) >= 1
        for req, truth in requests[30:]:
            fire(req, truth)
        assert "r2" in set(answered[30:])   # load returned to the rejoiner

        # -- final convergence: settle, compare content
        assert pp.replication.flush(timeout=30)
        for node in (current["r1"], current["r2"]):
            assert wait_for(
                lambda n=node: transfer.content_digest(gp)
                == transfer.content_digest(n.graph), timeout=30), \
                "replica diverged from primary"

        # accounting: every request answered, none errored
        m = fd.metrics.counters
        assert m.get("router.submitted") == len(requests)
        assert (m.get("router.routed_replica", 0)
                + m.get("router.primary_fallbacks", 0)) == len(requests)
        assert m.get("router.errors", 0) == 0
        assert m.get("router.readmissions", 0) >= 1

        # journal == offline replay: the settled queue is empty and the
        # journal file replays to exactly that
        import json
        with open(pp.replication.journal_path, encoding="utf-8") as f:
            journal = [json.loads(line) for line in f if line.strip()]
        mem = [(pid, msg["content"]["seq"])
               for pid, dq in pp.replication._redelivery.items()
               for msg, _ in dq]
        assert [(r["pid"], r["message"]["content"]["seq"])
                for r in journal] == mem
        rec = dict(door_record(fd), answered=answered, answers=answers,
                   modes=[n1.bootstrap_mode, n2.bootstrap_mode,
                          n2b.bootstrap_mode],
                   gaps=n1.graph.metrics.counters.get(
                       "peer.gaps_detected", 0) >= 1)
    finally:
        stop_ingest.set()
        fd.stop()
        prt.close()
        for node in set(current.values()):
            node.stop()
        pp.stop()
        gp.close()
    return rec


def sc_router_health_probe_reflects_backend_state():
    """The router's own /healthz is the tier's truth: all backends dead
    must read unhealthy (a load balancer over several routers needs the
    dead-tier signal), any live replica or the primary reads healthy."""
    r1 = FakeBackend("r1", healthy=False)
    primary = FakeBackend("primary")
    fd = FrontDoor(primary, [r1],
                   RouterConfig(poll_interval_s=0, health_refresh_s=0.0))
    fd.refresh_health()
    probe = fd.health_probe()

    healthy, payload = probe()
    assert healthy and payload["primary_healthy"]  # primary carries it
    assert not payload["backends"]["r1"]["healthy"]

    primary.healthy = False
    healthy, payload = probe()
    assert not healthy and not payload["primary_healthy"]

    r1.healthy = True
    fd.refresh_health()
    healthy, payload = probe()
    assert healthy and payload["backends"]["r1"]["healthy"]
    return dict(door_record(fd, r1, primary), health=payload)


def sc_refresh_health_probes_concurrently_and_deduplicates():
    """One sweep probes all replicas in parallel (wall time ~ the
    slowest single probe, not the sum) and concurrent sweeps collapse
    to one — a blackholed replica must not stack N x timeout onto the
    lazy-mode submit path."""
    import threading as _threading


    class SlowBackend(FakeBackend):
        probes = 0

        def health(self):
            SlowBackend.probes += 1
            time.sleep(0.3)
            return super().health()

    replicas = [SlowBackend(f"r{i}") for i in range(3)]
    fd = FrontDoor(FakeBackend("primary"), replicas,
                   RouterConfig(poll_interval_s=0, health_refresh_s=0.0))
    t0 = time.monotonic()
    fd.refresh_health()
    assert time.monotonic() - t0 < 0.75          # serial would be >= 0.9
    assert SlowBackend.probes == 3

    # dedup: a sweep already in flight makes the second call a no-op
    SlowBackend.probes = 0
    ts = [_threading.Thread(target=fd.refresh_health) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert SlowBackend.probes == 3               # one sweep, not two
    return door_record(fd, *replicas)


def sc_unknown_gid_permanent_on_primary_retryable_on_replica():
    """A gid miss is a replication race on a replica (re-route, no
    breaker strike) but a caller error on the primary (source of truth):
    the tier must answer 400-permanent, not 503-retry-forever."""
    gp = hg.HyperGraph()
    gp.add("anchor")
    prt = ServeRuntime(gp, serve_cfg())
    gr = hg.HyperGraph()
    rrt = ServeRuntime(gr, serve_cfg())
    try:
        replica = LocalBackend("r1", rrt)
        primary = LocalBackend("primary", prt, role="primary")
        with pytest.raises(AdmissionGated):
            replica.submit({"kind": "bfs", "seed_gid": "no-such"}, 5)
        with pytest.raises(Unservable):
            primary.submit({"kind": "bfs", "seed_gid": "no-such"}, 5)
        fd = FrontDoor(primary, [replica],
                       RouterConfig(poll_interval_s=0,
                                    health_refresh_s=0.0))
        with pytest.raises(Unservable):
            fd.submit({"kind": "bfs", "seed_gid": "no-such"})
        # the replica's miss re-routed without a breaker strike
        assert fd.breaker.state_of("r1") == CLOSED
        assert fd.metrics.counters.get("router.lag_rerouted", 0) == 1
        rec = door_record(fd, replica)
    finally:
        prt.close()
        rrt.close()
        gp.close()
        gr.close()
    return rec


def sc_placement_peek_does_not_burn_half_open_probe():
    """Ranking candidates must not consume the one-probe-per-cooldown
    half-open token: a request answered before reaching the gated
    backend would otherwise starve that backend's actual recovery
    probe."""
    t = [0.0]
    r1 = FakeBackend("r1")
    fd, primary = make_router([r1], clock=lambda: t[0],
                              breaker_cooldown_s=1.0)
    r1.fail_with = TransientFault("down")
    fd.submit({"kind": "x"})                  # strike 1 (primary answers)
    fd.submit({"kind": "x"})                  # strike 2 → OPEN
    assert fd.breaker.state_of("r1") == OPEN
    t[0] += 10.0                               # past the cooldown
    for _ in range(5):
        assert fd._placement()                 # peeks only
    assert fd.breaker.state_of("r1") == OPEN   # no transition consumed
    r1.fail_with = None
    out = fd.submit({"kind": "x"})             # the real probe, intact
    assert out["routed_to"] == "r1"
    return door_record(fd, r1, primary)


# -- the tests -----------------------------------------------------------------


def test_placement_spreads_across_equal_lag_replicas():
    both(globals(), "sc_placement_spreads_across_equal_lag_replicas")


def test_placement_prefers_lower_lag():
    both(globals(), "sc_placement_prefers_lower_lag")


def test_placement_load_tiebreak_at_equal_lag():
    both(globals(), "sc_placement_load_tiebreak_at_equal_lag")


def test_placement_breaker_penalty_sheds_degraded_replica():
    both(globals(), "sc_placement_breaker_penalty_sheds_degraded_replica")


def test_dead_replica_trips_breaker_and_reroutes_with_zero_errors():
    both(globals(),
         "sc_dead_replica_trips_breaker_and_reroutes_with_zero_errors")


def test_health_poll_readmits_rejoined_replica():
    both(globals(), "sc_health_poll_readmits_rejoined_replica")


def test_http_deadline_exceeded_propagates_unstruck():
    both(globals(), "sc_http_deadline_exceeded_propagates_unstruck")


def test_all_replicas_down_primary_answers():
    both(globals(), "sc_all_replicas_down_primary_answers")


def test_chaos_failover_soak(tmp_path):
    # the concurrent ingest's atoms (a writer on a clock) reach every
    # node's op log, atom map and digest at timing-bound points
    both(globals(), "sc_chaos_failover_soak",
         unstable=("gids", "log", "head", "floor", "seen", "digest",
                   "counters"), tmp_path=tmp_path)


def test_router_health_probe_reflects_backend_state():
    both(globals(), "sc_router_health_probe_reflects_backend_state")


def test_refresh_health_probes_concurrently_and_deduplicates():
    both(globals(),
         "sc_refresh_health_probes_concurrently_and_deduplicates")


def test_unknown_gid_permanent_on_primary_retryable_on_replica():
    both(globals(),
         "sc_unknown_gid_permanent_on_primary_retryable_on_replica")


def test_placement_peek_does_not_burn_half_open_probe():
    both(globals(), "sc_placement_peek_does_not_burn_half_open_probe")


# -- the port's own rules ----------------------------------------------------------


def test_poll_failures_are_counted_and_the_poll_lives():
    """The reference logs and drops an exception of the door's health poll
    (``replica/router.py:483``); the port counts it
    (``router.poll_errors``) and the poll thread keeps sweeping."""
    from hypergraphdb_tpu_torch.replica import FrontDoor, RouterConfig

    r1 = FakeBackend("r1")
    fd = FrontDoor(FakeBackend("primary"), [r1],
                   RouterConfig(poll_interval_s=0.01))
    calls = {"n": 0}
    real = fd.refresh_health

    def flaky():
        calls["n"] += 1
        if 2 <= calls["n"] <= 4:        # the poll's first three sweeps
            raise RuntimeError("sweep failed")
        return real()

    fd.refresh_health = flaky
    fd.start()                          # start() sweeps once itself
    try:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and calls["n"] < 7:
            time.sleep(0.01)
        assert calls["n"] >= 7                     # the poll lived on
        assert fd.metrics.counters["router.poll_errors"] == 3
        assert fd._poll_thread is not None and fd._poll_thread.is_alive()
    finally:
        fd.stop()


def test_every_serve_refusal_maps_to_its_own_status():
    """Each typed refusal of the serve runtime (every subclass of
    ``ServeError``) maps to a status of its own (none falls through to the
    generic 500), and the status map equals the reference's for the
    shared types."""
    import inspect

    import hypergraphdb_tpu.replica.httpd as ref_httpd
    import hypergraphdb_tpu.serve.types as ref_types
    from hypergraphdb_tpu_torch.replica.httpd import _status_of
    from hypergraphdb_tpu_torch.serve import types as port_types

    errors = [v for _, v in inspect.getmembers(port_types, inspect.isclass)
              if issubclass(v, port_types.ServeError)
              and v is not port_types.ServeError]
    assert errors
    for cls in errors:
        exc = cls.__new__(cls)
        assert _status_of(exc) != 500, cls.__name__
        ref = getattr(ref_types, cls.__name__, None)
        if ref is not None:
            assert _status_of(exc) == ref_httpd._status_of(
                ref.__new__(ref)), cls.__name__
