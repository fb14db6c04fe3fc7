"""The port's subscription tier under load, beside the reference's
``tests/test_sub_soak.py``:

1. **Differential soak** (3 seeds): standing patterns and ranges under a
   seeded concurrent writer, on both packages' threaded runtimes (the
   port's on ``device="cpu"``). At every checkpoint each consumer's fold
   of the pushed deltas must equal the full re-evaluation against the
   live graph (chained seqs, no duplicate adds, no phantom removals,
   audited digests, zero sheds), as the reference's test asserts on each
   package; and the folded sets of the two packages, checkpoint by
   checkpoint, must be equal (the writer is seeded and stops at each
   checkpoint, so the graphs are).
2. **Coalescing burst**: 1000 dirty standing patterns batch into the
   serve buckets (device dispatches at most a quarter of the evals), on
   the port alone: the reference fails this case (its
   ``_resolve_inflight`` unpacks ``sub.inflight`` outside its lock while
   another pump clears it).
3. **Two pumping threads** over such a burst, beside the dispatch thread:
   the port never raises and counts no pump error.

4. **A standing query through the front door survives its replica's
   death** (the reference's door-resume case, on both packages): a
   pattern subscription placed by ``FrontDoor.subscribe`` on one of two
   replicas, a live delta through it, the owner stopped without a drain
   while the primary adds and removes, then the door's poll re-places
   the original payload on the survivor and answers with one chained
   note (no loss, no duplicate, audited digests), still live after, and
   torn down by ``unsubscribe``. Each package's record (the owner, the
   folded match sets, the door's counters) must be equal.

Tolerance: exact equality; every wait is bounded."""

from __future__ import annotations

import importlib
import random
import threading
import time
from types import SimpleNamespace

import pytest

PKGS = ("hypergraphdb_tpu", "hypergraphdb_tpu_torch")


def package(pkg) -> SimpleNamespace:
    imp = importlib.import_module
    return SimpleNamespace(
        name=pkg, port=pkg == PKGS[1], graph=imp(f"{pkg}.core.graph"),
        config=imp(f"{pkg}.core.config"), serve=imp(f"{pkg}.serve"),
        sub=imp(f"{pkg}.sub"), registry=imp(f"{pkg}.sub.registry"),
        replica=imp(f"{pkg}.replica"), wire=imp(f"{pkg}.sub.wire"))


def new_graph(P):
    kw = {}
    if P.port:
        kw["query"] = P.config.QueryConfig(device="cpu")
    return P.graph.HyperGraph(P.config.HGConfiguration(**kw))


def serve_cfg(P, **kw):
    kw.setdefault("max_linger_s", 0.001)
    kw.setdefault("prewarm_aot", False)
    if P.port:
        kw["device"] = "cpu"
    return P.serve.ServeConfig(**kw)


def busy(mgr) -> bool:
    with mgr._lock:
        return any(s.dirty or s.inflight is not None for s in mgr.subs.all())


def settle(mgr, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        mgr.pump()
        if not busy(mgr):
            return
        time.sleep(0.005)
    raise AssertionError("subscriptions never settled")


class Folder:
    """A consumer's fold of the pushed deltas, enforcing the delivery
    contract on every note."""

    def __init__(self, P, subscribed: dict):
        assert subscribed["what"] == "subscribed"
        self.P = P
        self.matches = {int(m) for m in subscribed["matches"]}
        self.seq = subscribed["seq"]
        assert subscribed["digest"] == P.registry.match_digest(self.matches)

    def fold_env(self, env: dict) -> None:
        assert env["what"] == "notifications", env
        for n in env["notes"]:
            assert n["what"] == "notification"
            assert self.seq <= n["seq_from"] <= n["seq_to"]
            added = {int(x) for x in n["added"]}
            removed = {int(x) for x in n["removed"]}
            assert added.isdisjoint(self.matches), "duplicate delivery"
            assert removed <= self.matches, "phantom removal"
            self.matches -= removed
            self.matches |= added
            self.seq = n["seq_to"]
            assert n["digest"] == self.P.registry.match_digest(self.matches)

    def drain(self, poll) -> None:
        while True:
            env = poll()
            self.fold_env(env)
            if not env["notes"] and not env["more"]:
                return


def soak(P, seed: int) -> list:
    """The reference's differential soak on package ``P``; returns each
    checkpoint's folded match sets in subscription order."""
    rng = random.Random(seed)
    g = new_graph(P)
    hubs = [int(g.add(f"hub{i}")) for i in range(6)]
    pool = [int(g.add(f"n{i}")) for i in range(30)]
    links = [int(g.add_link((rng.choice(hubs), rng.choice(pool)),
                            value=5000 + rng.randrange(180)))
             for _ in range(40)]
    vatoms = [int(g.add(5000 + rng.randrange(180))) for _ in range(20)]
    rt = P.serve.ServeRuntime(g, serve_cfg(P, buckets=(4,)))
    mgr = P.sub.SubscriptionManager(g, rt)
    rt.attach_subscriptions(mgr)
    record = []
    try:
        folders = {}
        for h in hubs:
            r = mgr.subscribe("pattern", {"anchors": [h]}, window=512)
            folders[r["id"]] = Folder(P, r)
        for k in range(4):
            lo = 5000 + k * 40
            r = mgr.subscribe("range", {"lo": lo, "hi": lo + 60},
                              window=512)
            folders[r["id"]] = Folder(P, r)

        checkpoints = 3
        barrier = threading.Barrier(2, timeout=120)
        failures = []

        def writer():
            w = random.Random(seed * 7 + 1)
            try:
                for _ in range(checkpoints):
                    for _ in range(25):
                        p = w.random()
                        if p < 0.45:
                            links.append(int(g.add_link(
                                (w.choice(hubs), w.choice(pool)),
                                value=5000 + w.randrange(180))))
                        elif p < 0.65:
                            vatoms.append(int(
                                g.add(5000 + w.randrange(180))))
                        elif p < 0.80 and vatoms:
                            g.replace(w.choice(vatoms),
                                      5000 + w.randrange(180))
                        elif p < 0.92 and links:
                            g.remove(links.pop(w.randrange(len(links))))
                        elif vatoms:
                            g.remove(vatoms.pop(w.randrange(len(vatoms))))
                    barrier.wait()   # checkpoint: the graph is stable
                    barrier.wait()   # verified: resume writing
            except Exception as e:  # surface it, don't deadlock
                failures.append(e)
                barrier.abort()

        t = threading.Thread(target=writer)
        t.start()
        for ck in range(checkpoints):
            barrier.wait()
            settle(mgr)
            sets = []
            for sid, f in folders.items():
                f.drain(lambda s=sid: mgr.poll(s, max_notes=64,
                                               timeout_s=0.0))
                sub = mgr.subs.get(sid)
                assert f.matches == mgr._full_eval(sub), (
                    f"seed {seed} checkpoint {ck}: {sub.kind} fold "
                    f"diverged from the full re-evaluation")
                sets.append(sorted(f.matches))
            record.append(sets)
            barrier.wait()
        t.join(timeout=60)
        assert not t.is_alive() and not failures
        assert mgr.stats.shed == 0
        snap = mgr.stats.snapshot()
        assert snap["sub.resyncs"] == 0
        assert snap["sub.notified"] > 0
        assert snap["sub.eval_errors"] == 0
        if P.port:
            assert snap["sub.pump_errors"] == snap["sub.listener_errors"] == 0
    finally:
        mgr.close()
        rt.close(drain=False)
        g.close()
    return record


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_differential_soak_incremental_equals_full_eval(seed):
    got = {pkg: soak(package(pkg), seed) for pkg in PKGS}
    assert got[PKGS[1]] == got[PKGS[0]]


def burst_rig():
    P = package(PKGS[1])
    rng = random.Random(5)
    g = new_graph(P)
    hubs = [int(g.add(f"hub{i}")) for i in range(8)]
    pool = [int(g.add(i)) for i in range(64)]
    for j in range(256):
        g.add_link((hubs[j % 8], rng.choice(pool)), value=j)
    rt = P.serve.ServeRuntime(
        g, serve_cfg(P, buckets=(64,), max_linger_s=0.005))
    mgr = P.sub.SubscriptionManager(g, rt)
    mgr.config.max_subscriptions = 2048
    rt.attach_subscriptions(mgr)
    sids = [mgr.subscribe("pattern", {"anchors": [hubs[i % 8]]},
                          window=64)["id"] for i in range(1000)]
    return SimpleNamespace(P=P, g=g, rt=rt, mgr=mgr, hubs=hubs, pool=pool,
                           sids=sids, rng=rng)


def test_thousand_subscription_burst_coalesces_into_buckets():
    """1000 dirty standing patterns re-fire through the same bucketed
    batcher as ad-hoc lanes: device dispatches stay at most a quarter of
    the evals (a dispatch per subscription would be 1:1)."""
    b = burst_rig()
    try:
        settle(b.mgr, timeout=120)
        before = b.rt.stats_snapshot()["device_dispatches"]
        evals_before = b.mgr.stats.evals
        for h in b.hubs:               # one mutation per hub dirties all
            b.g.add_link((h, b.pool[0]), value=9999)
        settle(b.mgr, timeout=300)
        evals = b.mgr.stats.evals - evals_before
        dispatches = b.rt.stats_snapshot()["device_dispatches"] - before
        assert evals >= 1000
        assert 0 < dispatches <= evals // 4, (
            f"{dispatches} dispatches for {evals} evals: the burst did "
            "not coalesce")
        for sid in b.rng.sample(b.sids, 12):
            sub = b.mgr.subs.get(sid)
            assert set(sub.matches) == b.mgr._full_eval(sub)
        assert b.mgr.stats.pump_errors == 0
        assert b.mgr.stats.eval_errors == 0
    finally:
        b.mgr.close()
        b.rt.close(drain=False)
        b.g.close()


def test_two_pumping_threads_over_a_burst_never_raise():
    """Two threads pump the manager in a loop beside the dispatch thread
    (which pumps it too) while a burst re-fires 1000 subscriptions: one
    round owns each eval from submit to resolve, so no pump raises, none
    is counted as an error, and every subscription settles on its full
    re-evaluation."""
    b = burst_rig()
    errors = []
    stop = threading.Event()

    def pumper():
        while not stop.is_set():
            try:
                b.mgr.pump()
            except Exception as e:  # noqa: BLE001 - the failure recorded
                errors.append(e)
                return

    threads = [threading.Thread(target=pumper) for _ in range(2)]
    try:
        for t in threads:
            t.start()
        for _ in range(3):
            for h in b.hubs:
                b.g.add_link((h, b.rng.choice(b.pool)), value=7777)
            deadline = time.monotonic() + 120
            while busy(b.mgr) and time.monotonic() < deadline:
                time.sleep(0.01)
            assert not busy(b.mgr), "the burst never settled"
        stop.set()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert errors == []
        assert b.mgr.stats.pump_errors == 0
        assert b.mgr.stats.eval_errors == 0
        for sid in b.rng.sample(b.sids, 24):
            sub = b.mgr.subs.get(sid)
            assert set(sub.matches) == b.mgr._full_eval(sub)
    finally:
        stop.set()
        b.mgr.close()
        b.rt.close(drain=False)
        b.g.close()


# ------------------------------------------------------- 4. door resume


class SubNodeBackend:
    """A replaceable-node backend that also speaks the subscription verbs
    (the shape ``LocalBackend`` exposes for a primary)."""

    def __init__(self, P, backend_id, get_node):
        self.P = P
        self.id = backend_id
        self._get = get_node

    def _mgr(self):
        m = getattr(self._get().runtime, "subscriptions", None)
        if m is None:
            raise self.P.serve.Unservable(
                f"{self.id} has no subscription tier")
        return m

    def submit(self, payload, timeout):
        return self.P.replica.submit_payload(self._get().runtime, payload,
                                             timeout)

    def subscribe(self, payload, timeout):
        return self.P.wire.subscribe_payload(self._mgr(), payload)

    def poll(self, params, timeout):
        return self.P.wire.poll_payload(self._mgr(), params)

    def health(self):
        return self._get().health_probe()()


def wait_for(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def door_resume(P, tmp_path) -> dict:
    """The reference's door-resume case on package ``P``, with its own
    assertions; returns the owner, the folded match sets at each step (as
    gids) and the door's counters."""
    imp = importlib.import_module
    peer = imp(f"{P.name}.peer")
    transfer = imp(f"{P.name}.peer.transfer")
    c = imp(f"{P.name}.query.conditions")
    R = P.replica
    runtime_health = imp(f"{P.name}.obs.http").runtime_health
    rng = random.Random(17)
    net = peer.LoopbackNetwork()
    rec: dict = {}

    def gids(graph, handles):
        # a replica's local handles differ between the packages (their
        # receivers mint handles apart); gids are the shared names
        return sorted(transfer.existing_gid(graph, h) for h in handles)

    gp = new_graph(P)
    pp = peer.HyperGraphPeer.loopback(gp, net, identity="primary")
    pp.replication.debounce_s = 0.005
    pp.replication.send_backoff_s = 0.001
    pp.replication.redelivery_interval_s = 0.01
    pp.replication.max_redeliveries = 2
    pp.replication.max_redelivery_backlog = 500
    pp.replication.journal_path = str(tmp_path / "primary.jsonl")
    pp.start()
    hubs = [int(gp.add(f"hub{i}")) for i in range(4)]
    pool = [int(gp.add(f"p{i}")) for i in range(16)]
    for j in range(24):
        gp.add_link((rng.choice(hubs), rng.choice(pool)), value=100 + j)
    doomed = int(gp.add_link((hubs[0], pool[3]), value=999))

    def new_replica(ident):
        gr = new_graph(P)
        pr = peer.HyperGraphPeer.loopback(gr, net, identity=ident)
        pr.replication.debounce_s = 0.005
        node = R.ReplicaNode(gr, pr, R.ReplicaConfig(
            primary="primary", anti_entropy_interval_s=0.1,
            serve=serve_cfg(P)))
        node.start()
        return node

    n1, n2 = new_replica("r1"), new_replica("r2")
    current = {"r1": n1, "r2": n2}
    prt = fd = None
    try:
        assert pp.replication.flush()
        assert n1.wait_converged(timeout=30) and n2.wait_converged(
            timeout=30)
        for n in (n1, n2):
            assert wait_for(lambda n=n: transfer.content_digest(gp)
                            == transfer.content_digest(n.graph))

        def resolve(graph, value):
            hs = [int(h) for h in graph.find_all(c.AtomValue(value))]
            assert len(hs) == 1
            return hs[0]

        anchor = resolve(n1.graph, "hub0")
        assert anchor == resolve(n2.graph, "hub0")

        def truth(graph):
            return {int(h) for h in
                    graph.find_all(c.Incident(resolve(graph, "hub0")))}

        prt = P.serve.ServeRuntime(gp, serve_cfg(P))
        fd = R.FrontDoor(
            R.LocalBackend("primary", prt, runtime_health(prt),
                           role="primary"),
            [SubNodeBackend(P, "r1", lambda: current["r1"]),
             SubNodeBackend(P, "r2", lambda: current["r2"])],
            R.RouterConfig(breaker_threshold=2, breaker_cooldown_s=3600.0,
                           poll_interval_s=0, health_refresh_s=3600.0),
        ).start()
        fd.refresh_health()
        resp = fd.subscribe({"what": "subscribe", "kind": "pattern",
                             "anchors": [anchor], "window": 64})
        assert resp["what"] == "subscribed"
        dsid = resp["id"]
        assert dsid.startswith("dsub-")
        owner = resp["routed_to"]
        assert owner in ("r1", "r2")
        folder = Folder(P, resp)
        assert folder.matches == truth(n1.graph)
        rec.update(owner=owner, dsid=dsid,
                   start=gids(current[owner].graph, folder.matches))

        def drained_to(want_graph):
            folder.drain(lambda: fd.poll(
                {"id": dsid, "timeout_s": 0.2, "max": 32}))
            return folder.matches == truth(want_graph)

        gp.add_link((hubs[0], pool[0]), value=201)
        assert pp.replication.flush()
        assert wait_for(lambda: drained_to(current[owner].graph))
        rec["live"] = gids(current[owner].graph, folder.matches)

        survivor = "r2" if owner == "r1" else "r1"
        current[owner].stop(drain=False)
        gp.add_link((hubs[0], pool[1]), value=202)
        gp.remove(doomed)
        surv = current[survivor]
        assert wait_for(lambda: transfer.content_digest(gp)
                        == transfer.content_digest(surv.graph))
        assert wait_for(lambda: drained_to(surv.graph), timeout=30)
        assert fd.metrics.counters.get("router.sub_failovers", 0) == 1
        assert fd.metrics.counters.get("router.sub_chain_gaps", 0) == 0
        with fd._lock:
            assert fd._subs[dsid]["backend"] == survivor
        rec["failover"] = gids(surv.graph, folder.matches)

        gp.add_link((hubs[0], pool[2]), value=203)
        assert pp.replication.flush()
        assert wait_for(lambda: drained_to(surv.graph))
        assert fd.metrics.counters.get("router.sub_failovers", 0) == 1
        rec["after"] = gids(surv.graph, folder.matches)

        out = fd.subscribe({"what": "unsubscribe", "id": dsid})
        assert out == {"what": "unsubscribed", "id": dsid}
        with pytest.raises(P.serve.Unservable):
            fd.poll({"id": dsid, "timeout_s": 0.0})
        # router.sub_polls counts the polls a drain took: timing-bound
        rec["counters"] = {k: v for k, v in fd.metrics.counters.items()
                           if k.startswith("router.sub")
                           and k != "router.sub_polls"}
    finally:
        if fd is not None:
            fd.stop()
        if prt is not None:
            prt.close()
        for node in set(current.values()):
            node.stop(drain=False)
        pp.stop()
        gp.close()
    return rec


def test_replica_kill_resumes_subscription_through_door(tmp_path):
    recs = []
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        recs.append(door_resume(package(pkg), d))
    assert recs[1] == recs[0]
