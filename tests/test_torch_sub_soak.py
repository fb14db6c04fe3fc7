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

The replica failover case of the reference waits for the replica tier.
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
        port=pkg == PKGS[1], graph=imp(f"{pkg}.core.graph"),
        config=imp(f"{pkg}.core.config"), serve=imp(f"{pkg}.serve"),
        sub=imp(f"{pkg}.sub"), registry=imp(f"{pkg}.sub.registry"))


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
