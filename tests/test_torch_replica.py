"""The port's replica node (``hypergraphdb_tpu_torch.replica.node``)
against the reference's: every case of ``tests/test_replica.py``
(bootstrap → follow → serve, the lag gate and ``/healthz``, rejoin by
resume, a failed bootstrap, the in-place and the lazy re-bootstrap, the
anti-entropy loop, the resume gate, a failed resume) runs as one scenario
on both packages with the reference test's own assertions. Each scenario
returns what it observed (bootstrap modes, digests, gate answers, health
payloads, counters, served counts) and every peer it built is observed
before its first ``stop`` (atom map by gid, op log, seen map, digest,
stable counters: ``tests/test_torch_peer.py``'s harness); the port's
records must equal the reference's. Then the port's own rule: the
anti-entropy loop counts a failed probe and lives on.

This file also holds the replica harness the other
``test_torch_replica*`` files import: ``both`` re-binds a scenario's
package names (``ReplicaNode``, ``FrontDoor``, ``ServeConfig``, ...) to
each package in turn; ``serve_cfg`` puts the port's runtimes on the CPU.

Tolerance: exact equality, but for the record fields a case names as
timing-bound (and says why).
"""

from __future__ import annotations

import contextlib
import importlib
import inspect
import time
import types

import pytest

from tests import test_torch_peer as H

PKGS = H.PKGS


def replica_names(pkg: str) -> dict:
    """The replica-tier names a scenario reads, bound to ``pkg``."""
    def mod(sub):
        return importlib.import_module(f"{pkg}.{sub}")

    replica, serve, fault = mod("replica"), mod("serve"), mod("fault")
    names = {n: getattr(replica, n) for n in replica.__all__}
    names.update(
        ServeConfig=serve.ServeConfig, ServeRuntime=serve.ServeRuntime,
        AdmissionGated=serve.AdmissionGated, Unservable=serve.Unservable,
        DeadlineExceeded=serve.DeadlineExceeded,
        TransientFault=fault.TransientFault,
        InjectedCrash=fault.InjectedCrash, CLOSED=fault.CLOSED,
        OPEN=fault.OPEN, runtime_health=mod("obs.http").runtime_health,
        c=mod("query.conditions"), sub_wire=mod("sub.wire"),
        HGBreadthFirstTraversal=mod(
            "algorithms.traversals").HGBreadthFirstTraversal)
    return names


def rebind_classes(G: dict) -> None:
    """Classes of the replica parity files (scenario backends) re-made in
    ``G`` with their methods reading ``G``'s package names."""
    for k, v in list(G.items()):
        if (isinstance(v, type) and v.__module__.rsplit(".", 1)[-1]
                .startswith("test_torch_replica")):
            ns = {a: (types.FunctionType(f.__code__, G, f.__name__,
                                         f.__defaults__, f.__closure__)
                      if isinstance(f, types.FunctionType) else f)
                  for a, f in vars(v).items()
                  if a not in ("__dict__", "__weakref__")}
            G[k] = type(v.__name__, v.__bases__, ns)


def run(scope: dict, name: str, pkg: str, fx: dict) -> dict:
    """``tests/test_torch_peer.py``'s ``run_scenario`` with the replica
    names and the scenario backends bound to ``pkg``."""
    scope = dict(scope)
    scope.update(replica_names(pkg))
    G = H.bind(scope, pkg)
    rebind_classes(G)
    fn = G[name]
    with H.tracked(pkg) as seen, contextlib.ExitStack() as stack:
        args = {}
        for p in inspect.signature(fn).parameters:
            if p == "faults":
                args[p] = stack.enter_context(
                    contextlib.contextmanager(G[p])())
            elif p == "tmp_path":
                d = fx["tmp_path"] / pkg
                d.mkdir()
                args[p] = d
            else:
                args[p] = fx[p]
        out = fn(**args)
        for e in seen:
            if e[1] is None:
                e[1] = H.observe_safe(e[0])
    return {"result": out, "peers": [e[1] for e in seen]}


def both(scope: dict, name: str, unstable=(), result_unstable=(),
         **fx) -> list:
    """Run scenario ``name`` on the reference and on the port; the port's
    record must equal the reference's but for the peer-record fields in
    ``unstable`` and the scenario-result keys in ``result_unstable``.
    Returns both records."""
    recs = [run(scope, name, pkg, fx) for pkg in PKGS]
    for rec in recs:
        for pr in rec["peers"]:
            for k in unstable:
                pr.pop(k, None)
        if isinstance(rec["result"], dict):
            for k in result_unstable:
                rec["result"].pop(k, None)
    assert recs[1] == recs[0]
    return recs


# -- the scenarios' helpers (re-bound to each package) ----------------------


def serve_cfg(**kw):
    kw.setdefault("max_linger_s", 0.001)
    kw.setdefault("prewarm_aot", False)
    if PORT:
        kw["device"] = "cpu"
    return ServeConfig(**kw)


def faults():
    """The package's fault registry, reset around the scenario."""
    f = global_faults()
    f.reset()
    yield f
    f.reset()
    f.disable()


def wait_digest_equal(ga, gb, timeout=30.0):
    """Poll for content convergence. ``wait_converged`` alone is the
    replica's ADVERTISED lag — a push still in flight (sent, not yet
    dispatched) is invisible to it, so equality tests poll the digest."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if transfer.content_digest(ga) == transfer.content_digest(gb):
            return True
        time.sleep(0.02)
    return False


def make_primary(net, n_nodes=16):
    gp = hg.HyperGraph()
    pp = HyperGraphPeer.loopback(gp, net, identity="primary")
    pp.replication.debounce_s = 0.005
    pp.start()
    nodes = [int(gp.add(f"n{i}")) for i in range(n_nodes)]
    for i in range(n_nodes - 1):
        gp.add_link([nodes[i], nodes[i + 1]], value=f"e{i}")
    return gp, pp, nodes


def make_replica(net, ident="replica-1", **cfg_kw):
    gr = hg.HyperGraph()
    pr = HyperGraphPeer.loopback(gr, net, identity=ident)
    pr.replication.debounce_s = 0.005
    cfg_kw.setdefault("anti_entropy_interval_s", 0.1)
    cfg_kw.setdefault("serve", serve_cfg())
    node = ReplicaNode(gr, pr, ReplicaConfig(primary="primary", **cfg_kw))
    return node


def health_view(payload: dict) -> dict:
    """A health payload's replica fields and its key set (the runtime's
    queue and breaker numbers follow thread timing)."""
    keep = ("role", "primary", "peer_id", "replication_lag", "lag_bound",
            "bootstrapped", "bootstrap_mode", "read_gate")
    return {"keys": sorted(payload),
            **{k: payload[k] for k in keep if k in payload}}


def wait_anchored(node, timeout=30.0) -> bool:
    """A restart resumes only from an anchored replication clock: wait for
    it (bounded) rather than read it at once on a loaded host."""
    rep = node.peer.replication
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if rep.last_seen.get("primary") > 0:
            return True
        time.sleep(0.02)
    return False


def chunks(g) -> int:
    return g.metrics.counters.get("peer.transfer_chunks", 0)


def wait_for_rebootstrap(node, gp, chunks_before, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if ("primary" not in node.peer.replication.needs_full_sync
                and chunks(gp) > chunks_before):
            return True
        time.sleep(0.02)
    return False


# -- the reference scenarios -------------------------------------------------


def sc_bootstrap_follow_serve():
    rec = {}
    net = LoopbackNetwork()
    gp, pp, nodes = make_primary(net)
    node = make_replica(net)
    try:
        node.start()
        assert node.bootstrap_mode == "transfer"
        assert pp.replication.flush()
        assert node.wait_converged(timeout=30)
        assert wait_digest_equal(gp, node.graph)
        local_seed = int(transfer.lookup_local(
            node.graph, transfer.gid_of(gp, nodes[0], "primary")))
        res = node.runtime.submit_bfs(local_seed, max_hops=1) \
                  .result(timeout=30)
        assert res.count >= 2
        rec["count"] = int(res.count)
        rec["mode"] = node.bootstrap_mode
        gp.add("fresh")
        assert pp.replication.flush()
        assert wait_digest_equal(gp, node.graph)
        assert node.wait_converged(timeout=30)
        rec["digest"] = transfer.content_digest(node.graph)
        rec["health"] = health_view(node.health_probe()()[1])
    finally:
        node.stop()
        pp.stop()
        gp.close()
        node.graph.close()
    return rec


def sc_lag_gate_refuses_reads_and_unhealths():
    rec = {}
    net = LoopbackNetwork()
    gp, pp, nodes = make_primary(net, n_nodes=6)
    node = make_replica(net, max_replication_lag=4,
                        anti_entropy_interval_s=0)
    try:
        node.start()
        pp.replication.flush()
        assert node.wait_converged(timeout=30)
        ok, payload = node.health_probe()()
        assert ok and payload["replication_lag"] == 0
        assert payload["role"] == "replica"
        assert payload["lag_bound"] == 4
        assert payload["bootstrapped"] is True
        assert "breakers" in payload
        rec["healthy"] = health_view(payload)
        node.peer.replication.peer_heads["primary"] = (
            node.peer.replication.last_seen.get("primary") + 100)
        assert node.replication_lag == 100
        with pytest.raises(AdmissionGated) as ei:
            node.runtime.submit_bfs(0, max_hops=1)
        assert node.runtime.stats.gated == 1
        rec["refusal"] = str(ei.value)
        ok, payload = node.health_probe()()
        assert not ok and "read_gate" in payload
        rec["gated"] = health_view(payload)
        node.peer.replication.peer_heads["primary"] = (
            node.peer.replication.last_seen.get("primary"))
        assert node._read_gate() is None
        ok, _ = node.health_probe()()
        assert ok
    finally:
        node.stop()
        pp.stop()
        gp.close()
        node.graph.close()
    return rec


def sc_rejoin_resumes_without_full_transfer():
    rec = {}
    net = LoopbackNetwork()
    gp, pp, nodes = make_primary(net, n_nodes=8)
    node = make_replica(net, ident="replica-r")
    try:
        node.start()
        pp.replication.flush()
        assert node.wait_converged(timeout=30)
        assert wait_anchored(node)
        transfers_before = chunks(gp)
        node.stop()
        gp.add("while-down-1")
        gp.add("while-down-2")
        pp.replication.flush()
        gr = node.graph
        pr2 = HyperGraphPeer.loopback(gr, net, identity="replica-r")
        pr2.replication.debounce_s = 0.005
        node2 = ReplicaNode(gr, pr2, ReplicaConfig(
            primary="primary", anti_entropy_interval_s=0.1,
            serve=serve_cfg()))
        node2.start()
        assert node2.bootstrap_mode == "resume"
        assert chunks(gp) == transfers_before
        assert node2.wait_converged(timeout=30)
        assert wait_digest_equal(gp, gr)
        rec.update(modes=[node.bootstrap_mode, node2.bootstrap_mode],
                   chunks=transfers_before,
                   digest=transfer.content_digest(gr))
        node2.stop()
    finally:
        pp.stop()
        gp.close()
        node.graph.close()
    return rec


def sc_failed_bootstrap_does_not_leak_started_peer():
    net = LoopbackNetwork()
    gr = hg.HyperGraph()
    pr = HyperGraphPeer.loopback(gr, net, identity="orphan")
    node = ReplicaNode(gr, pr, ReplicaConfig(
        primary="primary", bootstrap_timeout_s=10.0,
        bootstrap_retry_after_s=0.02, bootstrap_max_resumes=2,
        serve=serve_cfg()))
    try:
        with pytest.raises(Exception) as ei:
            node.start()
        assert not pr._started
        assert node.runtime is None
        node.stop()
    finally:
        gr.close()
    return {"raised": type(ei.value).__name__, "started": pr._started,
            "mode": node.bootstrap_mode}


def sc_runtime_truncation_forces_in_place_rebootstrap():
    rec = {}
    net = LoopbackNetwork()
    gp, pp, nodes = make_primary(net, n_nodes=6)
    node = make_replica(net, anti_entropy_interval_s=0.05)
    try:
        node.start()
        pp.replication.flush()
        assert node.wait_converged(timeout=30)
        chunks_before = chunks(gp)
        node.peer.replication.needs_full_sync.add("primary")
        assert wait_for_rebootstrap(node, gp, chunks_before)
        # ``bootstrapped`` flips in the repair's own ``finally``, after the
        # chunks and the mark: a bounded wait, as the lazy case does (the
        # reference's immediate read races it on a loaded host)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not node.bootstrapped:
            time.sleep(0.02)
        assert node.bootstrapped
        gp.add("post-rebootstrap")
        assert pp.replication.flush()
        assert wait_digest_equal(gp, node.graph)
        rec.update(mode=node.bootstrap_mode,
                   digest=transfer.content_digest(node.graph))
    finally:
        node.stop()
        pp.stop()
        gp.close()
        node.graph.close()
    return rec


def sc_anti_entropy_loop_drives_convergence_during_push_outage():
    rec = {}
    net = LoopbackNetwork()
    gp, pp, nodes = make_primary(net, n_nodes=4)
    node = make_replica(net, anti_entropy_interval_s=0.05)
    try:
        node.start()
        pp.replication.flush()
        assert node.wait_converged(timeout=30)
        pp.replication.peer_interests.clear()
        gp.add("push-less")
        assert pp.replication.flush()
        assert wait_digest_equal(gp, node.graph)
        assert node.graph.metrics.counters.get(
            "peer.anti_entropy_probes", 0) >= 1
        rec["digest"] = transfer.content_digest(node.graph)
    finally:
        node.stop()
        pp.stop()
        gp.close()
        node.graph.close()
    return rec


def sc_truncation_lazy_rebootstrap_with_ae_loop_disabled():
    rec = {}
    net = LoopbackNetwork()
    gp, pp, nodes = make_primary(net, n_nodes=6)
    node = make_replica(net, anti_entropy_interval_s=0)
    try:
        node.start()
        assert node._ae_thread is None
        pp.replication.flush()
        assert node.wait_converged(timeout=30)
        chunks_before = chunks(gp)
        node.peer.replication.needs_full_sync.add("primary")
        reason = node._read_gate()
        assert reason is not None and "re-bootstrapping" in reason
        rec["reason"] = reason
        assert wait_for_rebootstrap(node, gp, chunks_before)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not node.bootstrapped:
            time.sleep(0.02)
        assert node.bootstrapped
        assert node._read_gate() is None
        gp.add("post-lazy-rebootstrap")
        assert pp.replication.flush()
        assert wait_digest_equal(gp, node.graph)
        rec["digest"] = transfer.content_digest(node.graph)
    finally:
        node.stop()
        pp.stop()
        gp.close()
        node.graph.close()
    return rec


def sc_resume_gate_until_primary_head_known():
    rec = {}
    net = LoopbackNetwork()
    gp, pp, nodes = make_primary(net, n_nodes=4)
    node = make_replica(net, anti_entropy_interval_s=0)
    try:
        node.start()
        pp.replication.flush()
        assert node.wait_converged(timeout=30)
        node.bootstrap_mode = "resume"
        node.peer.replication.peer_heads.pop("primary", None)
        reason = node._read_gate()
        assert reason is not None and "head unknown" in reason
        ok, payload = node.health_probe()()
        assert not ok and "read_gate" in payload
        rec.update(reason=reason, health=health_view(payload))
        node.peer.replication.peer_heads["primary"] = (
            node.peer.replication.last_seen.get("primary"))
        assert node._read_gate() is None
    finally:
        node.stop()
        pp.stop()
        gp.close()
        node.graph.close()
    return rec


def sc_resume_catch_up_send_failure_fails_bootstrap_typed():
    net = LoopbackNetwork()
    gp, pp, nodes = make_primary(net, n_nodes=4)
    node = make_replica(net, ident="replica-rf")
    try:
        node.start()
        pp.replication.flush()
        assert node.wait_converged(timeout=30)
        assert wait_anchored(node)
        node.stop()
        gr = node.graph
        pr2 = HyperGraphPeer.loopback(gr, net, identity="replica-rf")
        pr2.replication.debounce_s = 0.005
        pr2.replication.catch_up = lambda pid: False
        node2 = ReplicaNode(gr, pr2, ReplicaConfig(
            primary="primary", anti_entropy_interval_s=0,
            serve=serve_cfg()))
        with pytest.raises(TransientFault) as ei:
            node2.start()
        assert not node2._started
    finally:
        pp.stop()
        gp.close()
        node.graph.close()
    return {"raised": type(ei.value).__name__, "message": str(ei.value),
            "mode": node2.bootstrap_mode}


# -- the tests -----------------------------------------------------------------

#: peer-record fields that thread timing decides in a replica tier: the
#: primary's log floor and the entries above it (ack-driven truncation),
#: the seen maps and the counters (anti-entropy probes, repair transfers,
#: redeliveries and acks that land before or after the observation).
#: Each peer's identity, atom map by gid and content digest stay
#: compared; the scenarios record the counters they assert on.
TIMED = ("log", "head", "floor", "seen", "counters")

def test_bootstrap_follow_serve():
    both(globals(), "sc_bootstrap_follow_serve", unstable=TIMED)


def test_lag_gate_refuses_reads_and_unhealths():
    both(globals(), "sc_lag_gate_refuses_reads_and_unhealths",
         unstable=TIMED)


def test_rejoin_resumes_without_full_transfer():
    both(globals(), "sc_rejoin_resumes_without_full_transfer",
         unstable=TIMED)


def test_failed_bootstrap_does_not_leak_started_peer():
    both(globals(), "sc_failed_bootstrap_does_not_leak_started_peer",
         unstable=TIMED)


def test_runtime_truncation_forces_in_place_rebootstrap():
    both(globals(), "sc_runtime_truncation_forces_in_place_rebootstrap",
         unstable=TIMED)


def test_anti_entropy_loop_drives_convergence_during_push_outage():
    both(globals(),
         "sc_anti_entropy_loop_drives_convergence_during_push_outage",
         unstable=TIMED)


def test_truncation_lazy_rebootstrap_with_ae_loop_disabled():
    both(globals(), "sc_truncation_lazy_rebootstrap_with_ae_loop_disabled",
         unstable=TIMED)


def test_resume_gate_until_primary_head_known():
    both(globals(), "sc_resume_gate_until_primary_head_known",
         unstable=TIMED)


def test_resume_catch_up_send_failure_fails_bootstrap_typed():
    both(globals(), "sc_resume_catch_up_send_failure_fails_bootstrap_typed",
         unstable=TIMED)


# -- the port's own rule: a failed anti-entropy probe is counted ----------------


def test_anti_entropy_failures_are_counted_and_the_loop_lives():
    """The reference logs and drops an exception of its anti-entropy loop
    (``replica/node.py:385``); the port counts it in the replica graph's
    metrics (``replica.anti_entropy_errors``) and the loop keeps probing:
    once the probe heals, the replica converges by anti-entropy alone."""
    from hypergraphdb_tpu_torch.core.graph import HyperGraph
    from hypergraphdb_tpu_torch.peer import (
        HyperGraphPeer,
        LoopbackNetwork,
        transfer,
    )
    from hypergraphdb_tpu_torch.replica import ReplicaConfig, ReplicaNode
    from hypergraphdb_tpu_torch.serve import ServeConfig

    net = LoopbackNetwork()
    gp = HyperGraph()
    pp = HyperGraphPeer.loopback(gp, net, identity="primary")
    pp.replication.debounce_s = 0.005
    pp.start()
    gp.add("seed")
    gr = HyperGraph()
    pr = HyperGraphPeer.loopback(gr, net, identity="replica-1")
    node = ReplicaNode(gr, pr, ReplicaConfig(
        primary="primary", anti_entropy_interval_s=0.02,
        serve=ServeConfig(device="cpu", max_linger_s=0.001,
                          prewarm_aot=False)))
    calls = {"n": 0}
    real = pr.replication.anti_entropy

    def flaky(pid):
        calls["n"] += 1
        if calls["n"] <= 3:
            raise RuntimeError("probe failed")
        return real(pid)

    try:
        node.start()
        assert node.wait_converged(timeout=30)
        pr.replication.anti_entropy = flaky
        pp.replication.peer_interests.clear()   # only the probe can heal
        gp.add("after")
        assert pp.replication.flush()
        deadline = time.monotonic() + 30
        while (time.monotonic() < deadline
               and transfer.content_digest(gp)
               != transfer.content_digest(gr)):
            time.sleep(0.02)
        assert transfer.content_digest(gp) == transfer.content_digest(gr)
        assert gr.metrics.counters["replica.anti_entropy_errors"] == 3
        assert calls["n"] > 3                    # the loop lived on
        assert node._ae_thread is not None and node._ae_thread.is_alive()
    finally:
        node.stop()
        pp.stop()
        gp.close()
        gr.close()
