"""The port's fleet collector and EXPLAIN records
(``hypergraphdb_tpu_torch.obs.fleet``, ``submit(..., explain=True)``)
against the reference's.

The cases of ``tests/test_fleet.py`` run in both packages: per-node
metric merges, worst-of health, an unreachable node, span trees joined
across two tracers, the trace store's dedupe and bound, last-good
totals, real HTTP scrapes of a ``TelemetryServer`` on ``127.0.0.1`` (and
of a replica's submit server, which answers ``/metrics`` with 404), a
node's incident seen through the collector, the EXPLAIN cases over the
fake executor, the door's fleet routes (``/fleet/metrics``,
``/fleet/healthz``, ``/fleet/traces``, ``/fleet/slo``, their 404 without
a collector), EXPLAIN through ``submit_payload`` and over HTTP, and the
replicated tier end to end (a primary and a replica with their own
tracers behind a front door, a cross-process trace joined from both
peers' halves, the router's counters and a replica-side incident through
the door's port). The merged views, the door's views and the EXPLAIN
records are equal between the packages (trace ids aside, which are
random). Then EXPLAIN on both packages' real
runtimes over one small graph — a record for each lane (bfs, pattern,
range, join) and for the planned host shape — and the port's own rule:
a record that fails to assemble is counted, never swallowed.
Tolerance: exact equality."""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from types import SimpleNamespace
from types import SimpleNamespace as NS

import pytest

from tests.conftest import make_random_hypergraph
from tests.test_torch_graph import PKGS, mod
from tests.test_torch_serve_runtime import FakeClock, FakeExecutor, package

PORT = PKGS[1]


def ns(pkg) -> SimpleNamespace:
    return SimpleNamespace(
        name=pkg, obs=mod(pkg, "obs"), fleet=mod(pkg, "obs.fleet"),
        P=package(pkg), replica=mod(pkg, "replica"))


@pytest.fixture(params=PKGS)
def O(request):
    return ns(request.param)


def make_node(O, node_id, healthy=True, role="node"):
    reg = O.obs.Registry(node_id)
    tracer = O.obs.Tracer(clock=FakeClock()).enable()
    flight = O.obs.FlightRecorder(clock=FakeClock())
    payload = {"role": role, "queue_depth": 0}

    def health():
        return healthy, dict(payload)

    return O.fleet.LocalNodeSource(node_id, registries=[reg], tracer=tracer,
                                   flight=flight, health=health,
                                   role=role), reg, tracer, flight


def collector(O, sources, **kw):
    return O.fleet.FleetCollector(sources, clock=FakeClock(),
                                  flight=O.obs.FlightRecorder(),
                                  poll_interval_s=0, **kw)


# ---------------------------------------------------------------- metrics


def merged(O):
    src_a, reg_a, _, _ = make_node(O, "a")
    src_b, reg_b, _, _ = make_node(O, "b", healthy=False, role="replica")
    reg_a.counter("serve.submitted").inc(3)
    reg_b.counter("serve.submitted").inc(7)
    col = collector(O, [src_a, src_b])
    col.poll()
    return (col.fleet_metrics(), col.metric_total("serve_submitted_total"),
            col.fleet_healthz())


def test_fleet_metrics_keeps_per_node_series_distinct(O):
    text, total, _ = merged(O)
    assert 'serve_submitted_total{node="a"} 3' in text
    assert 'serve_submitted_total{node="b"} 7' in text
    assert text.count("# TYPE serve_submitted_total counter") == 1
    assert 'fleet_polls_total{node="fleet"} 1' in text
    assert total == 10.0


def test_fleet_healthz_worst_of_with_per_node_detail(O):
    ok, payload = merged(O)[2]
    assert ok is False
    assert payload["healthy_nodes"] == 1 and payload["nodes_total"] == 2
    assert payload["nodes"]["a"]["healthy"] is True
    assert payload["nodes"]["b"]["healthy"] is False
    assert payload["nodes"]["b"]["role"] == "replica"
    assert payload["nodes"]["b"]["detail"]["role"] == "replica"


def test_merged_views_equal_the_reference():
    assert merged(ns(PORT)) == merged(ns(PKGS[0]))


def test_unreachable_node_counts_unhealthy_not_fatal(O):
    src_a, *_ = make_node(O, "a")
    dead = O.fleet.HTTPNodeSource("dead", "http://127.0.0.1:1",
                                  timeout_s=0.2)
    col = collector(O, [src_a, dead])
    assert col.poll() == {"a": True, "dead": False}
    ok, payload = col.fleet_healthz()
    assert ok is False and payload["nodes"]["dead"]["scraped"] is False
    assert "error" in payload["nodes"]["dead"]
    assert col.registry.get("fleet.scrape_errors").value == 1


# ---------------------------------------------------- trace assembly


def joined_pair(O):
    src_a, reg_a, ta, _ = make_node(O, "a")
    src_b, reg_b, tb, _ = make_node(O, "b", role="replica")
    reg_a.counter("serve.submitted").inc(1)
    reg_b.counter("serve.submitted").inc(1)
    tr = ta.start_trace("peer.push")
    root = tr.start_span("push")
    tr.marks["root"] = root
    remote = tb.start_remote_trace("peer.apply", tr.context())
    remote.start_span("apply").end()
    remote.finish()
    root.end()
    tr.finish()
    return src_a, src_b, tr, root


def test_fleet_trace_joins_spans_from_two_processes(O):
    src_a, src_b, tr, root = joined_pair(O)
    col = collector(O, [src_a, src_b])
    col.poll()
    joined = col.fleet_trace(tr.trace_id)
    assert joined["n_processes"] == 2 and joined["processes"] == ["a", "b"]
    assert {s["node"] for s in joined["spans"]} == {"a", "b"}
    apply_span = next(s for s in joined["spans"] if s["name"] == "apply")
    assert apply_span["parent_id"] == root.span_id
    push = next(n for n in joined["tree"] if n["name"] == "push")
    assert any(ch["name"] == "apply" and ch["node"] == "b"
               for ch in push.get("children", ()))
    summary = next(s for s in col.fleet_traces()
                   if s["trace_id"] == tr.trace_id)
    assert summary["n_processes"] == 2
    n1 = joined["n_spans"]
    col.poll()
    assert col.fleet_trace(tr.trace_id)["n_spans"] == n1


def test_fleet_trace_store_is_bounded(O):
    src_a, _, ta, _ = make_node(O, "a")
    col = collector(O, [src_a], max_traces=4, traces_limit=64)
    for _ in range(10):
        t = ta.start_trace("serve.request")
        t.start_span("request").end()
        t.finish()
    col.poll()
    assert len(col.fleet_traces()) == 4
    assert col.registry.get("fleet.traces_assembled").value == 4


def test_failed_scrape_keeps_last_good_metrics_totals(O):
    src, reg, _, _ = make_node(O, "a")
    reg.counter("serve.completed").inc(40)
    reg.counter("serve.shed_deadline").inc(10)
    col = collector(O, [src])
    col.poll()
    assert col.metric_total("serve_shed_deadline_total") == 10.0

    def boom(traces_limit=64):
        raise OSError("telemetry port died")

    src.scrape = boom
    col.poll()
    ok, payload = col.fleet_healthz()
    assert ok is False and payload["nodes"]["a"]["scraped"] is False
    assert col.metric_total("serve_shed_deadline_total") == 10.0
    assert col.metric_total("serve_completed_total") == 40.0


class _NullDoor:
    """A submit function the fleet routes never call."""

    def __call__(self, payload):  # pragma: no cover - not exercised
        raise ValueError("no backends in this test")


def test_http_source_rejects_non_200_telemetry_bodies(O):
    """A node whose ``/metrics`` errors fails the scrape: a replica's
    submit server answers ``/metrics`` with a 404 JSON body, which kept as
    metrics text would corrupt the merged page."""
    srv = O.replica.SubmitServer(_NullDoor()).start()
    try:
        scrape = O.fleet.HTTPNodeSource("bad", srv.url).scrape()
    finally:
        srv.stop()
    assert scrape.ok is False and scrape.metrics_text == ""
    assert "404" in scrape.error


def test_http_source_scrapes_a_real_telemetry_server(O):
    _, reg, tracer, flight = make_node(O, "n")
    reg.counter("serve.submitted").inc(5)
    t = tracer.start_trace("serve.request")
    t.start_span("request").end()
    t.finish()
    flight.record("serve.retry", attempt=1)
    srv = O.obs.TelemetryServer(
        registries=[reg], tracer=tracer, flight=flight,
        health=lambda: (True, {"role": "replica"})).start()
    try:
        scrape = O.fleet.HTTPNodeSource("n", srv.url,
                                        role="replica").scrape()
    finally:
        srv.stop()
    assert scrape.ok and scrape.healthy
    assert "serve_submitted_total 5" in scrape.metrics_text
    assert len(scrape.traces) == 1
    assert scrape.flight[-1]["kind"] == "serve.retry"
    assert scrape.health["role"] == "replica"


def test_node_incident_visible_through_fleet_view(O):
    src_a, *_ = make_node(O, "a")
    src_b, _, _, flight_b = make_node(O, "b", role="replica")
    col = collector(O, [src_a, src_b])
    col.poll()
    assert col.incidents() == {}
    flight_b.record("serve.retry", key="bfs_2", attempt=1)
    flight_b.incident("serve_error", error="InjectedFault", tickets=3)
    col.poll()
    snap = col.incidents()
    assert snap["b"]["reason"] == "serve_error"
    kinds = [r["kind"] for r in snap["b"]["window"]]
    assert "serve.retry" in kinds and "incident" in kinds
    ok, payload = col.fleet_healthz()
    assert payload["incidents"]["b"]["reason"] == "serve_error"
    assert "window" not in payload["incidents"]["b"]
    assert col.registry.get("fleet.incidents_seen").value == 1
    col.poll()
    assert col.registry.get("fleet.incidents_seen").value == 1


# ------------------------------------------------------------- EXPLAIN


def traced_runtime(O, **kw):
    tracer = O.obs.Tracer(clock=FakeClock()).enable()
    cfg = O.P.serve.ServeConfig(buckets=(4,), max_linger_s=0.0,
                                clock=FakeClock(), manual=True,
                                tracer=tracer, **kw)
    rt = O.P.serve.ServeRuntime(graph=None, config=cfg,
                                executor=FakeExecutor(O.P))
    return rt, tracer


def test_explain_requires_tracing(O):
    cfg = O.P.serve.ServeConfig(buckets=(4,), max_linger_s=0.0,
                                clock=FakeClock(), manual=True,
                                tracer=O.obs.Tracer())
    rt = O.P.serve.ServeRuntime(graph=None, config=cfg,
                                executor=FakeExecutor(O.P))
    with pytest.raises(O.P.types.Unservable, match="needs tracing"):
        rt.submit_bfs(1, explain=True)
    assert rt.queue.depth() == 0 and rt.stats.submitted == 0
    rt.close()


def explain_once(O):
    rt, tracer = traced_runtime(O)
    fut = rt.submit_bfs(1, explain=True)
    rt.step(drain=True)
    res = fut.result(timeout=0)
    rec = fut.explain
    rt.close()
    drained = [t for t in tracer.drain() if t.name == "serve.request"
               and t.trace_id == rec["trace_id"]]
    again = O.fleet.explain_record(drained[0], result=res,
                                   lane_path="device",
                                   breaker_state=rec["breaker"])
    return rec, again, len(drained)


def test_explain_agrees_exactly_with_drained_span_tree(O):
    rec, again, n = explain_once(O)
    assert n == 1
    for k in ("lane", "occupancy", "bucket", "lanes_real", "device_s",
              "queue_wait_s", "retries", "total_s", "count", "trace_id"):
        assert again[k] == rec[k], k
    assert rec["lane"] == "bfs/device"
    assert rec["occupancy"] == pytest.approx(0.25)
    assert rec["retries"] == 0 and rec["breaker"] == "closed"


def test_explain_record_equals_the_reference():
    ref, _, _ = explain_once(ns(PKGS[0]))
    got, _, _ = explain_once(ns(PORT))
    ref.pop("trace_id")
    got.pop("trace_id")
    assert got == ref


def test_explain_record_is_attached_before_result_delivery(O):
    rt, _ = traced_runtime(O)
    futs = [rt.submit_bfs(i, explain=True) for i in range(3)]
    rt.step(drain=True)
    for fut in futs:
        fut.result(timeout=0)
        assert fut.explain["kind"] == "bfs"
    rt.close()


def test_explain_survives_any_sampling_rate(O):
    rt, tracer = traced_runtime(O)
    tracer.set_sample_rate("serve.request", 0.0)
    fut = rt.submit_bfs(1, explain=True)
    rt.step(drain=True)
    fut.result(timeout=0)
    assert fut.explain is not None
    assert any(t.trace_id == fut.explain["trace_id"] for t in tracer.drain())
    rt.close()


def test_lane_counters_follow_served_path(O):
    rt, _ = traced_runtime(O)
    rt.submit_bfs(1)
    rt.submit_pattern([2])
    rt.step(drain=True)
    rt.step(drain=True)
    counts = rt.stats.lane_counts()
    assert counts[("bfs", "device")] == 1
    assert counts[("pattern", "device")] == 1
    assert counts[("bfs", "host")] == 0
    rt.close()


def test_join_explain_plan_shape_derivation(O):
    derive = O.P.serve.ServeRuntime._join_explain
    res = NS(kind="join")
    flat = NS()
    assert derive(NS(kind="bfs"), "device", NS(join_plan=flat)) is None
    assert derive(res, "host", NS(join_plan=None, join_hub_lanes=0,
                                  join_partials=0)) == {
        "plan": "host", "hub_dispatches": 0, "partial_corrections": 0}
    rec = derive(res, "device", NS(join_plan=flat, join_hub_lanes=0,
                                   join_partials=1))
    assert rec["plan"] == "flat" and rec["partial_corrections"] == 1
    rec = derive(res, "device", NS(join_plan=flat, join_hub_lanes=3,
                                   join_partials=0))
    assert rec["plan"] == "hub" and rec["hub_dispatches"] == 3
    Bushy = mod(O.name, "join.planner").BushyJoinPlan
    rec = derive(res, "device", NS(join_plan=Bushy.__new__(Bushy),
                                   join_hub_lanes=2, join_partials=0))
    assert rec["plan"] == "bushy"


def test_join_explain_record_rides_the_span_tree(O):
    def finished():
        tracer = O.obs.Tracer(clock=FakeClock()).enable()
        tr = tracer.start_trace("serve.request", kind="join")
        tr.finish_terminal("resolve")
        return tr

    join = {"plan": "hub", "hub_dispatches": 2, "partial_corrections": 1}
    assert O.fleet.explain_record(finished(), join=join)["join"] == join
    assert "join" not in O.fleet.explain_record(finished())


def test_explain_failure_is_counted_not_swallowed(monkeypatch):
    """The port's rule: a record that fails to assemble leaves
    ``future.explain`` None, the request still resolves, and
    ``serve.explain_errors`` counts it (the reference counts nothing)."""
    O = ns(PORT)

    def broken(*a, **k):
        raise RuntimeError("record assembly failed")

    monkeypatch.setattr(O.fleet, "explain_record", broken)
    rt, _ = traced_runtime(O)
    fut = rt.submit_bfs(1, explain=True)
    ok = rt.submit_bfs(2)
    rt.step(drain=True)
    assert fut.result(timeout=0).kind == "bfs" and fut.explain is None
    assert ok.result(timeout=0).kind == "bfs"
    assert rt.stats.explain_errors == 1
    assert rt.stats.registry.get("serve.explain_errors").value == 1
    assert rt.stats.completed == 2
    rt.close()


# ------------------------------------- EXPLAIN on the real runtimes


def lane_records(pkg) -> list:
    """EXPLAIN for a request of each lane and for the planned host shape
    on one small graph, through each package's real runtime (the port on
    ``device="cpu"``), trace ids dropped."""
    cfg_mod = mod(pkg, "core.config")
    qc = (cfg_mod.QueryConfig(device="cpu") if pkg == PORT
          else cfg_mod.QueryConfig())
    g = mod(pkg, "core.graph").HyperGraph(cfg_mod.HGConfiguration(query=qc))
    nodes, links = make_random_hypergraph(g, n_nodes=60, n_links=120,
                                          max_arity=3, seed=7)
    c = mod(pkg, "query.conditions")
    var = mod(pkg, "query.variables").var
    obs = mod(pkg, "obs")
    S = mod(pkg, "serve")
    kw = {"device": "cpu"} if pkg == PORT else {}
    rt = S.ServeRuntime(g, S.ServeConfig(
        buckets=(4,), max_linger_s=0.0, manual=True, top_r=128,
        tracer=obs.Tracer(clock=FakeClock()).enable(), **kw))
    rt.attach_planner(mod(pkg, "plan").QueryPlanner(g))
    a = int(nodes[3])
    futs = [
        rt.submit_bfs(a, max_hops=2, explain=True),
        rt.submit_pattern([a, int(nodes[4])], explain=True),
        rt.submit_range(lo=10, hi=40, explain=True),
        rt.submit_join({"y": c.And(c.CoIncident(a), c.CoIncident(var("z"))),
                        "z": c.CoIncident(a)}, explain=True),
        rt.submit_planned(c.And(c.Incident(a), c.AtomType(
            int(g.get_type_handle_of(links[0])))), explain=True,
            force_shape="pattern"),
        rt.submit_planned(c.AtomValue(11, "eq"), explain=True,
                          force_shape="host"),
    ]
    while rt.step(drain=True):
        pass
    out = []
    for f in futs:
        res = f.result(timeout=0)
        rec = dict(f.explain)
        rec.pop("trace_id", None)
        out.append((res.kind, res.count, rec))
    out.append(rt.stats.explain_errors if pkg == PORT else 0)
    rt.close()
    g.close()
    return out


def test_explain_each_lane_and_the_host_shape_equal_the_reference():
    ref, got = lane_records(PKGS[0]), lane_records(PORT)
    assert got == ref
    kinds = [r[0] for r in got[:-1]]
    assert kinds == ["bfs", "pattern", "range", "join", "planned",
                     "planned"]
    bfs, pattern, rng, join, planned, host = (r[2] for r in got[:-1])
    assert bfs["lane"] == "bfs/device" and bfs["bucket"] == 4
    assert join["join"]["plan"] in ("flat", "bushy", "hub", "host")
    assert planned["plan"]["shape"] == "pattern"
    assert planned["plan"]["actual_rows"] >= 0 and planned["kind"] == "pattern"
    assert host == {"lane": {"kind": "host", "path": "host"},
                    "plan": host["plan"]}
    assert host["plan"]["shape"] == "host"
    assert got[-1] == 0


# ----------------------------------------------------- the door's HTTP port


def get(url):
    """(status, body): urllib raises on >= 400, both are wanted."""
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture
def door(O):
    src_a, src_b, tr, _ = joined_pair(O)
    col = O.fleet.FleetCollector([src_a, src_b], clock=FakeClock(),
                                 flight=O.obs.FlightRecorder(),
                                 poll_interval_s=0)
    col.slo = O.obs.SLOMonitor(clock=col.clock, flight=col.flight)
    col.slo.add(O.obs.Objective("availability", 0.999))
    col.poll()
    srv = O.replica.SubmitServer(_NullDoor(), fleet=col).start()
    try:
        yield srv, col, tr
    finally:
        srv.stop()


def door_views(srv, tr) -> dict:
    """What the door's fleet routes answer (trace ids, which are random,
    replaced by their role)."""
    out = {}
    for route in ("/fleet/healthz", "/fleet/slo", "/fleet/traces/12345",
                  "/fleet/traces/not-an-id", "/fleet/nope"):
        status, body = get(srv.url + route)
        out[route] = (status, json.loads(body))
    status, body = get(srv.url + f"/fleet/traces/{tr.trace_id}")
    joined = json.loads(body)
    out["joined"] = (status, joined["n_processes"], joined["processes"],
                     sorted((sp["node"], sp["name"])
                            for sp in joined["spans"]))
    status, body = get(srv.url + "/fleet/metrics")
    out["metrics"] = (status, sorted(
        ln for ln in body.splitlines() if not ln.startswith("#")))
    return out


def test_door_serves_fleet_metrics_and_healthz(O, door):
    srv, col, tr = door
    status, body = get(srv.url + "/fleet/metrics")
    assert status == 200
    assert 'node="a"' in body and 'node="b"' in body
    status, body = get(srv.url + "/fleet/healthz")
    assert status == 200
    payload = json.loads(body)
    assert payload["nodes_total"] == 2 and payload["role"] == "fleet"


def test_door_serves_one_joined_fleet_trace(O, door):
    srv, col, tr = door
    status, body = get(srv.url + f"/fleet/traces/{tr.trace_id}")
    assert status == 200
    joined = json.loads(body)
    assert joined["trace_id"] == tr.trace_id
    assert joined["n_processes"] == 2
    assert {sp["node"] for sp in joined["spans"]} == {"a", "b"}
    status, body = get(srv.url + "/fleet/traces")
    assert status == 200
    assert any(t["trace_id"] == tr.trace_id
               for t in json.loads(body)["traces"])
    assert get(srv.url + "/fleet/traces/12345")[0] == 404
    assert get(srv.url + "/fleet/traces/not-an-id")[0] == 400


def test_door_serves_slo_snapshot(O, door):
    srv, col, tr = door
    status, body = get(srv.url + "/fleet/slo")
    assert status == 200
    snap = json.loads(body)
    assert "availability" in snap
    assert snap["availability"]["target"] == 0.999


def test_door_without_fleet_404s_fleet_routes(O):
    srv = O.replica.SubmitServer(_NullDoor()).start()
    try:
        assert get(srv.url + "/fleet/metrics")[0] == 404
    finally:
        srv.stop()


def test_door_views_equal_the_reference():
    views = []
    for pkg in PKGS:
        O = ns(pkg)
        gen = door.__wrapped__(O)
        srv, col, tr = next(gen)
        try:
            views.append(door_views(srv, tr))
        finally:
            gen.close()
    assert views[1] == views[0]


def plain_traced_runtime(O):
    """A threaded runtime over the fake executor, tracing on."""
    tracer = O.obs.Tracer(clock=FakeClock()).enable()
    kw = {"device": "cpu"} if O.name == PORT else {}
    cfg = O.P.serve.ServeConfig(buckets=(4,), max_linger_s=0.0,
                                tracer=tracer, **kw)
    return O.P.serve.ServeRuntime(graph=None, config=cfg,
                                  executor=FakeExecutor(O.P))


def explain_via_payload(O) -> tuple:
    rt = plain_traced_runtime(O)
    try:
        out = O.replica.submit_payload(
            rt, {"kind": "bfs", "seed": 1, "explain": True}, 10.0,
            node_id="replica-1")
        out2 = O.replica.submit_payload(rt, {"kind": "bfs", "seed": 1},
                                        10.0)
    finally:
        rt.close()
    return out, out2


def test_explain_rides_the_submit_payload_schema(O):
    out, out2 = explain_via_payload(O)
    assert out["explain"]["lane"] == "bfs/device"
    assert out["explain"]["node"] == "replica-1"
    assert out["explain"]["trace_id"] > 0
    assert "explain" not in out2


def test_explain_over_http_submit(O):
    rt = plain_traced_runtime(O)
    srv = O.replica.SubmitServer(
        lambda p: O.replica.submit_payload(rt, p, 10.0, node_id="n1")
    ).start()
    try:
        body = json.dumps({"kind": "bfs", "seed": 2, "explain": True})
        req = urllib.request.Request(
            srv.url + "/submit", data=body.encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            out = json.loads(r.read().decode())
        assert out["explain"]["node"] == "n1"
        assert out["explain"]["lane"] == "bfs/device"
        assert out["explain"]["occupancy"] is not None
    finally:
        srv.stop()
        rt.close()


def test_explain_payloads_equal_the_reference():
    outs = []
    for pkg in PKGS:
        out, out2 = explain_via_payload(ns(pkg))
        out["explain"].pop("trace_id")
        outs.append((out, out2))
    assert outs[1] == outs[0]


# ------------------------------------- the replicated tier, end to end


def wait_for(cond, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def tier_view(O) -> dict:
    """The reference's end-to-end case on ``O``'s package, with its own
    assertions: a primary and a replica with their own tracers, a front
    door with the fleet collector, and through the door's HTTP port a
    merged metrics page, a cross-process trace joined from both peers'
    halves, and a replica-side flight incident in the fleet health view.
    Returns what it read (trace ids aside)."""
    hg = mod(O.name, "core.graph")
    peer = mod(O.name, "peer")
    R = O.replica
    kw = {"device": "cpu"} if O.name == PORT else {}
    serve = O.P.serve
    net = peer.LoopbackNetwork()
    gp = hg.HyperGraph()
    pp = peer.HyperGraphPeer.loopback(gp, net, identity="primary")
    pp.replication.debounce_s = 0.005
    pp.tracer = O.obs.Tracer(max_finished=256).enable()
    pp.start()
    hs = [int(gp.add(f"n{i}")) for i in range(4)]
    gr = hg.HyperGraph()
    pr = peer.HyperGraphPeer.loopback(gr, net, identity="replica-1")
    pr.replication.debounce_s = 0.005
    pr.tracer = O.obs.Tracer(max_finished=256).enable()
    node = R.ReplicaNode(gr, pr, R.ReplicaConfig(
        primary="primary",
        serve=serve.ServeConfig(max_linger_s=0.001, prewarm_aot=False,
                                tracer=pr.tracer, **kw)))
    prt = fd = fsrv = col = None
    out = {}
    try:
        node.start()
        assert node.wait_converged(timeout=30)
        gp.add("traced")
        assert pp.replication.flush()
        prt = serve.ServeRuntime(gp, serve.ServeConfig(
            max_linger_s=0.001, prewarm_aot=False, **kw))
        health = O.obs.runtime_health(prt)
        fd = R.FrontDoor(
            R.LocalBackend("primary", prt, health, role="primary"),
            [R.LocalBackend("replica-1", node.runtime,
                            node.health_probe())],
            R.RouterConfig(poll_interval_s=0))
        replica_flight = O.obs.FlightRecorder()
        replica_src = node.fleet_source()
        replica_src.flight = replica_flight
        col = O.fleet.FleetCollector(
            [O.fleet.LocalNodeSource("primary",
                                     registries=[prt.stats.registry],
                                     tracer=pp.tracer, health=health,
                                     role="primary"),
             replica_src, fd.fleet_source()],
            poll_interval_s=0, flight=O.obs.FlightRecorder())
        fsrv = R.frontdoor_server(fd, fleet=col).start()

        def joined():
            col.poll()
            return [t for t in col.fleet_traces() if t["n_processes"] >= 2]

        assert wait_for(lambda: bool(joined())), col.fleet_traces()
        tid = joined()[0]["trace_id"]
        status, body = get(fsrv.url + f"/fleet/traces/{tid}")
        assert status == 200
        trace = json.loads(body)
        assert trace["n_processes"] >= 2
        assert {"primary", "replica-1"} <= set(trace["processes"])
        out["trace"] = (trace["processes"], trace["name"] if "name"
                        in trace else None)
        res = fd.submit({"kind": "bfs", "seed": hs[0], "max_hops": 1,
                         "deadline_s": 10.0})
        assert res["routed_to"] in ("primary", "replica-1")
        out["answer"] = (res["count"], res["routed_to"])
        col.poll()
        status, body = get(fsrv.url + "/fleet/metrics")
        assert status == 200
        assert 'node="primary"' in body
        assert 'node="replica-1"' in body
        assert 'router_submitted_total{node="router"} 1' in body
        out["router_lines"] = sorted(
            ln for ln in body.splitlines() if ln.startswith("router_"))
        replica_flight.incident("breaker_trip", key="bfs_2")
        col.poll()
        status, body = get(fsrv.url + "/fleet/healthz")
        payload = json.loads(body)
        assert payload["incidents"]["replica-1"]["reason"] == \
            "breaker_trip"
        out["incident"] = payload["incidents"]["replica-1"]["reason"]
        out["nodes"] = sorted(payload["nodes"])
    finally:
        if fsrv is not None:
            fsrv.stop()
        if col is not None:
            col.stop()
        if prt is not None:
            prt.close()
        node.stop()
        pp.stop()
        gp.close()
        gr.close()
    return out


def test_replicated_tier_fleet_view_end_to_end(O):
    tier_view(O)


def test_replicated_tier_views_equal_the_reference():
    views = [tier_view(ns(pkg)) for pkg in PKGS]
    assert views[1] == views[0]
