"""The port's fleet collector and EXPLAIN records
(``hypergraphdb_tpu_torch.obs.fleet``, ``submit(..., explain=True)``)
against the reference's.

The cases of ``tests/test_fleet.py`` that need no ``replica/`` or
``peer/`` (which the port does not have yet; the rest are listed in
ROADMAP queue 1, item 10) run in both packages: per-node metric merges,
worst-of health, an unreachable node, span trees joined across two
tracers, the trace store's dedupe and bound, last-good totals, real HTTP
scrapes of a ``TelemetryServer`` on ``127.0.0.1``, a node's incident
seen through the collector, and the EXPLAIN cases over the fake executor.
The merged views and the EXPLAIN records are equal between the packages
(trace ids aside, which are random). Then EXPLAIN on both packages' real
runtimes over one small graph — a record for each lane (bfs, pattern,
range, join) and for the planned host shape — and the port's own rule:
a record that fails to assemble is counted, never swallowed.
Tolerance: exact equality."""

from __future__ import annotations

import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
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
        P=package(pkg))


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


class _NotFound(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
        body = b'{"error": "no such route"}'
        self.send_response(404)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def test_http_source_rejects_non_200_telemetry_bodies(O):
    """A node whose ``/metrics`` answers 404 fails the scrape (the
    reference's case points at a replica's submit server; any server
    answering 404 shows the same)."""
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _NotFound)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        scrape = O.fleet.HTTPNodeSource(
            "bad", f"http://127.0.0.1:{srv.server_address[1]}").scrape()
    finally:
        srv.shutdown()
        t.join(timeout=5)
        srv.server_close()
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
