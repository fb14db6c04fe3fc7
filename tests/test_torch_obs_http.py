"""The port's telemetry endpoint (``hypergraphdb_tpu_torch.obs.http``)
against the reference's, over real HTTP on ``127.0.0.1`` (an ephemeral
port) in front of each package's manual-mode runtime with the same fake
executor: every case of ``tests/test_obs_http.py`` in both packages, and
the bodies each route serves equal between them (``/metrics`` byte for
byte, ``/healthz`` as JSON, ``/debug/traces`` as records). Then the
health probe's ``perf`` and ``plan`` sections over a sentinel and a
planner, equal to the reference's but for the port's ``priors`` record.
Tolerance: exact equality."""

from __future__ import annotations

import json
import socket
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

from tests.test_torch_graph import PKGS, mod
from tests.test_torch_serve_runtime import FakeClock, FakeExecutor, package

PORT = PKGS[1]


def get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def setup(pkg, perf=None):
    P = package(pkg)
    obs = mod(pkg, "obs")
    tracer = obs.Tracer(clock=FakeClock())
    tracer.enable()
    cfg = P.serve.ServeConfig(buckets=(4,), max_linger_s=0.0,
                              clock=FakeClock(), manual=True, tracer=tracer,
                              breaker_threshold=3, perf=perf)
    rt = P.serve.ServeRuntime(graph=None, config=cfg,
                              executor=FakeExecutor(P))
    srv = obs.http.TelemetryServer(registries=[rt.stats.registry],
                                   tracer=tracer,
                                   health=obs.http.runtime_health(rt))
    return SimpleNamespace(P=P, obs=obs, rt=rt, srv=srv.start(),
                           tracer=tracer)


@pytest.fixture(params=PKGS)
def served(request):
    s = setup(request.param)
    try:
        yield s
    finally:
        s.srv.stop()
        s.rt.close(drain=True)


def test_metrics_endpoint_serves_prometheus_text(served):
    fut = served.rt.submit_bfs(1)
    served.rt.step(drain=True)
    fut.result(timeout=0)
    status, body = get(served.srv.url + "/metrics")
    assert status == 200
    for line in ("serve_submitted_total 1", "serve_completed_total 1",
                 "serve_latency_seconds_count 1"):
        assert line in body


def test_healthz_reflects_per_key_breaker_within_one_scrape(served):
    rt, url = served.rt, served.srv.url
    status, body = get(url + "/healthz")
    h = json.loads(body)
    assert status == 200 and h["breakers"] == {} and h["queue_depth"] == 0
    assert h["accepting"] is True
    key = ("bfs", 2)
    for _ in range(3):
        rt.breaker.record_failure(key)
    status, body = get(url + "/healthz")
    h = json.loads(body)
    assert status == 503 and h["breakers"] == {"bfs_2": "open"}
    assert h["breaker_worst"] == 2
    _, metrics = get(url + "/metrics")
    assert "serve_breaker_state_bfs_2 2.0" in metrics
    assert "serve_breaker_trips_bfs_2_total 1" in metrics
    rt.breaker.record_success(key)
    status, body = get(url + "/healthz")
    assert status == 200
    assert json.loads(body)["breakers"] == {"bfs_2": "closed"}
    assert "serve_breaker_state_bfs_2 0.0" in get(url + "/metrics")[1]


def test_debug_traces_peeks_without_draining(served):
    fut = served.rt.submit_bfs(7)
    served.rt.step(drain=True)
    fut.result(timeout=0)
    status, body = get(served.srv.url + "/debug/traces")
    assert status == 200
    recs = served.obs.parse_traces_jsonl(body)
    assert [r["name"] for r in recs] == ["serve.request"]
    assert served.tracer.finished_count() == 1


def test_debug_flight_and_404(served):
    served.obs.global_flight().record("http.test", marker=1)
    status, body = get(served.srv.url + "/debug/flight")
    assert status == 200
    assert any(json.loads(line)["kind"] == "http.test"
               for line in body.splitlines() if line.strip())
    assert get(served.srv.url + "/nope")[0] == 404


@pytest.mark.parametrize("pkg", PKGS)
def test_broken_health_probe_returns_500_not_crash(pkg):
    def bad_probe():
        raise RuntimeError("probe fell over")

    srv = mod(pkg, "obs.http").TelemetryServer(health=bad_probe).start()
    try:
        assert get(srv.url + "/healthz")[0] == 500
        assert get(srv.url + "/metrics")[0] == 200
    finally:
        srv.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_key_label_shapes(pkg):
    label = mod(pkg, "obs.http").breaker_key_label
    assert label(("bfs", 2)) == "bfs_2"
    assert label(("pattern", 3)) == "pattern_3"
    assert label("k") == "k"


@pytest.mark.parametrize("pkg", PKGS)
def test_server_start_stop_idempotent(pkg):
    srv = mod(pkg, "obs.http").TelemetryServer()
    srv.start()
    srv.start()
    assert get(srv.url + "/metrics")[0] == 200
    srv.stop()
    srv.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        srv.start()


@pytest.mark.parametrize("pkg", PKGS)
def test_stop_without_start_releases_the_port(pkg):
    srv = mod(pkg, "obs.http").TelemetryServer()
    host, port = srv.host, srv.port
    srv.stop()
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, port))
    s.close()


def scrape_all(pkg) -> dict:
    """One traffic script, then every route's body."""
    s = setup(pkg)
    try:
        futs = [s.rt.submit_bfs(i) for i in range(6)]
        s.rt.step(drain=True)
        s.rt.step(drain=True)
        for f in futs:
            f.result(timeout=0)
        for _ in range(3):
            s.rt.breaker.record_failure(("bfs", 2))
        out = {route: get(s.srv.url + route)
               for route in ("/metrics", "/healthz", "/debug/traces")}
    finally:
        s.srv.stop()
        s.rt.close(drain=True)
    out["/healthz"] = (out["/healthz"][0], json.loads(out["/healthz"][1]))
    out["/debug/traces"] = [
        {k: v for k, v in r.items() if k != "trace_id"} | {"spans": [
            {k: v for k, v in sp.items()
             if k not in ("span_id", "parent_id")} for sp in r["spans"]]}
        for r in s.obs.parse_traces_jsonl(out["/debug/traces"][1])]
    return out


def test_routes_serve_what_the_reference_serves():
    """The same traffic: ``/metrics`` byte-equal (the port's one extra
    counter, ``serve.explain_errors``, aside), ``/healthz`` equal,
    ``/debug/traces`` equal but for the random 128-bit ids."""
    ref, got = scrape_all(PKGS[0]), scrape_all(PORT)
    extra = {"# TYPE serve_explain_errors_total counter",
             "serve_explain_errors_total 0"}
    port_lines = [ln for ln in got["/metrics"][1].splitlines()
                  if ln not in extra]
    assert port_lines == ref["/metrics"][1].splitlines()
    assert got["/metrics"][0] == ref["/metrics"][0] == 200
    assert got["/healthz"] == ref["/healthz"]
    assert got["/debug/traces"] == ref["/debug/traces"]


def health_sections(pkg):
    """runtime_health over a sentinel and a planner on a small graph."""
    P = package(pkg)
    clock = FakeClock()
    sen = mod(pkg, "obs.perf").PerfSentinel(
        baseline={"lanes": {"bfs": {"p50_s": 0.01}}}, clock=clock)
    cfg = P.serve.ServeConfig(buckets=(4,), max_linger_s=0.0, clock=clock,
                              manual=True, perf=sen)
    rt = P.serve.ServeRuntime(graph=None, config=cfg,
                              executor=FakeExecutor(P))
    cfg_mod = mod(pkg, "core.config")
    qc = (cfg_mod.QueryConfig(device="cpu") if pkg == PORT
          else cfg_mod.QueryConfig())
    g = mod(pkg, "core.graph").HyperGraph(cfg_mod.HGConfiguration(query=qc))
    rt.graph = g
    rt.attach_planner(mod(pkg, "plan").QueryPlanner(g))
    ok, payload = mod(pkg, "obs.http").runtime_health(rt)()
    rt.close()
    g.close()
    return ok, payload


def test_health_carries_perf_and_plan_sections():
    ref_ok, ref = health_sections(PKGS[0])
    ok, got = health_sections(PORT)
    priors = got["plan"].pop("priors")
    assert (ok, got) == (ref_ok, ref)
    assert got["perf"]["watched"] == ["bfs"] and got["perf"]["violating"] == []
    assert "mesh" not in got
    assert priors["source"] is None
    assert {v["from"] for v in priors["lanes"].values()} == {"default"}
