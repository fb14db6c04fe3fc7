"""The port's perf sentinel and baseline file (``hypergraphdb_tpu_torch.obs.
perf``) against the reference's (``hypergraphdb_tpu.obs.perf``).

Every case of ``tests/test_perf_sentinel.py`` runs in both packages (the
``pkg`` parameter) on fake clocks with an injectable profiler; the
scenario cases also return what an operator sees — each evaluation's
snapshot, the incident reasons in the flight dumps, the profile
manifests, the health summary — and the two packages' records must be
equal (paths compared relative to each run's incident directory). The
seeded baseline over ``tests/perf_fixtures/`` equals the reference's but
for ``recorded_unix``. The acceptance drill (a seeded slowdown on one
lane, then the fleet collector and the ``perf_drift`` objective) runs
on both packages' runtimes with the same fake executor. Tolerance:
exact equality."""

from __future__ import annotations

import json
import logging
import os
from contextlib import contextmanager
from pathlib import Path
from types import SimpleNamespace

import pytest

from tests.test_torch_graph import PKGS, mod
from tests.test_torch_serve_runtime import FakeClock, FakeExecutor, package

PORT = PKGS[1]
FIXTURES = Path(__file__).resolve().parent / "perf_fixtures"


def ns(pkg) -> SimpleNamespace:
    return SimpleNamespace(
        name=pkg, perf=mod(pkg, "obs.perf"), flight=mod(pkg, "obs.flight"),
        fleet=mod(pkg, "obs.fleet"), http=mod(pkg, "obs.http"),
        slo=mod(pkg, "obs.slo"), P=package(pkg))


@pytest.fixture(params=PKGS)
def O(request):
    return ns(request.param)


BASELINE = {
    "schema_version": 1,
    "backend": "fake",
    "lanes": {"bfs": {"p50_s": 0.01, "p99_s": 0.02, "qps": 100.0}},
    "factors": {"p50_s": 3.0, "p99_s": 3.0, "device_s_per_req": 3.0},
}
TWO_LANES = dict(BASELINE, lanes={"bfs": {"p50_s": 0.01, "p99_s": 0.02},
                                  "range": {"p50_s": 0.01, "p99_s": 0.02}})


class FakeProfiler:
    """Records open/close edges and drops a marker file in the session
    dir."""

    def __init__(self):
        self.events: list = []

    def __call__(self, logdir):
        @contextmanager
        def session():
            self.events.append(("open", logdir))
            with open(os.path.join(logdir, "trace.marker"), "w") as f:
                f.write("profiler trace\n")
            yield True
            self.events.append(("close", logdir))

        return session()


def make_sentinel(O, tmp_path=None, baseline=BASELINE, windows=(5.0, 20.0),
                  **kw):
    clock = FakeClock()
    flight = O.flight.FlightRecorder(
        clock=clock, incident_dir=None if tmp_path is None else str(tmp_path),
        min_dump_interval_s=0.0)
    profiler = FakeProfiler()
    kw.setdefault("min_samples", 4)
    kw.setdefault("eval_interval_s", 0.0)
    kw.setdefault("profile_s", 2.0)
    sen = O.perf.PerfSentinel(baseline=baseline, clock=clock, flight=flight,
                              windows=windows, profiler=profiler, **kw)
    return sen, clock, flight, profiler


def feed(sen, clock, latency, n, dt=1.0, kind="bfs", tick=True, snaps=None):
    for _ in range(n):
        clock.advance(dt)
        sen.observe(kind, latency)
        if tick:
            snap = sen.tick()
            if snaps is not None:
                snaps.append(snap)


def rel(obj, root: str):
    """``obj`` with every string path under ``root`` made relative."""
    if isinstance(obj, dict):
        return {k: rel(v, root) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(rel(v, root) for v in obj)
    if isinstance(obj, str) and obj.startswith(root):
        return os.path.relpath(obj, root)
    return obj


def both(scenario, tmp_path) -> dict:
    out = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        out[pkg] = rel(scenario(ns(pkg), d), str(d))
    return out


def dump_reasons(O, flight) -> list:
    if flight.last_dump_path is None:
        return []
    recs = O.flight.parse_flight_jsonl(open(flight.last_dump_path).read())
    return [r["reason"] for r in recs if r["kind"] == "incident"]


# ---------------------------------------------------------------- baseline


def test_baseline_round_trip_and_version_check(O, tmp_path):
    path = str(tmp_path / "PERF_BASELINE.json")
    O.perf.save_baseline(BASELINE, path)
    assert O.perf.load_baseline(path)["lanes"]["bfs"]["p99_s"] == 0.02
    O.perf.save_baseline(dict(BASELINE, schema_version=2), path)
    with pytest.raises(ValueError):
        O.perf.load_baseline(path)
    O.perf.save_baseline({"schema_version": 1}, path)
    with pytest.raises(ValueError):
        O.perf.load_baseline(path)


def write_records(d: Path, recs: dict) -> None:
    for name, rec in recs.items():
        (d / name).write_text(json.dumps(rec))


C6 = {"batched_vs_unbatched": 2.0, "latency_ms_p50": 20.0,
      "latency_ms_p99": 30.0, "served_qps": 120.0}


def test_seed_baseline_from_bench_records(O, tmp_path):
    write_records(tmp_path, {
        "BENCH_C6_smoke.json": {"schema_version": 1, "backend": "cpu",
                                "recorded_unix": 1, "c6_serving": C6},
        "BENCH_C9_local.json": {"schema_version": 2, "backend": "cpu",
                                "recorded_unix": 1, "c9_value_index": {
                                    "latency_ms_p50": 5.0,
                                    "latency_ms_p99": 8.0,
                                    "served_qps": 900.0}},
        "BENCH_C7_smoke.json": {"schema_version": 1, "backend": "cpu",
                                "recorded_unix": 1, "c7_pattern_join": {
                                    "triangle": {
                                        "device_anchors_per_sec": 50.0}}},
    })
    out = str(tmp_path / "PERF_BASELINE.json")
    rec = O.perf.seed_baseline(str(tmp_path), out_path=out)
    assert sorted(rec["lanes"]) == ["bfs", "join", "range"]
    assert rec["lanes"]["bfs"]["p50_s"] == pytest.approx(0.02)
    assert rec["lanes"]["range"]["p99_s"] == pytest.approx(0.008)
    assert rec["lanes"]["join"]["p50_s"] == pytest.approx(0.02)
    assert rec["backend"] == "cpu"
    assert O.perf.load_baseline(out)["source"] == rec["source"]
    assert "pattern" not in rec["lanes"]
    assert "proxy" in rec["lanes"]["join"]["note"]


def test_seed_baseline_c11_beats_the_c7_join_proxy(O, tmp_path):
    write_records(tmp_path, {
        "BENCH_C7_smoke.json": {"schema_version": 1, "backend": "cpu",
                                "recorded_unix": 999, "c7_pattern_join": {
                                    "triangle": {
                                        "device_anchors_per_sec": 50.0}}},
        "BENCH_C11_smoke.json": {"schema_version": 2, "backend": "cpu",
                                 "recorded_unix": 1, "c11_join": {
                                     "latency_ms_p50": 40.0,
                                     "latency_ms_p99": 90.0,
                                     "served_qps": 77.0}},
    })
    join = O.perf.seed_baseline(str(tmp_path))["lanes"]["join"]
    assert join["p50_s"] == pytest.approx(0.04)
    assert join["p99_s"] == pytest.approx(0.09)
    assert join["qps"] == 77.0 and "open-loop" in join["note"]


def test_seed_baseline_over_the_committed_fixtures_equals_the_reference():
    """The reference's own fixtures: the two records are equal but for
    the seeding time."""
    recs = {}
    for pkg in PKGS:
        rec = mod(pkg, "obs.perf").seed_baseline(str(FIXTURES))
        assert isinstance(rec.pop("recorded_unix"), int)
        recs[pkg] = rec
    assert recs[PORT] == recs[PKGS[0]]
    assert recs[PORT]["lanes"]


def test_seed_baseline_newest_record_wins(O, tmp_path):
    write_records(tmp_path, {"BENCH_C6_smoke.json": {
        "schema_version": 1, "backend": "cpu", "recorded_unix": 100,
        "c6_serving": dict(C6, latency_ms_p50=1000.0)}})
    rec_dir = tmp_path / "records"
    rec_dir.mkdir()
    write_records(rec_dir, {"BENCH_C6_card.json": {
        "schema_version": 2, "backend": "cuda", "recorded_unix": 200,
        "c6_serving": dict(C6, latency_ms_p50=2.0)}})
    rec = O.perf.seed_baseline((str(tmp_path), str(rec_dir)))
    assert rec["source"] == ["BENCH_C6_card.json"]
    assert rec["backend"] == "cuda"
    assert rec["lanes"]["bfs"]["p50_s"] == pytest.approx(0.002)
    write_records(rec_dir, {"BENCH_C6_smoke.json": {
        "schema_version": 2, "backend": "cuda", "recorded_unix": 300,
        "c6_serving": dict(C6, latency_ms_p50=1.0)}})
    rec = O.perf.seed_baseline((str(tmp_path), str(rec_dir)))
    assert rec["source"] == ["BENCH_C6_smoke.json"]
    assert rec["lanes"]["bfs"]["p50_s"] == pytest.approx(0.001)


def test_seed_baseline_flags_mixed_backends(O, tmp_path):
    write_records(tmp_path, {
        "BENCH_C6_card.json": {"schema_version": 2, "backend": "cuda",
                               "recorded_unix": 200, "c6_serving": C6},
        "BENCH_C9_smoke.json": {"schema_version": 1, "backend": "cpu",
                                "recorded_unix": 100, "c9_value_index": {
                                    "latency_ms_p50": 5.0,
                                    "latency_ms_p99": 8.0,
                                    "served_qps": 900.0}},
    })
    rec = O.perf.seed_baseline(str(tmp_path))
    assert rec["backend"] == "mixed"
    assert rec["lanes"]["bfs"]["backend"] == "cuda"
    assert rec["lanes"]["range"]["backend"] == "cpu"


# ---------------------------------------------------------------- windows


def test_window_digest_math(O):
    sen, clock, _, _ = make_sentinel(O, windows=(10.0, 40.0))
    for lat in (0.01, 0.02, 0.03, 0.04):
        clock.advance(1.0)
        sen.observe("bfs", lat)
    sen.observe("bfs", 0.05, path="host")
    sen.observe_batch("bfs", 0.008, n_real=2, n_total=4)
    short = sen.tick()["lanes"]["bfs"]["windows"][0]
    assert short["n"] == 5
    assert short["qps"] == pytest.approx(0.5)
    assert short["p50_s"] == pytest.approx(0.03)
    assert short["p99_s"] == pytest.approx(0.05)
    assert short["host_fraction"] == pytest.approx(0.2)
    assert short["device_s_per_req"] == pytest.approx(0.004)
    assert short["occupancy"] == pytest.approx(0.5)


def soak(O, d):
    sen, clock, flight, profiler = make_sentinel(O, d)
    snaps = []
    feed(sen, clock, 0.01, 60, snaps=snaps)
    return snaps, flight.incidents, profiler.events, sen.health_summary()


def test_healthy_soak_fires_zero_incidents(tmp_path):
    out = both(soak, tmp_path)
    assert out[PORT] == out[PKGS[0]]
    snaps, incidents, events, health = out[PORT]
    assert incidents == 0 and events == []
    lane = snaps[-1]["lanes"]["bfs"]
    assert lane["violating"] is False
    assert all(w["degraded"] is False for w in lane["windows"])


def slowdown(O, d):
    sen, clock, flight, profiler = make_sentinel(O, d)
    snaps = []
    feed(sen, clock, 0.01, 30, snaps=snaps)
    feed(sen, clock, 0.2, 40, snaps=snaps)
    lane = sen.snapshot()["lanes"]["bfs"]
    manifest = json.load(open(os.path.join(lane["last_profile"],
                                           "PROFILE.json")))
    return (snaps, flight.incidents, lane, dump_reasons(O, flight),
            profiler.events, manifest,
            os.path.exists(os.path.join(lane["last_profile"],
                                        "trace.marker")))


def test_sustained_slowdown_exactly_one_incident_with_profile(tmp_path):
    out = both(slowdown, tmp_path)
    assert out[PORT] == out[PKGS[0]]
    snaps, incidents, lane, reasons, events, manifest, marker = out[PORT]
    assert incidents == 1 and lane["violating"] is True
    assert lane["alerts_total"] == 1
    assert reasons == ["perf_drift_bfs"]
    assert os.path.dirname(lane["last_profile"]) == os.path.dirname(
        lane["last_incident"])
    assert marker and manifest["lane"] == "bfs"
    assert manifest["profiler_active"] is True
    assert events[0][0] == "open" and ("close", lane["last_profile"]) in events
    assert manifest["t1"] >= manifest["t0"]


def test_short_blip_does_not_alert(O, tmp_path):
    sen, clock, flight, _ = make_sentinel(O, tmp_path, windows=(5.0, 60.0))
    feed(sen, clock, 0.01, 60)
    feed(sen, clock, 0.2, 2)
    feed(sen, clock, 0.01, 10)
    assert flight.incidents == 0


def rearm(O, d):
    sen, clock, flight, _ = make_sentinel(O, d, windows=(5.0, 20.0))
    marks = []
    feed(sen, clock, 0.01, 25)
    feed(sen, clock, 0.2, 20)
    marks.append(flight.incidents)
    feed(sen, clock, 0.01, 7)
    lane = sen.snapshot()["lanes"]["bfs"]
    marks.append([w["degraded"] for w in lane["windows"]])
    marks.append(lane["violating"])
    feed(sen, clock, 0.2, 6)
    marks.append(flight.incidents)
    feed(sen, clock, 0.01, 25)
    marks.append(sen.snapshot()["lanes"]["bfs"]["violating"])
    feed(sen, clock, 0.2, 20)
    marks.append(flight.incidents)
    return marks, sen.snapshot()


def test_rearm_only_after_every_window_clears(tmp_path):
    out = both(rearm, tmp_path)
    assert out[PORT] == out[PKGS[0]]
    assert out[PORT][0] == [1, [False, True], True, 1, False, 2]


def test_unwatched_lane_never_gates(O, tmp_path):
    sen, clock, flight, _ = make_sentinel(O, tmp_path)
    feed(sen, clock, 9.9, 50, kind="pattern")
    assert flight.incidents == 0
    lane = sen.snapshot()["lanes"]["pattern"]
    assert lane["watched"] is False and lane["violating"] is False


def test_snapshot_is_a_pure_read(O, tmp_path):
    sen, clock, flight, profiler = make_sentinel(O, tmp_path)
    feed(sen, clock, 0.01, 25, tick=False)
    feed(sen, clock, 0.2, 20, tick=False)
    for _ in range(5):
        assert sen.snapshot()["lanes"]["bfs"]["violating"] is False
    assert flight.incidents == 0 and profiler.events == []
    sen.tick()
    assert flight.incidents == 1


def two_lanes(O, d, dump_interval):
    sen, clock, flight, profiler = make_sentinel(O, d, baseline=TWO_LANES)
    flight.min_dump_interval_s = dump_interval
    for lat, n in ((0.01, 25), (0.2, 20)):
        for _ in range(n):
            clock.advance(1.0)
            sen.observe("bfs", lat)
            sen.observe("range", lat)
            sen.tick()
    sen.close()
    return sen, flight, profiler


def test_incidents_rate_limited_by_flight_recorder(O, tmp_path):
    sen, flight, _ = two_lanes(O, tmp_path, 3600.0)
    assert flight.incidents == 2 and flight.dumps == 1


def test_concurrent_alert_edges_open_one_profile_session(O, tmp_path):
    sen, flight, profiler = two_lanes(O, tmp_path, 0.0)
    assert flight.incidents == 2
    assert len([e for e in profiler.events if e[0] == "open"]) == 1
    assert len([e for e in profiler.events if e[0] == "close"]) == 1


def test_outrun_sample_ring_is_unknown_not_degraded(O, tmp_path):
    sen, clock, flight, _ = make_sentinel(O, tmp_path, windows=(5.0, 60.0),
                                          max_samples=8)
    feed(sen, clock, 0.01, 100)
    for _ in range(8):
        clock.advance(0.1)
        sen.observe("bfs", 0.2)
    lane = sen.tick()["lanes"]["bfs"]
    assert all(w["span_truncated"] for w in lane["windows"])
    assert all(w["status"] == "unknown" for w in lane["windows"])
    assert flight.incidents == 0
    sen2, clock2, flight2, _ = make_sentinel(O, tmp_path / "b")
    feed(sen2, clock2, 0.01, 25)
    feed(sen2, clock2, 0.2, 20)
    assert flight2.incidents == 1


def test_min_samples_zero_is_clamped_not_a_crash(O):
    sen, clock, flight, _ = make_sentinel(O, min_samples=0)
    assert sen.min_samples == 1
    sen.tick()
    assert flight.incidents == 0


def test_undersized_ring_warns_at_construction(O, caplog):
    logger = O.name + ".obs"
    with caplog.at_level(logging.WARNING, logger):
        O.perf.PerfSentinel(baseline={"lanes": {"range": {
            "p50_s": 0.01, "qps": 12568.0}}}, windows=(30.0, 120.0),
            max_samples=4096)
    assert any("span_truncated" in r.message for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger):
        O.perf.PerfSentinel(baseline={"lanes": {"bfs": {
            "p50_s": 0.01, "qps": 10.0}}}, windows=(30.0, 120.0),
            max_samples=4096)
    assert not caplog.records


# -------------------------------------------------------------------- skew


def test_shard_skew_math_names_the_straggler(O):
    skew = O.perf.shard_skew({"shards": [
        {"device": 0, "gid_lo": 0, "gid_hi": 100, "hbm_bytes_in_use": 100},
        {"device": 1, "gid_lo": 100, "gid_hi": 200, "hbm_bytes_in_use": 300},
    ]})
    assert skew["hbm_bytes_in_use"]["ratio"] == pytest.approx(1.5)
    assert skew["hbm_bytes_in_use"]["straggler"] == 1
    assert skew["gid_span"]["ratio"] == pytest.approx(1.0)
    assert O.perf.shard_skew({}) == {}
    cpu = O.perf.shard_skew({"shards": [{"device": 0, "gid_lo": 0,
                                         "gid_hi": 128}]})
    assert "hbm_bytes_in_use" not in cpu


def skew_edges(O, d):
    report = {"shards": [{"device": 0, "hbm_bytes_in_use": 100},
                         {"device": 1, "hbm_bytes_in_use": 100}]}
    sen, clock, flight, _ = make_sentinel(
        O, d, mesh_source=lambda: report, skew_ratio_max=1.5)
    marks = []
    for _ in range(3):
        clock.advance(1.0)
        sen.tick()
    marks.append(flight.incidents)
    report["shards"][1]["hbm_bytes_in_use"] = 1000
    for _ in range(5):
        clock.advance(1.0)
        sen.tick()
    marks.append(flight.incidents)
    marks.append(sen.health_summary())
    window = O.flight.parse_flight_jsonl(open(flight.last_dump_path).read())
    inc = [r for r in window if r["kind"] == "incident"][-1]
    marks.append((inc["reason"], inc["straggler"]))
    report["shards"][1]["hbm_bytes_in_use"] = 100
    sen.tick()
    marks.append(sen.health_summary()["violating"])
    report["shards"][1]["hbm_bytes_in_use"] = 1000
    sen.tick()
    marks.append(flight.incidents)
    return marks


def test_skew_violation_is_edge_triggered(tmp_path):
    out = both(skew_edges, tmp_path)
    assert out[PORT] == out[PKGS[0]]
    marks = out[PORT]
    assert marks[0] == 0 and marks[1] == 1
    assert marks[2]["violating"] == ["skew"]
    assert marks[3] == ("perf_skew_hbm_bytes_in_use", 1)
    assert marks[4] == [] and marks[5] == 2


# -------------------------------------------------- end-to-end runtime drill


def slow_executor(P, clock):
    """A fake executor whose collect costs ``delay`` seconds on the shared
    fake clock: the seeded per-lane slowdown."""

    class Slow(FakeExecutor):
        delay = 0.0

        def collect(self, token):
            clock.advance(self.delay)
            return super().collect(token)

    return Slow(P)


def drill_runtime(O, d, inject: bool):
    P = O.P
    clock = FakeClock()
    flight = O.flight.FlightRecorder(clock=clock, incident_dir=str(d),
                                     min_dump_interval_s=0.0)
    profiler = FakeProfiler()
    sen = O.perf.PerfSentinel(baseline=BASELINE, clock=clock, flight=flight,
                              windows=(5.0, 20.0), min_samples=4,
                              eval_interval_s=0.0, profiler=profiler)
    ex = slow_executor(P, clock)
    cfg = P.serve.ServeConfig(buckets=(4,), max_linger_s=0.0, clock=clock,
                              manual=True, perf=sen)
    rt = P.serve.ServeRuntime(graph=None, config=cfg, executor=ex)
    for n, delay in ((25, 0.005), (25, 0.2 if inject else 0.005)):
        ex.delay = delay
        for _ in range(n):
            clock.advance(1.0)
            rt.submit_bfs(1)
            rt.step(drain=True)
    return rt, sen, flight, profiler


def drill(O, d):
    rt, sen, flight, profiler = drill_runtime(O, d, inject=True)
    try:
        lane = sen.snapshot()["lanes"]["bfs"]
        collector = O.fleet.FleetCollector(
            [O.fleet.LocalNodeSource("n1", registries=[sen.registry],
                                     health=O.http.runtime_health(rt))],
            clock=rt.clock, poll_interval_s=0)
        collector.poll()
        fp = collector.fleet_perf()
        mon = O.slo.fleet_objectives(collector)
        collector.slo = mon
        for _ in range(3):
            rt.clock.advance(1.0)
            collector.poll()
        return (flight.incidents, lane, dump_reasons(O, flight), fp,
                mon.snapshot(), collector.fleet_metrics(),
                rt.stats_snapshot())
    finally:
        rt.close()
        sen.close()


def test_e2e_drill_injected_slowdown(tmp_path):
    out = both(drill, tmp_path)
    assert out[PORT] == out[PKGS[0]]
    incidents, lane, reasons, fp, slo, metrics, _ = out[PORT]
    assert incidents == 1 and lane["violating"] is True
    assert reasons == ["perf_drift_bfs"]
    assert lane["last_incident"] and lane["last_profile"]
    assert fp["violating"] == {"n1": ["bfs"]}
    assert fp["nodes"]["n1"]["watched"] == ["bfs"]
    assert fp["alerts_total"] == 1 and fp["nodes_reporting"] == 1
    drift = slo["perf_drift"]
    assert drift["windows"][0]["events"] >= 2
    assert drift["windows"][0]["error_ratio"] == pytest.approx(1.0)
    assert 'perf_lane_bfs_violating{node="n1"} 1' in metrics


def test_e2e_drill_undisturbed_soak_is_silent(O, tmp_path):
    rt, sen, flight, profiler = drill_runtime(O, tmp_path, inject=False)
    try:
        assert flight.incidents == 0 and profiler.events == []
        assert sen.health_summary()["violating"] == []
        assert not os.listdir(tmp_path)
    finally:
        rt.close()
        sen.close()


def test_runtime_device_batches_feed_the_sentinel(O):
    P = O.P
    clock = FakeClock()
    sen = O.perf.PerfSentinel(baseline=BASELINE, clock=clock,
                              windows=(5.0,), eval_interval_s=0.0)
    cfg = P.serve.ServeConfig(buckets=(4,), max_linger_s=0.0, clock=clock,
                              manual=True, perf=sen)
    rt = P.serve.ServeRuntime(graph=None, config=cfg,
                              executor=FakeExecutor(P))
    rt.submit_bfs(1)
    clock.advance(0.25)
    rt.step(drain=True)
    rt.close()
    w = sen.snapshot()["lanes"]["bfs"]["windows"][0]
    assert w["n"] == 1 and w["p50_s"] == pytest.approx(0.25)


def test_broken_sentinel_never_strands_a_batch(O):
    class ExplodingSentinel:
        def observe(self, *a, **k):
            raise RuntimeError("boom")

        def observe_batch(self, *a, **k):
            raise RuntimeError("boom")

        def maybe_tick(self):
            raise RuntimeError("boom")

    P = O.P
    cfg = P.serve.ServeConfig(buckets=(4,), max_linger_s=0.0,
                              clock=FakeClock(), manual=True,
                              perf=ExplodingSentinel())
    rt = P.serve.ServeRuntime(graph=None, config=cfg,
                              executor=FakeExecutor(P))
    fut = rt.submit_bfs(1)
    rt.step(drain=True)
    assert fut.result(timeout=0).kind == "bfs"
    assert rt.stats.registry.get("serve.perf_observe_errors").value == 1
    rt.close()


def test_port_profile_session_is_torch_profiler(tmp_path):
    """With no injected profiler the port's incident profile is
    ``obs.device.profile`` (``torch.profiler``, CPU activity here): the
    session opens on the alert edge and its Chrome trace lands in the
    profile dir when the bound expires."""
    O = ns(PORT)
    clock = FakeClock()
    flight = O.flight.FlightRecorder(clock=clock, incident_dir=str(tmp_path),
                                     min_dump_interval_s=0.0)
    sen = O.perf.PerfSentinel(baseline=BASELINE, clock=clock, flight=flight,
                              windows=(5.0, 20.0), min_samples=4,
                              eval_interval_s=0.0, profile_s=2.0)
    feed(sen, clock, 0.01, 25)
    feed(sen, clock, 0.2, 20)
    lane = sen.snapshot()["lanes"]["bfs"]
    sen.close()
    assert flight.incidents == 1
    prof = lane["last_profile"]
    manifest = json.load(open(os.path.join(prof, "PROFILE.json")))
    assert manifest["profiler_active"] is True
    assert manifest["t1"] >= manifest["t0"]
    assert os.path.getsize(os.path.join(prof, "trace.json")) > 0
