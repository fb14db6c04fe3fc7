"""The port's SLO monitor (``hypergraphdb_tpu_torch.obs.slo``) against the
reference's (``hypergraphdb_tpu.obs.slo``).

Every case of ``tests/test_slo.py`` runs as one scenario through both
packages on a fake clock and returns what an operator sees — each
evaluation's snapshot, the incident count, the flight dump's records —
and the two records must be equal (dump paths relative to each run's
incident directory); then the reference's assertions hold on the port's
record. The chaos smoke drives both packages' ``ServeRuntime`` with the
same fake executor. Tolerance: exact equality."""

from __future__ import annotations

import os
from types import SimpleNamespace

import pytest

from tests.test_torch_graph import PKGS, mod
from tests.test_torch_perf_sentinel import rel
from tests.test_torch_serve_runtime import FakeClock, make_runtime, package

PORT = PKGS[1]


def ns(pkg) -> SimpleNamespace:
    return SimpleNamespace(
        name=pkg, slo=mod(pkg, "obs.slo"), flight=mod(pkg, "obs.flight"),
        fleet=mod(pkg, "obs.fleet"), P=package(pkg))


def both(scenario, tmp_path=None) -> dict:
    out = {}
    for pkg in PKGS:
        if tmp_path is None:
            out[pkg] = scenario(ns(pkg), None)
            continue
        d = tmp_path / pkg
        d.mkdir()
        out[pkg] = rel(scenario(ns(pkg), d), str(d))
    assert out[PORT] == out[PKGS[0]]
    return out[PORT]


def make_monitor(O, windows=((10.0, 2.0), (60.0, 1.0)), target=0.99,
                 incident_dir=None):
    clock = FakeClock()
    flight = O.flight.FlightRecorder(
        clock=clock, incident_dir=None if incident_dir is None
        else str(incident_dir), min_dump_interval_s=0.0)
    mon = O.slo.SLOMonitor(clock=clock, flight=flight)
    mon.add(O.slo.Objective("obj", target, windows=windows))
    return mon, clock, flight


@pytest.mark.parametrize("pkg", PKGS)
def test_objective_validation(pkg):
    Objective = mod(pkg, "obs.slo").Objective
    for args, kw in (((1.5,), {}), ((0.99,), {"windows": ()}),
                     ((0.99,), {"windows": ((60.0, 1.0), (10.0, 2.0))})):
        with pytest.raises(ValueError):
            Objective("x", *args, **kw)


def burn_math(O, d):
    mon, clock, _ = make_monitor(O)
    good = bad = 0
    for _ in range(60):
        clock.advance(1.0)
        good += 95
        bad += 5
        mon.record("obj", good, bad)
    return mon.tick()


def test_burn_rate_math_over_sliding_window():
    snap = both(burn_math)["obj"]
    fast = snap["windows"][0]
    assert fast["error_ratio"] == pytest.approx(0.05)
    assert fast["burn_rate"] == pytest.approx(5.0)
    assert snap["budget_remaining"] == pytest.approx(1.0 - 5.0, rel=1e-3)


def every_window(O, d):
    mon, clock, flight = make_monitor(O, windows=((10.0, 2.0), (60.0, 4.0)))
    good = bad = 0
    snaps = []
    for i in range(60):
        clock.advance(1.0)
        good += 99
        bad += 3 if i >= 50 else 0
        mon.record("obj", good, bad)
        snaps.append(mon.tick())
    return snaps, flight.incidents


def test_alert_needs_every_window_burning():
    snaps, incidents = both(every_window)
    fast, slow = snaps[-1]["obj"]["windows"]
    assert fast["burning"] is True and slow["burning"] is False
    assert snaps[-1]["obj"]["alerting"] is False and incidents == 0


def idle(O, d):
    mon, clock, flight = make_monitor(O)
    for _ in range(100):
        clock.advance(1.0)
        mon.record("obj", 0, 0)
        snap = mon.tick()
    return snap, flight.incidents


def test_idle_windows_never_alert():
    snap, incidents = both(idle)
    assert snap["obj"]["alerting"] is False and incidents == 0
    assert all(w["burn_rate"] is None for w in snap["obj"]["windows"])


def fire_rearm(O, d):
    mon, clock, flight = make_monitor(O)
    good = bad = 0
    marks = []
    for g_step, b_step, n in ((5, 5, 100), (10, 0, 200), (5, 5, 100)):
        for _ in range(n):
            clock.advance(1.0)
            good += g_step
            bad += b_step
            mon.record("obj", good, bad)
            mon.tick()
        marks.append((flight.incidents, mon.snapshot()))
    return marks


def test_alert_fires_once_and_rearms_after_recovery():
    marks = both(fire_rearm)
    assert marks[0][0] == 1 and marks[0][1]["obj"]["alerting"] is True
    assert marks[0][1]["obj"]["alerts_total"] == 1
    assert marks[1][1]["obj"]["alerting"] is False
    assert marks[2][0] == 2


def flapping(O, d):
    mon, clock, flight = make_monitor(O)
    good = bad = 0
    for _ in range(60):
        clock.advance(1.0)
        good += 5
        bad += 5
        mon.record("obj", good, bad)
        mon.tick()
    first = flight.incidents
    for i in range(60):
        clock.advance(1.0)
        if i % 12 < 6:
            good += 10
        else:
            good += 5
            bad += 5
        mon.record("obj", good, bad)
        snap = mon.tick()
    return first, flight.incidents, snap


def test_flapping_short_window_stays_one_alert():
    first, incidents, snap = both(flapping)
    assert first == 1 and incidents == 1
    assert snap["obj"]["windows"][1]["burning"] is True
    assert snap["obj"]["alerts_total"] == 1


def pure_read(O, d):
    mon, clock, flight = make_monitor(O)
    good = bad = 0
    for _ in range(100):
        clock.advance(1.0)
        good += 5
        bad += 5
        mon.record("obj", good, bad)
        snap = mon.snapshot()
    before = flight.incidents
    mon.tick()
    return snap, before, flight.incidents


def test_snapshot_is_a_pure_read():
    snap, before, after = both(pure_read)
    assert snap["obj"]["alerting"] is False
    assert before == 0 and after == 1


def dump(O, d):
    mon, clock, flight = make_monitor(O, incident_dir=d)
    flight.record("serve.retry", attempt=1)
    good = bad = 0
    for _ in range(100):
        clock.advance(1.0)
        good += 1
        bad += 9
        mon.record("obj", good, bad)
        mon.tick()
    snap = mon.snapshot()["obj"]
    path = snap["last_incident"]
    recs = O.flight.parse_flight_jsonl(open(path).read())
    return snap, recs


def test_incident_dump_written_with_window(tmp_path):
    snap, recs = both(dump, tmp_path)
    assert os.path.basename(snap["last_incident"]).startswith("flight_")
    assert "serve.retry" in [r["kind"] for r in recs]
    incident = next(r for r in recs if r["kind"] == "incident")
    assert incident["reason"] == "slo_burn_obj"
    assert incident["objective"] == "obj"


@pytest.mark.parametrize("pkg", PKGS)
def test_unknown_objective_records_are_ignored(pkg):
    mon, clock, _ = make_monitor(ns(pkg))
    mon.record("nope", 1, 1)
    assert "nope" not in mon.snapshot()


def fleet_trio(O, d):
    clock = FakeClock()

    def replica(node_id, lag, bound=4, healthy=True):
        def health():
            return healthy, {"role": "replica", "replication_lag": lag,
                             "lag_bound": bound, "breaker_worst": 0}

        return O.fleet.LocalNodeSource(node_id, health=health,
                                       role="replica")

    col = O.fleet.FleetCollector(
        [replica("fresh", lag=0), replica("stale", lag=9),
         replica("down", lag=0, healthy=False)],
        clock=clock, flight=O.flight.FlightRecorder(clock=clock),
        poll_interval_s=0)
    mon = O.slo.fleet_objectives(col, windows=((10.0, 1.5), (30.0, 1.0)))
    col.slo = mon
    for _ in range(40):
        clock.advance(1.0)
        col.poll()
    return mon.snapshot(), col.fleet_healthz()


def test_fleet_objectives_lag_and_availability_sources():
    snap, health = both(fleet_trio)
    lag = snap["replication_lag"]["windows"][-1]
    assert lag["error_ratio"] == pytest.approx(1 / 3, rel=1e-3)
    avail = snap["availability"]["windows"][-1]
    assert avail["error_ratio"] == pytest.approx(1 / 3, rel=1e-3)
    assert snap["replication_lag"]["alerting"] is True
    assert health[0] is False and health[1]["healthy_nodes"] == 2


def chaos(O, d):
    clock = FakeClock()
    rt, ex, _ = make_runtime(O.P, clock=clock)
    flight = O.flight.FlightRecorder(clock=clock, incident_dir=str(d),
                                     min_dump_interval_s=0.0)
    col = O.fleet.FleetCollector(
        [O.fleet.LocalNodeSource("primary", registries=[rt.stats.registry],
                                 health=lambda: (True, {"role": "primary"}))],
        clock=clock, flight=flight, poll_interval_s=0)
    col.slo = O.slo.fleet_objectives(col, deadline_target=0.9,
                                     windows=((10.0, 2.0), (30.0, 1.5)))
    done = []
    for _ in range(40):
        clock.advance(1.0)
        fut = rt.submit_bfs(1, deadline_s=0.25)
        clock.advance(0.5)
        rt.step(drain=True)
        done.append(fut.done())
        col.poll()
    snap = col.slo.snapshot()
    recs = O.flight.parse_flight_jsonl(
        open(snap["serve_deadline"]["last_incident"]).read())
    rt.close()
    return done, rt.stats.shed_deadline, snap, recs


def test_chaos_shed_past_deadline_slo_fires_burn_incident(tmp_path):
    done, shed, snap, recs = both(chaos, tmp_path)
    assert all(done) and shed == 40
    assert snap["serve_deadline"]["alerting"] is True
    incident = next(r for r in recs if r["kind"] == "incident")
    assert incident["reason"] == "slo_burn_serve_deadline"
