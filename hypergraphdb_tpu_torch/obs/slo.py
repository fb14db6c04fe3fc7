"""Declarative SLOs: sliding-window error budgets + burn-rate alerts.

The port of ``hypergraphdb_tpu/obs/slo.py``; snapshots and incidents equal
the reference's under the same clock and samples.

An :class:`Objective` states a contract ("99% of requests beat their
deadline") as a good/bad event ratio target over sliding windows; the
:class:`SLOMonitor` samples each objective's CUMULATIVE good/bad totals
(pulled from a source callable, or pushed via :meth:`SLOMonitor.record`),
keeps a bounded time-series per objective, and evaluates **multi-window
burn rates** — the Google-SRE alerting shape: the error-budget burn rate
is ``error_ratio / (1 - target)`` (1.0 = spending the budget exactly at
its sustainable pace), and an alert fires only when EVERY configured
window burns past its threshold (the short window proves the problem is
happening NOW, the long window proves it is not a blip).

Alerts are **flight-recorder incidents**: an alert edge calls
``FlightRecorder.incident("slo_burn_<name>", ...)`` — the same
rate-limited window-dump machinery every other incident producer uses,
so the minutes leading into a burn are on disk next to the breaker trips
and typed serve errors that usually explain it. Alerting is
edge-triggered with hysteresis (re-arms once every window drops below
its threshold), so a sustained burn costs one incident, not one per
evaluation.

The whole module is clock-injected and import-light (no HTTP): the
tests drive windows with a fake clock, and the
fleet collector (:mod:`~hypergraphdb_tpu_torch.obs.fleet`) ticks one monitor
per poll. :func:`fleet_objectives` wires the standard fleet trio —
deadline-hit ratio from the ``serve.*`` terminals, replication-lag bound
from replica healthz, availability from breaker/gate states — over a
:class:`~hypergraphdb_tpu_torch.obs.fleet.FleetCollector`.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from hypergraphdb_tpu_torch.obs.flight import FlightRecorder, global_flight

#: default multi-window burn thresholds — (window_s, burn_rate): the
#: classic fast-burn pair scaled to serving-test time constants (a 1h/5m
#: page ladder makes no sense inside a CI smoke; deployments pass their
#: own windows)
DEFAULT_WINDOWS = ((60.0, 14.4), (300.0, 6.0))

#: a source yields (good_total, bad_total) CUMULATIVE counts
Source = Callable[[], tuple]


@dataclass(frozen=True)
class Objective:
    """One declarative SLO.

    ``target`` is the good-ratio contract (0.99 = 1% error budget);
    ``windows`` the multi-window burn alert config: ``(seconds,
    burn_threshold)`` pairs — ALL windows must burn past their threshold
    to alert. Windows must be sorted ascending by span; the longest one
    is also the budget-remaining report window."""

    name: str
    target: float
    description: str = ""
    windows: tuple = DEFAULT_WINDOWS

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"target {self.target} outside (0, 1)")
        if not self.windows:
            raise ValueError("at least one burn window required")
        spans = [w for w, _ in self.windows]
        if spans != sorted(spans):
            raise ValueError("windows must ascend by span")


@dataclass
class _State:
    """Per-objective monitor state: bounded cumulative sample series +
    alert hysteresis."""

    objective: Objective
    source: Optional[Source]
    #: (t, good_total, bad_total) samples, oldest first
    samples: deque = field(default_factory=deque)
    alerting: bool = False
    alerts: int = 0
    last_incident_path: Optional[str] = None


def _window_delta(samples: deque, now: float, span: float):
    """(Δgood, Δbad) over the trailing ``span`` seconds: newest sample
    minus the latest sample at/before the window start (the window sees
    the whole gap a sparse poll cadence leaves). None before 2 samples."""
    if len(samples) < 2:
        return None
    t1, g1, b1 = samples[-1]
    base = None
    cutoff = now - span
    for t, g, b in samples:
        if t <= cutoff:
            base = (t, g, b)
        else:
            break
    if base is None:
        base = samples[0]
    _, g0, b0 = base
    return max(0, g1 - g0), max(0, b1 - b0)


class SLOMonitor:
    """The evaluator. Thread-safe: ``tick`` runs on the collector's poll
    thread while ``snapshot`` serves HTTP scrapes."""

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 flight: Optional[FlightRecorder] = None,
                 max_samples: int = 4096):
        self.clock = clock or time.monotonic
        self.flight = flight if flight is not None else global_flight()
        self.max_samples = int(max_samples)
        self._lock = threading.Lock()
        self._states: dict[str, _State] = {}

    # -- registration --------------------------------------------------------
    def add(self, objective: Objective,
            source: Optional[Source] = None) -> "SLOMonitor":
        """Register one objective. ``source`` (optional) is pulled on
        every :meth:`tick`; push totals with :meth:`record` otherwise.
        Re-adding a name replaces the objective but KEEPS its series
        (live reconfiguration must not blind the windows)."""
        with self._lock:
            st = self._states.get(objective.name)
            if st is None:
                self._states[objective.name] = _State(objective, source)
            else:
                st.objective = objective
                if source is not None:
                    st.source = source
        return self

    def objectives(self) -> list[Objective]:
        with self._lock:
            return [st.objective for st in self._states.values()]

    # -- feeding -------------------------------------------------------------
    def record(self, name: str, good_total: int, bad_total: int,
               t: Optional[float] = None) -> None:
        """Append one cumulative sample for ``name`` (unknown names are
        ignored — a fleet node may advertise objectives this monitor
        does not carry)."""
        with self._lock:
            st = self._states.get(name)
            if st is None:
                return
            st.samples.append((self.clock() if t is None else float(t),
                               int(good_total), int(bad_total)))
            while len(st.samples) > self.max_samples:
                st.samples.popleft()

    def tick(self) -> dict:
        """Pull every sourced objective once, evaluate ALL objectives,
        fire incident on alert edges. Returns the evaluation snapshot
        (same shape as :meth:`snapshot`)."""
        with self._lock:
            pulls = [(name, st.source) for name, st in self._states.items()
                     if st.source is not None]
        for name, source in pulls:
            try:
                good, bad = source()
            except Exception:  # noqa: BLE001 - a broken source ≠ dead monitor
                continue
            self.record(name, good, bad)
        return self._evaluate()

    # -- evaluation ----------------------------------------------------------
    def _evaluate(self, mutate: bool = True) -> dict:
        now = self.clock()
        fire: list[tuple] = []
        out: dict = {}
        with self._lock:
            for name, st in self._states.items():
                obj = st.objective
                budget = 1.0 - obj.target
                wins = []
                all_burning = True
                any_burning = False
                for span, threshold in obj.windows:
                    d = _window_delta(st.samples, now, span)
                    if d is None or (d[0] + d[1]) == 0:
                        # no events in window: not burning (an idle
                        # fleet must not page), and not alert-worthy
                        wins.append({"window_s": span, "events": 0,
                                     "error_ratio": None, "burn_rate": None,
                                     "threshold": threshold,
                                     "burning": False})
                        all_burning = False
                        continue
                    good, bad = d
                    ratio = bad / (good + bad)
                    burn = ratio / budget
                    burning = burn >= threshold
                    all_burning = all_burning and burning
                    any_burning = any_burning or burning
                    wins.append({"window_s": span, "events": good + bad,
                                 "error_ratio": round(ratio, 6),
                                 "burn_rate": round(burn, 4),
                                 "threshold": threshold,
                                 "burning": burning})
                if mutate and all_burning and not st.alerting:
                    st.alerting = True
                    st.alerts += 1
                    fire.append((st, dict(
                        objective=name, target=obj.target,
                        **{f"burn_{int(w['window_s'])}s": w["burn_rate"]
                           for w in wins},
                    )))
                elif mutate and st.alerting and not any_burning:
                    # hysteresis re-arm only once EVERY window recovers:
                    # a sustained burn whose short window flaps (one
                    # clean burst, then burning again) stays ONE alert,
                    # not one incident per oscillation
                    st.alerting = False
                long_ratio = next(
                    (w["error_ratio"] for w in reversed(wins)
                     if w["error_ratio"] is not None), None,
                )
                out[name] = {
                    "target": obj.target,
                    "description": obj.description,
                    "windows": wins,
                    "alerting": st.alerting,
                    "alerts_total": st.alerts,
                    "budget_remaining": (
                        None if long_ratio is None
                        else round(1.0 - long_ratio / budget, 4)
                    ),
                    "last_incident": st.last_incident_path,
                }
        # incidents OUTSIDE the lock: the recorder writes files
        for st, fields in fire:
            path = self.flight.incident(
                "slo_burn_" + st.objective.name, **fields
            )
            if path is not None:
                with self._lock:
                    st.last_incident_path = path
                out[st.objective.name]["last_incident"] = path
        return out

    def snapshot(self) -> dict:
        """The ``/fleet/slo`` body: every objective's windows, burn
        rates, alert state, and budget remaining — a READ: no new
        samples, no alert-edge transitions, no incidents (scrapes must
        not fire or re-arm alerts; only :meth:`tick` does)."""
        return self._evaluate(mutate=False)


# ------------------------------------------------------- fleet standard trio


def fleet_objectives(collector, monitor: Optional[SLOMonitor] = None,
                     deadline_target: float = 0.99,
                     lag_target: float = 0.999,
                     availability_target: float = 0.999,
                     perf_target: float = 0.999,
                     sub_target: float = 0.999,
                     windows: tuple = DEFAULT_WINDOWS) -> SLOMonitor:
    """Wire the standard fleet SLO set over a
    :class:`~hypergraphdb_tpu_torch.obs.fleet.FleetCollector`:

    - ``serve_deadline`` — deadline-hit ratio from the ``serve.*``
      terminals (good = completed, bad = shed past deadline), summed
      across every node's scrape;
    - ``replication_lag`` — per poll, each replica whose advertised lag
      exceeds its own advertised bound is one bad event;
    - ``availability`` — per poll, each node unreachable, unhealthy, or
      with an OPEN serve breaker is one bad event;
    - ``perf_drift`` — per poll, each node whose perf sentinel
      (``obs.perf.PerfSentinel``, advertised as the ``perf`` healthz
      section) reports ANY lane or skew violation is one bad event —
      the fleet-level error budget over the hgperf verdicts. Nodes
      without a sentinel don't vote (absent ≠ healthy);
    - ``sub_staleness`` — per poll, each node whose hgsub subscription
      tier (the ``sub`` healthz section) reports a standing query dirty
      past its staleness bound is one bad event — the freshness budget
      of the streaming tier. Nodes without subscriptions don't vote.

    Returns the monitor (created on the collector's clock when not
    passed) — attach it with ``FleetCollector(..., slo=monitor)`` or
    ``collector.slo = monitor``."""
    mon = monitor or SLOMonitor(clock=collector.clock,
                                flight=collector.flight)

    def deadline_source():
        good = collector.metric_total("serve_completed_total")
        bad = collector.metric_total("serve_shed_deadline_total")
        return int(good), int(bad)

    # level-triggered objectives accumulate poll verdicts here (sources
    # must yield CUMULATIVE totals)
    acc = {"lag": [0, 0], "avail": [0, 0], "perf": [0, 0],
           "sub": [0, 0]}

    def lag_source():
        good, bad = 0, 0
        for scrape in collector.node_scrapes().values():
            h = scrape.health or {}
            if h.get("role") != "replica":
                continue
            lag, bound = h.get("replication_lag"), h.get("lag_bound")
            if lag is None or bound is None:
                continue
            if int(lag) > int(bound):
                bad += 1
            else:
                good += 1
        acc["lag"][0] += good
        acc["lag"][1] += bad
        return tuple(acc["lag"])

    def avail_source():
        good, bad = 0, 0
        for scrape in collector.node_scrapes().values():
            h = scrape.health or {}
            down = (not scrape.ok or not scrape.healthy
                    or int(h.get("breaker_worst", 0) or 0) >= 2)
            if down:
                bad += 1
            else:
                good += 1
        acc["avail"][0] += good
        acc["avail"][1] += bad
        return tuple(acc["avail"])

    def perf_source():
        good, bad = 0, 0
        for scrape in collector.node_scrapes().values():
            p = (scrape.health or {}).get("perf")
            if not isinstance(p, dict):
                continue  # no sentinel on this node: it doesn't vote
            if p.get("violating"):
                bad += 1
            else:
                good += 1
        acc["perf"][0] += good
        acc["perf"][1] += bad
        return tuple(acc["perf"])

    def sub_source():
        good, bad = 0, 0
        for scrape in collector.node_scrapes().values():
            s = (scrape.health or {}).get("sub")
            if not isinstance(s, dict):
                continue  # no subscription tier here: it doesn't vote
            if s.get("violating"):
                bad += 1
            else:
                good += 1
        acc["sub"][0] += good
        acc["sub"][1] += bad
        return tuple(acc["sub"])

    mon.add(Objective("serve_deadline", deadline_target,
                      "requests resolved within their deadline",
                      windows), deadline_source)
    mon.add(Objective("replication_lag", lag_target,
                      "replicas inside their advertised lag bound",
                      windows), lag_source)
    mon.add(Objective("availability", availability_target,
                      "nodes reachable, healthy, breakers not open",
                      windows), avail_source)
    mon.add(Objective("perf_drift", perf_target,
                      "nodes with every lane inside its perf baseline",
                      windows), perf_source)
    mon.add(Objective("sub_staleness", sub_target,
                      "nodes with every standing query inside its "
                      "staleness bound", windows), sub_source)
    return mon
