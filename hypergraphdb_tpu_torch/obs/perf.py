"""hgperf: continuous performance observability — the port of
``hypergraphdb_tpu/obs/perf.py``.

A serve lane silently getting 3× slower at runtime shows in no static
check and in no availability SLO. This module closes that gap:

- **PerfBaseline** (a ``PERF_BASELINE.json``-shaped record): the
  per-lane performance contract — p50/p99 latency, qps,
  device-seconds/request — seeded from bench-shaped ``BENCH_C*`` records
  (:func:`seed_baseline`). :func:`load_baseline` is the version-checking
  reader. **A recorded difference**: :func:`default_baseline_path` never
  resolves to the repository root's ``PERF_BASELINE.json``, which the
  reference seeded from its CPU smokes; the port reads
  ``HG_PERF_BASELINE`` or an explicit path, so a card is priced from a
  record seeded on a card (``chip_smoke.py`` phase 20 writes one).
- **PerfSentinel**: per-lane rolling digests fed by the serving
  runtime's completion path (``ServeConfig(perf=sentinel)``), evaluated
  against the baseline with **multi-window drift detection** in the
  ``obs.slo.SLOMonitor`` style: a lane alerts only when EVERY configured
  window is degraded (the short window proves the problem is happening
  NOW, the long one that it is not a blip), edge-triggered with
  hysteresis (re-arms only once every window clears), so a sustained
  degradation costs ONE incident, not one per evaluation. A firing
  detector raises a flight-recorder incident (``perf_drift_<lane>``) AND
  auto-opens a bounded :func:`~hypergraphdb_tpu_torch.obs.device.profile`
  session (``torch.profiler``) around the degraded lane, so the profiler
  trace lands beside the flight window dump — the "incident profile" an
  operator needs to answer WHY, captured before anyone asks.
- **Skew/straggler attribution** (:func:`shard_skew`): per-shard gauges
  from a sharded executor's ``mesh_report()`` rolled into max/mean skew
  ratios with the straggler shard named; a skew ratio sustained past
  ``skew_ratio_max`` raises its own edge-triggered ``perf_skew_<key>``
  incident. A runtime over a ``ShardedExecutor`` hands the sentinel the
  executor's ``mesh_report`` as its ``mesh_source``.

The whole module is clock-injected and import-light (``torch`` is
imported only when a profile session actually opens, and the profiler
is itself injectable, so the tests run without one). Aggregation across
the fleet rides the existing planes: the sentinel's
:meth:`~PerfSentinel.health_summary` is embedded in ``/healthz`` by
``obs.http.runtime_health``, merged at the door by
``FleetCollector.fleet_perf()``, and ``obs.slo.fleet_objectives`` wires a
``perf_drift`` error-budget objective over the per-node verdicts.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Optional

from hypergraphdb_tpu_torch.obs.flight import FlightRecorder, global_flight
from hypergraphdb_tpu_torch.obs.registry import Registry

#: committed baseline file schema (the reader rejects unknown versions)
BASELINE_SCHEMA_VERSION = 1

#: PROFILE.json capture-manifest format (see _write_manifest)
MANIFEST_SCHEMA_VERSION = 1

#: default committed baseline filename (next to the repo's BENCH_C* files)
BASELINE_FILENAME = "PERF_BASELINE.json"

#: default drift windows (seconds): short proves NOW, long proves
#: not-a-blip — serving-test time constants, deployments pass their own
DEFAULT_WINDOWS = (30.0, 120.0)

#: default tolerance factors: observed metric > baseline × factor ⇒
#: degraded. Generous by default — the seeded CPU-smoke baselines are
#: coarse anchors; operators tighten once real-hardware numbers exist.
DEFAULT_FACTORS = {"p50_s": 3.0, "p99_s": 3.0, "device_s_per_req": 3.0}

#: the baseline metrics the sentinel gates on (qps/occupancy ride the
#: digests as attribution context but never page — qps tracks OFFERED
#: load, and a quiet service must not read as a slow one)
GATED_METRICS = ("p50_s", "p99_s", "device_s_per_req")

#: latency contracts are checked as BREACH FRACTIONS — the share of a
#: window's samples slower than ``baseline × factor`` — not as the
#: window's own percentile: a long window's raw p99 jumps on a 3-sample
#: blip (percentiles never dilute tails), which would defeat the
#: "long window proves it is not a blip" contract. A p50 contract is
#: violated when >50% of the window breaches its limit, a p99 contract
#: when >5% breaches (a 5× overdraft of the 1% tail budget — the
#: burn-rate idea translated to latency limits). ``device_s_per_req``
#: is a window AGGREGATE (Σ device-seconds / Σ real lanes), which
#: dilutes blips naturally.
BREACH_ALLOWANCES = {"p50_s": 0.5, "p99_s": 0.05}

#: per-shard report keys whose max/mean skew is gate-worthy (structural
#: keys like gid_span are reported for attribution but never page)
DEFAULT_SKEW_GATE_KEYS = ("hbm_bytes_in_use", "device_seconds")


# ------------------------------------------------------------- baseline file


def default_baseline_path() -> Optional[str]:
    """Where a deployment's baseline lives: ``HG_PERF_BASELINE``, or None.

    The reference falls back to the repository root's
    ``PERF_BASELINE.json``; that record was seeded from CPU smokes, so
    the port never reads it unless a caller names it."""
    return os.environ.get("HG_PERF_BASELINE") or None


def load_baseline(path: str) -> dict:
    """The version-checking reader for ``PERF_BASELINE.json``. Raises
    ``ValueError`` on unknown schema versions or a record without the
    ``lanes`` contract — a sentinel must never run against a file whose
    shape it merely guessed."""
    with open(path) as f:
        rec = json.load(f)
    v = rec.get("schema_version")
    if v != BASELINE_SCHEMA_VERSION:
        raise ValueError(
            f"{path}: perf baseline schema {v!r} != "
            f"{BASELINE_SCHEMA_VERSION} (re-seed it with seed_baseline)"
        )
    if not isinstance(rec.get("lanes"), dict):
        raise ValueError(f"{path}: perf baseline has no 'lanes' mapping")
    return rec


def save_baseline(record: dict, path: str) -> str:
    with open(path, "w") as f:
        json.dump(record, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def _bench_candidates(bench_dirs, prefix: str) -> list:
    """Every readable bench record for one config prefix across
    ``bench_dirs``, as ``(recorded_unix, path, record)`` triples."""
    out = []
    seen = set()
    for bench_dir in bench_dirs:
        try:
            names = sorted(os.listdir(bench_dir))
        except OSError:
            continue
        for name in names:
            if not (name.startswith(prefix + "_")
                    and name.endswith(".json")):
                continue
            path = os.path.join(bench_dir, name)
            # dedup by REAL path, never by basename: a fresh
            # BENCH_C6_local.json under BENCH_RECORD_DIR must compete
            # with (and, being newer, beat) the committed one — only the
            # literal same file is skipped
            real = os.path.realpath(path)
            if real in seen:
                continue
            try:
                with open(path) as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                continue
            seen.add(real)
            out.append((int(rec.get("recorded_unix") or 0), path, rec))
    return out


def seed_baseline(bench_dirs=".", out_path: Optional[str] = None,
                  factors: Optional[dict] = None) -> dict:
    """Seed a ``PERF_BASELINE.json`` record from the recorded
    ``BENCH_C*`` files in ``bench_dirs`` (one dir or a sequence):

    - ``bfs``     ← ``BENCH_C6_*`` (open-loop serving: real latency
      percentiles + served qps);
    - ``range``   ← ``BENCH_C9_*`` (same shape);
    - ``pattern`` + ``sub`` ← ``BENCH_C10_*`` — one c10 run carries
      BOTH the ad-hoc open-loop pattern percentiles and the standing
      tier's notification-latency percentiles (ingest-dirty →
      delta-enqueued, the ``sub`` lane the manager feeds the sentinel);
    - ``join``    ← ``BENCH_C11_*`` (open-loop join serving: REAL
      latency percentiles + served qps, same shape as c6/c9/c10),
      falling back to ``BENCH_C7_*`` when no c11 record exists — c7 is
      closed-loop THROUGHPUT, so its latency anchor is the per-anchor
      mean (``1 / triangle.device_anchors_per_sec``) with ``p99_s`` a
      4× heuristic, recorded as such in the lane's ``note``.

    Per config the NEWEST record wins (``recorded_unix``): the
    documented re-seed flow — run a real-hardware sweep under a new
    tag, then seed — must pick the fresh run over the committed smokes,
    whatever its tag. Lanes with no bench record are omitted — the
    sentinel only gates lanes the baseline names. Writes ``out_path``
    when given; returns the record either way."""
    if isinstance(bench_dirs, str):
        bench_dirs = (bench_dirs,)
    lanes: dict = {}
    sources: list = []
    backends: list = []
    for prefix, key, build in (
        ("BENCH_C6", "c6_serving", _lanes_from_serving),
        ("BENCH_C9", "c9_value_index", _lanes_from_serving),
        ("BENCH_C10", "c10_pattern", _lanes_from_pattern),
        ("BENCH_C7", "c7_pattern_join", _lanes_from_join),
        # AFTER the c7 entry on purpose: both seed the ``join`` lane,
        # and last-writer-wins is the fallback order — c11's measured
        # open-loop percentiles beat c7's throughput proxy whenever a
        # c11 record exists at all
        ("BENCH_C11", "c11_join", _lanes_from_join_open),
    ):
        candidates = sorted(_bench_candidates(bench_dirs, prefix),
                            key=lambda t: t[0], reverse=True)
        for _, path, rec in candidates:
            payload = rec.get(key)
            if not isinstance(payload, dict):
                continue
            built = [(name, lane) for name, lane in build(payload)
                     if lane]
            if built:
                for lane_name, lane in built:
                    # per-lane provenance: a partial re-record (only c6
                    # on real hardware, the rest still CPU smokes) must
                    # not masquerade as a uniform contract
                    lane["backend"] = str(rec.get("backend") or "unknown")
                    lanes[lane_name] = lane
                    backends.append(lane["backend"])
                sources.append(os.path.basename(path))
                break
    uniq = sorted(set(backends))
    record = {
        "schema_version": BASELINE_SCHEMA_VERSION,
        "recorded_unix": int(time.time()),
        # "mixed" flags a cross-backend seed loudly (bench_diff's
        # backend_differs discipline) — the per-lane fields say which
        "backend": (uniq[0] if len(uniq) == 1 else
                    "mixed" if uniq else "unknown"),
        "source": sources,
        "factors": dict(factors or DEFAULT_FACTORS),
        "lanes": lanes,
    }
    if out_path is not None:
        save_baseline(record, out_path)
    return record


def _serving_lane(payload: dict) -> dict:
    """The shared open-loop serving shape (c6/c9/c10): latency
    percentiles in ms + served qps."""
    lane = {}
    p50, p99 = payload.get("latency_ms_p50"), payload.get("latency_ms_p99")
    if p50:
        lane["p50_s"] = round(float(p50) / 1e3, 6)
    if p99:
        lane["p99_s"] = round(float(p99) / 1e3, 6)
    if payload.get("served_qps"):
        lane["qps"] = float(payload["served_qps"])
    return lane


def _lanes_from_serving(payload: dict):
    lane_name = "bfs" if "batched_vs_unbatched" in payload else "range"
    return [(lane_name, _serving_lane(payload))]


def _lanes_from_pattern(payload: dict):
    """One c10 record seeds TWO lanes: the ad-hoc ``pattern`` serving
    percentiles and the standing-subscription ``sub`` lane, whose
    latency samples are notification deliveries (ingest-dirty →
    delta-enqueued), fed to the sentinel by the SubscriptionManager."""
    out = [("pattern", _serving_lane(payload))]
    sub = payload.get("sub") or {}
    lane = {}
    p50, p99 = sub.get("notify_ms_p50"), sub.get("notify_ms_p99")
    if p50:
        lane["p50_s"] = round(float(p50) / 1e3, 6)
    if p99:
        lane["p99_s"] = round(float(p99) / 1e3, 6)
    if lane:
        lane["note"] = ("standing-subscription notification latency "
                        "(dirty -> delta enqueued)")
    out.append(("sub", lane))
    return out


def _lanes_from_join_open(payload: dict):
    """The c11 open-loop join record: the same serving shape as
    c6/c9/c10 — measured latency percentiles under queueing + served
    qps — for the lane c7 could only proxy from closed-loop
    throughput."""
    lane = _serving_lane(payload)
    if lane:
        lane["note"] = ("open-loop join serving percentiles "
                        "(c11: Poisson arrivals under concurrent ingest)")
    return [("join", lane)]


def _lanes_from_join(payload: dict):
    tri = payload.get("triangle") or {}
    qps = tri.get("device_anchors_per_sec")
    if not qps or qps <= 0:
        return [("join", {})]
    p50 = 1.0 / float(qps)
    return [("join", {
        "p50_s": round(p50, 6),
        "p99_s": round(4.0 * p50, 6),
        "qps": float(qps),
        "note": "closed-loop c7 throughput proxy (per-anchor mean; "
                "p99 is a 4x heuristic)",
    })]


# --------------------------------------------------------- skew attribution

#: per-shard report keys that are identity/structure, not load gauges
_SHARD_IDENTITY_KEYS = ("device", "gid_lo", "gid_hi")


def shard_skew(mesh_report: dict) -> dict:
    """Roll a ``ShardedExecutor.mesh_report()`` into max/mean skew
    ratios per per-shard gauge, naming the straggler shard.

    Every numeric per-shard field is summarized (``hbm_bytes_in_use``
    where the backend reports allocator stats; ``device_seconds`` once a
    real-hardware path measures it; anything a future report adds),
    plus the structural ``gid_span`` derived from the partition ranges.
    Shape: ``{key: {"max", "mean", "ratio", "straggler"}}`` where
    ``straggler`` is the device id owning the max. Empty dict when the
    report carries no shards."""
    shards = mesh_report.get("shards") or ()
    series: dict[str, list] = {}
    for s in shards:
        dev = s.get("device")
        lo, hi = s.get("gid_lo"), s.get("gid_hi")
        if lo is not None and hi is not None:
            series.setdefault("gid_span", []).append((float(hi - lo), dev))
        for k, v in s.items():
            if k in _SHARD_IDENTITY_KEYS or not isinstance(v, (int, float)):
                continue
            series.setdefault(k, []).append((float(v), dev))
    out = {}
    for key, vals in series.items():
        mean = sum(v for v, _ in vals) / len(vals)
        mx, straggler = max(vals, key=lambda p: p[0])
        if mean <= 0:
            continue
        out[key] = {
            "max": mx,
            "mean": round(mean, 6),
            "ratio": round(mx / mean, 4),
            "straggler": straggler,
        }
    return out


# ----------------------------------------------------------------- sentinel


class _Lane:
    """One lane's rolling digest + alert hysteresis."""

    __slots__ = ("samples", "batches", "alerting", "alerts",
                 "last_incident", "last_profile")

    def __init__(self, max_samples: int):
        #: (t, latency_s, served_on_host) completion samples
        self.samples: deque = deque(maxlen=max_samples)
        #: (t, device_s, n_real, n_total) measured device batches
        self.batches: deque = deque(maxlen=max_samples)
        self.alerting = False
        self.alerts = 0
        self.last_incident: Optional[str] = None
        self.last_profile: Optional[str] = None


def _window(samples: list, batches: list, ring_full: bool,
            now: float, span: float,
            limits: Optional[dict] = None,
            min_samples: int = 0, min_breaches: int = 3) -> dict:
    """One lane's digest over the trailing ``span`` seconds — count,
    qps, p50/p99 latency, host-serve fraction, device-seconds/request
    and pad occupancy — plus the window's three-state verdict:

    - ``unknown`` — no baseline limits, or fewer than ``min_samples``
      samples: not enough evidence to call the window either way (an
      idle lane must neither page nor count as recovered);
    - ``degraded`` — some gated metric exceeded: a latency limit
      breached by more than its :data:`BREACH_ALLOWANCES` share AND by
      at least ``min_breaches`` samples (a single outlier in a small
      window is a blip, not a page), or the aggregate
      device-seconds/request over its limit;
    - ``clear`` — enough samples, nothing exceeded.

    A window whose span outruns the bounded sample ring is
    ``unknown`` too (``span_truncated``): at high qps the deque evicts
    history faster than the long window's span, and a sub-second burst
    filling the whole ring would otherwise read as "the long window is
    degraded" — exactly the blip the multi-window design must not page
    on. Size ``max_samples ≥ qps × longest window`` to keep long
    windows verdict-capable.

    Operates on ring SNAPSHOTS (``samples``/``batches`` lists plus the
    ``ring_full`` flag, captured under the sentinel lock) so the sorts
    run without blocking the dispatch-thread observe path."""
    cutoff = now - span
    lats: list = []
    hosts = 0
    crossed = False
    for t, lat, host in reversed(samples):
        if t <= cutoff:
            crossed = True
            break
        lats.append(lat)
        hosts += 1 if host else 0
    # ring at capacity with every retained sample inside the span: the
    # evicted history was younger than the window start, so the window
    # cannot honestly speak for its full span
    truncated = not crossed and ring_full
    n = len(lats)
    out: dict = {"n": n, "qps": round(n / span, 4) if span > 0 else None}
    if n:
        ordered = sorted(lats)
        out["p50_s"] = round(ordered[(n - 1) // 2], 6)
        out["p99_s"] = round(ordered[min(n - 1, (99 * n) // 100)], 6)
        out["host_fraction"] = round(hosts / n, 4)
    dev_s = real = total = 0.0
    for t, ds, nr, nt in reversed(batches):
        if t <= cutoff:
            break
        dev_s += ds
        real += nr
        total += nt
    if real:
        out["device_s_per_req"] = round(dev_s / real, 6)
        if total:
            out["occupancy"] = round(real / total, 4)
    exceeded: list = []
    known = bool(limits) and n >= min_samples and not truncated
    if truncated:
        out["span_truncated"] = True
    if known:
        for metric, allowance in BREACH_ALLOWANCES.items():
            limit = limits.get(metric)
            if limit is None:
                continue
            breaches = sum(1 for lat in lats if lat > limit)
            out[f"breach_{metric}"] = round(breaches / n, 4)
            if breaches / n > allowance and breaches >= min_breaches:
                exceeded.append(metric)
        limit = limits.get("device_s_per_req")
        observed = out.get("device_s_per_req")
        if limit is not None and observed is not None and observed > limit:
            exceeded.append("device_s_per_req")
    out["exceeded"] = exceeded
    out["status"] = ("unknown" if not known
                     else "degraded" if exceeded else "clear")
    return out


class _ProfileSession:
    """An open bounded profiler capture: the context manager, its
    output dir, and the deadline the next tick closes it at."""

    __slots__ = ("cm", "logdir", "lane", "until", "active")

    def __init__(self, cm, logdir: str, lane: str, until: float,
                 active: bool):
        self.cm = cm
        self.logdir = logdir
        self.lane = lane
        self.until = until
        self.active = active


#: reservation marker for the one-session-at-a-time incident profiler —
#: held in ``_profile`` between the check and the (lockless) session open
_PENDING_PROFILE = _ProfileSession(None, "", "", float("inf"), False)


class PerfSentinel:
    """The runtime perf sentinel: rolling per-lane digests vs the
    committed baseline, multi-window drift alerts as flight-recorder
    incidents with auto-captured profiler sessions, and mesh skew
    attribution.

    Feeding: wire ``ServeConfig(perf=sentinel)`` — the runtime pushes
    :meth:`observe` per completed request and :meth:`observe_batch` per
    ``block_timed``-measured device batch (``device_timing=True``), then
    rate-limits an evaluation through :meth:`maybe_tick` (no thread of
    its own). Use the SAME clock as the runtime: samples are stamped on
    it and the windows are cut against it.

    Evaluation (:meth:`tick`) is the mutating edge — scrapes read
    :meth:`snapshot` / :meth:`health_summary`, which never fire or
    re-arm alerts (the SLO monitor's discipline). Thread-safe.

    **Window sizing**: a window only renders a verdict once it holds
    ``min_samples`` — below that it is ``unknown``, which neither fires
    nor re-arms (no evidence ≠ recovered). Size spans so the lane's
    completion rate keeps windows populated even UNDER the slowdowns
    you want to catch: a closed-loop caller 10× slower completes 10×
    fewer requests per span, so ``span ≥ min_samples / (qps /
    slowdown_factor)`` — too-short windows go silent (``unknown``)
    during a catastrophic degradation rather than guessing."""

    def __init__(self, baseline=None,
                 clock: Optional[Callable[[], float]] = None,
                 flight: Optional[FlightRecorder] = None,
                 windows=DEFAULT_WINDOWS,
                 min_samples: int = 8,
                 min_breaches: int = 3,
                 eval_interval_s: float = 1.0,
                 profile_s: float = 2.0,
                 profiler: Optional[Callable] = None,
                 registry: Optional[Registry] = None,
                 mesh_source: Optional[Callable[[], dict]] = None,
                 skew_ratio_max: float = 1.5,
                 skew_gate_keys=DEFAULT_SKEW_GATE_KEYS,
                 max_samples: int = 4096):
        if isinstance(baseline, str):
            baseline = load_baseline(baseline)
        self.baseline = baseline or {"lanes": {}}
        self.factors = dict(DEFAULT_FACTORS)
        self.factors.update(self.baseline.get("factors") or {})
        self.clock = clock or time.monotonic
        self.flight = flight if flight is not None else global_flight()
        self.windows = tuple(float(w) for w in windows)
        if not self.windows or list(self.windows) != sorted(self.windows):
            raise ValueError("windows must be non-empty, ascending by span")
        # clamped ≥ 1: a window verdict over zero samples is undefined
        # (and min_samples=0 would divide by zero in the breach math)
        self.min_samples = max(1, int(min_samples))
        self.min_breaches = int(min_breaches)
        self.eval_interval_s = float(eval_interval_s)
        self.profile_s = float(profile_s)
        self._profiler = profiler  # None → obs.device.thread_profile
        self.registry = registry if registry is not None else Registry("perf")
        self.mesh_source = mesh_source
        self.skew_ratio_max = float(skew_ratio_max)
        self.skew_gate_keys = tuple(skew_gate_keys)
        self.max_samples = int(max_samples)
        self._lock = threading.Lock()
        self._lanes: dict[str, _Lane] = {}
        self._last_eval: Optional[float] = None
        self._profile: Optional[_ProfileSession] = None
        self._skew: Optional[dict] = None
        self._skew_alerting = False
        self._skew_alerts = 0
        self._alerts = self.registry.counter("perf.alerts")
        self._lane_gauges: dict = {}
        # baseline lanes register their gauges eagerly so a scrape (and
        # the fleet view) sees every watched lane at 0 before traffic —
        # and a lane whose baseline qps would overrun the sample ring
        # inside the longest window is called out NOW: it would sit
        # permanently span_truncated → unknown, silently un-alertable
        # (the failure mode this sentinel exists to catch)
        for kind, lane in (self.baseline.get("lanes") or {}).items():
            self._gauges_for(kind)
            qps = lane.get("qps") if isinstance(lane, dict) else None
            if qps and qps * self.windows[-1] > self.max_samples:
                import logging

                logging.getLogger("hypergraphdb_tpu_torch.obs").warning(
                    "perf sentinel lane %r: baseline qps %.0f over the "
                    "%.0fs window needs ~%d samples but max_samples=%d — "
                    "windows will report span_truncated/unknown at that "
                    "rate; raise max_samples or shrink the windows",
                    kind, qps, self.windows[-1],
                    int(qps * self.windows[-1]), self.max_samples,
                )

    # -- feeding (dispatch-thread hot path) ----------------------------------
    def observe(self, kind: str, latency_s: float, path: str = "device",
                t: Optional[float] = None) -> None:
        """One completed request on lane ``kind``: end-to-end latency +
        which executor path answered (host fallbacks feed the SAME
        digest — a lane degrading INTO its host path is exactly the
        drift this sentinel exists to catch; the window's
        ``host_fraction`` is the attribution)."""
        t = self.clock() if t is None else float(t)
        with self._lock:
            lane = self._lanes.get(kind)
            if lane is None:
                lane = self._lanes[kind] = _Lane(self.max_samples)
            lane.samples.append((t, float(latency_s), path == "host"))

    def observe_batch(self, kind: str, device_s: float, n_real: int = 0,
                      n_total: int = 0, t: Optional[float] = None) -> None:
        """One ``block_timed``-measured device batch: launch→ready wall
        seconds, real lane count, and the TOTAL bucket width including
        padding (``occupancy = Σ n_real / Σ n_total`` and
        ``device_s_per_req`` in the windows)."""
        t = self.clock() if t is None else float(t)
        with self._lock:
            lane = self._lanes.get(kind)
            if lane is None:
                lane = self._lanes[kind] = _Lane(self.max_samples)
            lane.batches.append((t, float(device_s), int(n_real),
                                 int(n_total)))

    def maybe_tick(self) -> Optional[dict]:
        """Rate-limited :meth:`tick` for the runtime's completion path:
        evaluates at most once per ``eval_interval_s``. Returns the
        snapshot when an evaluation ran, else None."""
        now = self.clock()
        with self._lock:
            due = (self._last_eval is None
                   or now - self._last_eval >= self.eval_interval_s)
            if due:
                self._last_eval = now
        return self.tick() if due else None

    # -- evaluation ----------------------------------------------------------
    def tick(self) -> dict:
        """Evaluate every lane + the mesh skew, fire incidents and
        open/close profile sessions on alert edges. Returns the
        snapshot."""
        return self._evaluate(mutate=True)

    def snapshot(self) -> dict:
        """A pure READ of the current evaluation state: no samples, no
        alert-edge transitions, no incidents, no profile churn (scrapes
        must not fire or re-arm alerts; only :meth:`tick` does)."""
        return self._evaluate(mutate=False)

    def _evaluate(self, mutate: bool) -> dict:
        now = self.clock()
        skew = self._eval_skew(now, mutate)
        base_lanes = self.baseline.get("lanes") or {}
        # phase 1 — snapshot the rings under the lock (O(n) copies, no
        # sorting): the dispatch-thread hot path (observe) must never
        # wait behind a digest computation
        with self._lock:
            if mutate:
                self._last_eval = now
            lane_snaps: dict = {}
            for kind in set(self._lanes) | set(base_lanes):
                lane = self._lanes.get(kind)
                if lane is None:
                    lane = self._lanes[kind] = _Lane(self.max_samples)
                lane_snaps[kind] = (
                    lane, list(lane.samples), list(lane.batches),
                    len(lane.samples) == (lane.samples.maxlen or 0),
                )
        # phase 2 — window digests (and ALL sorting, including the lane
        # ordering itself) OUTSIDE the lock
        verdicts: list = []
        out_lanes: dict = {}
        for kind in sorted(lane_snaps):
            lane, samples, batches, ring_full = lane_snaps[kind]
            base = base_lanes.get(kind)
            limits = None
            if base is not None:
                limits = {
                    m: base[m] * self.factors.get(m, 3.0)
                    for m in GATED_METRICS if base.get(m)
                }
            wins = []
            all_bad = bool(limits)
            all_clear = bool(limits)
            for span in self.windows:
                w = _window(samples, batches, ring_full, now, span,
                            limits=limits, min_samples=self.min_samples,
                            min_breaches=self.min_breaches)
                all_bad = all_bad and w["status"] == "degraded"
                all_clear = all_clear and w["status"] == "clear"
                wins.append(dict(w, span_s=span,
                                 degraded=w["status"] == "degraded"))
            verdicts.append((kind, lane, base, all_bad, all_clear))
            out_lanes[kind] = {
                "baseline": base,
                "watched": base is not None,
                "windows": wins,
            }
        # phase 3 — alert-state transitions back under the lock
        fire: list = []
        with self._lock:
            for kind, lane, base, all_bad, all_clear in verdicts:
                if mutate and base is not None:
                    if all_bad and not lane.alerting:
                        lane.alerting = True
                        lane.alerts += 1
                        short = out_lanes[kind]["windows"][0]
                        metric = (short["exceeded"] or GATED_METRICS)[0]
                        fire.append((kind, lane, {
                            "lane": kind,
                            "metric": metric,
                            "observed": short.get(metric),
                            "baseline": base.get(metric),
                            "factor": self.factors.get(metric, 3.0),
                            "host_fraction": short.get("host_fraction"),
                        }))
                    elif lane.alerting and all_clear:
                        # hysteresis: re-arm only once EVERY window is
                        # affirmatively CLEAR — a long window still
                        # digesting the degraded period keeps the lane
                        # armed-off (a flapping short window stays ONE
                        # incident), and so does an idle/sparse window
                        # (no evidence ≠ recovered: a stall right after
                        # the alert must not reset the edge)
                        lane.alerting = False
                out_lanes[kind].update(
                    violating=lane.alerting,
                    alerts_total=lane.alerts,
                    last_incident=lane.last_incident,
                    last_profile=lane.last_profile,
                )
            alerts_total = (sum(ln.alerts for ln in self._lanes.values())
                            + self._skew_alerts)
        # instrument writes + incident/profile IO OUTSIDE the lock (the
        # SLO monitor's discipline: the recorder writes files)
        for kind, rec in out_lanes.items():
            g = self._gauges_for(kind)
            g["violating"].set(1 if rec["violating"] else 0)
            short = rec["windows"][0]
            if short.get("p99_s") is not None:
                g["p99_s"].set(short["p99_s"])
            if short.get("qps") is not None:
                g["qps"].set(short["qps"])
        for kind, lane, fields in fire:
            # a rate-limited/unconfigured dump returns None — keep the
            # pointer to the previous REAL evidence rather than nulling
            # the only path an operator has
            path = self.flight.incident("perf_drift_" + kind, **fields)
            self._alerts.inc()
            logdir = self._open_profile(kind, now)
            with self._lock:
                lane.last_incident = path or lane.last_incident
                lane.last_profile = logdir or lane.last_profile
                out_lanes[kind]["last_incident"] = lane.last_incident
                out_lanes[kind]["last_profile"] = lane.last_profile
        # reap an EXPIRED profile session on snapshots too: closing a
        # session past its deadline enforces the already-decided bound,
        # it is not an alert-state mutation — and completions may have
        # stopped exactly because of the incident that opened it, so the
        # scrape path may be the only caller left ticking
        self._close_expired_profile(now)
        return {
            "lanes": out_lanes,
            "skew": skew,
            "alerts_total": alerts_total,
            "profile_open": self._profile is not None,
        }

    def _eval_skew(self, now: float, mutate: bool) -> Optional[dict]:
        if self.mesh_source is None:
            return self._skew
        try:
            report = self.mesh_source()
            skew = shard_skew(report or {})
        except Exception:  # noqa: BLE001 - a broken source ≠ dead sentinel
            return self._skew
        worst_key, worst = None, None
        for key in self.skew_gate_keys:
            d = skew.get(key)
            if d is not None and (worst is None or d["ratio"] > worst):
                worst_key, worst = key, d["ratio"]
        violating = worst is not None and worst > self.skew_ratio_max
        fire_fields = None
        with self._lock:
            if mutate:
                if violating and not self._skew_alerting:
                    self._skew_alerting = True
                    self._skew_alerts += 1
                    d = skew[worst_key]
                    fire_fields = {
                        "key": worst_key, "ratio": d["ratio"],
                        "straggler": d["straggler"],
                        "ratio_max": self.skew_ratio_max,
                    }
                elif self._skew_alerting and not violating:
                    self._skew_alerting = False
            self._skew = dict(skew, violating=self._skew_alerting,
                              alerts_total=self._skew_alerts)
            snap = self._skew
        for key, d in skew.items():
            g = self._lane_gauges.get(("skew", key))
            if g is None:
                g = self._lane_gauges[("skew", key)] = self.registry.gauge(
                    f"perf.skew.{key}"
                )
            g.set(d["ratio"])
        if fire_fields is not None:
            self.flight.incident("perf_skew_" + fire_fields["key"],
                                 **fire_fields)
            self._alerts.inc()
        return snap

    def _gauges_for(self, kind: str) -> dict:
        g = self._lane_gauges.get(kind)
        if g is None:
            g = self._lane_gauges[kind] = {
                "violating": self.registry.gauge(
                    f"perf.lane.{kind}.violating"),
                "p99_s": self.registry.gauge(f"perf.lane.{kind}.p99_s"),
                "qps": self.registry.gauge(f"perf.lane.{kind}.qps"),
            }
        return g

    # -- incident profiles ---------------------------------------------------
    def _profile_cm(self, logdir: str):
        """The incident's profiler session: the injected one, else
        ``obs.device.thread_profile`` (``torch.profiler`` on a thread of
        its own — the session opens on the ticking thread and may close
        on another, which a ``torch.profiler`` session cannot)."""
        if self._profiler is not None:
            return self._profiler(logdir)
        from hypergraphdb_tpu_torch.obs.device import thread_profile

        return thread_profile(logdir)

    def _open_profile(self, kind: str, now: float) -> Optional[str]:
        """Auto-capture: open ONE bounded profiler session per incident
        window, writing beside the flight dumps
        (``<incident_dir>/profile_<n>_<lane>/``). A session already
        open (another lane fired inside the bound) is left to finish —
        the profile covers the degraded period either way. Returns the
        session dir, or None (no incident_dir / open failed)."""
        root = self.flight.incident_dir
        if root is None:
            return None
        with self._lock:
            if self._profile is not None:
                return None
            # check-and-RESERVE in one lock hold: two alert edges racing
            # here must not both open a profiler session (the loser's cm
            # would never be exited — a leaked session for the rest of
            # the process)
            self._profile = _PENDING_PROFILE
            n = sum(ln.alerts for ln in self._lanes.values())
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in kind)[:32]
        logdir = os.path.join(root, f"profile_{n:04d}_{safe}")
        try:
            os.makedirs(logdir, exist_ok=True)
            cm = self._profile_cm(logdir)
            active = bool(cm.__enter__())
        except Exception:  # noqa: BLE001 - a dead profiler ≠ lost incident
            with self._lock:
                if self._profile is _PENDING_PROFILE:
                    self._profile = None
            return None
        session = _ProfileSession(cm, logdir, kind, now + self.profile_s,
                                  active)
        self._write_manifest(session, t0=now)
        with self._lock:
            self._profile = session
        return logdir

    def _close_expired_profile(self, now: float) -> None:
        with self._lock:
            session = self._profile
            if session is None or now < session.until:
                return
            self._profile = None
        self._finish_profile(session, now)

    def close(self) -> None:
        """Close any open profile session (shutdown path)."""
        with self._lock:
            session, self._profile = self._profile, None
        if session is not None and session is not _PENDING_PROFILE:
            self._finish_profile(session, self.clock())

    def _finish_profile(self, session: _ProfileSession, now: float) -> None:
        try:
            session.cm.__exit__(None, None, None)
        except Exception:  # noqa: BLE001  # hglint: disable=HG1005
            pass  # teardown: a torn session ≠ crash; the manifest below
            # still records what the profile DID capture
        self._write_manifest(session, t1=now)

    def _write_manifest(self, session: _ProfileSession,
                        t0: Optional[float] = None,
                        t1: Optional[float] = None) -> None:
        """``PROFILE.json`` beside the profiler's own trace files: which
        lane fired, the capture bounds, and whether a real profiler
        session actually opened (False on backends without one — the
        manifest still marks the window)."""
        path = os.path.join(session.logdir, "PROFILE.json")
        rec = {"lane": session.lane, "profiler_active": session.active,
               "bound_s": self.profile_s}
        try:
            if t0 is None and os.path.exists(path):
                with open(path) as f:
                    rec.update(json.load(f))
        except (OSError, ValueError):
            pass
        if t0 is not None:
            rec["t0"] = t0
        if t1 is not None:
            rec["t1"] = t1
        # stamped AFTER the merge so a pre-versioning manifest on disk
        # cannot strip the stamp from the rewrite
        rec["schema_version"] = MANIFEST_SCHEMA_VERSION
        try:
            with open(path, "w") as f:
                json.dump(rec, f, indent=2, sort_keys=True)
                f.write("\n")
        except OSError:
            pass

    # -- fleet surface -------------------------------------------------------
    def health_summary(self) -> dict:
        """The compact per-node verdict ``/healthz`` embeds (and
        ``FleetCollector.fleet_perf`` merges): which lanes are in
        violation, the watched set, total alerts, and the skew ratios.
        A pure read — never drives evaluation."""
        # snapshot under the lock, sort/shape outside: /healthz must not
        # queue the dispatch thread's observe() behind a digest
        with self._lock:
            alerting = [k for k, ln in self._lanes.items() if ln.alerting]
            skew_alerting = self._skew_alerting
            watched = list(self.baseline.get("lanes") or ())
            alerts_total = (sum(ln.alerts for ln in self._lanes.values())
                            + self._skew_alerts)
            skew = dict(self._skew) if self._skew else None
            profile_open = self._profile is not None
        violating = sorted(alerting)
        if skew_alerting:
            violating.append("skew")
        return {
            "violating": violating,
            "watched": sorted(watched),
            "alerts_total": alerts_total,
            "skew": ({k: d["ratio"] for k, d in skew.items()
                      if isinstance(d, dict)}
                     if skew else None),
            "profile_open": profile_open,
        }
