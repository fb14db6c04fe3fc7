"""Serving metrics: a façade over one hgobs registry.

Pre-hgobs this module owned its own counters and a private latency ring —
a second metrics surface disjoint from ``utils.metrics``. Every
instrument now lives in an :class:`hypergraphdb_tpu_torch.obs.Registry` under
the ``serve.*`` dotted namespace (:data:`DOTTED_NAMES`); the latency ring
became the shared histogram's bounded exact-percentile window. The public
API is UNCHANGED — counter attributes (``stats.submitted``), the
``record_*`` methods, and the legacy flat ``snapshot()`` keys all keep
working; the legacy-key ↔ dotted-name mapping is committed as
:data:`LEGACY_TO_DOTTED` (the compat shim) and ``snapshot_namespaced()``
returns the dotted view. The port's copy of
``hypergraphdb_tpu/serve/stats.py``.

No device code — safe to call from the submit path, the dispatch thread, and
test assertions concurrently.
"""

from __future__ import annotations

import threading
from typing import Optional

from hypergraphdb_tpu_torch.obs.registry import Registry


#: legacy ``snapshot()`` key -> dotted registry name (the compat shim;
#: derived keys map to the instruments they are computed from)
LEGACY_TO_DOTTED = {
    "submitted": "serve.submitted",
    "completed": "serve.completed",
    "shed_deadline": "serve.shed_deadline",
    "rejected_queue_full": "serve.rejected_queue_full",
    "gated": "serve.gated",
    "cancelled": "serve.cancelled",
    "errors": "serve.errors",
    "host_fallbacks": "serve.host_fallbacks",
    "batches": "serve.batches",
    "device_dispatches": "serve.device_dispatches",
    "sharded_dispatches": "serve.sharded_dispatches",
    "range_dispatches": "serve.range_dispatches",
    "retries": "serve.retries",
    "breaker_trips": "serve.breaker_trips",
    "breaker_state": "serve.breaker_state",
    "batch_occupancy": "serve.lanes_real",     # ÷ serve.lanes_padded
    "latency_ms": "serve.latency_seconds",
    "queue_depth": "serve.queue_depth",
}

#: every request KIND the runtime serves (the reference's vocabulary)
LANE_KINDS = ("bfs", "pattern", "join", "range")

#: every executor PATH a request can resolve through: the single-chip
#: device lane, the mesh-sharded device lane, the exact host lane
LANE_PATHS = ("device", "sharded", "host")

#: the per-lane served-request counter family, registered EAGERLY (the
#: full kind × path cross product, so a scrape — and the drift gate —
#: sees every lane's counter even before its first request; lanes a
#: deployment never routes legitimately sit at 0). Attribution is by
#: the ANSWERING executor: a device-served result under the sharded
#: executor counts ``sharded`` whatever kernel shape it rode.
LANE_NAMES = tuple(
    f"serve.lane.{kind}.{path}" for kind in LANE_KINDS
    for path in LANE_PATHS
)

#: every FIXED ``serve.*`` name this façade registers (drift-tested: the
#: registry holds exactly these — no orphans, no duplicates). Per-key
#: breaker instruments are the one DYNAMIC family on top:
#: ``serve.breaker.state.<key>`` / ``serve.breaker.trips.<key>``
#: (:data:`BREAKER_KEY_PREFIX`), created on a key's first transition.
#: BOTH names are load-bearing for static checking: hglint HG1105
#: evaluates ``DOTTED_NAMES`` (and any ``*_PREFIX`` constant) by AST and
#: flags literal metric sites outside the registry — renaming either
#: constant silently drops that coverage.
#: every plan SHAPE the hgplan planner can choose (``plan/planner.py``'s
#: candidate vocabulary: the four lanes' strategies plus the exact host
#: scan). Spelled here — not imported — because the dependency edge
#: runs plan → serve; the planner differential suite holds the two
#: vocabularies against each other instead.
PLAN_SHAPES = ("range_first", "pattern", "join", "bfs", "host")

#: every FIXED ``plan.*`` name (the hgplan planner's telemetry, recorded
#: through this façade so planned traffic shares the serving registry,
#: the drift gate, and the HG1105 vocabulary). Eager like the lane
#: family: per-shape choice counters cover all of :data:`PLAN_SHAPES`
#: from construction. NOTE: appended into :data:`DOTTED_NAMES` as one
#: expression — the HG1105 AST evaluator resolves a registry from its
#: single binding; re-assignment would make it self-referential and
#: silently drop governance of BOTH namespaces.
PLAN_NAMES = tuple(f"plan.choice.{shape}" for shape in PLAN_SHAPES) + (
    "plan.requests",
    "plan.est_rows",
    "plan.actual_rows",
    "plan.cost_seconds",
    "plan.abs_rel_error",
    "plan.feedback_updates",
    "plan.feedback_clamped",
    "plan.guard_vetoes",
)

DOTTED_NAMES = LANE_NAMES + PLAN_NAMES + (
    "serve.join.hub_dispatches",
    "serve.join.partial_corrections",
    "serve.submitted",
    "serve.completed",
    "serve.shed_deadline",
    "serve.rejected_queue_full",
    "serve.gated",
    "serve.cancelled",
    "serve.errors",
    "serve.host_fallbacks",
    "serve.perf_observe_errors",
    "serve.explain_errors",
    "serve.batches",
    "serve.device_dispatches",
    "serve.sharded_dispatches",
    "serve.range_dispatches",
    "serve.device_seconds",
    "serve.retries",
    "serve.breaker_trips",
    "serve.breaker_state",
    "serve.lanes_real",
    "serve.lanes_padded",
    "serve.latency_seconds",
    "serve.queue_depth",
)

#: name prefix of the per-batch-key breaker family (the labelled view
#: the one-gauge worst-state ``serve.breaker_state`` was too coarse
#: for — ``/healthz`` shows WHICH bucket is degraded, these let a
#: Prometheus scrape do the same)
BREAKER_KEY_PREFIX = "serve.breaker."


class ServeStats:
    """Thread-safe metrics surface for one :class:`~.runtime.ServeRuntime`.

    Counters: ``submitted``, ``completed``, ``shed_deadline`` (expired in
    queue), ``rejected_queue_full`` (fail-fast backpressure),
    ``cancelled`` (runtime closed without drain), ``host_fallbacks``
    (requests served exactly on host instead of the batched device path),
    ``batches`` (formed micro-batches), ``device_dispatches`` (real kernel
    launches). Occupancy is the fraction of real (non-padding) lanes per
    dispatched bucket."""

    def __init__(self, latency_window: int = 4096,
                 registry: Optional[Registry] = None):
        self.registry = registry if registry is not None else Registry()
        # coherence lock: each instrument locks itself, but the accounting
        # identity (submitted == completed + shed + cancelled + in-flight)
        # spans SEVERAL counters — record_* and snapshot() serialize on
        # this so a snapshot can never observe a torn multi-counter update
        self._lock = threading.Lock()
        r = self.registry
        self._submitted = r.counter("serve.submitted")
        self._completed = r.counter("serve.completed")
        self._shed = r.counter("serve.shed_deadline")
        self._rejected = r.counter("serve.rejected_queue_full")
        self._gated = r.counter("serve.gated")
        self._cancelled = r.counter("serve.cancelled")
        self._errors = r.counter("serve.errors")
        self._host_fallbacks = r.counter("serve.host_fallbacks")
        self._batches = r.counter("serve.batches")
        self._device_dispatches = r.counter("serve.device_dispatches")
        self._sharded_dispatches = r.counter("serve.sharded_dispatches")
        self._range_dispatches = r.counter("serve.range_dispatches")
        self._retries = r.counter("serve.retries")
        self._perf_errors = r.counter("serve.perf_observe_errors")
        self._explain_errors = r.counter("serve.explain_errors")
        self._join_hub = r.counter("serve.join.hub_dispatches")
        self._join_partial = r.counter("serve.join.partial_corrections")
        self._breaker_trips = r.counter("serve.breaker_trips")
        self._breaker_state = r.gauge("serve.breaker_state")
        self._lanes_real = r.counter("serve.lanes_real")
        self._lanes_padded = r.counter("serve.lanes_padded")
        self._latency = r.histogram("serve.latency_seconds",
                                    window=latency_window)
        self._device_seconds = r.histogram("serve.device_seconds")
        self._queue_depth = r.gauge("serve.queue_depth")
        # the per-lane served-request family, EAGER over the full
        # kind × path cross product (the drift gate's contract): which
        # lane answered each completed request, the EXPLAIN aggregate
        self._lanes = {
            (kind, path): r.counter(f"serve.lane.{kind}.{path}")
            for kind in LANE_KINDS for path in LANE_PATHS
        }
        # the hgplan planner's telemetry, eager over PLAN_SHAPES (same
        # drift-gate contract as the lane family)
        self._plan_choices = {
            shape: r.counter(f"plan.choice.{shape}") for shape in PLAN_SHAPES
        }
        self._plan_requests = r.counter("plan.requests")
        self._plan_est_rows = r.histogram("plan.est_rows")
        self._plan_actual_rows = r.histogram("plan.actual_rows")
        self._plan_cost = r.histogram("plan.cost_seconds")
        self._plan_abs_rel_error = r.histogram("plan.abs_rel_error")
        self._plan_fb_updates = r.counter("plan.feedback_updates")
        self._plan_fb_clamped = r.counter("plan.feedback_clamped")
        self._plan_guard_vetoes = r.counter("plan.guard_vetoes")
        # per-batch-key breaker family, lazily registered on a key's
        # first transition (label -> instrument; _key_instruments makes
        # reset() cover them too)
        self._key_states: dict = {}
        self._key_trips: dict = {}
        self._own = tuple(self._lanes.values()) + tuple(
            self._plan_choices.values()) + (
            self._plan_requests, self._plan_est_rows, self._plan_actual_rows,
            self._plan_cost, self._plan_abs_rel_error, self._plan_fb_updates,
            self._plan_fb_clamped, self._plan_guard_vetoes,
        ) + (
            self._submitted, self._completed, self._shed, self._rejected,
            self._gated, self._cancelled, self._errors, self._host_fallbacks,
            self._batches, self._device_dispatches,
            self._sharded_dispatches, self._range_dispatches,
            self._device_seconds,
            self._join_hub, self._join_partial,
            self._retries, self._perf_errors, self._explain_errors,
            self._breaker_trips, self._breaker_state,
            self._lanes_real, self._lanes_padded, self._latency,
            self._queue_depth,
        )

    def reset(self) -> None:
        """Zero every counter and the latency/occupancy windows — the
        bench's post-warmup cut so compile-time latencies never pollute
        steady-state percentiles. Resets only THIS façade's instruments
        (including the per-key breaker family): on a shared registry,
        foreign subsystems' counters (graph/tx/compact) must survive a
        serving-stats cut."""
        with self._lock:
            for m in self._own:
                m.reset()
            for m in list(self._key_states.values()):
                m.reset()
            for m in list(self._key_trips.values()):
                m.reset()

    # -- recording (serialized on the coherence lock) ------------------------
    def record_submit(self) -> None:
        with self._lock:
            self._submitted.inc()

    def record_shed(self) -> None:
        with self._lock:
            self._shed.inc()

    def record_reject(self) -> None:
        with self._lock:
            self._rejected.inc()

    def record_gated(self) -> None:
        """An admission-gate refusal (e.g. a replica past its lag
        bound): the request was never admitted, so it is outside the
        submitted/completed identity — counted on its own."""
        with self._lock:
            self._gated.inc()

    def record_cancel(self) -> None:
        with self._lock:
            self._cancelled.inc()

    def record_host_fallback(self) -> None:
        with self._lock:
            self._host_fallbacks.inc()

    def record_error(self) -> None:
        """A request failed with a typed non-deadline error (executor
        fault surfaced to the caller) — the accounting identity's fifth
        terminal: submitted == completed + shed + cancelled + errors +
        in-flight."""
        with self._lock:
            self._errors.inc()

    def record_retry(self) -> None:
        """One transient-failure re-attempt (device launch retry or a
        collect-failure host re-serve)."""
        with self._lock:
            self._retries.inc()

    def record_perf_error(self) -> None:
        """The hgperf sentinel's ``observe``/``observe_batch`` raised on
        the completion path. The dispatch loop swallows it (a perf
        evaluation bug must not fail the request) — this counter is the
        evidence that observations are being dropped."""
        with self._lock:
            self._perf_errors.inc()

    def record_explain_error(self) -> None:
        """An ``explain=True`` request's EXPLAIN record failed to assemble
        (the port's addition: the reference sets ``future.explain`` to
        None and counts nothing). The request itself still resolved."""
        with self._lock:
            self._explain_errors.inc()

    def record_join_hub_dispatch(self, n_lanes: int = 1) -> None:
        """``n_lanes`` real join lanes dispatched through the
        degree-split dense-frontier hub chain (join engine v2), which
        would otherwise take the exact host path."""
        with self._lock:
            self._join_hub.inc(n_lanes)

    def record_join_partial_correction(self) -> None:
        """One join request answered device-side under a SMALL dirty
        memtable with the per-lane correction merged in (ROADMAP 2d) —
        a request the previous whole-batch rule would have re-routed to
        host."""
        with self._lock:
            self._join_partial.inc()

    # -- hgplan telemetry ----------------------------------------------------
    def record_plan_request(self, shape: str, est_rows: float,
                            cost_s: float) -> None:
        """One planner verdict: which shape won, what it estimated, what
        the costing priced it at. Unknown shapes (a planner this façade
        predates) drop like unknown lanes — never raise on a serve
        thread."""
        with self._lock:
            self._plan_requests.inc()
            c = self._plan_choices.get(shape)
            if c is not None:
                c.inc()
            self._plan_est_rows.observe(float(est_rows))
            self._plan_cost.observe(float(cost_s))

    def record_plan_actual(self, est_rows: float, actual_rows: float) -> None:
        """The execution side of one planned request: the actual row
        count and the |est − actual| / max(actual, 1) relative error the
        feedback digest learns from."""
        with self._lock:
            self._plan_actual_rows.observe(float(actual_rows))
            err = abs(float(est_rows) - float(actual_rows))
            self._plan_abs_rel_error.observe(err / max(float(actual_rows),
                                                       1.0))

    def record_plan_feedback_update(self, clamped: bool = False) -> None:
        """One ratio admitted into the drift digest (``clamped`` when
        the stored ratio hit the digest's clamp bounds)."""
        with self._lock:
            self._plan_fb_updates.inc()
            if clamped:
                self._plan_fb_clamped.inc()

    def record_plan_guard_veto(self) -> None:
        """The sentinel guard kept the uncorrected plan because the
        learned correction would have steered onto a lane currently
        breaching its perf baseline."""
        with self._lock:
            self._plan_guard_vetoes.inc()

    def plan_choice_counts(self) -> dict:
        """{shape: chosen count} over the planner's vocabulary."""
        return {shape: c.value for shape, c in self._plan_choices.items()}

    def record_breaker_trip(self) -> None:
        with self._lock:
            self._breaker_trips.inc()

    def set_breaker_state(self, code: int) -> None:
        """Pushed by the circuit breaker on every state change (worst
        state across batch keys: 0 closed, 1 half-open, 2 open) — a
        single instrument write, deliberately outside the coherence lock
        (the breaker calls this from its own callback path)."""
        self._breaker_state.set(code)

    @staticmethod
    def _key_label(key) -> str:
        """Stable metric label for a batch key: ``("bfs", 2)`` → ``bfs_2``,
        by ``obs.http.breaker_key_label``, which ``/healthz`` uses too, so
        the two views join by name. Imported here, not at the top: the
        HTTP module is needed only once a breaker reports."""
        from hypergraphdb_tpu_torch.obs.http import breaker_key_label

        return breaker_key_label(key)

    def set_breaker_key_state(self, key, code: int) -> None:
        """Per-batch-key breaker gauge (``serve.breaker.state.<key>``),
        pushed on every transition of THAT key — the labelled view the
        worst-state gauge summarizes. Same callback discipline as
        :meth:`set_breaker_state`: a leaf instrument write, no coherence
        lock (dict get/set is GIL-atomic; a racing first transition just
        resolves the same instrument twice)."""
        label = self._key_label(key)
        g = self._key_states.get(label)
        if g is None:
            g = self._key_states[label] = self.registry.gauge(
                BREAKER_KEY_PREFIX + "state." + label
            )
        g.set(code)

    def record_breaker_key_trip(self, key) -> None:
        """Per-batch-key trip counter (``serve.breaker.trips.<key>``)."""
        label = self._key_label(key)
        c = self._key_trips.get(label)
        if c is None:
            c = self._key_trips[label] = self.registry.counter(
                BREAKER_KEY_PREFIX + "trips." + label
            )
        c.inc()

    def breaker_key_states(self) -> dict:
        """{label: current gauge code} for every key that ever
        transitioned — the scrape-side mirror of ``breaker.states()``."""
        return {label: g.value for label, g in self._key_states.items()}

    def record_batch(self, n_real: int, bucket: int) -> None:
        """One successfully launched micro-batch; occupancy measures the
        ADMISSION layer's coalescing (real requests / padded lanes)."""
        with self._lock:
            self._batches.inc()
            self._lanes_real.inc(n_real)
            self._lanes_padded.inc(bucket)

    def record_device_dispatch(self) -> None:
        """One real device kernel launch (a batch whose every lane fell
        back to host, or whose launch raised, dispatches none)."""
        with self._lock:
            self._device_dispatches.inc()

    def record_sharded_dispatch(self) -> None:
        """One kernel dispatch routed through the mesh-sharded executor
        (a subset of ``device_dispatches``-adjacent work: counted at the
        kernel-call site, so an all-host batch counts neither)."""
        with self._lock:
            self._sharded_dispatches.inc()

    def record_range_dispatch(self) -> None:
        """One kernel dispatch of the hgindex range lane (a subset of
        ``device_dispatches``-adjacent work, counted at the kernel-call
        site like ``sharded_dispatches`` — an all-host range batch
        counts neither)."""
        with self._lock:
            self._range_dispatches.inc()

    def record_lane(self, kind: str, path: str) -> None:
        """One request RESOLVED through lane ``(kind, path)`` — counted
        at completion (beside ``record_complete``), so the family's sum
        over paths equals ``completed``. Unknown combinations (a future
        lane this façade predates) are dropped rather than raised: a
        metrics façade must never fail a serving thread."""
        c = self._lanes.get((kind, path))
        if c is not None:
            c.inc()

    def lane_counts(self) -> dict:
        """{(kind, path): served count} for every registered lane."""
        return {k: c.value for k, c in self._lanes.items()}

    def record_device_time(self, seconds: float) -> None:
        """One batch's launch→ready device wall delta (only measured
        under ``ServeConfig(device_timing=True)`` — the histogram stays
        empty otherwise)."""
        self._device_seconds.observe(seconds)

    def record_complete(self, latency_s: float) -> None:
        with self._lock:
            self._completed.inc()
            self._latency.observe(latency_s)

    def set_queue_depth(self, depth: int) -> None:
        """Pushed by the admission queue on every depth change, so a
        direct Prometheus scrape of the registry sees a live gauge
        without anyone calling ``snapshot()`` first."""
        self._queue_depth.set(depth)

    # -- counter attributes (pre-hgobs public surface) -----------------------
    @property
    def submitted(self) -> int:
        return self._submitted.value

    @property
    def completed(self) -> int:
        return self._completed.value

    @property
    def shed_deadline(self) -> int:
        return self._shed.value

    @property
    def rejected_queue_full(self) -> int:
        return self._rejected.value

    @property
    def gated(self) -> int:
        return self._gated.value

    @property
    def cancelled(self) -> int:
        return self._cancelled.value

    @property
    def errors(self) -> int:
        return self._errors.value

    @property
    def retries(self) -> int:
        return self._retries.value

    @property
    def breaker_trips(self) -> int:
        return self._breaker_trips.value

    @property
    def join_hub_dispatches(self) -> int:
        return self._join_hub.value

    @property
    def join_partial_corrections(self) -> int:
        return self._join_partial.value

    @property
    def perf_observe_errors(self) -> int:
        return self._perf_errors.value

    @property
    def explain_errors(self) -> int:
        return self._explain_errors.value

    @property
    def plan_requests(self) -> int:
        return self._plan_requests.value

    @property
    def plan_guard_vetoes(self) -> int:
        return self._plan_guard_vetoes.value

    @property
    def plan_feedback_updates(self) -> int:
        return self._plan_fb_updates.value

    @property
    def host_fallbacks(self) -> int:
        return self._host_fallbacks.value

    @property
    def batches(self) -> int:
        return self._batches.value

    @property
    def device_dispatches(self) -> int:
        return self._device_dispatches.value

    @property
    def sharded_dispatches(self) -> int:
        return self._sharded_dispatches.value

    @property
    def range_dispatches(self) -> int:
        return self._range_dispatches.value

    # -- reading -------------------------------------------------------------
    def occupancy(self) -> Optional[float]:
        """Mean real-lane fraction over every dispatched bucket slot."""
        with self._lock:
            padded = self._lanes_padded.value
            if not padded:
                return None
            return self._lanes_real.value / padded

    def latency_percentiles_ms(self) -> dict:
        """{"p50": ..., "p95": ..., "p99": ...} over the latency window
        (milliseconds), or Nones before any completion. One locked read
        of the window — concurrent completions can't tear the triple
        (p50 > p99 impossible)."""
        p50, p95, p99 = self._latency.percentiles((0.50, 0.95, 0.99))
        return {
            "p50": None if p50 is None else p50 * 1e3,
            "p95": None if p95 is None else p95 * 1e3,
            "p99": None if p99 is None else p99 * 1e3,
        }

    def snapshot(self, queue_depth: Optional[int] = None) -> dict:
        """One COHERENT metrics dict under the LEGACY flat keys (the
        bench's reporting unit; see :data:`LEGACY_TO_DOTTED`): taken under
        the coherence lock, so multi-counter identities hold in every
        snapshot even under concurrent recording."""
        with self._lock:
            padded = self._lanes_padded.value
            out = {
                "submitted": self._submitted.value,
                "completed": self._completed.value,
                "shed_deadline": self._shed.value,
                "rejected_queue_full": self._rejected.value,
                "gated": self._gated.value,
                "cancelled": self._cancelled.value,
                "errors": self._errors.value,
                "host_fallbacks": self._host_fallbacks.value,
                "batches": self._batches.value,
                "device_dispatches": self._device_dispatches.value,
                "sharded_dispatches": self._sharded_dispatches.value,
                "range_dispatches": self._range_dispatches.value,
                "retries": self._retries.value,
                "breaker_trips": self._breaker_trips.value,
                "breaker_state": self._breaker_state.value,
                "batch_occupancy": (
                    self._lanes_real.value / padded if padded else None
                ),
            }
        out["latency_ms"] = self.latency_percentiles_ms()
        if queue_depth is not None:
            self._queue_depth.set(queue_depth)
            out["queue_depth"] = queue_depth
        return out

    def snapshot_namespaced(self, queue_depth: Optional[int] = None) -> dict:
        """The same snapshot under the dotted registry names (plus the
        derived ``serve.batch_occupancy``) — what new consumers key on.
        Latency percentiles ride under ``serve.latency_seconds`` in
        SECONDS, matching the histogram that name denotes everywhere else
        (only the legacy ``latency_ms`` key carries milliseconds)."""
        legacy = self.snapshot(queue_depth)
        out = {
            LEGACY_TO_DOTTED[k]: v for k, v in legacy.items()
            if k not in ("batch_occupancy", "latency_ms")
        }
        out["serve.batch_occupancy"] = legacy["batch_occupancy"]
        out["serve.latency_seconds"] = {
            k: (None if v is None else v / 1e3)
            for k, v in legacy["latency_ms"].items()
        }
        return out
