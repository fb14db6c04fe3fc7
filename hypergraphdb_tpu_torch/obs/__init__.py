"""hgobs — the observability subsystem of the port (the surface of
``hypergraphdb_tpu/obs``):

- **tracing** (:mod:`~hypergraphdb_tpu_torch.obs.trace`): bounded span
  trees with explicit parenting and injectable clocks. A served request
  emits ``submit → queue_wait → batch_form → launch → device → collect →
  resolve`` (or ``shed`` / ``host_fallback``); a query emits
  ``compile → plan → execute``;
- **metrics** (:mod:`~hypergraphdb_tpu_torch.obs.registry`): one registry
  of counters/gauges/log-bucketed histograms under dotted namespaces
  (``serve.*``, ``plan.*``, ``query.*``, ``perf.*``);
- **device timing** (:mod:`~hypergraphdb_tpu_torch.obs.device`): opt-in
  launch→ready wall deltas, per-dispatch ``torch.profiler`` ranges, and a
  gated ``torch.profiler`` session;
- **export** (:mod:`~hypergraphdb_tpu_torch.obs.export`): Prometheus text
  and schema-versioned JSONL traces;
- **flight recorder** (:mod:`~hypergraphdb_tpu_torch.obs.flight`): an
  always-on bounded ring of recent structured events that dumps its
  window to JSONL on incident;
- **HTTP endpoint** (:mod:`~hypergraphdb_tpu_torch.obs.http`):
  ``/metrics``, ``/healthz``, ``/debug/traces``, ``/debug/flight``;
- **fleet plane** (:mod:`~hypergraphdb_tpu_torch.obs.fleet`): one
  collector over every node's telemetry — per-node-labelled metric
  merges, span-tree assembly on the 128-bit trace ids, incident-window
  retention, and per-request EXPLAIN records;
- **SLOs** (:mod:`~hypergraphdb_tpu_torch.obs.slo`): declarative
  objectives over sliding windows with multi-window burn-rate alerts
  that fire as flight-recorder incidents;
- **perf sentinel** (:mod:`~hypergraphdb_tpu_torch.obs.perf`): per-lane
  rolling digests against a seeded baseline, multi-window drift
  detection with auto-captured incident profiles.

Tracing is off by default: every instrumentation site then costs one
attribute read and allocates nothing. ``obs.enable()`` turns it on for
the process; ``tracer().set_sample_rate`` keeps the buffer bounded.

Usage::

    from hypergraphdb_tpu_torch import obs

    obs.enable()
    obs.tracer().set_sample_rate("serve.request", 0.01)
    ... serve / query ...
    print(obs.export.prometheus_text(rt.stats.registry))
"""

from hypergraphdb_tpu_torch.obs import (
    device,
    export,
    fleet,
    flight,
    http,
    perf,
    slo,
    trace,
)
from hypergraphdb_tpu_torch.obs.device import annotate, block_timed, profile
from hypergraphdb_tpu_torch.obs.export import (
    TRACE_SCHEMA_VERSION,
    merge_expositions,
    parse_traces_jsonl,
    prometheus_text,
    relabel_exposition,
    sample_value,
    trace_to_dict,
    traces_to_jsonl,
    write_telemetry,
)
from hypergraphdb_tpu_torch.obs.fleet import (
    FleetCollector,
    HTTPNodeSource,
    LocalNodeSource,
    explain_record,
)
from hypergraphdb_tpu_torch.obs.flight import (
    FlightRecorder,
    global_flight,
    install_sigterm_dump,
    parse_flight_jsonl,
)
from hypergraphdb_tpu_torch.obs.http import (
    TelemetryServer,
    breaker_key_label,
    composite_health,
    runtime_health,
)
from hypergraphdb_tpu_torch.obs.perf import (
    PerfSentinel,
    load_baseline,
    seed_baseline,
    shard_skew,
)
from hypergraphdb_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    default_registry,
)
from hypergraphdb_tpu_torch.obs.slo import (
    Objective,
    SLOMonitor,
    fleet_objectives,
)
from hypergraphdb_tpu_torch.obs.trace import (
    Clock,
    Span,
    Trace,
    Tracer,
    global_tracer,
)


def tracer() -> Tracer:
    """The process-wide tracer (disabled until :func:`enable`)."""
    return global_tracer()


def enable(clock=None) -> Tracer:
    """Turn process-wide tracing on (optionally with a fake clock)."""
    return global_tracer().enable(clock)


def disable() -> Tracer:
    """Turn process-wide tracing off (already-open traces still finish)."""
    return global_tracer().disable()


__all__ = [
    "Clock",
    "Counter",
    "FleetCollector",
    "FlightRecorder",
    "Gauge",
    "HTTPNodeSource",
    "Histogram",
    "LocalNodeSource",
    "Objective",
    "PerfSentinel",
    "Registry",
    "SLOMonitor",
    "Span",
    "TRACE_SCHEMA_VERSION",
    "TelemetryServer",
    "Trace",
    "Tracer",
    "annotate",
    "block_timed",
    "breaker_key_label",
    "composite_health",
    "default_registry",
    "device",
    "disable",
    "enable",
    "explain_record",
    "export",
    "fleet",
    "fleet_objectives",
    "flight",
    "global_flight",
    "global_tracer",
    "http",
    "install_sigterm_dump",
    "load_baseline",
    "merge_expositions",
    "parse_flight_jsonl",
    "parse_traces_jsonl",
    "perf",
    "profile",
    "prometheus_text",
    "relabel_exposition",
    "runtime_health",
    "sample_value",
    "seed_baseline",
    "shard_skew",
    "slo",
    "trace",
    "trace_to_dict",
    "tracer",
    "traces_to_jsonl",
    "write_telemetry",
]
