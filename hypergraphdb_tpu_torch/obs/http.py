"""HTTP telemetry endpoint: the scrape surface a replicated tier needs.

The port of ``hypergraphdb_tpu/obs/http.py``. The health payload has no
``mesh`` section until the port serves sharded (ROADMAP queue 1, item 8):
a ``DeviceExecutor`` has no ``mesh_report``.

A tiny stdlib ``http.server`` thread exposing the process's telemetry —
no framework, no dependency, safe to run beside the serving runtime:

- ``GET /metrics``       — every wired registry in Prometheus exposition
  text (``obs.export.prometheus_text``), the scrape endpoint ROADMAP
  item 3's replica tier fronts with;
- ``GET /healthz``       — JSON health: per-batch-key breaker states,
  admission queue depth, delta staleness lag. 200 while healthy, 503
  when any breaker gate is OPEN or the runtime stopped admitting (load
  balancers speak status codes, humans read the body);
- ``GET /debug/traces``  — recent finished traces as JSONL (a PEEK —
  the exporter's ``drain()`` is not consumed);
- ``GET /debug/flight``  — the flight recorder's current window as
  JSONL.

Usage::

    rt = ServeRuntime(graph, cfg)
    srv = TelemetryServer(
        registries=[rt.stats.registry, graph.metrics.registry],
        tracer=cfg.tracer, health=runtime_health(rt),
    ).start()
    ... requests hit http://127.0.0.1:{srv.port}/metrics ...
    srv.stop()

Handlers only READ (registry instruments lock themselves; ``peek`` and
``records`` are snapshots), so a scrape can never stall the dispatch
thread.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Iterable, Optional, Tuple

from hypergraphdb_tpu_torch.obs.export import prometheus_text, traces_to_jsonl
from hypergraphdb_tpu_torch.obs.flight import FlightRecorder, global_flight
from hypergraphdb_tpu_torch.obs.registry import Registry
from hypergraphdb_tpu_torch.obs.trace import Tracer, global_tracer

#: health probe contract: () -> (healthy, payload dict)
HealthProbe = Callable[[], Tuple[bool, dict]]


def runtime_health(rt) -> HealthProbe:
    """The standard ``/healthz`` probe over one ``ServeRuntime``:
    per-batch-key breaker states (the one-gauge worst-state view made
    per-key — the ROADMAP "too coarse" follow-up), queue depth, and the
    pinned snapshot's staleness lag in delta edges. Tolerant of fake
    executors (no incremental manager → lag omitted)."""

    def probe() -> Tuple[bool, dict]:
        states = rt.breaker.states()
        payload = {
            "breakers": {breaker_key_label(k): v for k, v in states.items()},
            "breaker_worst": rt.breaker.worst_code(),
            "queue_depth": rt.queue.depth(),
            "accepting": not rt.queue.closed,
        }
        mgr = getattr(rt.executor, "mgr", None)
        if mgr is not None:
            payload["staleness_lag_edges"] = int(mgr.delta_edges)
        mesh_rep = getattr(rt.executor, "mesh_report", None)
        if callable(mesh_rep):
            # a multi-chip pod advertises its mesh shape, gid-range
            # partition map, and per-shard HBM occupancy — the fields
            # shard-aware FrontDoor placement reads
            try:
                payload["mesh"] = mesh_rep()
            except Exception:  # noqa: BLE001 - health must not 500 on it
                # a silently-missing field is indistinguishable from a
                # single-chip node; name the torn enrichment instead
                payload.setdefault("degraded", []).append("mesh")
        perf = getattr(rt, "perf", None)
        if perf is not None:
            # the hgperf sentinel's verdict (violating lanes, alerts,
            # skew) — what FleetCollector.fleet_perf merges. A pure
            # read: scrapes must not drive evaluation. Perf drift is
            # degraded-not-down: it never flips the health verdict.
            try:
                payload["perf"] = perf.health_summary()
            except Exception:  # noqa: BLE001 - health must not 500 on it
                payload.setdefault("degraded", []).append("perf")
        planner = getattr(rt, "planner", None)
        if planner is not None:
            # the hgplan planner's correction state (active per-shape
            # corrections, guard vetoes) — what FleetCollector.fleet_plan
            # merges. Same discipline as perf: pure read, degraded-not-
            # down, never flips the verdict.
            try:
                payload["plan"] = planner.health_summary()
            except Exception:  # noqa: BLE001 - health must not 500 on it
                payload.setdefault("degraded", []).append("plan")
        healthy = (payload["accepting"]
                   and all(v != "open" for v in states.values()))
        return healthy, payload

    return probe


def composite_health(*probes: HealthProbe) -> HealthProbe:
    """AND-combine health probes into ONE ``/healthz`` surface: healthy
    iff every probe is, payloads merged in order (later keys win). The
    replica tier stacks its replication-lag probe on top of
    :func:`runtime_health` this way — one endpoint, one JSON body, both
    stories."""

    def probe() -> Tuple[bool, dict]:
        ok = True
        payload: dict = {}
        for p in probes:
            healthy, part = p()
            ok = ok and healthy
            payload.update(part)
        return ok, payload

    return probe


def breaker_key_label(key) -> str:
    """One stable label per batch key: ``("bfs", 2)`` → ``"bfs_2"`` —
    shared by ``/healthz`` and the per-key ``serve.breaker.*``
    instruments, so the two views join by name."""
    if isinstance(key, (tuple, list)):
        return "_".join(str(p) for p in key)
    return str(key)


class _Handler(BaseHTTPRequestHandler):
    # the server thread must never block on a slow/half-open client
    timeout = 10

    def do_GET(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler API
        srv: "TelemetryServer" = self.server.telemetry  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                body = prometheus_text(*srv.registries).encode("utf-8")
                ctype = "text/plain; version=0.0.4; charset=utf-8"
                status = 200
            elif path == "/healthz":
                healthy, payload = (srv.health() if srv.health is not None
                                    else (True, {}))
                body = (json.dumps(payload, sort_keys=True) + "\n").encode()
                ctype = "application/json"
                status = 200 if healthy else 503
            elif path == "/debug/traces":
                traces = (srv.tracer.peek(srv.debug_traces_limit)
                          if srv.tracer is not None else [])
                body = traces_to_jsonl(traces).encode("utf-8")
                ctype = "application/jsonl"
                status = 200
            elif path == "/debug/flight":
                body = srv.flight.to_jsonl().encode("utf-8")
                ctype = "application/jsonl"
                status = 200
            else:
                body = b"not found\n"
                ctype = "text/plain"
                status = 404
        except Exception as e:  # a broken probe must not kill the server
            body = f"telemetry handler error: {type(e).__name__}\n".encode()
            ctype = "text/plain"
            status = 500
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args) -> None:  # scrapes are not news
        pass


class TelemetryServer:
    """The telemetry endpoint thread. ``port=0`` binds an ephemeral port
    (read it back from ``.port``); ``start()``/``stop()`` or use as a
    context manager."""

    def __init__(self, registries: Iterable[Registry] = (),
                 tracer: Optional[Tracer] = None,
                 flight: Optional[FlightRecorder] = None,
                 health: Optional[HealthProbe] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 debug_traces_limit: int = 64):
        self.registries = tuple(registries)
        self.tracer = tracer if tracer is not None else global_tracer()
        self.flight = flight if flight is not None else global_flight()
        self.health = health
        self.debug_traces_limit = int(debug_traces_limit)
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self._server.telemetry = self  # type: ignore[attr-defined]
        self.host, self.port = self._server.server_address[:2]
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "TelemetryServer":
        # check-and-set under the lock (transport.py's start discipline):
        # two racing start() calls must not spawn two serve loops — and a
        # start after stop() must FAIL LOUDLY, not serve_forever on a
        # closed socket (the listener died with stop(); make a new server)
        with self._lock:
            if self._closed:
                raise RuntimeError(
                    "TelemetryServer was stopped (port released); "
                    "construct a new one"
                )
            if self._thread is not None:
                return self
            self._thread = t = threading.Thread(
                target=self._server.serve_forever,
                name=f"hg-telemetry-{self.port}", daemon=True,
            )
        t.start()
        return self

    def stop(self) -> None:
        """Stop serving and RELEASE the port — also when ``start()`` was
        never called (the listening socket binds in ``__init__``)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            t, self._thread = self._thread, None
        if t is not None:
            # shutdown() only returns once serve_forever exits — never
            # call it for a loop that never ran (it would wait forever)
            self._server.shutdown()
            t.join(timeout=5)
        self._server.server_close()

    def __enter__(self) -> "TelemetryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
