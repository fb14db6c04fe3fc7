"""The HTTP skin of the replicated tier: ``POST /submit`` + ``GET /healthz``
(+ the hgsub subscription surface: ``POST /subscribe``,
``GET /notifications``).

One tiny stdlib server class worn twice:

- each **replica node** (and the primary) runs a :class:`SubmitServer`
  over its own serve runtime — the per-node submit surface the front
  door forwards to (:class:`~hypergraphdb_tpu_torch.replica.router.HTTPBackend`);
- the **front door** runs a :class:`SubmitServer` whose submit function
  IS :meth:`~hypergraphdb_tpu_torch.replica.router.FrontDoor.submit` — the
  one URL callers see.

**Subscriptions** ride the same port when a handler is wired
(``subscribe_fn`` / ``poll_fn``): ``POST /subscribe`` takes the
``sub/wire`` subscribe/unsubscribe envelopes, ``GET
/notifications?id=<sid>&timeout_s=<s>&max=<n>`` long-polls one
subscription's delta queue (the poll parks INSIDE the handler thread —
``ThreadingHTTPServer`` gives each poll its own; ``sub/wire`` clamps
the park below the handler's socket timeout). Nodes without the
subscription tier answer 404, which the front door reads as "route
elsewhere".

Status mapping (what :class:`~.router.HTTPBackend` keys its typed
errors off)::

    200  answered                      (JSON ServeResult shape)
    400  Unservable / malformed        (the REQUEST is the problem)
    503  AdmissionGated / QueueFull /  (the NODE is — re-route)
         RuntimeClosed
    504  DeadlineExceeded              (the budget is — propagate)
    500  anything else                 (bug — re-route + investigate)

Error bodies are JSON ``{"error": <type name>, "message": <str>}`` so
routers can distinguish a lag-gate refusal from a real failure without
string-matching prose. ``/metrics`` stays the
:class:`~hypergraphdb_tpu_torch.obs.http.TelemetryServer`'s job — run one
beside this per process; ``/healthz`` is duplicated here because the
front door and load balancers need it ON the submit port.

**Fleet views** (``SubmitServer(fleet=FleetCollector(...))`` — the
front door wears them): ``GET /fleet/metrics`` (per-node-labelled
merged exposition), ``/fleet/healthz`` (worst-of + per-node detail),
``/fleet/slo`` (error-budget burn state), ``/fleet/perf`` (per-node
perf-sentinel verdicts + violation map), ``/fleet/plan`` (per-node
hgplan correction state), and ``/fleet/traces/<tid>``
(one cross-process span tree stitched from every node's half) ride the
same port as ``/submit``, so the fleet is observed through the URL
callers already use. ``POST /submit {"explain": true}`` adds the
answering node's per-request cost-attribution record to the response.

Handlers hold no runtime locks (``submit`` blocks on
the request's future only), so a slow request never stalls a scrape.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from hypergraphdb_tpu_torch.obs.http import HealthProbe
from hypergraphdb_tpu_torch.serve.types import (
    AdmissionGated,
    DeadlineExceeded,
    QueueFull,
    RuntimeClosed,
    Unservable,
)

#: exception type → HTTP status (first match wins, order matters:
#: subclasses before ServeError-wide defaults). A new typed refusal must
#: be added here, or it degrades to the generic 500 and loses its
#: round-trip (``tests/test_torch_replica_router.py`` maps every serve
#: error type).
_STATUS = (
    (AdmissionGated, 503),
    (QueueFull, 503),
    (RuntimeClosed, 503),
    (DeadlineExceeded, 504),
    (Unservable, 400),
    ((KeyError, ValueError, TypeError), 400),
)


def _status_of(exc: BaseException) -> int:
    for types, code in _STATUS:
        if isinstance(exc, types):
            return code
    return 500


class _Handler(BaseHTTPRequestHandler):
    timeout = 30  # never block the handler thread on a half-open client

    def _respond(self, status: int, payload: dict) -> None:
        body = (json.dumps(payload, sort_keys=True) + "\n").encode("utf-8")
        self._respond_raw(status, body, "application/json")

    def _respond_raw(self, status: int, body: bytes, ctype: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler API
        srv: "SubmitServer" = self.server.submit_server  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0]
        if srv.fleet is not None and path.startswith("/fleet/"):
            try:
                self._do_fleet(srv.fleet, path)
            except Exception as e:  # noqa: BLE001 - a broken view ≠ dead door
                self._respond(500, {"error": type(e).__name__,
                                    "message": str(e)})
            return
        if path == "/notifications":
            if srv.poll_fn is None:
                self._respond(404, {"error": "NotFound",
                                    "message": "no subscription tier"})
                return
            from urllib.parse import parse_qs, urlsplit

            q = parse_qs(urlsplit(self.path).query)
            params = {k: v[0] for k, v in q.items() if v}
            try:
                result = srv.poll_fn(params)
            except BaseException as e:  # noqa: BLE001 - typed status map
                self._respond(_status_of(e), {"error": type(e).__name__,
                                              "message": str(e)})
                if not isinstance(e, Exception):
                    raise
                return
            self._respond(200, result)
            return
        if path != "/healthz":
            self._respond(404, {"error": "NotFound", "message": path})
            return
        try:
            healthy, payload = (srv.health() if srv.health is not None
                                else (True, {}))
        except Exception as e:  # noqa: BLE001 - a broken probe ≠ dead server
            self._respond(500, {"error": type(e).__name__,
                                "message": str(e)})
            return
        self._respond(200 if healthy else 503, payload)

    def _do_fleet(self, fleet, path: str) -> None:
        """The fleet views ON the door's port: the operator asks the one
        URL callers already use. ``fleet`` is a
        :class:`~hypergraphdb_tpu_torch.obs.fleet.FleetCollector`."""
        if path == "/fleet/metrics":
            self._respond_raw(
                200, fleet.fleet_metrics().encode("utf-8"),
                "text/plain; version=0.0.4; charset=utf-8",
            )
        elif path == "/fleet/healthz":
            healthy, payload = fleet.fleet_healthz()
            self._respond(200 if healthy else 503, payload)
        elif path == "/fleet/slo":
            if fleet.slo is None:
                self._respond(404, {"error": "NotFound",
                                    "message": "no SLO monitor attached"})
            else:
                self._respond(200, fleet.slo.snapshot())
        elif path == "/fleet/perf":
            self._respond(200, fleet.fleet_perf())
        elif path == "/fleet/plan":
            self._respond(200, fleet.fleet_plan())
        elif path == "/fleet/traces":
            self._respond(200, {"traces": fleet.fleet_traces()})
        elif path.startswith("/fleet/traces/"):
            tail = path[len("/fleet/traces/"):]
            try:
                tid = int(tail)
            except ValueError:
                self._respond(400, {"error": "ValueError",
                                    "message": f"bad trace id {tail!r}"})
                return
            joined = fleet.fleet_trace(tid)
            if joined is None:
                self._respond(404, {"error": "NotFound",
                                    "message": f"unknown trace {tid}"})
            else:
                self._respond(200, joined)
        else:
            self._respond(404, {"error": "NotFound", "message": path})

    def do_POST(self) -> None:  # noqa: N802
        srv: "SubmitServer" = self.server.submit_server  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0]
        if path == "/subscribe":
            fn = srv.subscribe_fn
        elif path == "/submit":
            fn = srv.submit_fn
        else:
            self._respond(404, {"error": "NotFound", "message": path})
            return
        if fn is None:
            self._respond(404, {"error": "NotFound",
                                "message": "no subscription tier"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n).decode("utf-8"))
            if not isinstance(payload, dict):
                raise ValueError("request body must be a JSON object")
        except Exception as e:  # noqa: BLE001 - unparsable body
            self._respond(400, {"error": type(e).__name__,
                                "message": str(e)})
            return
        try:
            result = fn(payload)
        except BaseException as e:  # noqa: BLE001 - typed status mapping
            self._respond(_status_of(e), {"error": type(e).__name__,
                                          "message": str(e)})
            if not isinstance(e, Exception):
                raise  # a real kill (InjectedCrash) must still kill
            return
        self._respond(200, result)

    def log_message(self, fmt, *args) -> None:  # requests are not news
        pass


class _Server(ThreadingHTTPServer):
    #: the listen backlog: the stdlib's 5 resets connections once a few
    #: dozen callers (or a door's fan-out) connect at once
    request_queue_size = 128
    daemon_threads = True


class SubmitServer:
    """The submit endpoint thread (``port=0`` binds ephemeral; read it
    back from ``.port``). ``submit_fn`` takes the decoded JSON payload
    and returns the response dict — wire
    ``lambda p: submit_payload(node.runtime, p, timeout)`` for a node,
    or ``frontdoor.submit`` for the router. Lifecycle mirrors
    ``obs.http.TelemetryServer`` (start/stop or context manager; stop
    releases the port; no restart after stop)."""

    def __init__(self, submit_fn: Callable[[dict], dict],
                 health: Optional[HealthProbe] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 fleet=None,
                 subscribe_fn: Optional[Callable[[dict], dict]] = None,
                 poll_fn: Optional[Callable[[dict], dict]] = None):
        self.submit_fn = submit_fn
        self.health = health
        #: hgsub surface: ``POST /subscribe`` body → response envelope,
        #: and ``GET /notifications`` query params → poll envelope.
        #: None (the default) answers 404 on both paths.
        self.subscribe_fn = subscribe_fn
        self.poll_fn = poll_fn
        #: optional hgobs FleetCollector: serves /fleet/metrics,
        #: /fleet/healthz, /fleet/slo, /fleet/perf, /fleet/plan,
        #: /fleet/traces[/<tid>] ON this
        #: port — the front door wears it so the fleet is operated
        #: through the same URL callers submit to
        self.fleet = fleet
        self._server = _Server((host, port), _Handler)
        self._server.submit_server = self  # type: ignore[attr-defined]
        self.host, self.port = self._server.server_address[:2]
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "SubmitServer":
        with self._lock:
            if self._closed:
                raise RuntimeError(
                    "SubmitServer was stopped (port released); "
                    "construct a new one"
                )
            if self._thread is not None:
                return self
            self._thread = t = threading.Thread(
                target=self._server.serve_forever,
                name=f"hg-submit-{self.port}", daemon=True,
            )
        t.start()
        return self

    def stop(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            t, self._thread = self._thread, None
        if t is not None:
            self._server.shutdown()
            t.join(timeout=5)
        self._server.server_close()

    def __enter__(self) -> "SubmitServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def node_server(node, timeout_s: float = 30.0,
                host: str = "127.0.0.1", port: int = 0,
                authoritative: bool = False) -> SubmitServer:
    """A replica node's submit endpoint: runtime + health in one call.
    ``authoritative=True`` marks a PRIMARY's endpoint: an unknown gid
    answers 400 (the gid is wrong) instead of 503 (merely not here yet).
    Explain responses are stamped with the node's peer identity. When
    the node's runtime carries an hgsub ``SubscriptionManager``
    (``runtime.subscriptions``), the subscription surface is served
    beside ``/submit``."""
    from hypergraphdb_tpu_torch.replica.router import submit_payload

    ident = getattr(getattr(node, "peer", None), "identity", None)
    subscribe_fn = poll_fn = None
    if getattr(node.runtime, "subscriptions", None) is not None:
        from hypergraphdb_tpu_torch.sub.wire import (
            poll_payload,
            subscribe_payload,
        )

        subscribe_fn = (
            lambda p: subscribe_payload(node.runtime.subscriptions, p)
        )
        poll_fn = lambda p: poll_payload(node.runtime.subscriptions, p)
    return SubmitServer(
        lambda p: submit_payload(node.runtime, p, timeout_s,
                                 authoritative=authoritative,
                                 node_id=ident),
        health=node.health_probe(), host=host, port=port,
        subscribe_fn=subscribe_fn, poll_fn=poll_fn,
    )


def frontdoor_server(frontdoor, host: str = "127.0.0.1",
                     port: int = 0, fleet=None) -> SubmitServer:
    """The front door's public endpoint; pass a
    :class:`~hypergraphdb_tpu_torch.obs.fleet.FleetCollector` as ``fleet`` to
    serve the ``/fleet/*`` views beside ``/submit``. Subscriptions are
    routed (and re-anchored across failover) by the door itself."""
    return SubmitServer(frontdoor.submit, health=frontdoor.health_probe(),
                        host=host, port=port, fleet=fleet,
                        subscribe_fn=frontdoor.subscribe,
                        poll_fn=frontdoor.poll)
