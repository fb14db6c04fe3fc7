"""Fleet observability: one collector over every process behind the door.

The port of ``hypergraphdb_tpu/obs/fleet.py``: the fold code, the merged
views and :func:`explain_record` are the reference's. Replica nodes join
it through ``replica/node.ReplicaNode.fleet_source`` (or an
:class:`HTTPNodeSource` over a node's endpoints).

PRs 9–12 made the deployment a genuine fleet — primary + replicas +
router + sharded mesh — while telemetry stayed strictly per-process:
every node runs its own ``/metrics``, ``/debug/traces``, and flight
recorder, and nobody joins them. This module is the join:

- **FleetCollector** scrapes every registered node source (in-process
  references or a remote node's
  :class:`~hypergraphdb_tpu_torch.obs.http.TelemetryServer` URL), keeps the
  latest scrape per node, and serves the merged views the front door
  exposes: ``fleet_metrics()`` (per-node-labelled exposition — the
  ``prometheus_text(labels=...)`` / :func:`~.export.merge_expositions`
  machinery keeps identically-named series distinct),
  ``fleet_healthz()`` (worst-of verdict + per-node detail), and the SLO
  monitor tick (:mod:`~hypergraphdb_tpu_torch.obs.slo`).
- **Cross-process trace assembly**: the sender/receiver trace halves
  that ``peer/messages.attach_trace`` correlates by 128-bit trace id
  (wide enough that a multi-process pod can be joined behind one
  collector) are folded into a per-trace-id store as
  scrapes arrive; :meth:`FleetCollector.fleet_trace` stitches all of a
  trace id's spans — wherever they were recorded — into ONE tree, each
  span tagged with its node, queryable as ``GET /fleet/traces/<tid>``
  on the door.
- **Incident visibility**: a flight-recorder incident on any node
  (breaker trip, typed serve error, SLO burn) is detected from the
  scraped flight window and the node's window at that moment is
  retained on the collector — an operator asks the DOOR what broke,
  not N processes.
- **Per-request cost attribution**: :func:`explain_record` turns a
  finished request trace into the EXPLAIN dict ``submit_*(explain=True)``
  and ``POST /submit {"explain": true}`` return — serving lane, bucket
  and pad occupancy, device seconds, retries, breaker state, trace id —
  assembled from the ticket's own span tree, so the record can never
  disagree with the trace an operator later pulls from the fleet view.

HTTP scraping uses stdlib urllib. Everything is clock-injected so the
tests drive polls deterministically.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Iterable, Optional

from hypergraphdb_tpu_torch.obs.export import (
    merge_expositions,
    parse_traces_jsonl,
    prometheus_text,
    sample_value,
    trace_to_dict,
)
from hypergraphdb_tpu_torch.obs.flight import (
    FlightRecorder,
    global_flight,
    parse_flight_jsonl,
)
from hypergraphdb_tpu_torch.obs.registry import Registry


@dataclass
class NodeScrape:
    """One node's telemetry at one poll: the unit the fleet views merge."""

    node_id: str
    role: str = "node"
    ok: bool = False                 # the scrape itself succeeded
    healthy: bool = False            # the node's own health verdict
    health: dict = field(default_factory=dict)
    metrics_text: str = ""
    traces: list = field(default_factory=list)   # trace records (dicts)
    flight: list = field(default_factory=list)   # flight records (dicts)
    t: float = 0.0
    error: Optional[str] = None


class LocalNodeSource:
    """An in-process node (the router itself, a test harness, a primary
    living in the door's process): direct references, no sockets."""

    def __init__(self, node_id: str, registries: Iterable[Registry] = (),
                 tracer=None, flight: Optional[FlightRecorder] = None,
                 health=None, role: str = "node"):
        self.node_id = str(node_id)
        self.role = role
        self.registries = tuple(registries)
        self.tracer = tracer
        self.flight = flight
        self.health = health

    def scrape(self, traces_limit: int = 64) -> NodeScrape:
        out = NodeScrape(self.node_id, self.role, ok=True)
        out.metrics_text = prometheus_text(*self.registries)
        if self.tracer is not None:
            out.traces = [trace_to_dict(t)
                          for t in self.tracer.peek(traces_limit)]
        if self.flight is not None:
            # round-trip through the ONE committed serialization so the
            # local and HTTP sources can never drift on record shape
            out.flight = parse_flight_jsonl(self.flight.to_jsonl())
        if self.health is not None:
            out.healthy, out.health = self.health()
        else:
            out.healthy = True
        return out


class HTTPNodeSource:
    """A remote node behind its
    :class:`~hypergraphdb_tpu_torch.obs.http.TelemetryServer` base URL — the
    deployment shape: one scrape per endpoint per poll."""

    def __init__(self, node_id: str, url: str, role: str = "node",
                 timeout_s: float = 5.0):
        self.node_id = str(node_id)
        self.url = url.rstrip("/")
        self.role = role
        self.timeout_s = float(timeout_s)

    def _get(self, route: str) -> tuple:
        """(status, text) — non-2xx bodies are still telemetry (a 503
        ``/healthz`` carries the unhealthy payload)."""
        try:
            with urllib.request.urlopen(self.url + route,
                                        timeout=self.timeout_s) as r:
                return r.status, r.read().decode("utf-8")
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode("utf-8", "replace")

    def _get_ok(self, route: str) -> str:
        """Body of a route that MUST answer 200 — an error body is not
        telemetry (kept as text it would corrupt the merged exposition
        page / the trace-record reader), so non-200 fails the scrape."""
        status, text = self._get(route)
        if status != 200:
            raise ValueError(f"{route} answered {status}")
        return text

    def scrape(self, traces_limit: int = 64) -> NodeScrape:
        out = NodeScrape(self.node_id, self.role)
        try:
            out.metrics_text = self._get_ok("/metrics")
            out.traces = parse_traces_jsonl(
                self._get_ok("/debug/traces")
            )[-traces_limit:]
            out.flight = parse_flight_jsonl(self._get_ok("/debug/flight"))
            # /healthz is the one route where non-200 IS the payload
            # (503 = an unhealthy node's own verdict)
            status, health_text = self._get("/healthz")
            try:
                out.health = json.loads(health_text)
            except ValueError:
                out.health = {}
            out.healthy = status == 200
            out.ok = True
        except (OSError, ValueError) as e:
            out.error = f"{type(e).__name__}: {e}"
        return out


class FleetCollector:
    """The fleet's telemetry brain: poll every node, keep the latest
    scrape, fold trace records into the per-trace-id store, watch flight
    windows for incidents, tick the SLO monitor.

    Thread-safe: the poll loop writes under one lock while the door's
    handler threads read merged views. ``poll_interval_s=0`` disables
    the background thread (tests call :meth:`poll` directly)."""

    def __init__(self, sources: Iterable = (), clock=None,
                 flight: Optional[FlightRecorder] = None,
                 poll_interval_s: float = 0.25, traces_limit: int = 64,
                 max_traces: int = 512, slo=None):
        self.sources = list(sources)
        self.clock = clock or time.monotonic
        #: the collector's OWN recorder — SLO burn incidents and
        #: node-incident sightings land here (and dump, if configured)
        self.flight = flight if flight is not None else global_flight()
        self.poll_interval_s = float(poll_interval_s)
        self.traces_limit = int(traces_limit)
        self.max_traces = int(max_traces)
        #: optional hgobs SLO monitor, ticked once per poll
        self.slo = slo
        self.registry = Registry("fleet")
        self._polls = self.registry.counter("fleet.polls")
        self._scrape_errors = self.registry.counter("fleet.scrape_errors")
        self._incidents_seen = self.registry.counter("fleet.incidents_seen")
        self._nodes_up = self.registry.gauge("fleet.nodes_up")
        self._nodes_total = self.registry.gauge("fleet.nodes_total")
        self._traces_held = self.registry.gauge("fleet.traces_assembled")
        self._lock = threading.Lock()
        self._scrapes: dict[str, NodeScrape] = {}
        #: trace id → {dedupe key: trace record + "node"} (insertion-LRU)
        self._trace_store: OrderedDict = OrderedDict()
        #: node id → newest flight-incident timestamp already accounted
        self._incident_marks: dict[str, float] = {}
        #: node id → retained window snapshot of its latest incident
        self._incident_windows: dict[str, dict] = {}
        #: one sweep at a time: a direct poll() racing the background
        #: loop would double-count incident sightings (the per-node
        #: mark check is check-then-act) and race the SLO sources'
        #: cumulative accumulators — serialize instead
        self._poll_gate = threading.Lock()
        self._poll_stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    def add_source(self, source) -> "FleetCollector":
        with self._lock:
            self.sources = [s for s in self.sources
                            if s.node_id != source.node_id] + [source]
        return self

    def start(self) -> "FleetCollector":
        self.poll()
        t = None
        if self.poll_interval_s > 0:
            with self._lock:      # check-and-set: two start()s, one loop
                if self._poll_thread is None:
                    self._poll_stop.clear()
                    self._poll_thread = t = threading.Thread(
                        target=self._poll_loop, name="fleet-collector",
                        daemon=True,
                    )
        if t is not None:
            t.start()
        return self

    def stop(self) -> None:
        self._poll_stop.set()
        with self._lock:
            t, self._poll_thread = self._poll_thread, None
        if t is not None:
            t.join(timeout=5)

    def __enter__(self) -> "FleetCollector":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _poll_loop(self) -> None:
        while not self._poll_stop.wait(self.poll_interval_s):
            try:
                self.poll()
            except Exception:  # noqa: BLE001 - the loop must survive
                import logging

                logging.getLogger("hypergraphdb_tpu_torch.obs").warning(
                    "fleet poll failed", exc_info=True
                )

    # -- polling -------------------------------------------------------------
    def poll(self) -> dict:
        """One scrape sweep over every source; returns {node_id: ok}.
        Serialized: a direct call landing while the background loop
        sweeps WAITS for its turn (bounded by one sweep) rather than
        interleaving with it."""
        with self._poll_gate:
            # deliberate blocking-under-lock: the gate's whole job is to
            # make a second caller WAIT for the in-progress sweep (which
            # joins its scrape workers) rather than interleave with it
            return self._poll_once()  # hglint: disable=HG702

    def _poll_once(self) -> dict:
        with self._lock:
            sources = list(self.sources)
        now = self.clock()
        results: dict[str, NodeScrape] = {}

        def run(src):
            try:
                results[src.node_id] = src.scrape(self.traces_limit)
            except Exception as e:  # noqa: BLE001 - one bad node ≠ no poll
                results[src.node_id] = NodeScrape(
                    src.node_id, getattr(src, "role", "node"),
                    error=f"{type(e).__name__}: {e}",
                )

        # scrape CONCURRENTLY (the front door's probe-sweep discipline):
        # the sweep waits for the slowest single node, not the sum — one
        # hung telemetry port must not stall incident detection and SLO
        # ticks for every healthy node behind it
        if len(sources) <= 1:
            for src in sources:
                run(src)
        else:
            threads = [
                threading.Thread(target=run, args=(src,),
                                 name=f"fleet-scrape-{src.node_id}",
                                 daemon=True)
                for src in sources
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        verdicts = {}
        up = 0
        for src in sources:
            scrape = results[src.node_id]
            scrape.t = now
            verdicts[src.node_id] = scrape.ok
            if scrape.ok:
                up += 1
            else:
                self._scrape_errors.inc()
                with self._lock:
                    prev = self._scrapes.get(scrape.node_id)
                # a failed scrape KEEPS the node's last-good metrics
                # page: the SLO counter sources read cumulative totals
                # off these pages, and letting a down node's sum drop
                # to zero would clamp the burn windows empty — muting
                # the deadline alert fleet-wide exactly mid-incident.
                # ok/healthy stay False, so health verdicts are honest.
                if prev is not None:
                    scrape.metrics_text = prev.metrics_text
            self._fold_traces(scrape)
            self._watch_incidents(scrape)
            with self._lock:
                self._scrapes[scrape.node_id] = scrape
        self._polls.inc()
        self._nodes_up.set(up)
        self._nodes_total.set(len(sources))
        with self._lock:
            self._traces_held.set(len(self._trace_store))
        if self.slo is not None:
            self.slo.tick()
        return verdicts

    def _fold_traces(self, scrape: NodeScrape) -> None:
        """Fold one scrape's trace records into the per-trace-id store.
        ``/debug/traces`` is a PEEK, so the same record arrives on every
        poll until it ages out of the node's buffer — records dedupe on
        (node, root name, t0, first span id). Bounded: the store keeps
        the most recently TOUCHED ``max_traces`` trace ids."""
        if not scrape.traces:
            return
        with self._lock:
            for rec in scrape.traces:
                tid = rec.get("trace_id")
                if tid is None:
                    continue
                spans = rec.get("spans") or []
                key = (scrape.node_id, rec.get("name"), rec.get("t0"),
                       spans[0]["span_id"] if spans else None)
                bucket = self._trace_store.get(tid)
                if bucket is None:
                    bucket = self._trace_store[tid] = {}
                else:
                    self._trace_store.move_to_end(tid)
                bucket[key] = dict(rec, node=scrape.node_id)
            while len(self._trace_store) > self.max_traces:
                self._trace_store.popitem(last=False)

    def _watch_incidents(self, scrape: NodeScrape) -> None:
        """Detect NEW ``incident`` records in a node's scraped flight
        window (per-node timestamps — flight clocks are per-process) and
        retain that node's window: the collector pulls the remote
        context the moment something fired, so the door's fleet view can
        show it even after the node's own ring rolls over."""
        incidents = [r for r in scrape.flight if r.get("kind") == "incident"]
        if not incidents:
            return
        newest = max(r["t"] for r in incidents)
        mark = self._incident_marks.get(scrape.node_id)
        if mark is not None and newest <= mark:
            return
        fresh = [r for r in incidents if mark is None or r["t"] > mark]
        self._incident_marks[scrape.node_id] = newest
        self._incidents_seen.inc(len(fresh))
        last = fresh[-1]
        with self._lock:
            self._incident_windows[scrape.node_id] = {
                "t": last["t"],
                "reason": last.get("reason"),
                "incidents_new": len(fresh),
                "seen_at": scrape.t,
                # the PULLED window: the node's recent history at the
                # moment the collector noticed
                "window": list(scrape.flight),
            }
        self.flight.record("fleet.incident_seen", node=scrape.node_id,
                           reason=str(last.get("reason")))

    # -- reading: nodes ------------------------------------------------------
    def node_scrapes(self) -> dict:
        """{node_id: latest NodeScrape} — what SLO sources read."""
        with self._lock:
            return dict(self._scrapes)

    def metric_total(self, sample_name: str) -> float:
        """Sum one exposition sample across every node's latest scrape
        (absent samples count 0) — fleet-wide counter totals."""
        total = 0.0
        for scrape in self.node_scrapes().values():
            v = sample_value(scrape.metrics_text, sample_name)
            if v is not None:
                total += v
        return total

    def incidents(self) -> dict:
        """{node_id: retained incident window snapshot}."""
        with self._lock:
            return {k: dict(v) for k, v in self._incident_windows.items()}

    # -- reading: merged views -----------------------------------------------
    def fleet_metrics(self) -> str:
        """The door's ``/fleet/metrics`` body: every node's exposition
        page stamped ``node="<id>"`` plus the collector's own counters,
        merged into one valid page."""
        pages = [({"node": "fleet"}, prometheus_text(self.registry))]
        for node_id, scrape in sorted(self.node_scrapes().items()):
            pages.append(({"node": node_id}, scrape.metrics_text))
        return merge_expositions(pages)

    def fleet_healthz(self) -> tuple:
        """(healthy, payload): worst-of verdict — healthy iff every node
        scraped AND reported healthy — with per-node detail and the
        retained incident summaries beside it."""
        nodes = {}
        ok = True
        scrapes = self.node_scrapes()
        for node_id, scrape in sorted(scrapes.items()):
            node_ok = scrape.ok and scrape.healthy
            ok = ok and node_ok
            nodes[node_id] = {
                "role": scrape.role,
                "scraped": scrape.ok,
                "healthy": scrape.healthy,
                "detail": scrape.health,
            }
            if scrape.error:
                nodes[node_id]["error"] = scrape.error
        incidents = {
            node_id: {k: v for k, v in snap.items() if k != "window"}
            for node_id, snap in self.incidents().items()
        }
        ok = ok and bool(scrapes)
        return ok, {
            "role": "fleet",
            "healthy_nodes": sum(
                1 for n in nodes.values() if n["scraped"] and n["healthy"]
            ),
            "nodes_total": len(nodes),
            "nodes": nodes,
            "incidents": incidents,
        }

    def fleet_perf(self) -> dict:
        """The door's ``/fleet/perf`` body: every node's perf-sentinel
        verdict (the ``perf`` section ``obs.http.runtime_health`` embeds
        in ``/healthz``) merged into one view — per-node summaries, the
        ``{node: [lanes]}`` violation map (so "which lane on which node
        drifted" is one GET), fleet-total alerts, and how many nodes
        report a sentinel at all (a node without one is absent, not
        healthy-by-omission)."""
        nodes: dict = {}
        violating: dict = {}
        alerts = 0
        for node_id, scrape in sorted(self.node_scrapes().items()):
            p = (scrape.health or {}).get("perf")
            if not isinstance(p, dict):
                continue
            nodes[node_id] = p
            v = p.get("violating") or []
            if v:
                violating[node_id] = list(v)
            alerts += int(p.get("alerts_total") or 0)
        return {
            "role": "fleet",
            "nodes": nodes,
            "violating": violating,
            "alerts_total": alerts,
            "nodes_reporting": len(nodes),
        }

    def fleet_plan(self) -> dict:
        """The door's ``/fleet/plan`` body: every node's hgplan
        correction state (the ``plan`` section ``obs.http.runtime_health``
        embeds in ``/healthz``) merged into one view — per-node
        summaries, fleet totals of active corrections and sentinel-guard
        vetoes, and how many nodes report a planner at all (same
        absent-not-healthy discipline as ``fleet_perf``)."""
        nodes: dict = {}
        corrections = 0
        vetoes = 0
        for node_id, scrape in sorted(self.node_scrapes().items()):
            p = (scrape.health or {}).get("plan")
            if not isinstance(p, dict):
                continue
            nodes[node_id] = p
            corrections += int(p.get("corrections_active") or 0)
            vetoes += int(p.get("guard_vetoes") or 0)
        return {
            "role": "fleet",
            "nodes": nodes,
            "corrections_active": corrections,
            "guard_vetoes": vetoes,
            "nodes_reporting": len(nodes),
        }

    # -- reading: assembled traces -------------------------------------------
    def fleet_traces(self) -> list:
        """Summaries of every assembled trace id, most recent last:
        ``{"trace_id", "processes", "n_processes", "n_spans", "names"}``."""
        with self._lock:
            items = [(tid, list(bucket.values()))
                     for tid, bucket in self._trace_store.items()]
        out = []
        for tid, recs in items:
            out.append({
                "trace_id": tid,
                "processes": sorted({r["node"] for r in recs}),
                "n_processes": len({r["node"] for r in recs}),
                "n_spans": sum(len(r.get("spans") or ()) for r in recs),
                "names": sorted({r.get("name") for r in recs}),
            })
        return out

    def fleet_trace(self, trace_id: int) -> Optional[dict]:
        """ONE stitched fleet trace: all of ``trace_id``'s spans from
        every node, joined into a single tree — the receiver half's
        parentless spans hang under the sender's propagated span id
        exactly as recorded, so the cross-process edges need no
        heuristics, just the union of span records. None when the id is
        unknown."""
        with self._lock:
            bucket = self._trace_store.get(int(trace_id))
            recs = list(bucket.values()) if bucket else None
        if not recs:
            return None
        spans = []
        for rec in recs:
            for sp in rec.get("spans") or ():
                spans.append(dict(sp, node=rec["node"],
                                  root_name=rec.get("name")))
        spans.sort(key=lambda s: (s.get("t0") or 0.0, s["span_id"]))
        ids = {sp["span_id"] for sp in spans}
        children: dict = {}
        roots = []
        for sp in spans:
            pid = sp.get("parent_id")
            if pid in ids:
                children.setdefault(pid, []).append(sp)
            else:
                roots.append(sp)

        def nest(sp, seen):
            node = {k: sp[k] for k in ("span_id", "parent_id", "name",
                                       "t0", "t1", "attrs", "node")}
            kids = []
            for ch in children.get(sp["span_id"], ()):
                if ch["span_id"] in seen:
                    continue  # malformed cycle: never recurse forever
                seen.add(ch["span_id"])
                kids.append(nest(ch, seen))
            if kids:
                node["children"] = kids
            return node

        seen = {sp["span_id"] for sp in roots}
        tree = [nest(sp, seen) for sp in roots]
        processes = sorted({r["node"] for r in recs})
        return {
            "trace_id": int(trace_id),
            "processes": processes,
            "n_processes": len(processes),
            "names": sorted({r.get("name") for r in recs}),
            "n_spans": len(spans),
            "spans": spans,
            "tree": tree,
        }


# ------------------------------------------------------------------ explain


def explain_record(trace, result=None, lane_path: Optional[str] = None,
                   breaker_state: Optional[str] = None,
                   shard_owner: Optional[int] = None,
                   node_id: Optional[str] = None,
                   join: Optional[dict] = None) -> dict:
    """The per-request cost-attribution (EXPLAIN) record, assembled from
    a FINISHED request trace's own span tree — the one source of truth,
    so the record can never disagree with the trace an operator later
    fetches from ``/fleet/traces/<trace_id>``.

    ``lane_path`` names the executor path that answered (``device`` /
    ``sharded`` / ``host``); when absent it is derived from the span
    tree (a ``host_fallback`` span → host, else device). ``result``
    (a ServeResult/JoinResult) contributes count/epoch/truncation."""

    def span_named(name):
        return trace.find(name)

    def dur(sp):
        return None if sp is None or sp.t1 is None else sp.t1 - sp.t0

    bf = span_named("batch_form")
    launch = span_named("launch")
    device = span_named("device")
    path = lane_path
    if path is None:
        path = "host" if span_named("host_fallback") is not None else "device"
    kind = trace.attrs.get("kind")
    bucket = None if bf is None else bf.attrs.get("bucket")
    n_real = None if bf is None else bf.attrs.get("n_real")
    rec = {
        "trace_id": trace.trace_id,
        "kind": kind,
        "lane": f"{kind}/{path}" if kind else path,
        "queue_wait_s": dur(span_named("queue_wait")),
        "bucket": bucket,
        "lanes_real": n_real,
        "lanes_padded": None if bf is None else bf.attrs.get("n_pad"),
        "occupancy": (
            None if not bucket else round(n_real / bucket, 4)
        ),
        "launch_s": dur(launch),
        "retries": None if launch is None else launch.attrs.get("retries"),
        "device_s": dur(device),
        "device_slot": None if device is None else device.attrs.get("slot"),
        "collect_s": dur(span_named("collect")),
        "total_s": None if trace.t1 is None else trace.t1 - trace.t0,
        "breaker": breaker_state,
        "shard_owner": shard_owner,
        "n_spans": len(trace.spans()),
        "dropped_spans": trace.dropped,
    }
    if node_id is not None:
        rec["node"] = node_id
    if join is not None:
        # join-engine attribution (plan shape flat/bushy/hub/host, hub
        # dispatches, partial memtable corrections) — assembled by the
        # runtime from the launched batch, batch-level by construction
        rec["join"] = dict(join)
    if result is not None:
        rec["served_by"] = getattr(result, "served_by", None)
        rec["count"] = int(getattr(result, "count", 0))
        rec["truncated"] = bool(getattr(result, "truncated", False))
        rec["epoch"] = int(getattr(result, "epoch", 0))
    return rec
