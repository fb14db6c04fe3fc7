"""The front door: one SUBMIT surface over the primary + N replicas.

Placement policy (read spreading):

1. refresh each replica's health (a background poll, or lazily when the
   poll is off) — ``/healthz``-shaped probes yield ``healthy`` plus the
   advertised ``replication_lag``;
2. order healthy replicas by advertised lag FIRST (freshness is the
   caller-visible contract), then break lag ties by a load score read
   from the same ``/healthz`` body — admission ``queue_depth`` plus a
   weighted penalty for a non-closed serve breaker (``breaker_worst``)
   — and round-robin within the equally-lagged-and-loaded group, so
   equally-fresh replicas share load instead of the first one eating it
   all while a deep-queued or degraded replica sheds placement to an
   idle sibling;
3. skip replicas whose per-replica circuit breaker gate is OPEN — a
   dead replica costs ``breaker_threshold`` failed probes ONCE, then
   its load re-routes without paying a timeout per request until the
   cooldown releases a half-open probe. A health poll that sees the
   replica answering again RESETS the gate (immediate re-admission on
   rejoin);
4. the primary is the exact-answer fallback: any request no replica
   could serve (all dead, all gated past their lag bound, typed
   refusals) lands there — degraded placement, zero caller-visible
   errors for in-budget requests.

Typed refusals that re-route: transport errors, 5xx, timeouts,
:class:`~hypergraphdb_tpu_torch.serve.AdmissionGated` (the replica's lag
gate), :class:`~hypergraphdb_tpu_torch.serve.QueueFull`. Permanent request
errors (:class:`~hypergraphdb_tpu_torch.serve.Unservable`, malformed
payloads) and an expired deadline propagate immediately — no backend
could do better, and burning the breaker on them would punish a healthy
replica for a caller bug.

Backends are duck-typed (``id`` / ``submit(payload, timeout)`` /
``health()``): :class:`LocalBackend` wraps an in-process runtime (tests,
single-host tiers), :class:`HTTPBackend` speaks to a
:class:`~hypergraphdb_tpu_torch.replica.httpd.SubmitServer` over real sockets.

**Standing queries** route through the same door: the FrontDoor owns a
door-side subscription id (``dsub-<n>``) per standing query, places the
subscribe like a submit, and MIRRORS the subscription (original
payload, current match set, anchoring seq, digest) so a backend loss is
survivable — when a poll finds the owning backend gone, the door
re-subscribes the original payload on another healthy backend and
synthesizes the ONE delta notification between the mirror's anchor seq
and the new snapshot (no loss, no duplicates; seqs are comparable
across backends because every node's subscription manager anchors at
the replication log position). Consumers never see backend identity:
subscription ids are rewritten both ways.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from hypergraphdb_tpu_torch.fault import (
    CLOSED,
    OPEN,
    CircuitBreaker,
    PermanentFault,
    TransientFault,
)
from hypergraphdb_tpu_torch.serve.types import (
    AdmissionGated,
    DeadlineExceeded,
    Unservable,
)
from hypergraphdb_tpu_torch.utils.metrics import Metrics

#: request errors no re-route can fix: propagate, never penalize the
#: backend's breaker for them
_PERMANENT = (Unservable, PermanentFault, KeyError, ValueError, TypeError)


def _request_ids(payload: dict) -> list:
    """The RAW atom handles a submit payload names (seed / anchors) —
    what shard-ownership placement compares against a backend's
    advertised gid coverage. Gid-addressed forms resolve per-backend and
    carry no global ordering, so they contribute nothing here."""
    ids = []
    if isinstance(payload.get("seed"), int):
        ids.append(int(payload["seed"]))
    anchors = payload.get("anchors")
    if isinstance(anchors, (list, tuple)):
        ids.extend(int(a) for a in anchors if isinstance(a, int))
    return ids


def submit_payload(runtime, payload: dict, timeout: float,
                   authoritative: bool = False,
                   node_id: Optional[str] = None) -> dict:
    """One wire-shaped request → the runtime → a wire-shaped response.
    The single serve-payload schema, shared by the local backend and the
    HTTP handler so both paths answer byte-identically::

        {"kind": "bfs", "seed": 7, "max_hops": 2, "deadline_s": 0.5}
        {"kind": "pattern", "anchors": [3, 9], "type_handle": 4}

    Response: ``{"kind", "count", "matches", "truncated", "epoch",
    "served_by"}``. ``authoritative`` marks the PRIMARY's source-of-truth
    view: a gid it doesn't know exists nowhere, which is the caller's
    error — on a replica the same miss is a replication race.

    ``{"explain": true}`` requests per-request cost attribution: the
    response carries the runtime's EXPLAIN record (serving lane,
    occupancy, device seconds, retries, breaker state, trace id —
    assembled from the request's own span tree) under ``"explain"``,
    stamped with ``node_id`` when the endpoint knows who it is. Needs
    tracing enabled on the answering node (400 otherwise, the
    :class:`~hypergraphdb_tpu_torch.serve.Unservable` mapping)."""
    kind = payload.get("kind")
    deadline = payload.get("deadline_s")
    explain = bool(payload.get("explain"))

    def _resolve(gid: str) -> int:
        # gid-addressed requests are location-transparent: the SAME
        # payload serves on any backend, whatever local handles its
        # history assigned (raw-handle payloads remain for single-node
        # callers that never leave one handle space)
        from hypergraphdb_tpu_torch.peer import transfer

        g = getattr(runtime, "graph", None)
        h = None if g is None else transfer.lookup_local(g, str(gid))
        if h is None:
            if authoritative:
                # the source of truth doesn't know it: the gid is wrong
                # (deleted or typo'd) — a permanent caller error, NOT a
                # retryable refusal, or a 503-retrying client would poll
                # an unanswerable request forever
                raise Unservable(f"unknown gid {gid!r}")
            # "not HERE (yet)" — a replica may simply trail the atom's
            # creation; AdmissionGated makes the router re-route (the
            # primary has it) without a breaker penalty, instead of
            # surfacing a caller error for a replication race
            raise AdmissionGated(f"unknown gid {gid!r} on this node")
        return int(h)

    if kind == "bfs":
        seed = (_resolve(payload["seed_gid"]) if "seed_gid" in payload
                else int(payload["seed"]))
        fut = runtime.submit_bfs(
            seed,
            max_hops=(None if payload.get("max_hops") is None
                      else int(payload["max_hops"])),
            deadline_s=deadline,
            include_seed=bool(payload.get("include_seed", True)),
            explain=explain,
        )
    elif kind == "pattern":
        anchors = ([_resolve(a) for a in payload["anchor_gids"]]
                   if "anchor_gids" in payload
                   else [int(a) for a in payload["anchors"]])
        fut = runtime.submit_pattern(
            anchors,
            type_handle=(None if payload.get("type_handle") is None
                         else int(payload["type_handle"])),
            deadline_s=deadline,
            explain=explain,
        )
    else:
        raise Unservable(f"unknown request kind {kind!r}")
    res = fut.result(timeout=timeout)
    out = {
        "kind": res.kind,
        "count": int(res.count),
        "matches": [int(m) for m in res.matches],
        "truncated": bool(res.truncated),
        "epoch": int(res.epoch),
        "served_by": res.served_by,
    }
    if explain:
        rec = getattr(fut, "explain", None)
        if rec is not None:
            if node_id is not None:
                rec = dict(rec, node=str(node_id))
            out["explain"] = rec
    if payload.get("gids"):
        # matches are LOCAL handles of the answering node; a caller
        # comparing answers across backends (or following up against a
        # different node) asks for the global-id view — replicated atoms
        # carry one gid everywhere, unreplicated ones map to None
        from hypergraphdb_tpu_torch.peer import transfer

        g = getattr(runtime, "graph", None)
        out["match_gids"] = (
            None if g is None
            else [transfer.existing_gid(g, int(m)) for m in res.matches]
        )
    return out


class LocalBackend:
    """In-process backend over one serve runtime + optional health probe
    (a :class:`~hypergraphdb_tpu_torch.replica.node.ReplicaNode` passes its
    :meth:`health_probe`; a primary passes ``runtime_health``)."""

    def __init__(self, backend_id: str, runtime, health=None,
                 role: str = "replica"):
        self.id = backend_id
        self.runtime = runtime
        self.role = role
        self._health = health

    def submit(self, payload: dict, timeout: float) -> dict:
        return submit_payload(self.runtime, payload, timeout,
                              authoritative=self.role == "primary",
                              node_id=self.id)

    def _sub_manager(self):
        m = getattr(self.runtime, "subscriptions", None)
        if m is None:
            raise Unservable(f"{self.id} has no subscription tier")
        return m

    def subscribe(self, payload: dict, timeout: float) -> dict:
        from hypergraphdb_tpu_torch.sub.wire import subscribe_payload

        return subscribe_payload(self._sub_manager(), payload)

    def poll(self, params: dict, timeout: float) -> dict:
        from hypergraphdb_tpu_torch.sub.wire import poll_payload

        return poll_payload(self._sub_manager(), params)

    def health(self):
        if self._health is None:
            return True, {"role": self.role}
        return self._health()


class HTTPBackend:
    """A backend behind a :class:`~.httpd.SubmitServer` URL. Non-2xx
    submit responses raise typed: 4xx → :class:`PermanentFault` (the
    request is the problem), everything else → :class:`TransientFault`
    (the backend is — re-route)."""

    def __init__(self, backend_id: str, url: str, role: str = "replica",
                 health_timeout_s: float = 5.0):
        self.id = backend_id
        self.url = url.rstrip("/")
        self.role = role
        self.health_timeout_s = health_timeout_s

    def submit(self, payload: dict, timeout: float) -> dict:
        return self._roundtrip(urllib.request.Request(
            self.url + "/submit",
            data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json"},
            method="POST",
        ), timeout)

    def subscribe(self, payload: dict, timeout: float) -> dict:
        return self._roundtrip(urllib.request.Request(
            self.url + "/subscribe",
            data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json"},
            method="POST",
        ), timeout)

    def poll(self, params: dict, timeout: float) -> dict:
        qs = urllib.parse.urlencode({
            k: params[k] for k in ("id", "timeout_s", "max")
            if params.get(k) is not None
        })
        return self._roundtrip(urllib.request.Request(
            self.url + "/notifications?" + qs, method="GET",
        ), timeout)

    def _roundtrip(self, req, timeout: float) -> dict:
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return json.loads(r.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            body = e.read().decode("utf-8", "replace")[:300]
            try:
                kind = json.loads(body).get("error")
            except Exception:  # noqa: BLE001 - non-JSON error body
                kind = None
            if kind == "AdmissionGated":
                # the replica's lag gate, not a failure: the router
                # re-routes WITHOUT a breaker penalty
                raise AdmissionGated(body) from e
            if kind == "DeadlineExceeded":
                # the CALLER's budget expired, not the backend: must
                # propagate un-struck (a 504 read as TransientFault
                # would burn the breaker of a healthy replica and
                # retry a dead-on-arrival request across the tier)
                raise DeadlineExceeded(body) from e
            if 400 <= e.code < 500:
                raise PermanentFault(
                    f"{self.id} rejected the request ({e.code}): {body}"
                ) from e
            raise TransientFault(
                f"{self.id} failed ({e.code}): {body}"
            ) from e
        except OSError as e:  # refused/reset/timeout — the wire's fault
            raise TransientFault(f"{self.id} unreachable: {e}") from e

    def health(self):
        try:
            with urllib.request.urlopen(self.url + "/healthz",
                                        timeout=self.health_timeout_s) as r:
                return True, json.loads(r.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read().decode("utf-8"))
            except Exception:  # noqa: BLE001 - non-JSON error body
                payload = {}
            return False, payload
        # plain OSError (dead socket) propagates: the caller counts it
        # as unreachable


@dataclass
class RouterConfig:
    """Front-door knobs."""

    breaker_threshold: int = 2      # consecutive failures → OPEN
    breaker_cooldown_s: float = 0.5
    #: health snapshots older than this refresh before placement
    health_refresh_s: float = 0.25
    #: background poll cadence (0 = poll only lazily at placement)
    poll_interval_s: float = 0.25
    #: distinct replicas tried before falling back to the primary
    max_attempts: int = 2
    #: load-score penalty per ``breaker_worst`` code unit (0 closed /
    #: 1 half-open / 2 open): a replica whose own serve breaker is
    #: degraded loses lag-tied placement to ``weight×code`` queued
    #: requests' worth of load
    load_breaker_weight: float = 16.0
    submit_timeout_s: float = 30.0
    clock: Optional[Callable[[], float]] = None


class FrontDoor:
    """The router. Thread-safe: requests may arrive from many HTTP
    handler threads; placement state is one small locked dict and the
    breaker locks itself."""

    def __init__(self, primary, replicas: Sequence, config:
                 Optional[RouterConfig] = None):
        self.config = config or RouterConfig()
        self.primary = primary
        self.replicas = list(replicas)
        self.clock = self.config.clock or time.monotonic
        self.breaker = CircuitBreaker(
            threshold=self.config.breaker_threshold,
            cooldown_s=self.config.breaker_cooldown_s,
            clock=self.clock,
        )
        self.metrics = Metrics()
        self._lock = threading.Lock()
        #: backend id → (healthy, lag, load score, advertised gid
        #: capacity or None, snapshot time)
        self._health: dict[str, tuple] = {}
        self._rr = 0
        self._poll_stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None
        #: one refresh at a time: a lazy-mode submit that finds a probe
        #: already in flight places with the snapshot it has instead of
        #: queueing another N-probe sweep behind it
        self._refresh_gate = threading.Lock()
        #: door sid → subscription mirror: the resume state that makes a
        #: backend loss survivable (original payload to re-subscribe,
        #: the match set + replication-anchored seq to diff against)
        self._subs: dict[str, dict] = {}
        self._sub_seq = 0

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FrontDoor":
        self.refresh_health()
        t = None
        if self.config.poll_interval_s > 0:
            with self._lock:      # check-and-set: two start()s, one poll
                if self._poll_thread is None:
                    self._poll_stop.clear()
                    self._poll_thread = t = threading.Thread(
                        target=self._poll_loop, name="frontdoor-health",
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

    def __enter__(self) -> "FrontDoor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- health / placement ---------------------------------------------------
    def refresh_health(self) -> None:
        """Probe every replica's health once. A backend whose health
        TRANSITIONS unhealthy → healthy (the rejoin edge) is re-admitted
        immediately (breaker reset) — rejoin should not wait out a
        cooldown ladder the outage already paid for. Deliberately
        edge-triggered: a backend whose ``/healthz`` lies green while
        its submits fail must NOT be level-reset every poll, or the
        breaker could never bound its probes.

        Probes run CONCURRENTLY (one short-lived thread per replica) and
        at most one sweep at a time: the wait is bounded by the slowest
        single probe, not their sum, and a blackholed replica (SYN
        dropped — urlopen eats its whole timeout) cannot stack N×timeout
        onto a lazy-mode submit path nor fan one sweep per handler
        thread."""
        if not self._refresh_gate.acquire(blocking=False):
            return  # a sweep is in flight; place with the snapshot we have
        try:
            now = self.clock()
            results: dict[str, tuple] = {}
            w = self.config.load_breaker_weight

            def probe(be):
                try:
                    healthy, payload = be.health()
                    lag = int(payload.get("replication_lag", 0))
                    # the load-aware tiebreak inputs, from
                    # the SAME body operators scrape: queued admissions
                    # + a penalty while the serve breaker is not closed
                    load = (float(payload.get("queue_depth", 0))
                            + w * float(payload.get("breaker_worst", 0)))
                    # shard ownership: a multi-chip pod advertises its
                    # partition map; the covered id space bounds which
                    # raw-handle requests its device path can own. No
                    # advertisement = a full replica (covers everything).
                    cover = None
                    mesh = payload.get("mesh")
                    if isinstance(mesh, dict):
                        pm = mesh.get("partition_map") or {}
                        if pm.get("capacity") is not None:
                            cover = int(pm["capacity"])
                except Exception:  # noqa: BLE001 - unreachable == unhealthy
                    healthy, lag, load, cover = False, 0, 0.0, None
                results[be.id] = (healthy, lag, load, cover)

            if len(self.replicas) <= 1:
                for be in self.replicas:
                    probe(be)
            else:
                threads = [
                    threading.Thread(target=probe, args=(be,),
                                     name=f"frontdoor-probe-{be.id}",
                                     daemon=True)
                    for be in self.replicas
                ]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
            for be in self.replicas:
                healthy, lag, load, cover = results.get(
                    be.id, (False, 0, 0.0, None))
                with self._lock:
                    prev = self._health.get(be.id)
                    self._health[be.id] = (healthy, lag, load, cover, now)
                if (healthy and prev is not None and not prev[0]
                        and self.breaker.state_of(be.id) != CLOSED):
                    self.breaker.reset(be.id)
                    self.metrics.incr("router.readmissions")
        finally:
            self._refresh_gate.release()

    def _poll_loop(self) -> None:
        while not self._poll_stop.wait(self.config.poll_interval_s):
            try:
                self.refresh_health()
            except Exception:  # noqa: BLE001 - counted; the poll lives on
                # the reference logs and drops this: counted here
                self.metrics.incr("router.poll_errors")

    def _placement(self, payload: Optional[dict] = None) -> list:
        """Healthy replicas ordered by SHARD OWNERSHIP first (a backend
        whose advertised partition map covers the request's raw ids
        beats one that would have to host-correct or re-route), then
        least-lagged, then a load-score tiebreak within a lag tie (queue
        depth + breaker penalty from ``/healthz``), round-robin within
        the equal head group (the spread), breaker-OPEN gates
        skipped."""
        now = self.clock()
        with self._lock:
            stale = any(
                self._health.get(be.id, (False, 0, 0.0, None, -1e9))[4]
                < now - self.config.health_refresh_s
                for be in self.replicas
            )
        if stale and self.config.poll_interval_s <= 0:
            self.refresh_health()
        with self._lock:
            known = {
                be.id: self._health.get(be.id, (False, 0, 0.0, None, 0.0))
                for be in self.replicas
            }
            self._rr += 1
            rr = self._rr
        healthy = [be for be in self.replicas if known[be.id][0]]
        if not healthy:
            return []
        req_ids = _request_ids(payload) if payload else []
        req_hi = max(req_ids) if req_ids else None

        def score(be):
            # load is QUANTIZED for grouping: exact float equality would
            # let one queued request's jitter collapse the round-robin
            # spread onto a single replica per poll window (herding) —
            # a few requests of depth difference is noise, not signal
            cover = known[be.id][3]
            owns = (req_hi is None or cover is None or req_hi < cover)
            return (0 if owns else 1,
                    known[be.id][1], int(known[be.id][2]) // 8)

        healthy.sort(key=score)
        best = score(healthy[0])
        grp = [be for be in healthy if score(be) == best]
        rest = [be for be in healthy if score(be) != best]
        k = rr % len(grp)
        ordered = grp[k:] + grp[:k] + rest
        # peek, don't allow: placement ranks candidates the request may
        # never reach — consuming a half-open probe token here would
        # starve the backend's actual recovery probe (the submit loop
        # calls allow() right before dispatching)
        return [be for be in ordered if self.breaker.peek(be.id)]

    # -- submit ---------------------------------------------------------------
    def submit(self, payload: dict,
               timeout: Optional[float] = None) -> dict:
        """Route one request: replicas by placement order (bounded
        attempts), then the primary. The response's ``routed_to`` names
        the backend that answered."""
        timeout = timeout if timeout is not None \
            else self.config.submit_timeout_s
        self.metrics.incr("router.submitted")
        attempts = 0
        for be in self._placement(payload):
            if attempts >= self.config.max_attempts:
                break
            if not self.breaker.allow(be.id):
                # lost the race for a half-open probe token between
                # placement's peek and here — skip without burning an
                # attempt on a backend we never tried
                continue
            attempts += 1
            try:
                res = be.submit(payload, timeout)
            except (DeadlineExceeded, *_PERMANENT):
                # no other backend can answer this better — and the
                # breaker must not punish a replica for a caller bug
                self.metrics.incr("router.errors")
                raise
            except AdmissionGated:
                # the replica's lag gate refused: a typed, HEALTHY
                # refusal — re-route without a breaker penalty
                self.metrics.incr("router.lag_rerouted")
                continue
            except Exception:  # noqa: BLE001 - transport/timeout/5xx
                # the breaker (not the health cache) owns failure
                # memory: K consecutive failures OPEN the gate and bound
                # the probes; health stays the poll's own observation so
                # the rejoin edge (unhealthy → healthy) is unambiguous
                self.breaker.record_failure(be.id)
                self.metrics.incr("router.rerouted")
                continue
            self.breaker.record_success(be.id)
            self.metrics.incr("router.routed_replica")
            res["routed_to"] = be.id
            return res
        # exact-answer fallback: the primary
        self.metrics.incr("router.primary_fallbacks")
        try:
            res = self.primary.submit(payload, timeout)
        except Exception:
            self.metrics.incr("router.errors")
            raise
        res["routed_to"] = self.primary.id
        return res

    # -- standing queries ------------------------------------------------------
    def _backend_by_id(self, bid):
        for be in self.replicas:
            if be.id == bid:
                return be
        return self.primary if self.primary.id == bid else None

    def subscribe(self, payload: dict,
                  timeout: Optional[float] = None) -> dict:
        """Place one standing query (or relay an ``unsubscribe``): the
        same placement/breaker walk as :meth:`submit`, plus a door-side
        mirror so the subscription survives losing its backend. The
        response's ``id`` is the DOOR's (``dsub-<n>``); consumers poll
        and unsubscribe through the door only."""
        timeout = timeout if timeout is not None \
            else self.config.submit_timeout_s
        if payload.get("what") == "unsubscribe":
            return self._unsubscribe(payload, timeout)
        self.metrics.incr("router.sub_subscribes")
        attempts = 0
        for be in self._placement(payload):
            if attempts >= self.config.max_attempts:
                break
            if not self.breaker.allow(be.id):
                continue
            attempts += 1
            try:
                resp = be.subscribe(payload, timeout)
            except (DeadlineExceeded, *_PERMANENT):
                self.metrics.incr("router.errors")
                raise
            except AdmissionGated:
                self.metrics.incr("router.lag_rerouted")
                continue
            except Exception:  # noqa: BLE001 - transport/timeout/5xx
                self.breaker.record_failure(be.id)
                self.metrics.incr("router.rerouted")
                continue
            self.breaker.record_success(be.id)
            return self._adopt(be, payload, resp)
        try:
            resp = self.primary.subscribe(payload, timeout)
        except Exception:
            self.metrics.incr("router.errors")
            raise
        return self._adopt(self.primary, payload, resp)

    @staticmethod
    def _snapshot(resp: dict) -> dict:
        """Read one ``subscribed`` envelope into the mirror's fields."""
        return {
            "sid": resp.get("id"),
            "kind": resp.get("kind"),
            "window": resp.get("window"),
            "matches": {int(m) for m in resp.get("matches") or ()},
            "seq": int(resp.get("seq") or 0),
            "digest": resp.get("digest"),
        }

    def _adopt(self, be, payload: dict, resp: dict) -> dict:
        """Mirror one freshly-placed subscription and rewrite its id to
        the door's namespace."""
        if resp.get("what") == "subscribed":
            snap = self._snapshot(resp)
            with self._lock:
                self._sub_seq += 1
                dsid = f"dsub-{self._sub_seq}"
                self._subs[dsid] = dict(
                    snap, backend=be.id, payload=dict(payload))
            self.metrics.incr("router.subscriptions")
            out = dict(resp)
            out["id"] = dsid
            out["routed_to"] = be.id
            return out
        return resp  # relay odd shapes verbatim (future envelopes)

    def _unsubscribe(self, payload: dict, timeout: float) -> dict:
        dsid = payload.get("id")
        with self._lock:
            m = self._subs.pop(dsid, None) if isinstance(dsid, str) \
                else None
        if m is None:
            raise Unservable(f"unknown subscription {dsid!r}")
        be = self._backend_by_id(m["backend"])
        if be is not None:
            try:
                be.subscribe({"what": "unsubscribe", "id": m["sid"]},
                             timeout)
            except Exception:  # noqa: BLE001 - best effort: the door's
                # view is gone either way; an orphaned backend copy
                # sheds into its bounded queue until resource close
                self.metrics.incr("router.sub_orphaned")
        return {"what": "unsubscribed", "id": dsid}

    def poll(self, params: dict,
             timeout: Optional[float] = None) -> dict:
        """Long-poll one door subscription. The happy path relays to the
        owning backend and folds the answered deltas into the mirror;
        ANY backend failure (transport, 5xx, a restarted replica that
        lost its subscription state) triggers the resume path instead of
        surfacing an error: re-subscribe elsewhere, diff, synthesize."""
        dsid = params.get("id")
        with self._lock:
            m = self._subs.get(dsid) if isinstance(dsid, str) else None
        if m is None:
            raise Unservable(f"unknown subscription {dsid!r}")
        try:  # validate the caller's knobs HERE: past this point every
            # backend refusal is a backend-state problem → failover
            wait = float(params.get("timeout_s", 0.0) or 0.0)
            int(params.get("max", 32) or 32)
        except (TypeError, ValueError) as e:
            raise Unservable(f"bad poll parameter: {e}") from None
        self.metrics.incr("router.sub_polls")
        timeout = timeout if timeout is not None \
            else wait + self.config.submit_timeout_s
        be = self._backend_by_id(m["backend"])
        if be is not None:
            try:
                env = be.poll(dict(params, id=m["sid"]), timeout)
            except DeadlineExceeded:
                self.metrics.incr("router.errors")
                raise
            except Exception:  # noqa: BLE001 - the backend lost it (or
                # itself): resume, don't error
                self.breaker.record_failure(be.id)
                return self._sub_failover(dsid, m, timeout)
            return self._fold_poll(dsid, m, env)
        return self._sub_failover(dsid, m, timeout)

    def _fold_poll(self, dsid: str, m: dict, env: dict) -> dict:
        """Apply one backend poll answer to the mirror and rewrite ids.
        The mirror replays the consumer contract exactly: deltas chain
        seq→seq, a resync replaces the set wholesale."""
        what = env.get("what")
        if what == "resync":
            if env.get("id") != m["sid"]:
                # the backend answered for a DIFFERENT subscription —
                # never expected; count it rather than corrupt the mirror
                self.metrics.incr("router.sub_id_mismatches")
                return dict(env, id=dsid)
            with self._lock:
                m["matches"] = {int(x) for x in env.get("matches") or ()}
                m["seq"] = int(env.get("seq") or 0)
                m["digest"] = env.get("digest")
            return dict(env, id=dsid)
        if what == "notifications":
            if env.get("id") != m["sid"]:
                self.metrics.incr("router.sub_id_mismatches")
                return dict(env, id=dsid, notes=[], more=False)
            notes = []
            for note in env.get("notes") or ():
                if note.get("what") == "notification" \
                        and note.get("id") == m["sid"]:
                    added = [int(x) for x in note.get("added") or ()]
                    removed = [int(x) for x in note.get("removed") or ()]
                    with self._lock:
                        if int(note.get("seq_from") or 0) != m["seq"]:
                            # a broken chain the backend's own resync
                            # discipline should make impossible — count
                            # it and re-anchor at the note's far edge
                            self.metrics.incr("router.sub_chain_gaps")
                        m["matches"].difference_update(removed)
                        m["matches"].update(added)
                        m["seq"] = int(note.get("seq_to") or 0)
                        m["digest"] = note.get("digest")
                    notes.append(dict(note, id=dsid))
                else:
                    notes.append(note)
            return {"what": "notifications", "id": dsid, "notes": notes,
                    "more": bool(env.get("more"))}
        return dict(env, id=dsid)

    def _sub_failover(self, dsid: str, m: dict, timeout: float) -> dict:
        """The resume path: the owning backend is gone (or forgot the
        subscription), so re-place the ORIGINAL payload on another
        backend and answer the poll with the ONE synthesized delta
        between the mirror's anchor seq and the adopted snapshot — the
        consumer sees an ordinary chained notification, never a gap, a
        loss, or a duplicate."""
        self.metrics.incr("router.sub_failovers")
        old = set(m["matches"])
        old_seq = m["seq"]
        dead = m["backend"]
        candidates = [be for be in self._placement(m["payload"])
                      if be.id != dead]
        if self.primary.id != dead:
            candidates.append(self.primary)
        adopted, snap = None, None
        for be in candidates:
            try:
                r = be.subscribe(m["payload"], timeout)
            except Exception:  # noqa: BLE001 - keep walking the tier
                continue
            if r.get("what") == "subscribed":
                adopted, snap = be, self._snapshot(r)
                break
        if adopted is None:
            raise TransientFault(
                f"subscription {dsid} lost backend {dead!r} and no other "
                "backend could adopt it")
        new = snap["matches"]
        with self._lock:
            m.update(snap, backend=adopted.id)
            new_seq, digest = m["seq"], m["digest"]
        added = sorted(new - old)
        removed = sorted(old - new)
        notes = []
        if added or removed or new_seq != old_seq:
            notes = [{
                "what": "notification", "id": dsid,
                "seq_from": old_seq, "seq_to": new_seq,
                "added": added, "removed": removed, "digest": digest,
            }]
        return {"what": "notifications", "id": dsid, "notes": notes,
                "more": False}

    # -- fleet observability ---------------------------------------------------
    def fleet_source(self, node_id: str = "router"):
        """The router's OWN node source for a
        :class:`~hypergraphdb_tpu_torch.obs.fleet.FleetCollector`: routing
        counters + the router health probe — the door reads itself the
        same way it reads its backends."""
        from hypergraphdb_tpu_torch.obs.fleet import LocalNodeSource

        return LocalNodeSource(
            node_id, registries=[self.metrics.registry],
            health=self.health_probe(), role="router",
        )

    # -- health surface --------------------------------------------------------
    def health_probe(self):
        """The router's own ``/healthz``: per-backend health/lag/breaker
        plus the routing counters. Healthy while ANY backend (replica or
        primary) can take traffic — the tier is degraded-not-down by
        design."""

        def probe():
            with self._lock:
                snap = dict(self._health)
            backends = {}
            any_replica = False
            for be in self.replicas:
                healthy, lag, load, cover, t = snap.get(
                    be.id, (False, 0, 0.0, None, 0.0))
                state = self.breaker.state_of(be.id)
                if healthy and state != OPEN:
                    any_replica = True
                backends[be.id] = {
                    "healthy": healthy,
                    "replication_lag": lag,
                    "load_score": load,
                    "gid_capacity": cover,
                    "breaker": state,
                }
            primary_ok = True
            ph = getattr(self.primary, "health", None)
            if ph is not None:
                try:
                    primary_ok = bool(ph()[0])
                except Exception:  # noqa: BLE001 - unreachable == down
                    primary_ok = False
            payload = {
                "role": "router",
                "primary": self.primary.id,
                "primary_healthy": primary_ok,
                "backends": backends,
                "counters": dict(self.metrics.counters),
            }
            return any_replica or primary_ok, payload

        return probe
