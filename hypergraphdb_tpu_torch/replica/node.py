"""ReplicaNode: an ingest-following peer that SERVES.

Lifecycle (the bootstrap → follow → serve chain)::

    node = ReplicaNode(graph, peer, ReplicaConfig(primary="primary-id"))
    node.start()          # 1. bootstrap  2. follow  3. serve
    fut = node.runtime.submit_bfs(seed)     # reads, lag-bounded
    node.stop()

1. **bootstrap** — publish a full interest (pushes start flowing at
   once, applied idempotently), then pull the primary's whole graph via
   the resumable snapshot transfer (``peer/transfer`` + ``cact``). A
   node whose SeenMap already anchors the primary (a REJOIN after a
   crash or restart) skips the transfer and resumes by incremental
   catch-up — unless the primary's log truncated past it
   (``needs_full_sync``), which forces the clean re-bootstrap.
2. **follow** — replication pushes + gap-aware catch-up keep the local
   graph converging; a periodic anti-entropy digest probe is the
   backstop for losses no later push ever reveals.
3. **serve** — the node's own :class:`~hypergraphdb_tpu_torch.serve.ServeRuntime`
   answers reads over the LOCAL graph. The runtime's ``admission_gate``
   is wired to the replication lag: a replica more than
   ``max_replication_lag`` log entries behind the primary refuses with
   :class:`~hypergraphdb_tpu_torch.serve.AdmissionGated` — the cross-process
   mirror of the single-node ``max_lag_edges`` staleness contract
   (bounded-stale inside one process, bounded-lag across processes;
   both bound how far an answer may trail the ingest front).

``/healthz``: :meth:`ReplicaNode.health_probe` stacks the replica story
(role, advertised lag, lag bound, bootstrap state) on top of the
standard :func:`~hypergraphdb_tpu_torch.obs.http.runtime_health` breaker/queue
view via :func:`~hypergraphdb_tpu_torch.obs.http.composite_health` — the
fields the front door's placement reads (``replication_lag``,
``read_gate``) ride the same JSON body an operator already scrapes.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from hypergraphdb_tpu_torch.obs.http import (
    HealthProbe,
    composite_health,
    runtime_health,
)
from hypergraphdb_tpu_torch.serve import ServeConfig, ServeRuntime


@dataclass
class ReplicaConfig:
    """Knobs of one replica node."""

    #: the primary's peer identity (who to bootstrap from and follow)
    primary: str
    #: reads gate once the replica trails the primary's log by more
    #: than this many entries — the staleness contract across processes
    max_replication_lag: int = 256
    #: anti-entropy digest cadence (0 disables the loop; gap repair via
    #: contiguity tracking still runs on every apply cycle)
    anti_entropy_interval_s: float = 0.5
    bootstrap_page: int = 256
    bootstrap_timeout_s: float = 120.0
    #: snapshot-transfer stall watchdog: re-pull after this much silence,
    #: up to ``bootstrap_max_resumes`` consecutive no-progress resumes
    #: before the bootstrap fails typed (``TransientFault``) — the knobs
    #: of :meth:`~hypergraphdb_tpu_torch.peer.peer.HyperGraphPeer.transfer_graph_from`
    bootstrap_retry_after_s: float = 1.0
    bootstrap_max_resumes: int = 8
    #: serving knobs for the node's own runtime (``admission_gate`` is
    #: overwritten with the replica's lag gate); its ``device`` is the
    #: card unless the caller asks for ``"cpu"``
    serve: ServeConfig = field(default_factory=ServeConfig)
    #: stand up the node's standing-query tier (a
    #: :class:`~hypergraphdb_tpu_torch.sub.SubscriptionManager` attached to
    #: the runtime, anchored at the replication log position so a
    #: subscription's resume seq is comparable across the tier)
    subscriptions: bool = True
    #: :class:`~hypergraphdb_tpu_torch.sub.SubConfig` overrides (None =
    #: defaults)
    sub: Optional[object] = None


class ReplicaNode:
    """One replica: graph + following peer + lag-gated serve runtime.

    The ``peer`` is constructed by the caller (loopback for tests, TCP
    for deployments) and must NOT be started — :meth:`start` owns the
    whole lifecycle so the bootstrap ordering is right."""

    def __init__(self, graph, peer, config: ReplicaConfig):
        self.graph = graph
        self.peer = peer
        self.config = config
        self.runtime: Optional[ServeRuntime] = None
        #: the node's standing-query manager (None until started, or
        #: when ``config.subscriptions`` is off)
        self.subscriptions = None
        self.bootstrapped = False
        #: how the last bootstrap ran: "transfer" (full snapshot pull)
        #: or "resume" (incremental catch-up from the persisted clock)
        self.bootstrap_mode: Optional[str] = None
        self._ae_stop = threading.Event()
        self._ae_thread: Optional[threading.Thread] = None
        self._started = False
        #: at most one re-bootstrap RUN at a time (AE loop vs the read
        #: gate's lazy kick — whoever loses the race is a no-op)
        self._repair_gate = threading.Lock()
        #: guards only the spawn check-and-set (never held across the
        #: repair itself — the read gate must stay non-blocking)
        self._repair_spawn_lock = threading.Lock()
        self._repair_thread: Optional[threading.Thread] = None
        #: leaf lock for the node's shared state words (``bootstrapped``,
        #: ``bootstrap_mode``, ``runtime``, ``_started``, ``_ae_thread``)
        #: — written from the caller, AE, and repair threads; held only
        #: across the assignment, never across blocking work
        self._state_lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ReplicaNode":
        if self._started:
            return self
        self._ae_stop.clear()  # a restarted node may kick repairs again
        self.peer.start()
        try:
            self._bootstrap()
            cfg = dataclasses.replace(self.config.serve,
                                      admission_gate=self._read_gate)
            rt = ServeRuntime(self.graph, cfg)
            with self._state_lock:
                self.runtime = rt
            if self.config.subscriptions:
                from hypergraphdb_tpu_torch.sub import SubscriptionManager

                rep = self.peer.replication
                primary = self.config.primary
                # anchor standing queries at the REPLICATION log
                # position: the seq a notification carries is the same
                # coordinate on every node, which is what lets the
                # front door resume a subscription on another backend
                sub = SubscriptionManager(
                    self.graph, rt, self.config.sub,
                    seq_source=lambda: rep.last_seen.get(primary),
                )
                rt.attach_subscriptions(sub)
                with self._state_lock:
                    self.subscriptions = sub
        except BaseException:
            # a failed bootstrap must not leak a started peer (worker
            # threads, transport, a published interest the primary keeps
            # pushing to) — stop() is a no-op until _started flips
            try:
                if self.subscriptions is not None:
                    self.subscriptions.close()
                    with self._state_lock:
                        self.subscriptions = None
                if self.runtime is not None:
                    self.runtime.close(drain=False)
                    with self._state_lock:
                        self.runtime = None
            finally:
                self.peer.stop()
            raise
        t = None
        if self.config.anti_entropy_interval_s > 0:
            self._ae_stop.clear()
            t = threading.Thread(
                target=self._anti_entropy_loop,
                name=f"replica-ae-{self.peer.identity[:8]}", daemon=True,
            )
        with self._state_lock:
            self._ae_thread = t
            self._started = True
        if t is not None:
            t.start()
        return self

    def stop(self, drain: bool = True) -> None:
        with self._state_lock:
            if not self._started:
                return
            self._started = False
            ae, self._ae_thread = self._ae_thread, None
        self._ae_stop.set()
        if ae is not None:
            ae.join(timeout=5)
        with self._repair_spawn_lock:
            t = self._repair_thread
        if t is not None:
            # a kicked repair mid-flight: give it a bounded window; a
            # transfer that outlives it keeps running on the daemon
            # thread against the stopping peer and fails typed there
            t.join(timeout=5)
        if self.subscriptions is not None:
            # before the runtime: close wakes parked polls and stops new
            # evals, so the runtime's drain isn't fed by a dying tier
            self.subscriptions.close()
        if self.runtime is not None:
            self.runtime.close(drain=drain)
        self.peer.stop()

    def __enter__(self) -> "ReplicaNode":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- bootstrap -----------------------------------------------------------
    def _bootstrap(self) -> None:
        rep = self.peer.replication
        primary = self.config.primary
        # interest FIRST: pushes committed while the snapshot streams
        # arrive immediately and apply idempotently (gid write-through),
        # shrinking the catch-up tail to whatever raced the eof
        rep.publish_interest(None)
        resume = (rep.last_seen.get(primary) > 0
                  and primary not in rep.needs_full_sync)
        if resume:
            # rejoin: the persisted clock anchors incremental catch-up —
            # no multi-MB re-transfer for a bounced process
            with self._state_lock:
                self.bootstrap_mode = "resume"
            if not rep.catch_up(primary):
                # resume's ONLY wake-up signal: the request never left
                # (reliable-send budget spent). Swallowing it would park
                # the node gated at "head unknown" until an unrelated
                # push happens by — fail the bootstrap typed instead so
                # the caller's retry policy owns it
                from hypergraphdb_tpu_torch.fault import TransientFault

                raise TransientFault(
                    f"resume catch-up could not reach {primary!r}")
        else:
            self.peer.transfer_graph_from(
                primary, page=self.config.bootstrap_page,
                timeout=self.config.bootstrap_timeout_s,
                retry_after_s=self.config.bootstrap_retry_after_s,
                max_resumes=self.config.bootstrap_max_resumes,
            )
            with self._state_lock:
                self.bootstrap_mode = "transfer"
            # the tail committed during the transfer: a lost send here is
            # non-fatal — the clock is anchored at the server's head, so
            # lag stays visible and pushes/anti-entropy heal the tail
            rep.catch_up(primary)
        with self._state_lock:
            self.bootstrapped = True

    # -- the staleness contract ----------------------------------------------
    @property
    def replication_lag(self) -> int:
        """Log entries the primary is known to be ahead of this replica."""
        return self.peer.replication.replication_lag(self.config.primary)

    def _read_gate(self) -> Optional[str]:
        """The serve runtime's admission gate: None admits; a reason
        string refuses typed. Bounded-lag reads are the contract — a
        refusal here is the router's cue to place the request on a
        fresher replica (or the primary), never a caller-visible error."""
        if self.config.primary in self.peer.replication.needs_full_sync:
            # the mark must be actionable even with the AE loop disabled
            # (anti_entropy_interval_s=0) — otherwise a truncated-past
            # replica wedges gated forever with nobody left to repair
            # it. Checked BEFORE ``bootstrapped`` so a FAILED repair
            # (mark survives, bootstrapped stays False) re-kicks on the
            # next gated read instead of wedging behind the
            # "bootstrapping" answer.
            self._kick_rebootstrap()
            return "replica diverged (primary log truncated); re-bootstrapping"
        if not self.bootstrapped:
            return "replica bootstrapping"
        if (self.bootstrap_mode == "resume" and self.config.primary
                not in self.peer.replication.peer_heads):
            # a resumed replica hasn't heard the primary's head THIS
            # incarnation (peer_heads is per-process; the resume
            # condition guarantees the primary's head is nonzero, so
            # push/catch-up/digest metadata will fill it) — until then
            # replication_lag reads 0 no matter how far behind we are,
            # and admitting would serve unboundedly stale data at an
            # advertised lag of 0. Transfer mode re-anchors at the
            # server's head on resolve, so it is exempt.
            return "replication head unknown since restart"
        lag = self.replication_lag
        if lag > self.config.max_replication_lag:
            return (f"replication lag {lag} exceeds bound "
                    f"{self.config.max_replication_lag}")
        return None

    def wait_converged(self, timeout: float = 30.0,
                       poll_s: float = 0.02) -> bool:
        """Block until the advertised lag reaches 0 and both replication
        pipelines are drained (tests / controlled failover)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            # the full read gate (not just lag == 0): a resumed replica
            # reads lag 0 until the primary's head arrives — converged
            # means ADMITTING, at an actual lag of zero
            if (self._read_gate() is None and self.replication_lag == 0
                    and self.peer.replication.flush(timeout=max(
                        0.1, deadline - time.monotonic()))):
                if (self._read_gate() is None
                        and self.replication_lag == 0):
                    return True
            time.sleep(poll_s)
        return False

    # -- health ---------------------------------------------------------------
    def health_probe(self) -> HealthProbe:
        """The replica's ``/healthz`` surface: the standard runtime view
        (per-key breaker states, queue depth, delta staleness) PLUS the
        replica fields the front door's placement reads. Unhealthy while
        bootstrapping or past the lag bound — a load balancer sees 503
        exactly when the router would refuse to place reads here."""

        def replica_probe():
            lag = self.replication_lag
            gate = self._read_gate()
            payload = {
                "role": "replica",
                "primary": self.config.primary,
                "peer_id": self.peer.identity,
                "replication_lag": lag,
                "lag_bound": self.config.max_replication_lag,
                "bootstrapped": self.bootstrapped,
                "bootstrap_mode": self.bootstrap_mode,
            }
            if gate is not None:
                payload["read_gate"] = gate
            sub = self.subscriptions
            if sub is not None:
                # the standing-query story rides the same body the
                # fleet SLO tier scrapes (the ``sub_staleness``
                # objective reads ``sub.violating``)
                payload["sub"] = sub.health_section()
            return gate is None, payload

        if self.runtime is None:
            return replica_probe
        return composite_health(runtime_health(self.runtime), replica_probe)

    # -- fleet observability ---------------------------------------------------
    def fleet_source(self, node_id: Optional[str] = None):
        """This replica as a
        :class:`~hypergraphdb_tpu_torch.obs.fleet.LocalNodeSource` (same-
        process fleets / tests; a real deployment registers the node's
        TelemetryServer URL as an
        :class:`~hypergraphdb_tpu_torch.obs.fleet.HTTPNodeSource` instead):
        serve + graph registries, the runtime's tracer, the process
        flight recorder, and the composite health probe the front door
        already reads."""
        from hypergraphdb_tpu_torch.obs.fleet import LocalNodeSource
        from hypergraphdb_tpu_torch.obs.flight import global_flight

        rt = self.runtime
        regs = [] if rt is None else [rt.stats.registry]
        gm = getattr(self.graph, "metrics", None)
        if gm is not None:
            regs.append(gm.registry)
        return LocalNodeSource(
            node_id or self.peer.identity, registries=regs,
            tracer=None if rt is None else rt.tracer,
            flight=global_flight(), health=self.health_probe(),
            role="replica",
        )

    # -- follow ---------------------------------------------------------------
    def _anti_entropy_loop(self) -> None:
        """The backstop convergence prod: a digest probe every interval.
        Cheap enough to leave on (ints on the wire); the response path
        triggers catch-up only when the digest disagrees. When a digest
        (or empty catch-up page) reveals the primary truncated past us
        (``needs_full_sync``), the loop runs the clean re-bootstrap IN
        PLACE — without it a long-partitioned replica would wedge
        permanently gated, since :meth:`start` is the only other reader
        of the mark. A probe or repair that raises is counted
        (``replica.anti_entropy_errors``) and the loop lives on."""
        while not self._ae_stop.wait(self.config.anti_entropy_interval_s):
            try:
                if self.config.primary in \
                        self.peer.replication.needs_full_sync:
                    self._rebootstrap()
                else:
                    self.peer.replication.anti_entropy(self.config.primary)
            except Exception:  # noqa: BLE001 - counted; the loop lives on
                # the reference logs and drops this: counted here, in the
                # graph's metrics beside the peer plane's own counters
                self.graph.metrics.incr("replica.anti_entropy_errors")

    def _kick_rebootstrap(self) -> None:
        """Start :meth:`_rebootstrap` on a background thread unless one
        is already running — the read gate's path for a replica whose AE
        loop is disabled (and a harmless no-op when the loop exists and
        gets there first)."""
        with self._repair_spawn_lock:
            if not self._started or self._ae_stop.is_set():
                return  # stopping/stopped: no new repairs
            if (self._repair_thread is not None
                    and self._repair_thread.is_alive()):
                return
            self._repair_thread = t = threading.Thread(
                target=self._rebootstrap,
                name=f"replica-repair-{self.peer.identity[:8]}",
                daemon=True,
            )
        t.start()

    def _rebootstrap(self) -> None:
        """Runtime re-bootstrap (AE thread or the read gate's kick):
        incremental repair cannot converge once the primary's log
        truncated past us, so gate reads (``bootstrapped`` drives
        :meth:`_read_gate`) and pull a fresh snapshot. A completed
        transfer clears ``needs_full_sync`` and re-anchors the
        replication clock at the server's head; on failure the mark
        survives and the next tick (or gated read) retries — reads stay
        gated the whole time (a diverged replica must not serve). At
        most one runs at a time; a concurrent entrant no-ops."""
        if not self._repair_gate.acquire(blocking=False):
            return  # a repair is already in flight
        try:
            rep = self.peer.replication
            with self._state_lock:
                self.bootstrapped = False
            try:
                self.peer.transfer_graph_from(
                    self.config.primary, page=self.config.bootstrap_page,
                    timeout=self.config.bootstrap_timeout_s,
                    retry_after_s=self.config.bootstrap_retry_after_s,
                    max_resumes=self.config.bootstrap_max_resumes,
                )
                rep.catch_up(self.config.primary)
                with self._state_lock:
                    self.bootstrap_mode = "transfer"
            finally:
                with self._state_lock:
                    self.bootstrapped = (
                        self.config.primary not in rep.needs_full_sync)
        finally:
            self._repair_gate.release()
