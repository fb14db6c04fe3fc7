"""Per-key circuit breaker: trip to a degraded path, probe, recover.

The serving runtime keys one breaker gate per batch key (the "bucket" of
kernel statics): ``K`` consecutive device failures for a key trip its
gate OPEN, and while open every batch of that key routes to the exact
host-fallback path — a flaky device degrades *throughput*, never
*answers*. After ``cooldown_s`` the gate half-opens and releases ONE
probe batch to the device; a probe success closes the gate (device
serving resumes), a probe failure re-opens it for another cooldown. A
probe that never reports (lost batch) does not wedge the gate: another
probe is released once a further cooldown elapses.

States and the numeric codes the ``serve.breaker_state`` gauge exports::

    closed (0)  --K consecutive failures-->  open (2)
    open   (2)  --cooldown elapsed------->  half_open (1), one probe out
    half_open   --probe success---------->  closed (0)
    half_open   --probe failure---------->  open (2)

Lock discipline: one lock guards all gates; the ``on_state`` /
``on_trip`` / ``on_key_state`` / ``on_key_trip`` callbacks run UNDER it,
so state-change notifications are serialized in transition order — two
racing transitions can never apply their gauge writes reversed and leave
``serve.breaker_state`` stale. Callbacks must therefore be cheap
instrument writes (the wired ones are: a gauge set / counter inc, each
behind its own leaf lock; nothing takes the breaker lock while holding
an instrument lock, so the one-way nesting is HG401-clean) and must
never call back into the breaker.

Observability: every transition lands one event in the process flight
recorder; a trip is an **incident** (the recorder dumps its window —
rate-limited file IO on an already-degraded path, the one deliberate
exception to "callbacks are leaf instrument writes").
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from hypergraphdb_tpu_torch.obs.flight import global_flight

_FLIGHT = global_flight()

CLOSED = "closed"
HALF_OPEN = "half_open"
OPEN = "open"

#: state → exported gauge code (ordered by badness; the gauge publishes
#: the WORST code across keys, so "anything open?" is one scrape)
STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class _Gate:
    __slots__ = ("state", "failures", "opened_t", "probe_t")

    def __init__(self) -> None:
        self.state = CLOSED
        self.failures = 0          # consecutive failures while closed
        self.opened_t = 0.0        # when the gate last opened
        self.probe_t: Optional[float] = None  # when a probe was released


class CircuitBreaker:
    """Keyed breaker gates; see module docstring for the state machine."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 0.25,
                 clock: Optional[Callable[[], float]] = None,
                 on_state: Optional[Callable[[int], None]] = None,
                 on_trip: Optional[Callable[[], None]] = None,
                 on_key_state: Optional[Callable] = None,
                 on_key_trip: Optional[Callable] = None):
        if threshold < 1:
            raise ValueError("breaker threshold must be >= 1")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock or time.monotonic
        self.on_state = on_state      # worst STATE_CODES value, post-change
        self.on_trip = on_trip        # called on every -> OPEN transition
        #: per-key views (the labelled metrics): (key, STATE_CODES value)
        #: after every transition of THAT key / (key,) on its trips
        self.on_key_state = on_key_state
        self.on_key_trip = on_key_trip
        self._lock = threading.Lock()
        self._gates: dict = {}
        self._trips = 0

    # -- the dispatch-side queries -------------------------------------------
    def allow(self, key) -> bool:
        """May the next batch for ``key`` touch the device? OPEN gates say
        no (host fallback); a HALF_OPEN gate says yes exactly once per
        cooldown window (the probe)."""
        with self._lock:
            g = self._gates.get(key)
            if g is None or g.state == CLOSED:
                return True
            now = self.clock()
            if g.state == OPEN:
                if now - g.opened_t < self.cooldown_s:
                    return False
                g.state = HALF_OPEN
                g.probe_t = now
                self._notify_locked(key, g)
                return True
            # HALF_OPEN: one probe per cooldown window
            if g.probe_t is not None and now - g.probe_t < self.cooldown_s:
                return False
            g.probe_t = now
            return True

    def record_success(self, key) -> None:
        """A device batch for ``key`` completed: close the gate."""
        with self._lock:
            g = self._gates.get(key)
            if g is not None and (g.state != CLOSED or g.failures):
                notify = g.state != CLOSED
                g.state = CLOSED
                g.failures = 0
                g.probe_t = None
                if notify:
                    self._notify_locked(key, g)

    def reset(self, key) -> None:
        """Administratively close ``key``'s gate NOW — the rejoin path:
        a router whose health poll sees a previously-dead replica
        answering again re-admits it immediately instead of waiting out
        the cooldown + probe ladder. Notifies like any transition."""
        with self._lock:
            g = self._gates.get(key)
            if g is not None and (g.state != CLOSED or g.failures):
                notify = g.state != CLOSED
                g.state = CLOSED
                g.failures = 0
                g.probe_t = None
                if notify:
                    self._notify_locked(key, g)

    def record_failure(self, key) -> None:
        """A device batch for ``key`` failed (launch or collect)."""
        with self._lock:
            g = self._gates.get(key)
            if g is None:
                g = self._gates[key] = _Gate()
            if g.state == HALF_OPEN:
                # the probe failed: straight back to OPEN
                g.state = OPEN
                g.opened_t = self.clock()
                g.probe_t = None
                self._trips += 1
                self._notify_locked(key, g, tripped=True)
            elif g.state == CLOSED:
                g.failures += 1
                if g.failures >= self.threshold:
                    g.state = OPEN
                    g.opened_t = self.clock()
                    self._trips += 1
                    self._notify_locked(key, g, tripped=True)
            # OPEN: late failures from in-flight batches change nothing

    def _notify_locked(self, key, gate: _Gate,
                       tripped: bool = False) -> None:
        """State-change callbacks, serialized by the caller-held lock
        (see module docstring for why and what callbacks may do).
        Also the flight-recorder tap: one ring append per transition,
        incident (rate-limited dump) on every trip."""
        if _FLIGHT.enabled:
            _FLIGHT.record("breaker.transition", key=str(key),
                           state=gate.state)
        if self.on_state is not None:
            self.on_state(self._worst_locked())
        if self.on_key_state is not None:
            self.on_key_state(key, STATE_CODES[gate.state])
        if tripped:
            if self.on_trip is not None:
                self.on_trip()
            if self.on_key_trip is not None:
                self.on_key_trip(key)
            if _FLIGHT.enabled:
                _FLIGHT.incident("breaker_trip", key=str(key))

    # -- reading -------------------------------------------------------------
    def peek(self, key) -> bool:
        """Would :meth:`allow` admit ``key`` right now — WITHOUT
        consuming the half-open probe token or transitioning the gate?
        For placement-style callers that rank candidates they may never
        dispatch to: burning the one-probe-per-cooldown token on a
        backend the request doesn't reach would starve its actual
        recovery probe. The dispatcher calls :meth:`allow` immediately
        before committing."""
        with self._lock:
            g = self._gates.get(key)
            if g is None or g.state == CLOSED:
                return True
            now = self.clock()
            if g.state == OPEN:
                return now - g.opened_t >= self.cooldown_s
            # HALF_OPEN: a fresh probe window admits one
            return g.probe_t is None or now - g.probe_t >= self.cooldown_s

    def state_of(self, key) -> str:
        with self._lock:
            g = self._gates.get(key)
            return CLOSED if g is None else g.state

    def states(self) -> dict:
        """Every key's current gate state — the per-key ``/healthz``
        view (keys with no gate yet have implicitly closed gates and do
        not appear)."""
        with self._lock:
            return {k: g.state for k, g in self._gates.items()}

    def worst_code(self) -> int:
        with self._lock:
            return self._worst_locked()

    @property
    def trips(self) -> int:
        with self._lock:
            return self._trips

    def _worst_locked(self) -> int:
        return max(
            (STATE_CODES[g.state] for g in self._gates.values()),
            default=0,
        )
