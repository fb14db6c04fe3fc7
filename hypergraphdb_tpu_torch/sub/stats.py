"""Subscription metrics: the ``sub.*`` dotted namespace.

The port of ``hypergraphdb_tpu/sub/stats.py``: one façade over an
:class:`hypergraphdb_tpu_torch.obs.registry.Registry` in the
``serve/stats.py`` mold. Every fixed name is committed in
:data:`DOTTED_NAMES`, counters are registered eagerly so a scrape sees
the whole family before the first subscription, and the ``record_*``
methods serialize on one coherence lock so the accounting identities
(``notified + shed`` vs enqueued, ``evals + eval_errors`` vs rounds) hold
in every snapshot.

The port counts two failures the reference logs and drops:
``sub.pump_errors``, an evaluator round that raised on the runtime's
dispatch thread, and ``sub.listener_errors``, a graph-event listener that
raised (every subscription is then marked dirty, so the next round
re-evaluates them all). Safe from the dispatch thread, the graph-event
listeners and handler threads concurrently.
"""

from __future__ import annotations

import threading
from typing import Optional

from hypergraphdb_tpu_torch.obs.registry import Registry

#: every fixed ``sub.*`` name this façade registers: the reference's, then
#: the port's two error counters
DOTTED_NAMES = (
    "sub.subscribed",
    "sub.unsubscribed",
    "sub.active",
    "sub.eval_rounds",
    "sub.evals",
    "sub.eval_errors",
    "sub.dirty_skipped",
    "sub.full_fallbacks",
    "sub.notified",
    "sub.shed",
    "sub.resyncs",
    "sub.polls",
    "sub.queue_depth",
    "sub.staleness_seconds",
    "sub.pump_errors",
    "sub.listener_errors",
)


class SubStats:
    """Thread-safe metrics surface for one
    :class:`~hypergraphdb_tpu_torch.sub.manager.SubscriptionManager`."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry if registry is not None else Registry()
        self._lock = threading.Lock()
        r = self.registry
        self._subscribed = r.counter("sub.subscribed")
        self._unsubscribed = r.counter("sub.unsubscribed")
        self._active = r.gauge("sub.active")
        self._eval_rounds = r.counter("sub.eval_rounds")
        self._evals = r.counter("sub.evals")
        self._eval_errors = r.counter("sub.eval_errors")
        self._dirty_skipped = r.counter("sub.dirty_skipped")
        self._full_fallbacks = r.counter("sub.full_fallbacks")
        self._notified = r.counter("sub.notified")
        self._shed = r.counter("sub.shed")
        self._resyncs = r.counter("sub.resyncs")
        self._polls = r.counter("sub.polls")
        self._queue_depth = r.gauge("sub.queue_depth")
        self._staleness = r.gauge("sub.staleness_seconds")
        self._pump_errors = r.counter("sub.pump_errors")
        self._listener_errors = r.counter("sub.listener_errors")
        self._own = (
            self._subscribed, self._unsubscribed, self._active,
            self._eval_rounds, self._evals, self._eval_errors,
            self._dirty_skipped, self._full_fallbacks, self._notified,
            self._shed, self._resyncs, self._polls, self._queue_depth,
            self._staleness, self._pump_errors, self._listener_errors,
        )

    def reset(self) -> None:
        """Zero this façade's instruments only — foreign subsystems on a
        shared registry survive (the serve-stats discipline)."""
        with self._lock:
            for m in self._own:
                m.reset()

    # -- recording ------------------------------------------------------------
    def record_subscribe(self, active: int) -> None:
        with self._lock:
            self._subscribed.inc()
            self._active.set(active)

    def record_unsubscribe(self, active: int) -> None:
        with self._lock:
            self._unsubscribed.inc()
            self._active.set(active)

    def record_eval_round(self, submitted: int, skipped: int) -> None:
        """One pump round: ``submitted`` dirty subscriptions re-entered
        the serve lanes, ``skipped`` clean ones did NOT re-evaluate —
        the incremental tier's whole point, so it is counted as
        evidence (``sub.dirty_skipped``)."""
        with self._lock:
            self._eval_rounds.inc()
            if skipped:
                self._dirty_skipped.inc(skipped)

    def record_eval(self) -> None:
        with self._lock:
            self._evals.inc()

    def record_eval_error(self) -> None:
        with self._lock:
            self._eval_errors.inc()

    def record_full_fallback(self) -> None:
        """A truncated lane result forced an exact full host
        re-evaluation for one subscription."""
        with self._lock:
            self._full_fallbacks.inc()

    def record_pump_error(self) -> None:
        """An evaluator round raised on the runtime's dispatch thread."""
        with self._lock:
            self._pump_errors.inc()

    def record_listener_error(self) -> None:
        """A graph-event listener raised; every subscription went dirty."""
        with self._lock:
            self._listener_errors.inc()

    def record_notify(self) -> None:
        with self._lock:
            self._notified.inc()

    def record_shed(self, n: int = 1) -> None:
        with self._lock:
            self._shed.inc(n)

    def record_resync(self) -> None:
        with self._lock:
            self._resyncs.inc()

    def record_poll(self) -> None:
        with self._lock:
            self._polls.inc()

    def set_queue_depth(self, depth: int) -> None:
        self._queue_depth.set(depth)

    def set_staleness(self, seconds: float) -> None:
        self._staleness.set(seconds)

    # -- reading --------------------------------------------------------------
    @property
    def subscribed(self) -> int:
        return self._subscribed.value

    @property
    def active(self) -> int:
        return int(self._active.value)

    @property
    def evals(self) -> int:
        return self._evals.value

    @property
    def eval_rounds(self) -> int:
        return self._eval_rounds.value

    @property
    def dirty_skipped(self) -> int:
        return self._dirty_skipped.value

    @property
    def full_fallbacks(self) -> int:
        return self._full_fallbacks.value

    @property
    def pump_errors(self) -> int:
        return self._pump_errors.value

    @property
    def listener_errors(self) -> int:
        return self._listener_errors.value

    @property
    def eval_errors(self) -> int:
        return self._eval_errors.value

    @property
    def notified(self) -> int:
        return self._notified.value

    @property
    def shed(self) -> int:
        return self._shed.value

    @property
    def resyncs(self) -> int:
        return self._resyncs.value

    def snapshot(self) -> dict:
        """One coherent dotted-name snapshot (the drift gate asserts its
        keys equal :data:`DOTTED_NAMES`)."""
        with self._lock:
            return {
                "sub.subscribed": self._subscribed.value,
                "sub.unsubscribed": self._unsubscribed.value,
                "sub.active": self._active.value,
                "sub.eval_rounds": self._eval_rounds.value,
                "sub.evals": self._evals.value,
                "sub.eval_errors": self._eval_errors.value,
                "sub.dirty_skipped": self._dirty_skipped.value,
                "sub.full_fallbacks": self._full_fallbacks.value,
                "sub.notified": self._notified.value,
                "sub.shed": self._shed.value,
                "sub.resyncs": self._resyncs.value,
                "sub.polls": self._polls.value,
                "sub.queue_depth": self._queue_depth.value,
                "sub.staleness_seconds": self._staleness.value,
                "sub.pump_errors": self._pump_errors.value,
                "sub.listener_errors": self._listener_errors.value,
            }
