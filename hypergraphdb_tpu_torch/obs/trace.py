"""Request tracing: lightweight span trees with explicit parenting.

A :class:`Trace` is a bounded tree of :class:`Span` records, all stamped
by ONE injectable clock (fake clocks in tests make every duration exact).
Spans carry typed attributes; parenting is EXPLICIT (``parent=``) because
the span chains this repo cares about cross threads — a served request's
``submit`` span is opened on the caller's thread and its ``collect`` span
on the dispatch thread, so an implicit thread-local "current span" could
never link them. The in-tree producer (the query compiler's
``compile → plan → execute``) uses the explicit API; a
thread-local convenience layer (``Tracer.trace_ctx`` / ``Tracer.span``)
is offered for ad-hoc single-thread instrumentation.

Safety properties that make tracing reasonable to leave on:

- **off-gate**: ``Tracer.enabled`` is a plain attribute; every
  instrumentation site reads it (or a ``Ticket.trace is None`` it
  derives from) ONCE and allocates nothing when tracing is off;
- **span budget**: each trace records at most ``max_spans`` spans —
  overflow spans are counted in ``Trace.dropped`` and discarded, never
  accumulated (a pathological per-row instrumentation bug degrades to a
  counter, not an OOM);
- **bounded retention**: finished traces land in a ``maxlen`` deque on
  the tracer (``drain()`` hands them to the exporter); a server nobody
  scrapes stays O(max_finished), not O(requests);
- **head-based sampling** (production qps): per-root-kind sample rates
  (``set_sample_rate``) decide AT START whether a trace will be
  retained. Unsampled traces still record spans (bounded as above) but
  are discarded at finish — unless something upgrades them: the
  ``error``/``shed`` terminals and explicit :meth:`Trace.force_sample`
  calls (breaker trips) always retain, so incidents are captured at
  100% no matter how low the rate. An optional adaptive controller
  (:meth:`Tracer.enable_adaptive`) scales every rate down when the
  finished-trace buffer fills faster than it is drained, and back up
  when pressure clears — always-on tracing degrades to a lower rate,
  never to buffer overflow.

**Cross-process propagation**: :meth:`Trace.context` emits a compact
wire context ``{"tid", "sid", "s"}`` (trace id, parent span id, sampling
decision); :meth:`Tracer.start_remote_trace` opens the receiving side's
trace UNDER that context — same trace id, root spans parented on the
propagated remote span id, the sender's sampling decision honored — so a
replication push or snapshot transfer renders as ONE span tree spanning
sender and receiver (join the two tracers' drains on ``trace_id``).
Trace ids carry a per-process random high-bits base, so trees from two
real processes cannot collide.

The tests drive everything with a fake clock and zero device work.
"""

from __future__ import annotations

import itertools
import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Optional

from hypergraphdb_tpu_torch.obs.flight import global_flight as _global_flight

#: injectable time source (seconds, monotonic) — tests pass a fake
Clock = Callable[[], float]

#: attribute value types the JSONL exporter commits to (schema v1)
ATTR_TYPES = (bool, int, float, str, type(None))

#: terminal span names that force-sample their trace (the always-capture
#: set: a failed or shed request is exactly the trace worth keeping)
ALWAYS_SAMPLE_TERMINALS = frozenset({"error", "shed"})

_ids = itertools.count(1)

#: per-process random high bits for trace AND span ids: a joined
#: cross-process tree is reconstructed by (trace id, parent span id), so
#: BOTH key spaces must be collision-free across processes — a server
#: span whose local id equals the client's propagated parent id would
#: misattach the remote subtree. FULL 128-BIT ids (86 random high bits
#: over a 42-bit per-process counter): a multi-chip pod puts many
#: processes behind ONE collector, and the former 62-bit space made
#: cross-process collisions merely improbable instead of negligible —
#: the id-width change is the trace-record schema v2 bump
#: (``obs.export.TRACE_SCHEMA_VERSION``)
_TRACE_ID_BASE = random.SystemRandom().getrandbits(86) << 42

_FLIGHT = _global_flight()


class Span:
    """One timed node of a trace tree. ``t1 is None`` while open."""

    __slots__ = ("span_id", "parent_id", "name", "t0", "t1", "attrs",
                 "_trace")

    def __init__(self, trace: "Trace", name: str,
                 parent_id: Optional[int], t0: float, attrs: dict):
        self.span_id = _TRACE_ID_BASE + next(_ids)
        self.parent_id = parent_id
        self.name = name
        self.t0 = t0
        self.t1: Optional[float] = None
        self.attrs = attrs
        self._trace = trace

    def set(self, **attrs) -> "Span":
        """Attach typed attributes (scalars only — the exporter's schema)."""
        for k, v in attrs.items():
            if not isinstance(v, ATTR_TYPES):
                raise TypeError(
                    f"span attr {k}={v!r}: only scalars are exportable"
                )
            self.attrs[k] = v
        return self

    def end(self, t1: Optional[float] = None) -> "Span":
        """Close the span (idempotent — the first end wins). Taken under
        the trace lock so the cross-thread race the serve path relies on
        (submitter ends ``submit`` while the dispatch thread's ``finish``
        closes everything) really is first-end-wins, not check-then-act."""
        tr = self._trace
        with tr._lock:
            if self.t1 is None:
                self.t1 = tr.clock() if t1 is None else t1
        return self

    @property
    def duration(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, id={self.span_id}, "
                f"parent={self.parent_id}, t0={self.t0}, t1={self.t1})")


class Trace:
    """A bounded span tree plus free-form ``marks`` (caller-owned refs to
    spans left open across threads, e.g. the serve path's ``queue_wait``).

    Thread-safe: one lock guards the span list and the budget counter —
    a served request's spans are appended from both the submitting and
    the dispatching thread."""

    def __init__(self, name: str, clock: Clock, max_spans: int,
                 attrs: Optional[dict] = None,
                 owner: Optional["Tracer"] = None,
                 trace_id: Optional[int] = None,
                 remote_parent: Optional[int] = None,
                 sampled: bool = True):
        self.name = name
        self.clock = clock
        self.max_spans = max_spans
        self._owner = owner
        self.attrs = dict(attrs or {})
        self.trace_id = (_TRACE_ID_BASE + next(_ids)
                         if trace_id is None else int(trace_id))
        #: propagated remote span id: parentless spans of this trace
        #: attach under it, so the receiver's subtree hangs off the
        #: sender's span in the joined tree (None for local roots)
        self.remote_parent = remote_parent
        #: head-based sampling decision — set at start, upgradable by
        #: force_sample(); unsampled traces are discarded at retain time
        self.sampled = sampled
        self.t0 = clock()
        self.t1: Optional[float] = None
        self.dropped = 0
        self.marks: dict = {}     # caller-owned cross-thread span refs
        self._lock = threading.Lock()
        self._spans: list[Span] = []
        self._finished = False

    # -- recording -----------------------------------------------------------
    def start_span(self, name: str, parent: Optional[Span] = None,
                   t0: Optional[float] = None, **attrs) -> Span:
        """Open a child span. Over-budget spans are counted and DISCARDED,
        and spans started after ``finish()`` (a cross-thread race: e.g. a
        submitter instrumenting a ticket the dispatch thread already
        resolved) are silently detached — the returned span is real but
        unrecorded in both cases, so call sites never branch."""
        span = Span(self, name,
                    self.remote_parent if parent is None else parent.span_id,
                    self.clock() if t0 is None else t0, {})
        if attrs:
            span.set(**attrs)
        with self._lock:
            if self._finished:
                pass  # already exported: never mutate a retained trace
            elif len(self._spans) < self.max_spans:
                self._spans.append(span)
            else:
                self.dropped += 1
        return span

    def add_span(self, name: str, t0: float, t1: float,
                 parent: Optional[Span] = None, **attrs) -> Span:
        """Record an already-timed interval (device timing hooks measure
        first, attribute after)."""
        return self.start_span(name, parent=parent, t0=t0, **attrs).end(t1)

    @contextmanager
    def span(self, name: str, parent: Optional[Span] = None, **attrs):
        sp = self.start_span(name, parent=parent, **attrs)
        try:
            yield sp
        finally:
            sp.end()

    def finish_terminal(self, name: str, parent: Optional[Span] = None,
                        **attrs) -> None:
        """Record a terminal span (``resolve`` / ``shed`` / ``error`` …)
        under ``parent`` (default: the ``root`` mark) and finish the
        trace — the ONE place the terminal-span schema lives, shared by
        the serve, query, compaction, and peer producers. The
        always-sample terminals (``error``/``shed``) upgrade an
        unsampled trace so incidents survive any sampling rate, and
        every terminal lands one event in the flight recorder. No-op on
        an already-finished trace."""
        if self.finished:
            return
        if name in ALWAYS_SAMPLE_TERMINALS:
            self.force_sample()
        if _FLIGHT.enabled:
            _FLIGHT.record("trace.terminal", trace=self.name,
                           terminal=name)
        self.start_span(
            name,
            parent=parent if parent is not None else self.marks.get("root"),
            **attrs,
        ).end()
        self.finish()

    def finish_error(self, exc: BaseException,
                     parent: Optional[Span] = None, **attrs) -> None:
        """The error terminal: span ``error`` with the exception's type
        name, then finish."""
        self.finish_terminal("error", parent=parent,
                             error=type(exc).__name__, **attrs)

    # -- lifecycle -----------------------------------------------------------
    def finish(self) -> bool:
        """Close the trace (idempotent) and hand it to the owning tracer's
        finished buffer. Returns True on the first call."""
        with self._lock:
            if self._finished:
                return False
            self._finished = True
            self.t1 = self.clock()
            for sp in self._spans:
                if sp.t1 is None:  # inline: Span.end takes THIS lock
                    sp.t1 = self.t1
        if self._owner is not None:
            self._owner._retain(self)
        return True

    @property
    def finished(self) -> bool:
        with self._lock:
            return self._finished

    def force_sample(self) -> None:
        """Upgrade the head-based sampling decision: retain this trace
        regardless of the rate it was started under (errors, sheds,
        breaker trips — the traces an operator is actually hunting)."""
        with self._lock:
            self.sampled = True

    # -- cross-process propagation -------------------------------------------
    def context(self, span: Optional[Span] = None) -> dict:
        """The compact wire context carried on peer messages:
        ``{"tid": trace id, "sid": parent span id, "s": sampled}``.
        ``span`` names the local span remote children should hang under
        (default: the ``root`` mark, else the propagated parent)."""
        if span is None:
            span = self.marks.get("root")
        sid = span.span_id if span is not None else (self.remote_parent or 0)
        with self._lock:
            s = 1 if self.sampled else 0
        return {"tid": self.trace_id, "sid": sid, "s": s}

    # -- reading -------------------------------------------------------------
    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def find(self, name: str) -> Optional[Span]:
        with self._lock:
            for sp in self._spans:
                if sp.name == name:
                    return sp
        return None

    def children_of(self, span: Optional[Span]) -> list[Span]:
        want = None if span is None else span.span_id
        with self._lock:
            return [s for s in self._spans if s.parent_id == want]


class Tracer:
    """The trace factory + finished-trace buffer. One per process by
    default (``hypergraphdb_tpu_torch.obs.tracer()``), instantiable for tests.

    ``enabled`` is the zero-cost gate: every ``start_trace`` caller checks
    it first (one attribute read); while False nothing is allocated and
    ``start_trace`` returns None.

    Sampling: ``default_sample_rate`` (1.0 = everything) with per-root-kind
    overrides (``set_sample_rate("serve.request", 0.01)``). The decision is
    made at ``start_trace`` (head-based) from a seeded RNG; unsampled
    traces still run (bounded) but are counted into ``traces_dropped``
    instead of retained — unless an always-sample terminal or
    ``force_sample()`` upgrades them. ``enable_adaptive()`` adds the rate
    controller: when the finished buffer fills past ``target_fill`` the
    effective rate scales down (never below ``floor``); a drain that finds
    the pressure gone scales it back up toward 1.0."""

    def __init__(self, clock: Optional[Clock] = None, max_spans: int = 64,
                 max_finished: int = 1024, seed: Optional[int] = None):
        self.clock: Clock = clock or time.perf_counter
        self.max_spans = max_spans
        self.enabled = False
        self.traces_started = 0
        #: unsampled traces discarded at finish (never buffered)
        self.traces_dropped = 0
        #: sampled traces that pushed the FULL buffer (oldest evicted) —
        #: nonzero means the scraper/drain cadence lost data
        self.traces_evicted = 0
        self.default_sample_rate = 1.0
        self._rates: dict[str, float] = {}
        self._rng = random.Random(seed)
        # adaptive controller state (None target = controller off).
        # PER-ROOT-KIND first: pressure halves the scale of the kind
        # holding the largest share of the finished buffer (the hot
        # kind), so replication-qps `peer.push` traces cannot starve
        # `serve.request`'s budget; the GLOBAL scale is the outer clamp,
        # halved only once the hot kind is already at its floor. The
        # effective scale never drops below the floor.
        self._adapt_target: Optional[float] = None
        self._adapt_floor = 0.01
        self._adapt_scale = 1.0
        self._adapt_kind_scales: dict[str, float] = {}
        #: finished-buffer composition by root kind (who is filling it)
        self._kind_fill: dict[str, int] = {}
        self._lock = threading.Lock()
        self._finished: deque[Trace] = deque(maxlen=max_finished)
        self._tls = threading.local()

    # -- lifecycle -----------------------------------------------------------
    def enable(self, clock: Optional[Clock] = None) -> "Tracer":
        with self._lock:
            if clock is not None:
                self.clock = clock
            self.enabled = True
        return self

    def disable(self) -> "Tracer":
        with self._lock:
            self.enabled = False
        return self

    # -- sampling knobs ------------------------------------------------------
    def set_sample_rate(self, name: str, rate: float) -> "Tracer":
        """Per-root-kind head sample rate (exact trace-name match, e.g.
        ``"serve.request"``); rates outside [0, 1] are clamped."""
        with self._lock:
            self._rates[name] = min(1.0, max(0.0, float(rate)))
        return self

    def sample_rate_of(self, name: str) -> float:
        """The EFFECTIVE rate for ``name``: configured × adaptive scale
        (per-kind × global, floored)."""
        with self._lock:
            return (self._rates.get(name, self.default_sample_rate)
                    * self._scale_locked(name))

    def _scale_locked(self, name: str) -> float:
        scale = self._adapt_scale * self._adapt_kind_scales.get(name, 1.0)
        if self._adapt_target is not None:
            scale = max(self._adapt_floor, scale)
        return scale

    def enable_adaptive(self, target_fill: float = 0.5,
                        floor: float = 0.01) -> "Tracer":
        """Turn the rate controller on: when a retain finds the finished
        buffer past ``target_fill`` of its capacity, halve the global
        rate scale (never below ``floor``); a drain that finds the buffer
        under half the target doubles it back toward 1.0. Bounded-buffer
        fill is the controlled variable, so always-on tracing sheds RATE
        under pressure instead of overflowing."""
        with self._lock:
            self._adapt_target = min(1.0, max(0.0, float(target_fill)))
            self._adapt_floor = float(floor)
        return self

    def sampling_snapshot(self) -> dict:
        """The sampling/buffer counters one dict deep — what
        ``bench.py --telemetry`` records per config."""
        with self._lock:
            return {
                "default_rate": self.default_sample_rate,
                "rates": dict(self._rates),
                "adaptive_scale": self._adapt_scale,
                "adaptive_kind_scales": dict(self._adapt_kind_scales),
                "traces_started": self.traces_started,
                "traces_dropped_unsampled": self.traces_dropped,
                "traces_evicted": self.traces_evicted,
                "finished_fill": len(self._finished),
                "finished_capacity": self._finished.maxlen,
            }

    # -- explicit API (cross-thread chains) ----------------------------------
    def start_trace(self, name: str, **attrs) -> Optional[Trace]:
        """A new trace, or None when tracing is off — callers thread the
        returned handle (e.g. on a serve Ticket) and call ``finish_trace``
        when the request resolves. The head-based sampling decision is
        drawn HERE; an unsampled trace still records (bounded) so a later
        error/shed terminal can upgrade it."""
        if not self.enabled:
            return None
        with self._lock:
            self.traces_started += 1
            rate = (self._rates.get(name, self.default_sample_rate)
                    * self._scale_locked(name))
            sampled = rate >= 1.0 or self._rng.random() < rate
        return Trace(name, self.clock, self.max_spans, attrs, owner=self,
                     sampled=sampled)

    def start_remote_trace(self, name: str, ctx: Optional[dict],
                           **attrs) -> Optional[Trace]:
        """The receiving half of cross-process propagation: a trace that
        JOINS the context's tree — same trace id, parentless spans hang
        under the propagated span id, and the SENDER's head sampling
        decision is honored (no local draw, so both halves of a tree are
        kept or dropped together). None when tracing is off or no context
        arrived (then callers fall back to ``start_trace`` or nothing)."""
        if not self.enabled or not ctx:
            return None
        try:
            tid = int(ctx["tid"])
            sid = int(ctx["sid"]) or None
            sampled = bool(ctx.get("s", 1))
        except (KeyError, TypeError, ValueError):
            return None  # malformed context from a foreign/older peer
        with self._lock:
            self.traces_started += 1
        return Trace(name, self.clock, self.max_spans, attrs, owner=self,
                     trace_id=tid, remote_parent=sid, sampled=sampled)

    def finish_trace(self, trace: Optional[Trace]) -> None:
        """Close + retain a trace (idempotent, None-tolerant)."""
        if trace is not None:
            trace.finish()

    def _retain(self, trace: Trace) -> None:
        with self._lock:
            if not trace.sampled:
                self.traces_dropped += 1
                return
            if len(self._finished) == self._finished.maxlen:
                self.traces_evicted += 1  # deque evicts the oldest
                old = self._finished[0]
                n = self._kind_fill.get(old.name, 0)
                if n > 1:
                    self._kind_fill[old.name] = n - 1
                else:
                    self._kind_fill.pop(old.name, None)
            self._finished.append(trace)
            self._kind_fill[trace.name] = (
                self._kind_fill.get(trace.name, 0) + 1
            )
            if (self._adapt_target is not None
                    and self._finished.maxlen
                    and len(self._finished)
                    >= self._adapt_target * self._finished.maxlen):
                # per-kind controller first: throttle whoever owns the
                # largest share of the buffer, not every kind at once
                hot = max(self._kind_fill, key=self._kind_fill.get)
                cur = self._adapt_kind_scales.get(hot, 1.0)
                if cur > self._adapt_floor:
                    self._adapt_kind_scales[hot] = max(
                        self._adapt_floor, cur * 0.5
                    )
                else:
                    # the hot kind is floored and pressure persists:
                    # the global scale is the outer clamp
                    self._adapt_scale = max(self._adapt_floor,
                                            self._adapt_scale * 0.5)

    # -- implicit API (single-thread chains) ---------------------------------
    @contextmanager
    def trace_ctx(self, name: str, **attrs):
        """Open a trace AND make it the thread's current one, so nested
        ``tracer.span(...)`` calls attach without handle-threading. Yields
        None when tracing is off (callers never branch — ``span`` no-ops
        with no current trace)."""
        tr = self.start_trace(name, **attrs)
        if tr is None:
            yield None
            return
        stack = self._stack()
        root = tr.start_span(name)
        stack.append((tr, root))
        try:
            yield tr
        finally:
            stack.pop()
            root.end()
            self.finish_trace(tr)

    @contextmanager
    def span(self, name: str, **attrs):
        """A span under the thread's current trace (no-op without one)."""
        stack = self._stack()
        if not stack:
            yield None
            return
        tr, parent = stack[-1]
        sp = tr.start_span(name, parent=parent, **attrs)
        stack.append((tr, sp))
        try:
            yield sp
        finally:
            stack.pop()
            sp.end()

    def current_trace(self) -> Optional[Trace]:
        stack = self._stack()
        return stack[-1][0] if stack else None

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    # -- reading -------------------------------------------------------------
    def drain(self) -> list[Trace]:
        """Pop every finished trace (export consumes the buffer). With
        the adaptive controller on, a drain that finds the pressure gone
        grows the rate scale back toward 1.0."""
        with self._lock:
            out = list(self._finished)
            self._finished.clear()
            self._kind_fill.clear()
            if (self._adapt_target is not None and self._finished.maxlen
                    and len(out)
                    < 0.5 * self._adapt_target * self._finished.maxlen):
                self._adapt_scale = min(1.0, self._adapt_scale * 2.0)
                for k, v in list(self._adapt_kind_scales.items()):
                    grown = min(1.0, v * 2.0)
                    if grown >= 1.0:
                        del self._adapt_kind_scales[k]
                    else:
                        self._adapt_kind_scales[k] = grown
            return out

    def peek(self, n: Optional[int] = None) -> list[Trace]:
        """The most recent finished traces WITHOUT consuming them — the
        ``/debug/traces`` read (drain() stays the exporter's)."""
        with self._lock:
            out = list(self._finished)
        return out if n is None else out[-int(n):]

    def finished_count(self) -> int:
        with self._lock:
            return len(self._finished)


#: the process-wide tracer — disabled until obs.enable()
_GLOBAL = Tracer()


def global_tracer() -> Tracer:
    return _GLOBAL
