"""One metrics registry: counters, gauges, log-bucketed histograms.

This replaces the repo's two disjoint metric surfaces — the
``utils.metrics.Metrics`` ``(count, total, max)`` timing triples and the
``serve.stats.ServeStats`` latency ring — with ONE instrument vocabulary:

- :class:`Counter` — monotonic int (``inc``);
- :class:`Gauge`   — last-write float (``set``);
- :class:`Histogram` — log-bucketed distribution. Buckets grow
  geometrically (default ×2 from 1 µs): 31 bounds + the +Inf tail span
  1 µs → ~10³ s with bounded relative error; ``count/total/max`` ride along so the old
  timing-triple reports cost nothing extra. An optional bounded
  ``window`` keeps the most recent raw samples for EXACT percentiles
  (the ServeStats latency ring, now inside the shared instrument);
  without a window, percentiles come from the buckets (error ≤ one
  bucket ratio).

A :class:`Registry` is a flat dotted-name → instrument map. There is one
process-wide default (``default_registry()``); everything is instantiable
so tests and per-graph/per-runtime surfaces stay isolated. Names are
namespaced by convention (``serve.*``, ``graph.*``, ``compact.*``,
``query.*``, ``tx.*`` — see README "Observability"); registering the same
name as two different kinds is an error, which is what keeps the
namespace drift-free.

Lock discipline (hglint HG402): the registry lock guards the name map;
each instrument owns its own lock for its counters — recording never
takes the registry lock, and no path holds two instrument locks at once.
"""

from __future__ import annotations

import bisect
import math
import threading
from collections import deque
from typing import Optional, Sequence

#: default log-bucket boundaries: ×2 from 1 µs to ~1100 s (seconds-scaled
#: instruments; pass explicit ``bounds`` for anything else)
DEFAULT_BOUNDS = tuple(1e-6 * 2.0 ** k for k in range(31))


class Counter:
    """Monotonic counter (``.value`` reads, ``inc`` writes)."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._n = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._n += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


class Gauge:
    """Last-write-wins float."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._v = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._v

    def reset(self) -> None:
        with self._lock:
            self._v = 0.0


class Histogram:
    """Log-bucketed distribution with count/total/max and optional exact
    percentile window.

    ``bounds`` are the bucket UPPER edges (ascending); an implicit +Inf
    bucket catches the tail, so ``observe`` never fails on range."""

    kind = "histogram"

    def __init__(self, name: str, bounds: Sequence[float] = DEFAULT_BOUNDS,
                 window: int = 0):
        if list(bounds) != sorted(set(bounds)):
            raise ValueError("histogram bounds must be ascending, unique")
        self.name = name
        self.bounds = tuple(float(b) for b in bounds)
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.bounds) + 1)  # +Inf tail bucket
        self._count = 0
        self._total = 0.0
        self._max = 0.0
        self._window: Optional[deque] = (
            deque(maxlen=window) if window else None
        )

    def observe(self, value: float) -> None:
        v = float(value)
        i = bisect.bisect_left(self.bounds, v)  # first bound >= v
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._total += v
            if v > self._max:
                self._max = v
            if self._window is not None:
                self._window.append(v)

    # -- reading -------------------------------------------------------------
    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def total(self) -> float:
        with self._lock:
            return self._total

    @property
    def max(self) -> float:
        with self._lock:
            return self._max

    @property
    def mean(self) -> float:
        with self._lock:
            return self._total / self._count if self._count else 0.0

    def summary(self) -> dict:
        """count/total/mean/max under ONE lock acquisition — reading the
        properties separately can tear against a concurrent observe
        (mean × count ≠ total)."""
        with self._lock:
            return {
                "count": self._count,
                "total": self._total,
                "mean": self._total / self._count if self._count else 0.0,
                "max": self._max,
            }

    def percentile(self, p: float) -> Optional[float]:
        """p ∈ [0, 1]. EXACT over the raw-sample window when one is
        configured (and non-empty); otherwise the bucket upper edge at the
        cumulative rank — error bounded by one bucket ratio. None before
        any observation."""
        return self.percentiles((p,))[0]

    def percentiles(self, ps: Sequence[float]) -> list[Optional[float]]:
        """Several percentiles from ONE locked read (one window sort) —
        separate :meth:`percentile` calls each see a different live state,
        so a concurrently-updated window could report p50 > p99."""
        for p in ps:
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"percentile {p} outside [0, 1]")
        # one locked SNAPSHOT (the consistency contract), but the window
        # sort itself runs outside the lock — a wide window must not
        # stall concurrent observe() calls
        with self._lock:
            window = list(self._window) if self._window else None
            if window is None:
                if not self._count:
                    return [None] * len(ps)
                return [self._bucket_percentile_locked(p) for p in ps]
        lat = sorted(window)
        return [
            lat[min(len(lat) - 1, int(round(p * (len(lat) - 1))))]
            for p in ps
        ]

    def _bucket_percentile_locked(self, p: float) -> float:
        rank = p * self._count
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= rank and c:
                if i < len(self.bounds):
                    return self.bounds[i]
                return self._max  # +Inf tail: best bound we have
        return self._max

    def bucket_counts(self) -> list[tuple[float, int]]:
        """Cumulative (upper_edge, count) pairs, Prometheus-style, ending
        with (+Inf, count)."""
        return self.export_state()[0]

    def export_state(self) -> tuple[list[tuple[float, int]], float, int]:
        """(cumulative buckets, sum, count) under ONE lock — the scrape
        read. Separate reads could emit an exposition whose ``_sum``
        disagrees with its own ``_bucket``/``_count`` lines."""
        with self._lock:
            out, cum = [], 0
            for edge, c in zip(self.bounds, self._counts):
                cum += c
                out.append((edge, cum))
            out.append((math.inf, cum + self._counts[-1]))
            return out, self._total, self._count

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._count = 0
            self._total = 0.0
            self._max = 0.0
            if self._window is not None:
                self._window.clear()


class Registry:
    """Flat name → instrument map; get-or-create, kind-checked."""

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get_or_create(self, name: str, kind: str, factory):
        if not name or name != name.strip("."):
            raise ValueError(f"bad metric name {name!r}")
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif m.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {kind}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, "counter", lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, "gauge", lambda: Gauge(name))

    def histogram(self, name: str,
                  bounds: Sequence[float] = DEFAULT_BOUNDS,
                  window: int = 0) -> Histogram:
        m = self._get_or_create(
            name, "histogram", lambda: Histogram(name, bounds, window)
        )
        # drift guard, same spirit as the kind check: explicitly-requested
        # non-default params must match the existing instrument — a caller
        # asking for an exact-percentile window must not silently get a
        # windowless histogram someone else registered first (default-arg
        # calls are treated as pure gets)
        want_bounds = tuple(float(b) for b in bounds)
        if want_bounds != tuple(DEFAULT_BOUNDS) and want_bounds != m.bounds:
            raise ValueError(
                f"histogram {name!r} already registered with different "
                "bounds"
            )
        if window and (m._window is None or m._window.maxlen != window):
            raise ValueError(
                f"histogram {name!r} already registered with window="
                f"{None if m._window is None else m._window.maxlen}, "
                f"requested {window}"
            )
        return m

    # -- reading -------------------------------------------------------------
    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> list[str]:
        with self._lock:
            names = list(self._metrics)
        return sorted(names)

    def instruments(self) -> list:
        with self._lock:
            metrics = dict(self._metrics)
        return [metrics[k] for k in sorted(metrics)]

    def snapshot(self) -> dict:
        """{name: scalar | histogram summary} — the debug dump."""
        out = {}
        for m in self.instruments():
            if m.kind == "histogram":
                out[m.name] = m.summary()
            else:
                out[m.name] = m.value
        return out

    def reset(self) -> None:
        for m in self.instruments():
            m.reset()


#: the process-wide registry (kernel wrappers, global_metrics)
_DEFAULT = Registry("default")


def default_registry() -> Registry:
    return _DEFAULT
