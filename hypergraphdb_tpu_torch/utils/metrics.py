"""Counters, gauges and timers of one graph, backed by an
:class:`~hypergraphdb_tpu_torch.obs.registry.Registry`.

The graph's transaction manager, snapshot path and snapshot manager bump
them (``tx.commits``, ``graph.mutations``, ``compact.passes``,
``compact.full_uploads``, ...); :data:`global_metrics` is the process's.
Every instrument lives in ``self.registry``, so the whole surface renders
to Prometheus (``obs.export.prometheus_text(metrics.registry)``) and rides
a fleet node's registries (a front door's routing counters, a replica's
graph counters). ``counters``, ``gauges`` and ``timings`` are views over
the registry; a timer is a histogram, read back as ``(count, total
seconds, max seconds)``.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Optional

from hypergraphdb_tpu_torch.obs.registry import Registry, default_registry


class Metrics:
    def __init__(self, registry: Optional[Registry] = None) -> None:
        self.registry = registry if registry is not None else Registry()
        #: (kind, name) -> instrument: a repeat event touches only the
        #: instrument's own lock (a racing first miss resolves the same
        #: instrument twice)
        self._memo: dict = {}

    def _instrument(self, kind: str, name: str):
        m = self._memo.get((kind, name))
        if m is None:
            make = {"c": self.registry.counter, "g": self.registry.gauge,
                    "h": self.registry.histogram}[kind]
            m = self._memo[(kind, name)] = make(name)
        return m

    def incr(self, name: str, n: int = 1) -> None:
        self._instrument("c", name).inc(n)

    def gauge(self, name: str, value: float) -> None:
        self._instrument("g", name).set(value)

    def observe(self, name: str, seconds: float) -> None:
        self._instrument("h", name).observe(seconds)

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    @property
    def counters(self) -> dict:
        return {m.name: m.value for m in self.registry.instruments()
                if m.kind == "counter"}

    @property
    def gauges(self) -> dict:
        return {m.name: m.value for m in self.registry.instruments()
                if m.kind == "gauge"}

    @property
    def timings(self) -> dict:
        """name -> (count, total seconds, max seconds), each triple read
        under one lock."""
        out = {}
        for m in self.registry.instruments():
            if m.kind == "histogram":
                s = m.summary()
                out[m.name] = (s["count"], s["total"], s["max"])
        return out

    def snapshot(self) -> dict:
        """Counters, gauges and each timer's count, total, mean and max
        (seconds) in one dump."""
        counters, gauges, timings = {}, {}, {}
        for m in self.registry.instruments():
            if m.kind == "counter":
                counters[m.name] = m.value
            elif m.kind == "gauge":
                gauges[m.name] = m.value
            else:
                s = m.summary()  # one lock: the four cannot tear
                timings[m.name] = {"count": s["count"], "total_s": s["total"],
                                   "mean_s": s["mean"], "max_s": s["max"]}
        return {"counters": counters, "gauges": gauges, "timings": timings}

    def reset(self) -> None:
        """Zero every instrument this object made; on a shared registry the
        others' instruments stay. Iterates a copy, so a racing first
        recording cannot break the loop."""
        for m in list(self._memo.values()):
            m.reset()


#: the process-wide metrics (the fault registry's ``fault.injected``),
#: on the process's default registry
global_metrics = Metrics(registry=default_registry())
