"""Observability: query tracing and the flight recorder.

- :mod:`~hypergraphdb_tpu_torch.obs.trace`: bounded span trees with
  explicit parenting and injectable clocks; a query emits
  ``compile → plan → execute``;
- :mod:`~hypergraphdb_tpu_torch.obs.flight`: an always-on bounded ring of
  recent structured events (trace terminals) that dumps its window to
  JSONL on incident.

Tracing is off by default: every instrumentation site then costs one
attribute read and allocates nothing. ``obs.enable()`` turns it on for
the process.
"""

from hypergraphdb_tpu_torch.obs import flight, trace
from hypergraphdb_tpu_torch.obs.flight import (
    FlightRecorder,
    global_flight,
    install_sigterm_dump,
)
from hypergraphdb_tpu_torch.obs.trace import (
    Span,
    Trace,
    Tracer,
    global_tracer,
)


def tracer() -> Tracer:
    """The process-wide tracer."""
    return global_tracer()


def enable(clock=None) -> Tracer:
    """Turn tracing on, process-wide (optionally with a fake clock)."""
    return global_tracer().enable(clock)


def disable() -> Tracer:
    return global_tracer().disable()


__all__ = ["FlightRecorder", "Span", "Trace", "Tracer", "disable",
           "enable", "flight", "global_flight", "global_tracer",
           "install_sigterm_dump", "trace", "tracer"]
