"""Always-on flight recorder: a bounded ring of recent structured events.

Metrics tell you the rates; traces tell you one request; neither answers
"what were the last few hundred things this process did before it broke".
The :class:`FlightRecorder` does: a fixed-size ring of small structured
events — span terminals, fault firings, breaker transitions, serve
retries, compaction swaps — that costs ONE bounded ring append per event
on the healthy path (a ``deque(maxlen=...)`` append, GIL-atomic, no lock,
no IO, no growth) and, on **incident**, dumps its full window to a JSONL
file so the minutes before a breaker trip or typed serve error are on
disk before anyone asks.

Wired producers (each behind one ``enabled`` attribute read): every
trace terminal (``obs.trace.Trace.finish_terminal``), so a query that
raised is in the window; the serve runtime's retries and typed errors,
the fault registry's firings and the breakers' transitions and trips.

Incident dumps are rate-limited (``min_dump_interval_s``) and written
only when an ``incident_dir`` is configured — incidents are always
COUNTED either way. A dump is a point-in-time snapshot of the ring; the
dump path is returned and remembered (``last_dump_path``).

Records are scalars-only dicts, so JSONL serialization never fails
mid-incident.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Optional

#: default ring capacity: at ~100 B/event this is <1 MB of history
DEFAULT_CAPACITY = 4096


class FlightRecorder:
    """Bounded ring of ``(t, kind, fields)`` events + incident dumping.

    ``enabled`` is the zero-ish-cost gate (a plain attribute, the
    ``Tracer.enabled`` discipline) — ON by default: the healthy-path
    cost is one tuple allocation and one atomic deque append per event,
    cheap enough to leave running in production, which is the point of a
    flight recorder."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 clock: Optional[Callable[[], float]] = None,
                 incident_dir: Optional[str] = None,
                 min_dump_interval_s: float = 1.0):
        self.enabled = True
        self.clock = clock or time.monotonic
        self.incident_dir = incident_dir
        self.min_dump_interval_s = float(min_dump_interval_s)
        #: the ring: deque.append with maxlen is one GIL-atomic op — the
        #: healthy path takes NO lock (same discipline as the replication
        #: worker's pending queue)
        self._ring: deque = deque(maxlen=int(capacity))
        # incident bookkeeping only (rare path) lives behind the lock.
        # REENTRANT: the SIGTERM dump hook runs incident() from a signal
        # handler, which CPython executes on the main thread at the next
        # bytecode — possibly while that same thread already holds this
        # lock (a plain Lock would self-deadlock the orderly kill)
        self._lock = threading.RLock()
        self._incidents = 0
        self._dumps = 0
        self._last_dump_t: Optional[float] = None
        self.last_dump_path: Optional[str] = None

    # -- the hot path --------------------------------------------------------
    def record(self, kind: str, **fields) -> None:
        """Append one event. Scalars only (the JSONL dump contract);
        non-scalars are stringified rather than rejected — a recorder
        must never throw from an error path."""
        if not self.enabled:
            return
        self._ring.append((self.clock(), kind, fields))

    # -- configuration -------------------------------------------------------
    def configure(self, incident_dir: Optional[str] = None,
                  capacity: Optional[int] = None,
                  min_dump_interval_s: Optional[float] = None) -> None:
        """Point incident dumps at a directory / resize the ring (resize
        starts a fresh ring — history is bounded, not durable)."""
        with self._lock:
            if incident_dir is not None:
                self.incident_dir = incident_dir
            if min_dump_interval_s is not None:
                self.min_dump_interval_s = float(min_dump_interval_s)
            if capacity is not None:
                self._ring = deque(self._ring, maxlen=int(capacity))

    def reset(self) -> None:
        """Clear the ring and incident counters (test isolation)."""
        with self._lock:
            self._ring.clear()
            self._incidents = 0
            self._dumps = 0
            self._last_dump_t = None
            self.last_dump_path = None

    # -- reading -------------------------------------------------------------
    def records(self) -> list[tuple]:
        """Snapshot of the ring, oldest first."""
        return list(self._ring)

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    @property
    def incidents(self) -> int:
        with self._lock:
            return self._incidents

    @property
    def dumps(self) -> int:
        with self._lock:
            return self._dumps

    # -- incidents -----------------------------------------------------------
    def incident(self, reason: str, **fields) -> Optional[str]:
        """Record the incident event, then dump the full window to
        ``<incident_dir>/flight_<n>_<reason>.jsonl`` — rate-limited so an
        error storm costs one file per interval, not one per error.
        Returns the dump path (None when not configured / rate-limited).
        Never raises: an unwritable dir must not turn one incident into
        two."""
        self.record("incident", reason=reason, **fields)
        with self._lock:
            self._incidents += 1
            if self.incident_dir is None:
                return None
            now = self.clock()
            if (self._last_dump_t is not None
                    and now - self._last_dump_t < self.min_dump_interval_s):
                return None
            self._last_dump_t = now
            self._dumps += 1
            n = self._dumps
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in reason)[:48]
        path = os.path.join(self.incident_dir, f"flight_{n:04d}_{safe}.jsonl")
        try:
            self.dump(path)
        except OSError:
            return None
        with self._lock:
            self.last_dump_path = path
        return path

    def to_jsonl(self) -> str:
        """The current window as JSONL text (one ``{"t", "kind", ...}``
        object per line, oldest first) — the ONE serialization both
        incident dumps and the ``/debug/flight`` endpoint emit, so the
        two views can never drift apart."""
        lines = []
        for t, kind, fields in self.records():
            rec = {"t": t, "kind": kind}
            for k, v in fields.items():
                rec[k] = (v if isinstance(v, (bool, int, float, str,
                                              type(None))) else str(v))
            lines.append(json.dumps(rec, sort_keys=True))
        return "\n".join(lines) + ("\n" if lines else "")

    def dump(self, path: str) -> str:
        """Write :meth:`to_jsonl` to ``path``."""
        text = self.to_jsonl()
        with open(path, "w") as f:
            f.write(text)
        return path


def parse_flight_jsonl(text: str) -> list[dict]:
    """The committed reader for dump files: every line must carry
    ``t`` and ``kind``."""
    out = []
    for i, line in enumerate(text.splitlines()):
        if not line.strip():
            continue
        rec = json.loads(line)
        for key in ("t", "kind"):
            if key not in rec:
                raise ValueError(f"flight line {i}: missing {key!r}")
        out.append(rec)
    return out


#: the process-wide recorder every in-tree site binds at import (the
#: fault-registry singleton contract: sites cache the reference)
_GLOBAL = FlightRecorder()


def global_flight() -> FlightRecorder:
    return _GLOBAL


def install_sigterm_dump(recorder: Optional[FlightRecorder] = None,
                         signum: Optional[int] = None) -> Callable[[], None]:
    """OPT-IN: dump the flight window when the process is killed orderly.

    Installs a SIGTERM handler (overridable via ``signum``) that records
    ``FlightRecorder.incident("sigterm")`` — writing the window to the
    recorder's ``incident_dir`` if one is configured — and then hands the
    signal on, PRESERVING the prior disposition: a previously-installed
    Python handler is invoked; a process that explicitly ignored the
    signal (``SIG_IGN``) keeps ignoring it (dump only, no death); with
    the default disposition the handler re-raises the signal against the
    process with ``SIG_DFL`` restored, so the kill still kills (operators
    get the window, supervisors still see a SIGTERM death).

    Must be called from the main thread (CPython restricts
    ``signal.signal``). Returns an uninstall callable restoring the prior
    handler. NOT installed automatically anywhere — a library must never
    repurpose a process's signals behind the operator's back; wire it
    from your entry point.
    """
    import signal as _signal

    rec = recorder or _GLOBAL
    signum = _signal.SIGTERM if signum is None else signum
    prev = _signal.getsignal(signum)

    def _handler(num, frame):
        rec.incident("sigterm", signal=int(num))
        if prev == _signal.SIG_IGN:
            return  # the operator chose to survive this signal; honor it
        if callable(prev) and prev != _signal.SIG_DFL:
            prev(num, frame)
            return
        # default (or unknowable C-installed) disposition: restore
        # SIG_DFL and re-deliver, so the process still dies with the
        # conventional -SIGTERM status
        _signal.signal(num, _signal.SIG_DFL)
        os.kill(os.getpid(), num)

    _signal.signal(signum, _handler)

    def uninstall():
        if _signal.getsignal(signum) is not _handler:
            # someone installed their own handler AFTER ours (it chains
            # to us via its own getsignal) — restoring `prev` here would
            # silently remove THEIR handler; leave the chain alone
            import logging

            logging.getLogger("hypergraphdb_tpu_torch.obs").warning(
                "sigterm dump hook is no longer the active handler for "
                "signal %s — leaving the current disposition in place",
                signum,
            )
            return
        # getsignal returns None for a handler installed from C — it
        # cannot be re-installed from Python, so fall back to SIG_DFL
        # (at least detaching the recorder) instead of raising
        _signal.signal(
            signum, prev if prev is not None else _signal.SIG_DFL
        )

    return uninstall
