"""Deterministic, seeded fault injection: named points with schedules.

The serving/peer/durability planes each carry named **fault points** —
one-line sites of the form::

    if _FAULTS.enabled:                  # ONE attribute read when off
        _FAULTS.check("serve.launch", kind=kind)

``check`` raises the armed error when the point's schedule fires and is a
counted no-op otherwise. The gate discipline is exactly
``obs.trace.Tracer.enabled``'s: with the registry disabled (the default)
every site costs one attribute read and allocates nothing — enforced by
the event-order differential + poisoned-``check`` regression in
``tests/test_serve_fault.py``.

Schedules are **deterministic by construction**: probability draws come
from a per-point ``random.Random`` seeded by ``(seed, point name)``, so a
point's fire/pass decision depends ONLY on its own hit index — never on
thread interleaving across points. Same seed → same fault sequence, which
is what makes the chaos soaks replayable.

Schedule kinds (first match wins: ``at`` > ``times`` > ``prob``):

- ``at={2, 5}``   — fire on exactly those 1-based hit indices;
- ``times=3``     — fire on the next 3 hits, then pass forever;
- ``prob=0.2``    — fire each hit with probability 0.2 (seeded);
- ``when=fn``     — additional ctx predicate; a hit failing it never
  fires, never draws, and does NOT consume a schedule index — ``at``/
  ``times``/``prob`` count only MATCHED hits, so a filter like "transfer
  chunks only" keeps unrelated traffic out of the schedule arithmetic.

Every fire appends ``(name, hit_index)`` to :attr:`FaultRegistry.journal`,
bumps the ``fault.injected`` counter in the process obs registry, and
lands a ``fault.fired`` event in the process flight recorder — so every
injected-fault test doubles as a flight-recorder fixture and an incident
dump always shows the faults that led up to it.
"""

from __future__ import annotations

import random
import threading
from typing import Callable, Optional

from hypergraphdb_tpu_torch.fault.errors import FaultError, TransientFault
from hypergraphdb_tpu_torch.obs.flight import global_flight

_FLIGHT = global_flight()


class _Point:
    """One armed fault point's schedule + bookkeeping."""

    __slots__ = ("name", "error", "times", "prob", "at", "when", "rng",
                 "fired", "matched")

    def __init__(self, name: str, error, times: Optional[int],
                 prob: Optional[float], at: Optional[set],
                 when: Optional[Callable[[dict], bool]], rng: random.Random):
        self.name = name
        self.error = error
        self.times = times
        self.prob = prob
        self.at = at
        self.when = when
        self.rng = rng
        self.fired = 0
        self.matched = 0  # hits that passed `when` — the schedule index


class FaultRegistry:
    """Named fault points with seeded, deterministic schedules.

    ``enabled`` is the zero-cost gate (a plain attribute, same discipline
    as ``Tracer.enabled``); all other state lives behind one lock. One
    process-wide instance (:func:`global_faults`) serves the in-tree
    sites; tests inject private instances through ``ServeConfig(faults=)``
    where isolation matters."""

    def __init__(self) -> None:
        self.enabled = False
        self._lock = threading.Lock()
        self._seed = 0
        self._points: dict[str, _Point] = {}
        self._hits: dict[str, int] = {}
        #: (point name, 1-based hit index) per fire, in fire order — the
        #: reproducibility record chaos tests assert on
        self.journal: list[tuple[str, int]] = []

    # -- lifecycle -----------------------------------------------------------
    def enable(self, seed: int = 0) -> "FaultRegistry":
        """Turn injection on. ``seed`` keys every probabilistic schedule
        armed afterwards (re-arming an existing probabilistic point resets
        its stream)."""
        with self._lock:
            self._seed = int(seed)
            self.enabled = True
        return self

    def disable(self) -> "FaultRegistry":
        with self._lock:
            self.enabled = False
        return self

    def reset(self) -> "FaultRegistry":
        """Disarm everything and clear counters/journal (the enabled flag
        is left as-is — pair with :meth:`disable` for a full teardown)."""
        with self._lock:
            self._points.clear()
            self._hits.clear()
            self.journal.clear()
        return self

    # -- arming --------------------------------------------------------------
    def arm(self, name: str, *, times: Optional[int] = None,
            prob: Optional[float] = None, at=None,
            error=TransientFault,
            when: Optional[Callable[[dict], bool]] = None) -> None:
        """Arm ``name`` with one schedule (see module docstring). ``error``
        is the exception CLASS to raise (instantiated with a descriptive
        message), or a callable ``(name, hit_index) -> BaseException``."""
        if times is None and prob is None and at is None:
            raise ValueError(f"fault point {name!r}: no schedule given "
                             "(one of times=, prob=, at=)")
        if prob is not None and not 0.0 <= prob <= 1.0:
            raise ValueError(f"fault point {name!r}: prob {prob} not in "
                             "[0, 1]")
        with self._lock:
            # per-point stream: decisions depend only on this point's own
            # hit ordering, never on cross-point interleaving
            rng = random.Random(f"{self._seed}:{name}")
            self._points[name] = _Point(
                name, error, None if times is None else int(times),
                prob, None if at is None else {int(i) for i in at},
                when, rng,
            )

    def disarm(self, name: str) -> None:
        with self._lock:
            self._points.pop(name, None)

    # -- the site call -------------------------------------------------------
    def check(self, name: str, **ctx) -> None:
        """Count a hit at fault point ``name``; raise the armed error when
        its schedule fires. No-op while disabled (sites additionally gate
        on :attr:`enabled` so the disabled path never even gets here)."""
        if not self.enabled:
            return
        with self._lock:
            self._hits[name] = self._hits.get(name, 0) + 1
            pt = self._points.get(name)
            if pt is None:
                return
            if pt.when is not None and not pt.when(ctx):
                return
            pt.matched += 1
            idx = pt.matched
            if pt.at is not None:
                fire = idx in pt.at
            elif pt.times is not None:
                fire = pt.fired < pt.times
            elif pt.prob is not None:
                fire = pt.rng.random() < pt.prob
            else:  # pragma: no cover - arm() requires a schedule
                fire = False
            if not fire:
                return
            pt.fired += 1
            self.journal.append((name, idx))
            err = pt.error
        # construct + count + record outside the lock: error factories,
        # the metrics instrument, and the flight ring take their own paths
        exc = (err(name, idx) if not isinstance(err, type)
               else err(f"injected fault at {name!r} (hit {idx})"))
        from hypergraphdb_tpu_torch.utils.metrics import global_metrics

        global_metrics.incr("fault.injected")
        if _FLIGHT.enabled:
            _FLIGHT.record("fault.fired", point=name, hit=idx,
                           error=type(exc).__name__)
        raise exc

    # -- reading -------------------------------------------------------------
    def hits(self, name: str) -> int:
        """How many times ``name`` was reached while enabled."""
        with self._lock:
            return self._hits.get(name, 0)

    def fired(self, name: str) -> int:
        """How many of those hits raised."""
        with self._lock:
            pt = self._points.get(name)
            return 0 if pt is None else pt.fired

    def armed(self) -> list[str]:
        with self._lock:
            names = list(self._points)
        return sorted(names)


#: the process-wide registry every in-tree site binds at import — a
#: singleton by contract (sites cache the reference in a module global,
#: so replacing it would silently disconnect them)
_GLOBAL = FaultRegistry()


def global_faults() -> FaultRegistry:
    return _GLOBAL


# re-exported for the common "catch anything injected" shape
__all__ = ["FaultError", "FaultRegistry", "global_faults"]
