"""Serving vocabulary: requests, results, errors, tickets.

The port's copy of ``hypergraphdb_tpu/serve/types.py``. No torch imports
here — the deterministic runtime tests drive the whole admission/batching
machinery with a fake executor and never touch a device.
"""

from __future__ import annotations

from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

#: injectable time source (seconds, monotonic) — tests pass a fake
Clock = Callable[[], float]


class ServeError(Exception):
    """Base class of every serving-runtime error."""


class DeadlineExceeded(ServeError):
    """The request's deadline expired before a device dispatch — shed in
    the admission queue (load shedding), the dispatch was never paid."""

    def __init__(self, waited_s):
        # the router re-raises this across an HTTP hop with the server's
        # error body as the message — only a local shed knows the wait
        if isinstance(waited_s, (int, float)):
            super().__init__(
                f"deadline exceeded after {waited_s * 1e3:.1f} ms "
                "in the admission queue")
            self.waited_s = float(waited_s)
        else:
            super().__init__(str(waited_s))
            self.waited_s = None


class QueueFull(ServeError):
    """Fail-fast admission: the bounded queue was full (backpressure)."""


class RuntimeClosed(ServeError):
    """Submitted to (or cancelled by) a closed runtime."""


class Unservable(ServeError):
    """The condition/request is outside the batchable subset — run it
    through ``graph.find_all`` instead."""


class AdmissionGated(ServeError):
    """The runtime's ``admission_gate`` refused this request — the node
    is temporarily unfit to answer within its contract (e.g. a replica
    whose replication lag exceeds its staleness bound). Retry elsewhere:
    a router treats this as "re-route", never as a caller error."""


# ---------------------------------------------------------------- requests


@dataclass(frozen=True)
class BFSRequest:
    """K-batchable BFS: atoms reachable from ``seed`` within ``max_hops``.

    Matches ``query.conditions.BFS`` semantics when ``include_seed`` is
    False (the condition's default excludes the start atom)."""

    seed: int
    max_hops: int
    include_seed: bool = True

    @property
    def kind(self) -> str:
        return "bfs"

    @property
    def batch_key(self) -> tuple:
        # max_hops is a static kernel arg — one compiled program per value
        return ("bfs", self.max_hops)


@dataclass(frozen=True)
class PatternRequest:
    """Conjunctive incident pattern: links incident to ALL ``anchors``,
    optionally restricted to ``type_handle``. The per-request type rides a
    traced (K,) vector, so typed and untyped requests share one batch."""

    anchors: tuple[int, ...]
    type_handle: Optional[int] = None

    def __post_init__(self):
        if not self.anchors:
            raise Unservable("pattern request needs at least one anchor")
        object.__setattr__(
            self, "anchors", tuple(int(a) for a in self.anchors)
        )

    @property
    def kind(self) -> str:
        return "pattern"

    @property
    def batch_key(self) -> tuple:
        # anchor arity P is a device shape dim — one program per P
        return ("pattern", len(self.anchors))


@dataclass(frozen=True)
class JoinRequest:
    """A conjunctive-pattern join: the structural half is a hashable
    ``join/ir.PatternSignature`` (``sig``) and the per-request half the
    constant vector (``consts``) — the split_constants factoring, which
    is exactly the batch-key/payload discipline: requests sharing one
    signature ride one compiled multiway-intersection program
    (``ops/join.execute_join``) as K lanes of one batch, however
    different their anchor atoms.

    Build via ``query.bridge.to_join_request`` (condition-spec front
    door) or directly from ``join.split_constants``."""

    sig: object                 # join/ir.PatternSignature (kept untyped:
    consts: tuple[int, ...]     # this module stays device/join-import-free)

    def __post_init__(self):
        object.__setattr__(
            self, "consts", tuple(int(x) for x in self.consts)
        )
        n = getattr(self.sig, "n_consts", None)
        if n is not None and n != len(self.consts):
            raise Unservable(
                f"signature expects {n} constants, got {len(self.consts)}"
            )

    @property
    def kind(self) -> str:
        return "join"

    @property
    def batch_key(self) -> tuple:
        # the signature IS the compiled program's identity: elimination
        # order, step statics, filter layout all derive from it
        return ("join", self.sig)


@dataclass(frozen=True)
class RangeRequest:
    """A value range / ordered / top-k query over one indexed dimension
    (the hgindex serve lane): atoms whose value of ``kind`` falls in the
    ``[lo, hi]`` rank window, optionally type-filtered, optionally
    constrained incident to ``anchor``, returned in value order
    (``desc`` flips it) with an optional ``limit`` (top-k).

    ``dim`` is the value kind byte (the indexed DIMENSION — requests of
    one dimension share a sorted device column and a batch); ``lo_rank``
    / ``hi_rank`` are 64-bit order-preserving payload ranks
    (``utils/ordered_bytes.rank64``), ``None`` = open bound;
    ``lo_rank2`` / ``hi_rank2`` the matching SECOND rank words (payload
    bytes 8..16, ``rank128`` — 0 for fixed-width kinds and short keys).
    ``lo_op`` ∈ {"gt", "gte"}, ``hi_op`` ∈ {"lt", "lte"}. ``exact``
    records whether the 128-bit rank pair decides the request exactly:
    True for fixed-width kinds (rank order == value order, tie-free) and
    for variable-width bounds that are CLEAN (≤16 payload bytes, no NUL
    among them); lanes with ``exact=False`` are served on the exact host
    path — honest scoping, the device window cannot see ties past the
    pair. Even an ``exact`` variable-width request falls back to host
    when a consulted column is not ``device_exact`` (the runtime checks
    at dispatch). ``values`` keeps the ORIGINAL (lo, hi) python values
    so host execution and memtable correction compare real keys, never
    coarse ranks.

    Build via ``query.bridge.to_range_request`` (which derives the
    dimension and ranks through the typesystem) rather than by hand."""

    dim: int
    lo_rank: Optional[int]
    hi_rank: Optional[int]
    lo_op: str = "gte"
    hi_op: str = "lte"
    lo_rank2: int = 0
    hi_rank2: int = 0
    values: tuple = (None, None)
    type_handle: Optional[int] = None
    anchor: Optional[int] = None
    desc: bool = False
    limit: Optional[int] = None
    exact: bool = True

    def __post_init__(self):
        if self.lo_op not in ("gt", "gte") or self.hi_op not in ("lt", "lte"):
            raise Unservable(
                f"bad range ops ({self.lo_op}, {self.hi_op}); lower must "
                "be gt/gte, upper lt/lte"
            )
        if self.limit is not None and self.limit < 1:
            raise Unservable("range limit must be >= 1")

    @property
    def kind(self) -> str:
        return "range"

    @property
    def batch_key(self) -> tuple:
        # one sorted device column (and one compiled program) per value
        # dimension: the dimension IS the statics key
        return ("range", int(self.dim))


# ---------------------------------------------------------------- results


@dataclass(frozen=True, eq=False)  # ndarray field: dataclass eq would
class ServeResult:                 # raise on >1-element comparisons
    """One request's answer.

    ``matches`` holds the first ``top_r`` matching atom ids ascending —
    except for ``kind == "range"`` results, where they come in the
    request's VALUE order (ascending rank, or descending under
    ``desc=True``; rank ties break toward the smaller gid) and the
    window is additionally capped by the request's ``limit``;
    ``truncated`` flags a result set larger than the compact window (then
    ``count`` is exact but ``matches`` is a prefix). ``epoch`` is the
    compaction epoch of the pinned view that served the request;
    ``served_by`` is ``"device"`` for the batched path or ``"host"`` for
    the exact fallback (oversized rows / anchors beyond the base's id
    space)."""

    kind: str               # "bfs" | "pattern" | "range"
    count: int
    matches: np.ndarray     # int64, ascending
    truncated: bool
    epoch: int
    served_by: str = "device"


@dataclass(frozen=True, eq=False)
class JoinResult:
    """One join request's answer: the first ``top_r`` binding tuples.

    ``tuples`` is ``(n, V)`` int64, columns in the REQUEST's variable
    order (``vars``), rows ascending lexicographically; ``truncated``
    flags a binding set larger than the compact window (``count`` stays
    exact — truncation-honest device lanes are re-served on the exact
    host path before they get here, see ``DeviceExecutor.collect``)."""

    kind: str               # always "join"
    count: int
    tuples: np.ndarray      # (n, V) int64, lexicographic ascending
    vars: tuple             # column names, request order
    truncated: bool
    epoch: int
    served_by: str = "device"


# ---------------------------------------------------------------- tickets


@dataclass
class Ticket:
    """A queued request + its completion future and deadline bookkeeping
    (absolute times per the runtime's injected clock).

    ``priority`` orders admission pops: a higher class pops first, FIFO
    within a class (deadline shedding and backpressure are
    priority-blind). ``trace`` is the request's hgobs trace handle —
    ``None`` whenever tracing is off, so the disabled path allocates
    nothing and every terminal helper gates on one attribute read. The
    terminal span (``resolve``/``shed``/``error``) is emitted HERE so
    every completion path — dispatch, cancel_all, executor failure —
    closes the trace exactly once."""

    request: object
    future: Future = field(default_factory=Future)
    submit_t: float = 0.0
    deadline_t: Optional[float] = None
    priority: int = 0
    trace: object = None
    #: per-request cost attribution: the runtime finishes the trace
    #: EARLY at resolve time and attaches an ``obs.fleet.explain_record``
    #: to the future (``future.explain``) BEFORE the result is delivered,
    #: so a caller reading ``fut.result()`` then ``fut.explain`` never
    #: races the dispatch thread
    explain: bool = False

    def expired(self, now: float) -> bool:
        return self.deadline_t is not None and now >= self.deadline_t

    def _close_trace(self, terminal: str, **attrs) -> None:
        tr = self.trace
        if tr is not None:
            tr.finish_terminal(terminal, **attrs)

    # Completion goes through these tolerant helpers everywhere: a caller
    # may have cancel()ed the future, and an InvalidStateError out of the
    # dispatch thread would kill the whole service for one dead request.
    def resolve(self, result) -> bool:
        try:
            self.future.set_result(result)
            ok = True
        except Exception:
            ok = False  # cancelled/already-done: nobody is listening
        self._close_trace("resolve", delivered=ok)
        return ok

    def fail(self, exc: BaseException) -> bool:
        try:
            self.future.set_exception(exc)
            ok = True
        except Exception:
            ok = False
        if not isinstance(exc, DeadlineExceeded):  # shed() emits its own
            self._close_trace("error", error=type(exc).__name__)
        return ok

    def shed(self, now: float) -> None:
        self.fail(DeadlineExceeded(now - self.submit_t))
        self._close_trace("shed", waited_s=now - self.submit_t)

    @property
    def batch_key(self) -> tuple:
        return self.request.batch_key
