"""Bounded admission queue: backpressure, deadline shedding, priorities.

The queue is the runtime's ONLY synchronization point between submitters
and the dispatch thread: one condition variable guards a deque of
:class:`~.types.Ticket`. Pops are PRIORITY-ordered: ``front()`` (which
picks the key the next micro-batch is formed around) returns the oldest
ticket of the highest priority class present, and ``take`` hands tickets
out highest-class-first, FIFO within a class — so a latency-critical
class jumps the batch-formation line while same-class requests keep
strict arrival order. Capacity, deadline shedding, and the ``block`` /
``fail`` policies are priority-blind: a high-priority request that
arrives at a full queue still waits or fails like any other. A lingered
lower class still forces flushes (the batcher's linger clock is
``oldest()``, priority-blind), so only genuinely saturating
higher-priority load — dispatch never finding the queue clear of higher
classes — delays lower ones, and deadlines bound how long a delayed
request waits.

Backpressure policy is per-queue:

- ``"block"`` — ``submit`` waits for space (bounded by the request's own
  deadline when it has one: a request that would expire while waiting is
  shed immediately, with the queue untouched);
- ``"fail"``  — ``submit`` raises :class:`~.types.QueueFull` at once.

Deadline shedding happens at pop time (``shed_expired``): an expired
ticket's future completes with a typed :class:`~.types.DeadlineExceeded`
and the ticket never reaches a batch — a dead request costs zero device
work.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

from hypergraphdb_tpu_torch.serve.stats import ServeStats
from hypergraphdb_tpu_torch.serve.types import (
    Clock,
    QueueFull,
    RuntimeClosed,
    Ticket,
)


class AdmissionQueue:
    """Bounded FIFO of tickets with deadline shedding.

    All mutation happens under one condition variable; the dispatch thread
    waits on the same cv (``wait_for_work``) so a submit wakes it without
    polling."""

    def __init__(self, capacity: int, policy: str = "block",
                 clock: Clock = None, stats: Optional[ServeStats] = None):
        if policy not in ("block", "fail"):
            raise ValueError(f"unknown admission policy {policy!r}")
        if capacity < 1:
            raise ValueError("queue capacity must be >= 1")
        import time

        self.capacity = capacity
        self.policy = policy
        self.clock = clock or time.monotonic
        self.stats = stats or ServeStats()
        self._cv = threading.Condition()
        self._dq: deque[Ticket] = deque()
        # priority class -> queued count (zero entries removed): with a
        # single class present — the overwhelmingly common shape —
        # front() stays the O(1) deque head instead of an O(n) scan
        self._prio_counts: dict[int, int] = {}
        self._closed = False

    # -- submit side ---------------------------------------------------------
    def submit(self, ticket: Ticket) -> Ticket:
        """Enqueue (or shed / reject) one ticket; returns it either way —
        a shed ticket's future already carries ``DeadlineExceeded``."""
        with self._cv:
            while True:
                if self._closed:
                    raise RuntimeClosed("runtime is closed")
                if len(self._dq) < self.capacity:
                    self._dq.append(ticket)
                    p = ticket.priority
                    self._prio_counts[p] = self._prio_counts.get(p, 0) + 1
                    self.stats.record_submit()
                    self.stats.set_queue_depth(len(self._dq))
                    self._cv.notify_all()
                    return ticket
                if self.policy == "fail":
                    self.stats.record_reject()
                    raise QueueFull(
                        f"admission queue full ({self.capacity})"
                    )
                # block policy: wait for space, bounded by the request's
                # own deadline — expiring in THIS wait is still "expired
                # in the queue", shed the same way
                now = self.clock()
                if ticket.expired(now):
                    # counts as submitted-then-shed so the accounting
                    # identity holds: submitted == completed + shed +
                    # cancelled + in-flight
                    self.stats.record_submit()
                    ticket.shed(now)
                    self.stats.record_shed()
                    return ticket
                timeout = (
                    None if ticket.deadline_t is None
                    else max(ticket.deadline_t - now, 0.0)
                )
                self._cv.wait(timeout)

    # -- dispatch side -------------------------------------------------------
    def shed_expired(self, now: float) -> int:
        """Complete every expired ticket with DeadlineExceeded and drop it
        from the queue. Returns the shed count."""
        shed = 0
        with self._cv:
            live = deque()
            for t in self._dq:
                if t.expired(now):
                    t.shed(now)
                    self.stats.record_shed()
                    self._prio_dec(t.priority)
                    shed += 1
                else:
                    live.append(t)
            if shed:
                self._dq = live
                self.stats.set_queue_depth(len(self._dq))
                self._cv.notify_all()  # space freed: wake blocked submits
        return shed

    def take(self, batch_key: tuple, max_n: int) -> list:
        """Remove and return up to ``max_n`` tickets with ``batch_key``,
        highest priority class first, FIFO within a class; other keys
        stay queued in arrival order."""
        with self._cv:
            match = [t for t in self._dq if t.batch_key == batch_key]
            if len(self._prio_counts) > 1:
                # stable sort: equal priorities keep queue (arrival)
                # order. Skipped entirely on the common single-class
                # queue, where arrival order IS the answer.
                match.sort(key=lambda t: -t.priority)
            out = match[:max_n]
            if out:
                chosen = {id(t) for t in out}
                self._dq = deque(
                    t for t in self._dq if id(t) not in chosen
                )
                for t in out:
                    self._prio_dec(t.priority)
                self.stats.set_queue_depth(len(self._dq))
                self._cv.notify_all()
            return out

    def oldest(self) -> Optional[Ticket]:
        """The globally-oldest queued ticket regardless of priority — the
        LINGER clock. Keeping linger on this (while ``front()`` picks
        which key flushes) guarantees progress for every class: a
        lingered low-priority group forces a flush, draining whatever
        class is ahead of it until it reaches the front itself."""
        with self._cv:
            return self._dq[0] if self._dq else None

    def _prio_dec(self, p: int) -> None:
        """Drop one queued ticket from priority class ``p`` (caller holds
        the cv)."""
        n = self._prio_counts.get(p, 0) - 1
        if n > 0:
            self._prio_counts[p] = n
        else:
            self._prio_counts.pop(p, None)

    def front(self) -> Optional[Ticket]:
        """The oldest ticket of the highest priority class present — the
        ticket whose key defines the next micro-batch. O(1) with one
        class queued; a full scan only while classes actually mix."""
        with self._cv:
            if not self._dq:
                return None
            if len(self._prio_counts) <= 1:
                return self._dq[0]
            best = None
            for t in self._dq:
                if best is None or t.priority > best.priority:
                    best = t
            return best

    def count_key(self, batch_key: tuple) -> int:
        with self._cv:
            return sum(1 for t in self._dq if t.batch_key == batch_key)

    def depth(self) -> int:
        with self._cv:
            return len(self._dq)

    def wait_for_work(self, timeout: Optional[float] = None) -> bool:
        """Dispatch-thread parking: returns True when the queue is
        non-empty or closed (else after ``timeout``)."""
        with self._cv:
            if self._dq or self._closed:
                return True
            self._cv.wait(timeout)
            return bool(self._dq) or self._closed

    def park(self, timeout: float) -> None:
        """Sleep up to ``timeout`` seconds, waking early on any queue
        event (submit/close) — the dispatch thread's linger wait when
        requests are already queued but the flush policy says not yet."""
        with self._cv:
            if self._closed:
                return
            self._cv.wait(timeout)

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Stop admitting; queued tickets stay for draining."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    @property
    def closed(self) -> bool:
        with self._cv:
            return self._closed

    def cancel_all(self) -> int:
        """Fail every queued ticket with RuntimeClosed (non-drain close)."""
        with self._cv:
            n = len(self._dq)
            for t in self._dq:
                t.fail(RuntimeClosed("runtime closed"))
                self.stats.record_cancel()
            self._dq.clear()
            self._prio_counts.clear()
            self.stats.set_queue_depth(0)
            self._cv.notify_all()
            return n

    def wake(self) -> None:
        """Nudge any waiter (used on close and by fake-clock tests)."""
        with self._cv:
            self._cv.notify_all()
