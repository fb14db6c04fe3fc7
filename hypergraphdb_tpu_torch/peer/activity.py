"""Activity framework: distributed async state machines.

Re-expression of the reference's workflow package (``peer/workflow/``):
``Activity``/``FSMActivity`` with ``@FromState``/``@OnMessage`` transition
methods, scheduled by an ``ActivityManager`` whose global queue ages
per-activity action queues by ``timestamp × queue-size`` for fairness
(``peer/workflow/ActivityManager.java:49,63-103``).

An activity is a small state machine keyed by (activity_type, activity_id).
Incoming messages are enqueued to the owning activity's action queue; a
worker pool drains the globally-fairest queue first. ``Activity.future``
resolves when the activity reaches a terminal state (Completed/Failed) —
the ``TaskActivity`` future-result analogue.
"""

from __future__ import annotations

import heapq
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Optional

from hypergraphdb_tpu_torch.peer import messages as M

# terminal workflow states (WorkflowState analogue)
STARTED = "Started"
COMPLETED = "Completed"
FAILED = "Failed"
CANCELED = "Canceled"
TERMINAL = frozenset({COMPLETED, FAILED, CANCELED})


def from_state(state: str, performative: Optional[str] = None):
    """Decorator marking a transition method: runs when a message arrives
    while the activity is in ``state`` (optionally filtered by
    performative) — the ``@FromState``/``@OnMessage`` annotations."""

    def deco(fn):
        fn._from_state = state
        fn._performative = performative
        return fn

    return deco


class Activity:
    """Base distributed activity (one side of a conversation)."""

    TYPE = "activity"

    def __init__(self, peer, activity_id: Optional[str] = None):
        self.peer = peer
        self.id = activity_id or __import__("uuid").uuid4().hex
        self.state = STARTED
        self.future: Future = Future()
        self._transitions = self._collect_transitions()
        # transitions of ONE activity must serialize: the manager's worker
        # pool can otherwise run two messages of the same conversation
        # concurrently, racing FSM state (the reference serializes through
        # per-activity action queues; our heap pops can interleave).
        # RLock: complete()/fail() take it too, and transitions call them
        # from inside handle() with the lock already held.
        self._handle_lock = threading.RLock()

    @classmethod
    def _collect_transitions(cls) -> list:
        out = []
        for name in dir(cls):
            fn = getattr(cls, name, None)
            if callable(fn) and hasattr(fn, "_from_state"):
                out.append(fn)
        return out

    # -- lifecycle ----------------------------------------------------------
    def initiate(self) -> None:
        """Client-side kick-off: send the opening message."""

    def handle(self, sender: str, msg: dict) -> None:
        """Dispatch to the matching @from_state transition (serialized per
        activity — see ``_handle_lock``)."""
        with self._handle_lock:
            if self.state in TERMINAL:
                return  # late message after completion: drop, don't fail
            for fn in self._transitions:
                if fn._from_state == self.state and (
                    fn._performative is None
                    or fn._performative == msg.get("performative")
                ):
                    fn(self, sender, msg)
                    return
            self.fail(f"no transition from {self.state} "
                      f"for {msg.get('performative')}")

    def complete(self, result: Any = None) -> None:
        # state writes race handle()'s state reads when a caller (timeout
        # path, peer shutdown) terminates the activity from another thread
        # (hglint HG402) — reentrant from within a transition
        with self._handle_lock:
            self.state = COMPLETED
            if not self.future.done():
                self.future.set_result(result)

    def fail(self, reason: Any) -> None:
        with self._handle_lock:
            self.state = FAILED
            if not self.future.done():
                self.future.set_exception(
                    reason if isinstance(reason, Exception)
                    else RuntimeError(str(reason))
                )

    # -- conveniences --------------------------------------------------------
    def send(self, target: str, performative: str, content: Any = None,
             trace_ctx: Optional[dict] = None) -> None:
        """Send an activity message; ``trace_ctx`` (a ``Trace.context()``
        dict) stamps it for cross-process span-tree propagation."""
        self.peer.interface.send(
            target, M.attach_trace(
                M.make_message(performative, self.TYPE, content, self.id),
                trace_ctx,
            )
        )

    def reply(self, target: str, msg: dict, performative: str,
              content: Any = None,
              trace_ctx: Optional[dict] = None) -> None:
        self.peer.interface.send(target, M.attach_trace(
            M.reply_to(msg, performative, content), trace_ctx,
        ))


class ActivityManager:
    """Fair scheduler over per-activity action queues.

    Priority = enqueue-timestamp − backlog·age_weight: older and more
    backed-up activities run first (the ``ActivityManager.java:63-103``
    aging rule), drained by a small worker pool.
    """

    def __init__(self, peer, workers: int = 2, age_weight: float = 0.001,
                 tick_interval: float = 0.25):
        self.peer = peer
        self.age_weight = age_weight
        #: watchdog cadence: live activities exposing a ``tick(now)``
        #: method (e.g. TransferGraphClient's stall-resume) get called
        #: every interval — the timer infrastructure the message-driven
        #: FSMs otherwise lack; 0 disables the ticker
        self.tick_interval = tick_interval
        self._activities: dict[tuple[str, str], Activity] = {}
        self._factories: dict[str, Callable[..., Activity]] = {}
        self._queues: dict[tuple[str, str], list] = {}
        self._heap: list = []
        self._cv = threading.Condition()
        self._running = False
        self._workers = [
            threading.Thread(target=self._work, name=f"activity-worker-{i}",
                             daemon=True)
            for i in range(workers)
        ]
        self._stop_evt = threading.Event()
        self._ticker = threading.Thread(
            target=self._tick_loop, name="activity-ticker", daemon=True
        )
        self._seq = 0

    # -- registry -------------------------------------------------------------
    def register_type(self, activity_type: str,
                      factory: Callable[..., Activity]) -> None:
        """Server-side: how to instantiate the responding activity when a
        fresh conversation of this type arrives (bootstrap op analogue)."""
        self._factories[activity_type] = factory

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        for w in self._workers:
            w.start()
        if self.tick_interval:
            self._ticker.start()

    def stop(self) -> None:
        self._running = False
        self._stop_evt.set()
        with self._cv:
            self._cv.notify_all()
        for w in self._workers:
            w.join(timeout=5)
        if self._ticker.is_alive():
            self._ticker.join(timeout=5)

    def _tick_loop(self) -> None:
        import logging

        while not self._stop_evt.wait(self.tick_interval):
            with self._cv:
                acts = list(self._activities.values())
            now = time.monotonic()
            for act in acts:
                tick = getattr(act, "tick", None)
                if tick is not None:
                    try:
                        tick(now)
                    except Exception:  # a bug must not kill the timer
                        logging.getLogger(
                            "hypergraphdb_tpu_torch.peer"
                        ).exception("activity tick failed")
                if act.state in TERMINAL:
                    # reap activities that reached a terminal state
                    # OUTSIDE a handle() transition (e.g. a watchdog
                    # fail(), or completion inside initiate()): _work
                    # only cleans up after messages, so these would
                    # otherwise sit in the registry forever
                    with self._cv:
                        key = (act.TYPE, act.id)
                        if self._activities.get(key) is act:
                            self._activities.pop(key, None)
                            self._queues.pop(key, None)

    # -- activity lifecycle ----------------------------------------------------
    def initiate(self, activity: Activity) -> Activity:
        key = (activity.TYPE, activity.id)
        with self._cv:
            self._activities[key] = activity
        activity.initiate()
        return activity

    def on_message(self, sender: str, msg: dict) -> None:
        """Transport handler: route to the owning activity's queue,
        instantiating a responder for fresh conversations."""
        atype = msg.get("activity_type")
        aid = msg.get("activity_id")
        if not atype or not aid:
            return
        key = (atype, aid)
        with self._cv:
            act = self._activities.get(key)
            if act is None:
                factory = self._factories.get(atype)
                if factory is None:
                    return
                act = factory(self.peer, activity_id=aid)
                self._activities[key] = act
            q = self._queues.setdefault(key, [])
            q.append((sender, msg))
            # fairness: older first, long backlogs boosted
            prio = time.monotonic() - len(q) * self.age_weight
            self._seq += 1
            heapq.heappush(self._heap, (prio, self._seq, key))
            self._cv.notify()

    def _work(self) -> None:
        while True:
            with self._cv:
                while self._running and not self._heap:
                    self._cv.wait(timeout=0.5)
                if not self._running:
                    return
                _, _, key = heapq.heappop(self._heap)
                q = self._queues.get(key)
                if not q:
                    continue
                sender, msg = q.pop(0)
                act = self._activities.get(key)
            if act is None or act.state in TERMINAL:
                continue
            try:
                act.handle(sender, msg)
            except Exception as e:  # a failing transition fails the activity
                act.fail(e)
            if act.state in TERMINAL:
                with self._cv:
                    self._activities.pop(key, None)
                    self._queues.pop(key, None)
