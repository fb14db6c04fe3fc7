"""Interest-based replication with an op log and offline catch-up.

Re-expression of the reference's ``peer/replication/`` + ``peer/log/``:

- **Interest predicates** (``Replication.java:19``): each peer publishes a
  serialized query condition; others push atom changes matching it
  (``PublishInterestsTask``/``RememberTaskClient.java:54``).
- **Op log with vector timestamps** (``peer/log/Log.java:34``): every local
  mutation appends (seq, op, atom closure); peers track how far they've
  seen each other's logs.
- **Catch-up** (``CatchUpTaskClient.java:33``): a peer that was offline
  requests entries since its recorded timestamp and applies them in order.

Eventual consistency, no consensus — deliberately matching the reference's
stance."""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Optional

from hypergraphdb_tpu_torch.core import events as ev
from hypergraphdb_tpu_torch.peer import messages as M
from hypergraphdb_tpu_torch.peer import transfer
from hypergraphdb_tpu_torch.query import serialize as qser

#: redelivery-journal record format; pre-versioning journals parse as 1
JOURNAL_SCHEMA_VERSION = 1


class OpLog:
    """Append-only log of local mutations (one per peer).

    Entries: (seq, kind, payload). seq is this peer's own monotonically
    increasing timestamp — the vector-clock component it owns.

    Durable when constructed with a graph (the reference persists its
    versioned log, ``peer/log/Log.java:34``, so peers can serve CATCH-UP
    across restarts): each entry is a data record in the graph's store —
    WAL-protected on the native backend — addressed by an ordered system
    index keyed on the big-endian sequence number.

    The persisted index IS the log: opens read only the head/floor meta
    markers (a long-lived ingesting peer's log no longer bloats open time
    or RAM), ``since`` serves by RANGE CURSOR from
    the index, and :meth:`truncate_below` reclaims entries every connected
    peer has acknowledged (the reference's log is likewise bounded by
    catch-up needs). Without a graph the log lives in a plain list (tests,
    ephemeral peers)."""

    IDX = "hg.sys.oplog"
    META = "hg.sys.oplog.meta"

    def __init__(self, graph=None) -> None:
        self._lock = threading.Lock()
        self._graph = graph
        self._mem: list[tuple[int, str, Any]] = []  # RAM mode only
        self._head = 0
        self._floor = 0  # entries with seq <= floor are truncated
        if graph is not None:
            self._head = self._meta_get(b"head")
            self._floor = self._meta_get(b"floor")
            if self._head == 0:
                # legacy log without meta markers: recover head from the
                # last index key (keys scan, no payload loads)
                idx = graph.store.get_index(self.IDX, create=False)
                if idx is not None:
                    for key in idx.scan_keys():
                        self._head = int.from_bytes(key, "big")

    # -- meta markers ---------------------------------------------------------
    def _meta_get(self, key: bytes) -> int:
        idx = self._graph.store.get_index(self.META, create=False)
        if idx is None:
            return 0
        vals = idx.find(key).array()
        return int(vals.max()) if len(vals) else 0

    @staticmethod
    def _meta_set(idx, key: bytes, prev: int, value: int) -> None:
        if prev:
            idx.remove_entry(key, prev)
        idx.add_entry(key, value)

    # -- appends ---------------------------------------------------------------
    def append(self, kind: str, payload: Any) -> int:
        seq = self.append_mem(kind, payload)
        self.persist_many([(seq, kind, payload)])
        return seq

    def append_mem(self, kind: str, payload: Any) -> int:
        """Assign a sequence number (and, in RAM mode, record the entry) —
        callers batching many appends persist once via
        :meth:`persist_many`."""
        with self._lock:
            self._head += 1
            if self._graph is None:
                self._mem.append((self._head, kind, payload))
            return self._head

    def rollback_mem(self, mark: int) -> None:
        """Un-assign every sequence number above ``mark`` (a batched
        prepare whose transaction conflicted retries with fresh seqs)."""
        with self._lock:
            self._head = mark
            if self._graph is None:
                while self._mem and self._mem[-1][0] > mark:
                    self._mem.pop()

    def persist_many(self, batch) -> None:
        """Durably record a batch of (seq, kind, payload) entries — plus
        the head marker — in ONE store transaction (the push worker drains
        dozens of mutations per cycle; a transaction per entry would
        serialize it against the ingest thread's commits)."""
        g = self._graph
        if g is None or not batch:
            return
        import json

        encoded = [
            (seq.to_bytes(8, "big"),
             json.dumps([kind, payload]).encode("utf-8"))
            for seq, kind, payload in batch
        ]
        new_head = max(seq for seq, _, _ in batch)

        def persist() -> None:
            idx = g.store.get_index(self.IDX)
            for key, raw in encoded:
                dh = g.handles.make()
                g.store.store_data(dh, raw)
                idx.add_entry(key, dh)
            meta = g.store.get_index(self.META)
            prev = self._meta_get(b"head")
            if new_head > prev:
                self._meta_set(meta, b"head", prev, new_head)

        g.txman.ensure_transaction(persist)

    # -- reads -----------------------------------------------------------------
    def since(self, seq: int,
              limit: Optional[int] = None) -> list[tuple[int, str, Any]]:
        """Entries with sequence > ``seq``, served by index range cursor
        (durable mode) — the in-RAM log is gone, so this is O(result), not
        O(log). Truncated entries (≤ floor) cannot be served; callers
        compare ``seq`` against :attr:`floor` to detect the gap."""
        g = self._graph
        if g is None:
            with self._lock:
                out = [e for e in self._mem if e[0] > seq]
            return out[:limit] if limit is not None else out
        import json

        idx = g.backend.get_index(self.IDX, create=False)
        if idx is None:
            return []
        lo = (max(seq, 0) + 1).to_bytes(8, "big")
        # key scan under the commit lock: memstore's bulk_items iterates the
        # LIVE sorted dict, so a concurrent persist_many would raise
        # RuntimeError mid-iteration. The hold is
        # bounded by `limit`; payload loads happen outside the lock.
        pairs: list[tuple[int, int]] = []
        with g.txman._commit_lock:
            for key, hs in idx.bulk_items(lo=lo):
                s = int.from_bytes(key, "big")
                for dh in hs.tolist():
                    pairs.append((s, int(dh)))
                if limit is not None and len(pairs) >= limit:
                    break
        res: list[tuple[int, str, Any]] = []
        for s, dh in pairs:
            raw = g.store.get_data(dh)
            if raw is None:
                continue
            kind, payload = json.loads(raw.decode("utf-8"))
            res.append((s, kind, payload))
        # no final cut: the key scan above stops only at a key boundary,
        # so a page never splits the entries of one sequence number (a
        # client resumes after the highest seq it applied)
        return res

    def truncate_below(self, seq: int) -> int:
        """Drop entries with sequence ≤ ``seq`` (their data records too)
        and advance the floor. Returns how many entries were dropped.
        Callers only pass positions every peer has acknowledged."""
        g = self._graph
        with self._lock:
            seq = min(seq, self._head)
            if seq <= self._floor:
                return 0
            old_floor = self._floor
        if g is None:
            with self._lock:
                self._floor = seq
                n0 = len(self._mem)
                self._mem = [e for e in self._mem if e[0] > seq]
                return n0 - len(self._mem)
        idx = g.backend.get_index(self.IDX, create=False)
        if idx is None:
            return 0
        victims: list[tuple[bytes, int]] = []
        with g.txman._commit_lock:  # live-iterator guard, same as since()
            for key, hs in idx.bulk_items():
                if int.from_bytes(key, "big") > seq:
                    break
                for dh in hs.tolist():
                    victims.append((key, int(dh)))

        def drop() -> None:
            sidx = g.store.get_index(self.IDX)
            for key, dh in victims:
                sidx.remove_entry(key, dh)
                g.store.remove_data(dh)
            meta = g.store.get_index(self.META)
            self._meta_set(meta, b"floor", old_floor, seq)

        # durable first: the in-memory floor only advances once the drop
        # committed, so a failed/conflicted truncation never makes since()
        # report a gap that pushes peers into needless full syncs
        g.txman.ensure_transaction(drop)
        with self._lock:
            self._floor = max(self._floor, seq)
        return len(victims)

    @property
    def head(self) -> int:
        with self._lock:
            return self._head

    @property
    def floor(self) -> int:
        with self._lock:
            return self._floor


class SeenMap:
    """Durable, GAP-AWARE vector clock: peer id → applied-seq intervals
    of THEIR log. Two views per peer:

    - the **contiguous ack** (:meth:`get`): the highest seq such that
      every entry up to it has been applied here — what we acknowledge
      to the sender and request catch-up ``since``. This is the value
      persisted through the store (one entry per peer, same index/schema
      as the pre-gap-aware map), so catch-up resumes correctly after
      BOTH sides restart (ref ``CatchUpTaskClient.java:33``);
    - the **applied intervals** (:meth:`intervals` / :meth:`gaps`): the
      full set of applied seq ranges, RAM-only. A push that skips ahead
      (its predecessors dropped past the redelivery budget) opens a
      HOLE between intervals — the divergence the old max-applied ack
      silently papered over. :class:`Replication` watches
      :meth:`has_gap` and repairs by targeted catch-up from the
      contiguous ack; the re-applied tail is idempotent, so losing the
      RAM intervals in a crash costs a re-fetch, never correctness.

    Seq 0 means "nothing" and is trivially applied, so interval 0 always
    starts at 0 and the contiguous ack is its high end. Anchors
    (:meth:`set` — a completed snapshot transfer, a legacy max-ack) cover
    the whole prefix ``[0, seq]``."""

    IDX = "hg.sys.oplog.seen"

    def __init__(self, graph=None) -> None:
        self._graph = graph
        self._lock = threading.Lock()
        self._map: dict[str, int] = {}  # contiguous ack (durable)
        #: pid → sorted disjoint [lo, hi] intervals of applied seqs
        self._ranges: dict[str, list[list[int]]] = {}
        if graph is not None:
            idx = graph.store.get_index(self.IDX, create=False)
            if idx is not None:
                for key, hs in idx.bulk_items():
                    vals = hs.tolist()
                    if vals:
                        self._map[key.decode("utf-8")] = max(vals)
        for pid, v in self._map.items():
            self._ranges[pid] = [[0, v]]
        #: pid → last value durably written (the remove key of the next
        #: persist); loaded state IS persisted state
        self._persisted: dict[str, int] = dict(self._map)

    def get(self, pid: str, default: int = 0) -> int:
        with self._lock:
            return self._map.get(pid, default)

    def set(self, pid: str, seq: int) -> None:
        """Anchor: everything up to ``seq`` is covered (snapshot
        bootstrap semantics — the transfer shipped the whole prefix)."""
        self._cover(pid, 0, int(seq))

    def record_applied(self, pid: str, seq: int,
                       prev: Optional[int] = None,
                       persist: bool = True) -> int:
        """One entry of ``pid``'s log applied here; returns the (possibly
        advanced) contiguous ack. ``prev`` — the seq the sender last
        PUSHED to us before this one — additionally covers the range
        ``(prev, seq)``: those positions hold entries the sender's
        interest predicate deliberately skipped, not losses (a real loss
        is a pushed-but-dropped seq, and ``prev`` points AT it, never
        past it — so the hole it leaves stays visible).
        ``persist=False`` defers the durable store write — a batch
        applier covers each position in RAM and calls :meth:`persist`
        ONCE per sender per cycle instead of paying one store
        transaction per in-order push."""
        if seq <= 0:
            return self.get(pid)
        seq = int(seq)
        lo = seq
        if prev is not None and 0 <= int(prev) < seq:
            lo = int(prev) + 1
        return self._cover(pid, lo, seq, persist=persist)

    def _cover(self, pid: str, lo: int, hi: int,
               persist: bool = True) -> int:
        with self._lock:
            ivs = self._ranges.setdefault(pid, [[0, 0]])
            ivs.append([lo, hi])
            # the sort-and-merge must stay atomic with the read (interval
            # invariant), and the list is bounded: it holds MERGED ranges,
            # so after every _cover it collapses back to a handful
            ivs.sort()  # hglint: disable=HG703
            merged = [ivs[0][:]]
            for a, b in ivs[1:]:
                if a <= merged[-1][1] + 1:  # overlapping or adjacent
                    merged[-1][1] = max(merged[-1][1], b)
                else:
                    merged.append([a, b])
            self._ranges[pid] = merged
            contiguous = merged[0][1]  # merged[0][0] == 0 by seeding
            prev = self._map.get(pid)
            advanced = prev is None or contiguous > prev
            if advanced:
                self._map[pid] = contiguous
        if persist and advanced:
            self.persist(pid)
        return contiguous

    def persist(self, pid: str) -> None:
        """Durably store ``pid``'s current contiguous ack if it advanced
        past the last persisted value (no-op otherwise). The store tx
        runs OUTSIDE the leaf lock; an exception propagates — callers
        must not ack past an unpersisted position (they retry on the
        next cycle; the sender re-serves from our last durable ack and
        apply is idempotent)."""
        g = self._graph
        if g is None:
            return
        with self._lock:
            cur = self._map.get(pid)
            prev = self._persisted.get(pid)
        if cur is None or (prev is not None and cur <= prev):
            return
        key = pid.encode("utf-8")

        def persist_tx() -> None:
            idx = g.store.get_index(self.IDX)
            if prev is not None:
                idx.remove_entry(key, prev)
            idx.add_entry(key, cur)

        g.txman.ensure_transaction(persist_tx)
        with self._lock:
            if self._persisted.get(pid, -1) < cur:
                self._persisted[pid] = cur

    # -- gap queries -----------------------------------------------------------
    def intervals(self, pid: str) -> list[tuple[int, int]]:
        with self._lock:
            return [tuple(iv) for iv in self._ranges.get(pid, [[0, 0]])]

    def max_applied(self, pid: str) -> int:
        with self._lock:
            ivs = self._ranges.get(pid)
            return ivs[-1][1] if ivs else 0

    def has_gap(self, pid: str) -> bool:
        with self._lock:
            return len(self._ranges.get(pid, ())) > 1

    def gaps(self, pid: str) -> list[tuple[int, int]]:
        """The missing seq ranges between applied intervals — what a
        targeted repair catch-up must re-fetch."""
        with self._lock:
            ivs = self._ranges.get(pid, [])
            return [
                (ivs[i][1] + 1, ivs[i + 1][0] - 1)
                for i in range(len(ivs) - 1)
            ]

    def items(self):
        with self._lock:
            return list(self._map.items())


class Replication:
    """Per-peer replication service: publishes interests, pushes matching
    changes, applies incoming pushes, serves/runs catch-up."""

    ACTIVITY_TYPE = "replication"

    def __init__(self, peer):
        self.peer = peer
        self.log = OpLog(peer.graph)
        #: my interest predicate (None = not interested in anything)
        self.interest = None
        #: peers whose logs truncated past our position — incremental
        #: catch-up cannot converge; bootstrap via cact.transfer_graph
        self.needs_full_sync: set[str] = set()
        #: peer id -> their deserialized interest condition
        self.peer_interests: dict[str, Any] = {}
        #: durable vector clock: peer id → last seq of THEIR log applied
        self.last_seen = SeenMap(peer.graph)
        self._listening = False
        # thread-local "applying a foreign push" flag: suppresses the local
        # event listeners so replicated writes don't echo back out, without
        # blinding OTHER threads' genuine local mutations
        self._tls = threading.local()
        # async push pipeline: the mutation path only
        # ENQUEUES a handle; serialization, logging and network push run on
        # a single worker thread (order-preserving, so log sequence numbers
        # follow commit order). The reference pushes via activities off the
        # event thread for the same reason (RememberTaskClient.java:54).
        # lock-free enqueue: deque.append is atomic under the GIL, so the
        # mutation path pays ONE C-level call — no lock, no notify (the
        # worker polls on short timeouts; flush() wakes it explicitly)
        self._pending: Any = deque()
        self._cv = threading.Condition()
        self._worker: Optional[threading.Thread] = None
        self._stopping = False
        self._draining = 0  # items popped but not yet fully processed
        self._flush_asap = False
        # incoming-apply pipeline: pushes/catch-up
        # results are APPLIED off the transport dispatch thread — a large
        # closure store must not stall unrelated peer messages (the
        # reference applies via scheduled activities,
        # ActivityManager.java:63-103). One FIFO worker preserves per-peer
        # order; SeenMap writes batch per drained cycle.
        self._apply_q: Any = deque()
        self._apply_cv = threading.Condition()
        self._apply_worker: Optional[threading.Thread] = None
        self._apply_busy = 0
        #: how far each peer has acknowledged MY log (their CONTIGUOUS
        #: applied seq — gap-aware); min over interested peers gates log
        #: truncation, so a peer stuck behind a gap pins the floor until
        #: its repair catch-up has what it needs
        self.peer_acks: dict[str, int] = {}
        #: last known HEAD of each peer's log (push/catch-up/digest
        #: metadata rides it along) — ``replication_lag`` reads this
        self.peer_heads: dict[str, int] = {}
        #: peers with a detected apply gap whose targeted repair
        #: catch-up is in flight (cleared when a catch-up page arrives,
        #: so a lost repair request re-triggers on the next apply cycle)
        self._gap_repairs: set[str] = set()
        #: contiguous position at each peer's LAST digest-result — the
        #: anti-entropy stall detector: behind-the-head is only repaired
        #: when we made no progress since the previous probe (or on the
        #: first probe), so steady in-flight ingest doesn't trigger a
        #: redundant catch-up every tick
        self._ae_seen_pos: dict[str, int] = {}
        #: auto-truncate the op log once every interested peer has
        #: acknowledged at least `truncate_batch` entries past the floor
        self.auto_truncate = True
        self.truncate_batch = 256
        #: catch-up responses are served in pages of this many entries (one
        #: rejoining peer must not make the dispatch thread materialize and
        #: wire-expand the whole surviving log); the client requests the
        #: next page after applying the previous one
        self.catchup_page = 1024
        #: debounce: wait for a quiet gap before draining so serialization
        #: does not steal cycles from a hot ingest loop (with the GIL, a
        #: busy worker halves writer throughput); backpressure cap bounds
        #: the deferred backlog
        self.debounce_s = 0.05
        self.max_backlog = 20_000
        # -- self-healing send plane (hgfault): pushes get bounded retry
        # with capped backoff ON THE WORKER THREAD (never the mutation
        # path), then land in a PER-PEER ORDERED redelivery queue. Order
        # is the invariant: once a peer has queued redeliveries (or is
        # down-marked), every later push to it queues BEHIND them and the
        # retry pass drains in order, stopping at the first failure — a
        # redelivered remove can never land after a newer re-add.
        # Receivers apply idempotently (store_closure is a write-through
        # upsert keyed by gid) and the SeenMap records only applied
        # progress, so a duplicated push is a no-op. A message dropped
        # past max_redeliveries is a real wire loss — but no longer a
        # SILENT one: the receiver's SeenMap tracks applied-seq
        # CONTIGUITY, so the hole shows the moment a later push lands
        # (targeted catch-up repairs it), and the periodic anti-entropy
        # digest catches the before-a-silence case; the journal below
        # additionally lets the queue itself survive a process death.
        self.send_attempts = 3
        self.send_backoff_s = 0.02
        self.send_backoff_max_s = 0.25
        self.max_redeliveries = 4
        #: spacing between redelivery passes when the drain queue is
        #: otherwise idle: back-to-back passes would burn the whole
        #: ladder in a fraction of a second, covering no realistic
        #: outage (flush() skips the spacing — "settle now" semantics)
        self.redelivery_interval_s = 0.25
        self.max_redelivery_backlog = 10_000
        #: pid -> deque[(message, attempt)] — worker-thread-owned;
        #: emptied entries are popped so dict truthiness == "work queued"
        self._redelivery: dict[str, Any] = {}
        self._redelivery_n = 0
        #: crash-surviving redelivery queue: path of a JSONL journal
        #: (None + a persistent graph → defaulted beside the store at
        #: attach()). Rewritten crash-atomically (fsync + os.replace,
        #: the ops/checkpoint discipline) by the worker whenever the
        #: queue changes; replayed on attach, so queued-but-undelivered
        #: pushes survive a process death instead of dying with it.
        #: Receivers apply idempotently, so replay is safe by
        #: construction.
        self.journal_path: Optional[str] = None
        self._journal_dirty = False
        #: minimum spacing of DIRTY-queue journal rewrites: each save is
        #: O(total backlog), so a hot ingest loop against one dead peer
        #: would otherwise pay a growing multi-MB rewrite EVERY worker
        #: cycle, throttling replication to the healthy peers through
        #: the shared worker. An EMPTY queue always saves immediately —
        #: the state flush() reports settled stays journal-exact; the
        #: widened crash window only risks re-losing messages the gap
        #: tracking / anti-entropy backstops already repair.
        self.journal_save_interval_s = 0.25
        self._journal_last_save = 0.0
        #: last seq actually pushed per peer (anchored at the log head
        #: when the interest registers): pushes carry it as ``prev`` so
        #: interest-filtered receivers can tell a predicate skip from a
        #: wire loss. RAM-only is safe: fanout only reaches peers in
        #: ``peer_interests``, and the interest handler re-anchors on
        #: every (re)registration
        self._sent_head: dict[str, int] = {}
        #: peers whose LAST ladder exhausted → fresh pushes skip straight
        #: to the redelivery queue until the grace expires, so one dead
        #: peer's backoff sleeps cannot head-of-line-block the worker's
        #: pushes to healthy peers (the redelivery pass probes ONE head
        #: message per down peer per pass and clears the mark on success)
        self.down_peer_grace_s = 0.5
        self._down_until: dict[str, float] = {}
        self._sleep = time.sleep  # injectable (tests)

    # -- wiring ---------------------------------------------------------------
    def attach(self) -> None:
        """Subscribe to local graph events (HGAtomAddedEvent push path)."""
        if self._listening:
            return
        g = self.peer.graph
        g.events.add_listener(ev.HGAtomAddedEvent, self._on_added)
        g.events.add_listener(ev.HGAtomRemovedEvent, self._on_removed)
        g.events.add_listener(ev.HGAtomReplacedEvent, self._on_replaced)
        self._listening = True
        self._stopping = False
        if self.journal_path is None:
            loc = getattr(getattr(g, "config", None), "location", None)
            if loc:
                import os

                self.journal_path = os.path.join(
                    loc, "replication.redelivery.jsonl"
                )
        self._journal_replay()
        self._worker = threading.Thread(
            target=self._drain, name="replication-push", daemon=True
        )
        self._worker.start()
        self._apply_worker = threading.Thread(
            target=self._apply_drain, name="replication-apply", daemon=True
        )
        self._apply_worker.start()

    def detach(self) -> None:
        """Flush the push queue and stop the worker + listeners."""
        if not self._listening:
            return
        g = self.peer.graph
        g.events.remove_listener(ev.HGAtomAddedEvent, self._on_added)
        g.events.remove_listener(ev.HGAtomRemovedEvent, self._on_removed)
        g.events.remove_listener(ev.HGAtomReplacedEvent, self._on_replaced)
        self._listening = False
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        with self._apply_cv:
            self._apply_cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=10)
            self._worker = None
        if self._apply_worker is not None:
            self._apply_worker.join(timeout=10)
            self._apply_worker = None

    def flush(self, timeout: float = 10.0) -> bool:
        """Block until every enqueued mutation has been logged and pushed
        (including the redelivery queue settling — delivered or dropped
        after ``max_redeliveries``), AND every received push/catch-up
        batch has been applied (both worker pipelines drained)."""
        import time as _time

        deadline = _time.monotonic() + timeout
        with self._cv:
            self._flush_asap = True
            self._cv.notify_all()
            while self._pending or self._draining or self._redelivery:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.notify_all()
                self._cv.wait(min(remaining, 0.05))
        with self._apply_cv:
            while self._apply_q or self._apply_busy:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return False
                self._apply_cv.notify_all()
                self._apply_cv.wait(min(remaining, 0.05))
        return True

    # -- local mutation hooks (mutation path: enqueue ONLY) --------------------
    def _on_added(self, graph, event) -> None:
        self._enqueue("add", int(event.handle))

    def _on_replaced(self, graph, event) -> None:
        self._enqueue("add", int(event.handle))  # same write-through semantics

    def _on_removed(self, graph, event) -> None:
        self._enqueue("remove", int(event.handle))

    @property
    def _applying(self) -> bool:
        return getattr(self._tls, "applying", False)

    def _enqueue(self, kind: str, h: int) -> None:
        if self._applying:
            # this write IS a replicated one — re-pushing it would echo
            # forever between interested peers
            return
        self._pending.append((kind, h))  # atomic; no lock on this path

    def _drain(self) -> None:
        while True:
            with self._cv:
                while (not self._pending and not self._redelivery
                       and not self._stopping):
                    self._flush_asap = False
                    self._cv.wait(0.1)
                if not self._pending and self._stopping:
                    # redelivery is best-effort on shutdown: catch-up is
                    # the documented convergence path for whatever is left
                    return
                if (not self._pending and self._redelivery
                        and not self._stopping and not self._flush_asap):
                    # redelivery-only cycle: space the passes out so the
                    # bounded ladder spans a real outage window instead
                    # of burning out back-to-back (a submit/flush/stop
                    # notification still wakes us early)
                    self._cv.wait(self.redelivery_interval_s)
                batch = []
                if self._pending:
                    # debounce: while the writer is hot (queue growing)
                    # hold off, unless stopping/flushing or backlog-capped
                    last = len(self._pending)
                    while (not self._stopping and not self._flush_asap
                           and last < self.max_backlog):
                        self._cv.wait(self.debounce_s)
                        now = len(self._pending)
                        if now == last:
                            break  # quiet gap: the writer paused
                        last = now
                    while self._pending:
                        batch.append(self._pending.popleft())
                self._draining += len(batch)
            try:
                log_batch, pushes = (
                    self._prepare_batch(batch) if batch else ([], [])
                )
            except Exception:
                import logging

                logging.getLogger("hypergraphdb_tpu_torch.peer").warning(
                    "replication batch prepare failed", exc_info=True
                )
                log_batch, pushes = [], []
            try:
                self.log.persist_many(log_batch)  # one tx for the batch
                for (seq, _, _), kind, h, entry in pushes:
                    self._fanout(kind, h, entry, seq)
                # truncation that lost a race against a hot ingest loop
                # retries here, when the writer has gone quiet
                self._maybe_truncate()
            except Exception:
                import logging

                logging.getLogger("hypergraphdb_tpu_torch.peer").warning(
                    "replication batch persist/push failed", exc_info=True
                )
            try:
                if self._redelivery:
                    # busy-marked so flush() cannot observe "all queues
                    # empty" while a popped message is still in flight
                    with self._cv:
                        self._draining += 1
                    try:
                        self._retry_redeliveries()
                    finally:
                        with self._cv:
                            self._draining -= 1
            except Exception:
                import logging

                logging.getLogger("hypergraphdb_tpu_torch.peer").warning(
                    "replication redelivery pass failed", exc_info=True
                )
            finally:
                if self._journal_dirty:
                    # persist queue changes BEFORE flush() can observe
                    # the cycle as settled — journal == queue state.
                    # Rate-limited while a backlog churns (each save is
                    # O(backlog)); the settled/EMPTY state always saves
                    now_m = time.monotonic()
                    if (not self._redelivery
                            or now_m - self._journal_last_save
                            >= self.journal_save_interval_s):
                        self._journal_dirty = False
                        self._journal_last_save = now_m
                        self._journal_save()
                with self._cv:
                    self._draining -= len(batch)
                    self._cv.notify_all()

    # -- worker-side log + push -------------------------------------------------
    def _prepare_batch(self, batch):
        """Prepare a drained batch inside ONE transaction (per-atom commits
        were half the worker's cost). The tx CAN conflict — serialization
        reads note cells a racing writer may move — so on conflict the
        memory-log appends are rolled back and the whole batch retried;
        the worker must never die."""
        from hypergraphdb_tpu_torch.core.errors import TransactionConflict

        g = self.peer.graph
        for _ in range(8):
            log_batch: list[tuple] = []
            pushes: list[tuple] = []
            mark = self.log.head
            tx = g.txman.begin()
            try:
                for kind, h in batch:
                    try:
                        if kind == "remove":
                            item = self._prepare_remove(h)
                        else:
                            item = self._prepare_record(kind, h)
                        if item is not None:
                            log_batch.append(item[0])
                            pushes.append(item)
                    except Exception:
                        import logging

                        logging.getLogger("hypergraphdb_tpu_torch.peer").warning(
                            "replication push failed for %s %s", kind, h,
                            exc_info=True,
                        )
            except BaseException:
                g.txman.abort(tx)
                self.log.rollback_mem(mark)
                raise
            try:
                g.txman.commit(tx)
                return log_batch, pushes
            except TransactionConflict:
                self.log.rollback_mem(mark)
                continue
        import logging

        logging.getLogger("hypergraphdb_tpu_torch.peer").warning(
            "replication batch kept conflicting; re-enqueued for a later "
            "drain cycle"
        )
        # the log IS the catch-up source — dropping the batch would be
        # permanent silent replication loss. Put it back at the FRONT so
        # ordering is preserved and the next (debounced) cycle retries.
        self._pending.extendleft(reversed(batch))
        return [], []

    def _prepare_remove(self, h: int):
        gid = transfer.existing_gid(self.peer.graph, h)
        if gid is None:
            # the atom never crossed the wire: no peer can hold a copy, so
            # there is nothing to retract (and minting a gid for it would
            # pollute the atom map)
            return None
        entry = {"gid": gid}
        seq = self.log.append_mem("remove", entry)
        return (seq, "remove", entry), "remove", h, entry

    def _prepare_record(self, kind: str, h: int):
        g = self.peer.graph
        if not g.contains(h):
            return None  # removed before the worker got to it
        if self.peer_interests:
            # pushes are applied out of order at receivers → full closure
            atoms = transfer.serialize_closure(g, h, self.peer.identity)
        else:
            # log-only entry: catch-up replays IN ORDER, so an atom's
            # targets always have earlier entries — one record suffices
            # (serializing the whole closure per mutation tripled the
            # ingest-side overhead for nothing)
            atoms = [transfer.serialize_atom(g, h, self.peer.identity)]
        entry = {"atoms": atoms,
                 "root": transfer.gid_of(g, h, self.peer.identity)}
        seq = self.log.append_mem(kind, entry)
        return (seq, kind, entry), kind, h, entry

    def _expand_for_wire(self, kind: str, entry: dict):
        """Log entries hold the ROOT record only (ordered replay makes the
        closure redundant); a PARTIAL catch-up client may lack targets from
        before its `since`, so expand to the full closure at serve time —
        rare path, paid by the server, not the ingest hot loop."""
        atoms = entry.get("atoms")
        if kind == "remove" or not atoms or len(atoms) != 1:
            return entry
        if not atoms[0].get("targets"):
            return entry  # no dependencies to miss
        g = self.peer.graph
        h = transfer.lookup_local(g, entry["root"])
        if h is None or not g.contains(h):
            return entry  # atom gone; serve the recorded form
        return {
            "atoms": transfer.serialize_closure(g, int(h), self.peer.identity),
            "root": entry["root"],
        }

    def _fanout(self, kind: str, h: int, entry: dict, seq: int = 0) -> None:
        if kind == "remove":
            for pid in list(self.peer_interests):
                self._push(pid, "remove", entry, seq)
            return
        targets = [
            pid for pid, cond in list(self.peer_interests.items())
            if cond is None or self._matches(cond, h)
        ]
        if not targets:
            return
        # an interest may have arrived AFTER prepare chose the log-only
        # single-atom form; pushes are applied out of order at receivers,
        # so expand to the full closure (same rule as catch-up serving)
        entry = self._expand_for_wire(kind, entry)
        for pid in targets:
            self._push(pid, kind, entry, seq)

    def _matches(self, cond, h: int) -> bool:
        try:
            return bool(cond.satisfies(self.peer.graph, h))
        except Exception:
            return False

    def _push(self, pid: str, kind: str, entry: dict,
              seq: int = 0) -> None:
        # the push carries the ENTRY's own seq (gap-aware receivers
        # record exactly which log positions they applied — a batch-wide
        # head would make every entry of a drained batch look applied the
        # moment any one of them lands) plus the current head, so the
        # receiver's advertised lag is fresh on every push, plus ``prev``
        # — the last seq actually PUSHED to this peer: seqs in
        # (prev, seq) were skipped by the peer's own interest predicate,
        # so the receiver covers them as accounted-for instead of
        # reading every predicate skip as a wire loss and burning a
        # full-log repair catch-up per apply cycle (a REAL loss is a
        # pushed-but-dropped seq — prev points AT it, never past it)
        s = seq or self.log.head
        prev = self._sent_head.get(pid, 0)
        self._sent_head[pid] = s
        msg = M.make_message(
            M.INFORM, self.ACTIVITY_TYPE,
            {"what": "push", "kind": kind, "entry": entry,
             "seq": s, "head": self.log.head, "prev": prev},
        )
        # distributed tracing (worker thread, one enabled read): the push
        # roots a cross-process tree — the receiver's apply subtree joins
        # on the propagated trace id, even when delivery happens later
        # through the redelivery queue (the context rides the message)
        tracer = self.peer.tracer
        tr = None
        if tracer.enabled:
            tr = tracer.start_trace("peer.push", kind=kind, target=pid)
        if tr is not None:
            tr.marks["root"] = tr.start_span("push", target=pid, kind=kind)
            M.attach_trace(msg, tr.context())
        if (self._redelivery.get(pid)
                or time.monotonic() < self._down_until.get(pid, 0.0)):
            # ORDER: the peer already has queued redeliveries (or just
            # exhausted a ladder) — this push must line up behind them,
            # never overtake (and we skip paying 3 backoff sleeps per
            # message to a down peer)
            self._queue_redelivery(pid, msg, 1)
            if tr is not None:
                tr.finish_terminal("redelivery_queued")
            return
        if self._send_reliable(pid, msg):
            if tr is not None:
                tr.finish_terminal("sent")
        else:
            self._queue_redelivery(pid, msg, 1)
            if tr is not None:
                tr.finish_terminal("redelivery_queued")

    def _send_reliable(self, pid: str, message: dict) -> bool:
        """Send with bounded retry + capped backoff. Worker-thread only —
        the mutation path never sleeps here. Returns whether the
        transport accepted the message (delivery stays at-most-once;
        end-to-end convergence is redelivery + catch-up's job). Tracks
        per-peer down-marks: an exhausted ladder marks the peer down for
        ``down_peer_grace_s`` (fresh pushes skip the ladder), any success
        clears the mark."""
        m = self.peer.graph.metrics
        m.incr("peer.sends")
        for attempt in range(self.send_attempts):
            if attempt:
                m.incr("peer.send_retries")
                self._sleep(min(
                    self.send_backoff_s * (2.0 ** (attempt - 1)),
                    self.send_backoff_max_s,
                ))
            try:
                if self.peer.interface.send(pid, message):
                    self._down_until.pop(pid, None)
                    return True
            except Exception:  # hglint: disable=HG1005
                pass  # transport failure == unreachable now; the loop's
                # fall-through marks the peer down and counts send_failures
        self._down_until[pid] = time.monotonic() + self.down_peer_grace_s
        m.incr("peer.send_failures")
        return False

    def _queue_redelivery(self, pid: str, message: dict,
                          attempt: int) -> None:
        if self._redelivery_n >= self.max_redelivery_backlog:
            # a long-dead peer must not grow an unbounded queue; such a
            # peer re-joins via the TransferGraph bootstrap anyway
            self.peer.graph.metrics.incr("peer.redelivery_dropped")
            return
        q = self._redelivery.get(pid)
        if q is None:
            q = self._redelivery[pid] = deque()
        q.append((message, attempt))
        self._redelivery_n += 1
        self._journal_dirty = True
        with self._cv:
            self._cv.notify_all()

    def _retry_redeliveries(self) -> None:
        """One redelivery pass (worker thread, after the regular drain):
        per peer, drain the queue IN ORDER and stop at the first failure
        — one probe ladder per down peer per pass, so a dead peer with a
        deep backlog costs one bounded ladder, not sleeps-per-message.
        A head message failing past ``max_redeliveries`` drops with a
        counter (a real gap; see the class comment for the honest
        convergence story)."""
        m = self.peer.graph.metrics
        for pid in list(self._redelivery):
            q = self._redelivery.get(pid)
            while q:
                msg, attempt = q[0]
                m.incr("peer.redeliveries")
                if self._send_reliable(pid, msg):
                    q.popleft()
                    self._redelivery_n -= 1
                    self._journal_dirty = True
                    continue
                # ladder failed: leave the rest queued behind the head
                # (per-peer order is the invariant), probe again next
                # pass — unless the head is out of budget
                if attempt >= self.max_redeliveries:
                    q.popleft()
                    self._redelivery_n -= 1
                    self._journal_dirty = True
                    m.incr("peer.redelivery_dropped")
                else:
                    q[0] = (msg, attempt + 1)
                break
            if not q:
                self._redelivery.pop(pid, None)

    # -- redelivery journal (crash-surviving queue) -----------------------------
    def _journal_replay(self) -> None:
        """Load a surviving journal into the redelivery queue (peer
        open). Order within the file IS per-peer submission order — the
        save writes queues front-to-back — so the per-peer ordering
        invariant survives the restart too."""
        path = self.journal_path
        if path is None:
            return
        import json
        import os

        if not os.path.exists(path):
            return
        try:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    # pre-versioning journals (no stamp) default to 1;
                    # a FUTURE stamp is skipped, not guessed at — losing
                    # a redelivery is recoverable (catch-up), a
                    # mis-parsed one is not
                    if rec.get("schema_version", 1) != JOURNAL_SCHEMA_VERSION:
                        continue
                    pid = rec["pid"]
                    q = self._redelivery.get(pid)
                    if q is None:
                        q = self._redelivery[pid] = deque()
                    q.append((rec["message"], int(rec.get("attempt", 1))))
                    self._redelivery_n += 1
        except Exception:
            import logging

            logging.getLogger("hypergraphdb_tpu_torch.peer").warning(
                "redelivery journal %s unreadable; starting empty", path,
                exc_info=True,
            )

    def _journal_save(self) -> None:
        """Crash-atomic rewrite of the redelivery journal (worker thread
        only, after a cycle that changed the queue): same-directory tmp,
        fsync, ``os.replace`` — the ``ops/checkpoint._atomic_write``
        discipline, so a death at any instant leaves the previous
        complete journal, never a torn one. An unwritable path logs and
        degrades to the old dies-with-the-process behavior."""
        path = self.journal_path
        if path is None:
            return
        import json

        from hypergraphdb_tpu_torch.ops.checkpoint import _atomic_write

        lines = []
        for pid, q in self._redelivery.items():
            for msg, attempt in q:
                lines.append(json.dumps(
                    {"schema_version": JOURNAL_SCHEMA_VERSION,
                     "pid": pid, "attempt": attempt, "message": msg},
                    sort_keys=True,
                ))
        data = "".join(line + "\n" for line in lines).encode("utf-8")
        try:
            # the ONE crash-atomic publish (tmp + fsync + os.replace +
            # the registered crash point), not a drifting inline copy:
            # ordinary failure cleans the tmp, an InjectedCrash at
            # peer.journal.save leaves it behind like a real kill
            _atomic_write(path, lambda f: f.write(data),
                          "peer.journal.save")
        except Exception:
            import logging

            logging.getLogger("hypergraphdb_tpu_torch.peer").warning(
                "redelivery journal save failed (%s)", path, exc_info=True
            )

    # -- interest publication ---------------------------------------------------
    def publish_interest(self, condition) -> None:
        """Declare what I want replicated to me, to every known peer."""
        self.interest = condition
        payload = None if condition is None else qser.to_json(condition)
        for pid in self.peer.interface.peers():
            self.peer.interface.send(pid, M.make_message(
                M.SUBSCRIBE, self.ACTIVITY_TYPE,
                {"what": "interest", "condition": payload},
            ))

    # -- catch-up ---------------------------------------------------------------
    def catch_up(self, pid: str) -> bool:
        """Ask ``pid`` for its log entries after my recorded position
        (reliable-send: a dropped request retries with backoff — losing
        it would silently stall convergence until the next manual call).
        Returns whether the request was SENT (False when even the
        reliable-send budget couldn't reach the peer — the caller's cue
        that no catchup-result will ever arrive). Traced: each page
        roots one cross-process tree — request here, ``catchup_serve``
        on the server, ``apply`` back here — joined on the propagated
        trace id."""
        self.peer.graph.metrics.incr("peer.catchups")
        msg = M.make_message(
            M.REQUEST, self.ACTIVITY_TYPE,
            {"what": "catchup", "since": self.last_seen.get(pid, 0)},
        )
        tracer = self.peer.tracer
        tr = None
        if tracer.enabled:
            tr = tracer.start_trace("peer.catchup", target=pid)
        if tr is not None:
            tr.marks["root"] = tr.start_span("catchup_request", target=pid)
            M.attach_trace(msg, tr.context())
        ok = self._send_reliable(pid, msg)
        if tr is not None:
            tr.finish_terminal("sent" if ok else "error",
                               **({} if ok else {"error": "SendFailed"}))
        return ok

    def _check_gap(self, sender: str) -> None:
        """Receiver-side gap repair (apply worker): applied-seq intervals
        with a hole mean a push was lost past the redelivery budget —
        exactly the divergence the old max-applied ack could never see.
        Trigger ONE targeted catch-up from the contiguous ack (the pages
        re-cover the hole; re-applying the already-applied tail is
        idempotent); the in-flight mark clears when a catch-up page
        arrives, so a lost repair request re-triggers instead of wedging.
        NOTE for interest-FILTERED peers: a seq the sender's predicate
        skipped looks like a hole too — the repair catch-up then fetches
        it, which matches catch-up's existing unfiltered semantics."""
        if not self.last_seen.has_gap(sender):
            self._gap_repairs.discard(sender)
            return
        if sender in self._gap_repairs:
            return
        self._gap_repairs.add(sender)
        self.peer.graph.metrics.incr("peer.gaps_detected")
        try:
            if not self.catch_up(sender):
                # the request never left (reliable-send budget spent):
                # no catchup-result will ever clear the mark — drop it
                # so the next apply cycle re-triggers instead of wedging
                self._gap_repairs.discard(sender)
        except Exception:  # noqa: BLE001  # hglint: disable=HG1005
            # retried on the next cycle; dropping the mark re-arms it
            self._gap_repairs.discard(sender)

    def anti_entropy(self, pid: str) -> None:
        """Backstop convergence probe: ask ``pid`` for its log digest
        (head/floor) and catch up if our contiguous position is behind.
        Contiguity tracking only detects a loss once a LATER push lands;
        when the lost pushes were the last traffic before a silence,
        nothing ever exposes the hole — this periodic digest exchange
        does. Cheap on both sides (a few ints on the wire); safe from
        any thread (reliable-send may sleep its bounded backoff)."""
        self.peer.graph.metrics.incr("peer.anti_entropy_probes")
        self._send_reliable(pid, M.make_message(
            M.REQUEST, self.ACTIVITY_TYPE, {"what": "digest"},
        ))

    def replication_lag(self, pid: str) -> int:
        """Entries of ``pid``'s log not yet contiguously applied here —
        the replica staleness measure the serving gate and ``/healthz``
        advertise. Based on the freshest head ``pid`` told us (every
        push/catch-up/digest carries one), so between probes it can
        under-report; the anti-entropy cadence bounds that window."""
        return max(0, self.peer_heads.get(pid, 0)
                   - self.last_seen.get(pid, 0))

    # -- message handling (runs on the peer's dispatch path) --------------------
    def handle(self, sender: str, msg: dict) -> bool:
        if msg.get("activity_type") != self.ACTIVITY_TYPE:
            return False
        content = msg.get("content") or {}
        if not isinstance(content, dict):
            return False
        what = content.get("what")
        if what == "interest":
            cond = content.get("condition")
            # anchor the per-peer push chain at the CURRENT head: seqs
            # at or below it predate the interest — the peer's own
            # catch-up/bootstrap territory, never "skipped by predicate"
            self._sent_head.setdefault(sender, self.log.head)
            self.peer_interests[sender] = (
                None if cond is None else qser.from_json(cond)
            )
        elif what == "push":
            # apply OFF the dispatch thread — a slow closure store must not
            # stall unrelated peer traffic; the propagated trace context
            # rides along so the apply joins the sender's tree
            seq = int(content.get("seq", 0))
            head = int(content.get("head", seq))
            if head > self.peer_heads.get(sender, 0):
                self.peer_heads[sender] = head
            prev = content.get("prev")  # None: pre-prev wire format
            self._enqueue_apply(
                sender, [(content["kind"], content["entry"], seq,
                          M.trace_context(msg),
                          None if prev is None else int(prev))]
            )
        elif what == "catchup":
            # remote-child span: this serve hangs under the requester's
            # catchup_request span in the joined tree
            tracer = self.peer.tracer
            tr = None
            if tracer.enabled:
                tr = tracer.start_remote_trace(
                    "peer.catchup.serve", M.trace_context(msg),
                    peer=sender,
                )
            serve_span = (None if tr is None
                          else tr.start_span("catchup_serve"))
            if tr is not None:
                tr.marks["root"] = serve_span
            since = int(content.get("since", 0))
            floor = self.log.floor
            entries = []
            if since >= floor:
                # page-sized serve: one request must
                # not materialize + wire-expand the whole remaining log on
                # the dispatch thread; the client re-requests after applying
                raw = self.log.since(since, limit=self.catchup_page)
                # re-read the floor AFTER the scan: a truncation that raced
                # the cursor may have dropped entries in (since, floor] —
                # serving the surviving tail would silently skip them;
                # report the gap instead so the client falls back to a
                # full bootstrap
                floor = self.log.floor
                if since >= floor:
                    entries = [
                        {"seq": seq, "kind": kind,
                         "entry": self._expand_for_wire(kind, entry)}
                        for seq, kind, entry in raw
                    ]
            self.peer.graph.metrics.incr("peer.catchup_pages")
            result = M.make_message(
                M.INFORM, self.ACTIVITY_TYPE,
                {"what": "catchup-result", "entries": entries,
                 "head": self.log.head, "floor": floor},
            )
            if tr is not None:
                # chain the SAME trace onward: the client's apply spans
                # parent under this serve span
                M.attach_trace(result, tr.context(serve_span))
            self.peer.interface.send(sender, result)
            if tr is not None:
                tr.finish_terminal("served", entries=len(entries))
        elif what == "catchup-result":
            floor = int(content.get("floor", 0))
            entries = content.get("entries") or []
            head = int(content.get("head", 0))
            if head > self.peer_heads.get(sender, 0):
                self.peer_heads[sender] = head
            # a catch-up page arrived: a pending gap-repair request is no
            # longer in flight — if the gap survives this page, the next
            # apply cycle re-triggers the repair
            self._gap_repairs.discard(sender)
            if floor > self.last_seen.get(sender, 0) and not entries:
                # the server truncated past our position: incremental
                # catch-up cannot converge — a full bootstrap (TransferGraph)
                # is required
                self.needs_full_sync.add(sender)
                return True
            # a page-limited response may stop short of the server's head:
            # continue the catch-up after this page has been applied
            top = max((int(e["seq"]) for e in entries), default=0)
            tctx = M.trace_context(msg)
            self._enqueue_apply(
                sender,
                [(e["kind"], e["entry"], int(e["seq"]), tctx)
                 for e in entries],
                continue_catchup=bool(entries) and top < head,
            )
        elif what == "digest":
            # anti-entropy probe: answer with my log coordinates — cheap
            # dispatch-thread work (two lock reads, no payloads)
            self.peer.interface.send(sender, M.make_message(
                M.INFORM, self.ACTIVITY_TYPE,
                {"what": "digest-result", "head": self.log.head,
                 "floor": self.log.floor},
            ))
        elif what == "digest-result":
            head = int(content.get("head", 0))
            floor = int(content.get("floor", 0))
            if head > self.peer_heads.get(sender, 0):
                self.peer_heads[sender] = head
            mine = self.last_seen.get(sender, 0)
            prev = self._ae_seen_pos.get(sender)
            self._ae_seen_pos[sender] = mine
            if mine < floor:
                # truncated past us: incremental repair is impossible
                self.needs_full_sync.add(sender)
            elif head > mine and (prev is None or mine <= prev):
                # the backstop caught divergence no push ever revealed
                # (e.g. the LAST pushes before a silence were dropped
                # past the redelivery budget — nothing later arrives to
                # expose the hole via contiguity). Behind-the-head while
                # STILL ADVANCING is ordinary in-flight lag — repairing
                # it would shadow the push pipeline with a redundant
                # catch-up every probe; a stalled position (or the first
                # probe) is the loss signal
                self.peer.graph.metrics.incr("peer.anti_entropy_repairs")
                self.catch_up(sender)
        elif what == "ack":
            # receiver's applied position in MY log: feeds truncation
            seq = int(content.get("seq", 0))
            if seq > self.peer_acks.get(sender, 0):
                self.peer_acks[sender] = seq
            try:
                self._maybe_truncate()
            except Exception:  # hglint: disable=HG1005
                # e.g. the drop transaction kept conflicting with a hot
                # ingest loop — the push worker retries opportunistically
                pass
        else:
            return False
        return True

    def _enqueue_apply(self, sender: str, items: list,
                       continue_catchup: bool = False) -> None:
        if not items:
            return
        with self._apply_cv:
            self._apply_q.append((sender, items, continue_catchup))
            self._apply_cv.notify_all()

    def _apply_drain(self) -> None:
        while True:
            with self._apply_cv:
                while not self._apply_q and not self._stopping:
                    self._apply_cv.wait(0.1)
                if not self._apply_q:
                    return  # stopping and drained
                batch = []
                while self._apply_q:
                    batch.append(self._apply_q.popleft())
                self._apply_busy += 1
            try:
                # per-sender pre-batch contiguous positions: ONE ack per
                # sender per drained cycle (sent only when the contiguous
                # position advanced), not per push
                pre: dict[str, int] = {}
                failed: set[str] = set()
                noack: set[str] = set()
                conts: set[str] = set()
                tracer = self.peer.tracer
                for sender, items, cont in batch:
                    if cont:
                        conts.add(sender)
                    # push items carry a 5th element: the sender's prev
                    # pushed seq (predicate-skip accounting); catch-up
                    # pages apply exact positions only
                    for kind, entry, seq, tctx, *rest in items:
                        prev = rest[0] if rest else None
                        if sender in failed:
                            # a failed apply must not be acked past — stop
                            # advancing this sender; catch-up refetches
                            # from the last acknowledged position
                            continue
                        # remote-child trace: the apply subtree joins the
                        # sender's push/serve span tree on trace id (one
                        # enabled read; untraced messages carry no ctx)
                        tr = (tracer.start_remote_trace(
                                  "peer.apply", tctx, kind=kind,
                                  sender=sender)
                              if tracer.enabled else None)
                        if tr is not None:
                            tr.marks["root"] = tr.start_span(
                                "apply", kind=kind, seq=seq)
                        try:
                            self._apply(sender, kind, entry)
                            self.peer.graph.metrics.incr("peer.applies")
                        except Exception as apply_exc:
                            import logging

                            logging.getLogger(
                                "hypergraphdb_tpu_torch.peer"
                            ).warning(
                                "replication apply failed (%s from %s)",
                                kind, sender, exc_info=True,
                            )
                            if tr is not None:
                                tr.finish_error(apply_exc)
                            failed.add(sender)
                            continue
                        if tr is not None:
                            tr.finish_terminal("applied")
                        if seq:
                            if sender not in pre:
                                pre[sender] = self.last_seen.get(sender)
                            try:
                                # gap-aware: record the exact position;
                                # the contiguous ack advances only over
                                # an unbroken applied prefix. RAM-only
                                # here — ONE durable persist per sender
                                # per cycle below, not one store tx per
                                # in-order push
                                self.last_seen.record_applied(
                                    sender, seq, prev, persist=False)
                            except Exception:
                                # e.g. TransactionConflict after retries
                                # under a hot ingest loop — the worker
                                # must NEVER die.
                                # Not durably recorded → do not ack past
                                # it either; the sender re-serves from
                                # our last ack and _apply is idempotent.
                                import logging

                                logging.getLogger(
                                    "hypergraphdb_tpu_torch.peer"
                                ).warning(
                                    "seen-map update failed for %s",
                                    sender, exc_info=True,
                                )
                                noack.add(sender)
                for sender, before in pre.items():
                    if sender in noack:
                        continue
                    cur = self.last_seen.get(sender)
                    try:
                        # the cycle's ONE durable write for this sender
                        # (no-op when nothing advanced); an unpersisted
                        # position must not be acked — skip, the sender
                        # re-serves from our last durable ack and the
                        # next cycle retries the persist
                        self.last_seen.persist(sender)
                    except Exception:
                        import logging

                        logging.getLogger(
                            "hypergraphdb_tpu_torch.peer"
                        ).warning("seen-map persist failed for %s",
                                  sender, exc_info=True)
                        self._check_gap(sender)
                        continue
                    if cur > before:
                        try:
                            self.peer.graph.metrics.incr("peer.acks")
                            self.peer.interface.send(sender, M.make_message(
                                M.INFORM, self.ACTIVITY_TYPE,
                                {"what": "ack", "seq": cur},
                            ))
                        except Exception:  # noqa: BLE001 - peer gone
                            self.peer.graph.metrics.incr(
                                "peer.ack_send_failures")
                    self._check_gap(sender)
                # page-limited catch-up: pull the next page now that this
                # one is applied and acknowledged. A sender whose apply or
                # seen-map update failed waits for the next scheduled
                # catch-up: its cursor did not move, so asking now would
                # fetch the same page again
                for sender in conts - failed - noack:
                    try:
                        self.catch_up(sender)
                    except Exception:  # noqa: BLE001 - peer may be gone
                        self.peer.graph.metrics.incr(
                            "peer.catch_up_failures")
            except Exception:
                # belt-and-braces: anything unexpected is logged, the
                # worker loop survives
                import logging

                logging.getLogger("hypergraphdb_tpu_torch.peer").warning(
                    "replication apply cycle failed", exc_info=True
                )
            finally:
                with self._apply_cv:
                    self._apply_busy -= 1
                    self._apply_cv.notify_all()

    def _maybe_truncate(self) -> None:
        """Reclaim log entries every interested peer has acknowledged. A
        peer with a declared interest but no ack yet pins the floor (its
        ack defaults to 0), so nothing a connected peer still needs is
        dropped; fully-detached peers re-join via catch-up or, past the
        floor, a full bootstrap."""
        if not self.auto_truncate or not self.peer_acks:
            return
        audience = set(self.peer_interests) | set(self.peer_acks)
        lo = min(self.peer_acks.get(pid, 0) for pid in audience)
        if lo - self.log.floor >= self.truncate_batch:
            self.log.truncate_below(lo)

    def _apply(self, sender: str, kind: str, entry: dict) -> None:
        g = self.peer.graph
        self._tls.applying = True
        try:
            # under the peer's apply mutex: a concurrently-streaming
            # snapshot transfer must not race this gid's check-then-act
            with self.peer.apply_lock:
                if kind == "remove":
                    local = transfer.lookup_local(g, entry["gid"])
                    if local is not None and g.contains(int(local)):
                        g.remove(int(local))
                    return
                transfer.store_closure(g, entry["atoms"])
        finally:
            self._tls.applying = False
