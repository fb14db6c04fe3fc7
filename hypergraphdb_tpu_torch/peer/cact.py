"""CACT — cluster activities: remote graph operations.

Re-expression of the reference's ``peer/cact/`` package: ``AddAtom``,
``GetAtom``, ``RemoveAtom``, ``ReplaceAtom``, ``GetIncidenceSet``,
``QueryCount``, ``RunRemoteQuery`` and the cursor-streaming
``RemoteQueryExecution`` (``peer/cact/RemoteQueryExecution.java:34``: the
server compiles+runs the query locally, holds the result open, and the
client pages through it over the wire).

Each op is a two-sided FSM activity over the performative protocol:
client sends REQUEST with op payload; server replies INFORM (result) or
FAILURE. RemoteQuery adds a paging loop (QUERY_REF → INFORM chunks →
CANCEL/complete)."""

from __future__ import annotations

from typing import Any, Optional

from hypergraphdb_tpu_torch.peer import messages as M
from hypergraphdb_tpu_torch.peer import transfer
from hypergraphdb_tpu_torch.peer.activity import Activity, STARTED, from_state
from hypergraphdb_tpu_torch.query import serialize as qser


# --------------------------------------------------------------- client side


class RemoteOpClient(Activity):
    """Generic request/response client activity. Traced: each op roots a
    ``peer.op`` trace whose context rides the REQUEST, so the server's
    ``op_serve`` span joins the same tree (remote-child parenting) — the
    ``RemoteGraphView`` window and every ``HyperGraphPeer.*_remote`` call
    get cross-process attribution for free."""

    TYPE = "cact"

    def __init__(self, peer, target: Optional[str] = None, op: Optional[dict] = None,
                 activity_id: Optional[str] = None):
        super().__init__(peer, activity_id)
        self.target = target
        self.op = op or {}
        self._trace = None

    def initiate(self) -> None:
        tracer = self.peer.tracer
        ctx = None
        if tracer.enabled:
            self._trace = tr = tracer.start_trace(
                "peer.op", op=str(self.op.get("op")), target=self.target,
            )
            if tr is not None:
                tr.marks["root"] = tr.start_span(
                    "op", op=str(self.op.get("op")))
                ctx = tr.context()
        self.send(self.target, M.REQUEST, self.op, trace_ctx=ctx)

    @from_state(STARTED, M.INFORM)
    def on_result(self, sender: str, msg: dict) -> None:
        if self._trace is not None:
            self._trace.finish_terminal("resolve")
        self.complete(msg["content"])

    @from_state(STARTED, M.FAILURE)
    def on_failure(self, sender: str, msg: dict) -> None:
        if self._trace is not None:
            self._trace.finish_terminal("error", error="RemoteFailure")
        self.fail(RuntimeError(str(msg["content"])))


class RemoteOpServer(Activity):
    """Generic server: executes the op against the local graph."""

    TYPE = "cact"

    OPS = {}

    @from_state(STARTED, M.REQUEST)
    def on_request(self, sender: str, msg: dict) -> None:
        op = msg["content"] or {}
        tracer = self.peer.tracer
        tr = (tracer.start_remote_trace("peer.op.serve",
                                        M.trace_context(msg), peer=sender)
              if tracer.enabled else None)
        if tr is not None:
            tr.marks["root"] = tr.start_span("op_serve",
                                             op=str(op.get("op")))
        handler = self.OPS.get(op.get("op"))
        if handler is None:
            self.reply(sender, msg, M.FAILURE, f"unknown op {op.get('op')}")
            if tr is not None:
                tr.finish_terminal("error", error="UnknownOp")
            self.fail(f"unknown op {op.get('op')}")
            return
        try:
            result = handler(self, op)
        except Exception as e:
            self.reply(sender, msg, M.FAILURE, f"{type(e).__name__}: {e}")
            if tr is not None:
                tr.finish_error(e)
            self.fail(e)
            return
        self.reply(sender, msg, M.INFORM, result)
        if tr is not None:
            tr.finish_terminal("served")
        self.complete(result)

    # -- op handlers (the cact/ class-per-op set) -------------------------

    def _op_define_atom(self, op: dict) -> Any:
        """AddAtom/DefineAtom: store a transferred closure locally."""
        handles = transfer.store_closure(self.peer.graph, op["atoms"])
        return {"handles": handles}

    def _op_get_atom(self, op: dict) -> Any:
        g = self.peer.graph
        gid = op.get("gid")
        h = transfer.lookup_local(g, gid) if gid else op.get("handle")
        if h is None or not g.contains(int(h)):
            raise KeyError(f"atom not found: {gid or op.get('handle')}")
        return {"atoms": transfer.serialize_closure(g, int(h), self.peer.identity)}

    def _op_remove_atom(self, op: dict) -> Any:
        g = self.peer.graph
        gid = op.get("gid")
        h = transfer.lookup_local(g, gid) if gid else op.get("handle")
        ok = bool(h is not None and g.remove(int(h)))
        return {"removed": ok}

    def _op_get_incidence_set(self, op: dict) -> Any:
        g = self.peer.graph
        h = int(op["handle"])
        return {"incidence": g.get_incidence_set(h).array().tolist()}

    def _op_query_count(self, op: dict) -> Any:
        cond = qser.from_json(op["condition"])
        return {"count": self.peer.graph.count(cond)}

    def _op_run_query(self, op: dict) -> Any:
        """One-shot remote query: compile + run + return all handles.
        (Streaming variant: RemoteQueryServer below.)"""
        cond = qser.from_json(op["condition"])
        return {"handles": [int(h) for h in self.peer.graph.find_all(cond)]}

    def _op_replace_atom(self, op: dict) -> Any:
        """ReplaceAtom (ref ``peer/cact/ReplaceAtom.java``): replace the
        VALUE of the atom behind a global id, keeping identity/incidence."""
        import base64

        g = self.peer.graph
        h = transfer.lookup_local(g, op["gid"])
        if h is None or not g.contains(int(h)):
            return {"replaced": False}
        if op["type"] not in g.typesystem._by_name and op.get("type_schema"):
            transfer.install_type(g, op["type_schema"])
        atype = g.typesystem.get_type(op["type"])
        value = (
            atype.make(base64.b64decode(op["value_b64"]))
            if op.get("value_b64") is not None else None
        )
        # type passed EXPLICITLY: a class-less RecordType revives the value
        # as a dict, which inference would silently retype to 'dict',
        # unindexing the atom from its real type
        g.replace(int(h), value, type=op["type"])
        return {"replaced": True}

    def _op_get_atom_type(self, op: dict) -> Any:
        """GetAtomType (ref ``peer/cact/GetAtomType.java``): the type name
        + wire schema of a remote atom, keyed by global id."""
        g = self.peer.graph
        h = transfer.lookup_local(g, op["gid"])
        if h is None or not g.contains(int(h)):
            raise KeyError(f"atom not found: {op['gid']}")
        rec = g.store.get_link(int(h))
        name = g.typesystem.name_of(rec[0])
        return {"type": name, "schema": transfer.describe_type(g, name)}

    def _op_add_atom(self, op: dict) -> Any:
        """Create an atom on THIS peer from a wire value + target global
        ids (the ``PeerHyperNode.add`` server half): targets resolve
        through the atom map; returns the new atom's global id."""
        import base64

        g = self.peer.graph
        if op["type"] not in g.typesystem._by_name and op.get("type_schema"):
            transfer.install_type(g, op["type_schema"])
        atype = g.typesystem.get_type(op["type"])
        value = (
            atype.make(base64.b64decode(op["value_b64"]))
            if op.get("value_b64") is not None else None
        )
        tg = []
        for gid in op.get("targets", ()):
            h = transfer.lookup_local(g, gid)
            if h is None:
                raise KeyError(f"unmapped target {gid}")
            tg.append(int(h))
        if tg:
            h = g.add_link(tg, value=value, type=op["type"])
        else:
            h = g.add_node(value, type=op["type"])
        return {"gid": transfer.gid_of(g, int(h), self.peer.identity)}

    def _op_peek_atom(self, op: dict) -> Any:
        """One serialized atom, WITHOUT the closure — the read half of the
        remote view (the caller is a window, not a replica)."""
        g = self.peer.graph
        h = transfer.lookup_local(g, op["gid"])
        if h is None or not g.contains(int(h)):
            raise KeyError(f"atom not found: {op['gid']}")
        return {"atom": transfer.serialize_atom(g, int(h), self.peer.identity)}

    def _op_sync_types(self, op: dict) -> Any:
        """SyncTypes (ref ``peer/cact/SyncTypes.java``): install a batch of
        remote type schemas so subsequently pushed/pulled atoms of those
        types resolve locally instead of depending on name-keyed luck."""
        g = self.peer.graph
        installed = []
        for desc in op.get("types", ()):
            transfer.install_type(g, desc)
            installed.append(desc["name"])
        return {"installed": installed}


RemoteOpServer.OPS = {
    "define_atom": RemoteOpServer._op_define_atom,
    "get_atom": RemoteOpServer._op_get_atom,
    "add_atom": RemoteOpServer._op_add_atom,
    "peek_atom": RemoteOpServer._op_peek_atom,
    "remove_atom": RemoteOpServer._op_remove_atom,
    "replace_atom": RemoteOpServer._op_replace_atom,
    "get_atom_type": RemoteOpServer._op_get_atom_type,
    "sync_types": RemoteOpServer._op_sync_types,
    "get_incidence_set": RemoteOpServer._op_get_incidence_set,
    "query_count": RemoteOpServer._op_query_count,
    "run_query": RemoteOpServer._op_run_query,
}


# ------------------------------------------------------- streaming remote query


class RemoteQueryClient(Activity):
    """Cursor-paging remote query (RemoteQueryExecution): QUERY_REF opens a
    server-held result; INFORM chunks stream back; the final chunk (eof)
    completes with the full handle list."""

    TYPE = "cact-query"

    def __init__(self, peer, target: Optional[str] = None,
                 condition=None, page: int = 64,
                 activity_id: Optional[str] = None):
        super().__init__(peer, activity_id)
        self.target = target
        self.condition = condition
        self.page = page
        self.rows: list[int] = []

    def initiate(self) -> None:
        self.send(self.target, M.QUERY_REF, {
            "condition": qser.to_json(self.condition),
            "page": self.page,
        })

    @from_state(STARTED, M.INFORM)
    def on_chunk(self, sender: str, msg: dict) -> None:
        c = msg["content"]
        self.rows.extend(c["rows"])
        if c["eof"]:
            self.complete(self.rows)
        else:
            self.reply(sender, msg, M.CONFIRM)  # pull next page

    @from_state(STARTED, M.FAILURE)
    def on_failure(self, sender: str, msg: dict) -> None:
        self.fail(RuntimeError(str(msg["content"])))


class RemoteQueryServer(Activity):
    """Server side: executes once, then streams pages on CONFIRM pulls —
    the server-held open-result-set state (``state=ResultSetOpen``)."""

    TYPE = "cact-query"

    def __init__(self, peer, activity_id: Optional[str] = None):
        super().__init__(peer, activity_id)
        self.results: Optional[list[int]] = None
        self.pos = 0
        self.page = 64

    @from_state(STARTED, M.QUERY_REF)
    def on_open(self, sender: str, msg: dict) -> None:
        content = msg["content"]
        try:
            cond = qser.from_json(content["condition"])
            self.page = int(content.get("page", 64))
            self.results = [int(h) for h in self.peer.graph.find_all(cond)]
        except Exception as e:
            self.reply(sender, msg, M.FAILURE, f"{type(e).__name__}: {e}")
            self.fail(e)
            return
        self.state = "ResultSetOpen"
        self._send_page(sender, msg)

    @from_state("ResultSetOpen", M.CONFIRM)
    def on_pull(self, sender: str, msg: dict) -> None:
        self._send_page(sender, msg)

    @from_state("ResultSetOpen", M.CANCEL)
    def on_cancel(self, sender: str, msg: dict) -> None:
        self.complete(None)

    def _send_page(self, sender: str, msg: dict) -> None:
        rows = self.results[self.pos : self.pos + self.page]
        self.pos += len(rows)
        eof = self.pos >= len(self.results)
        self.reply(sender, msg, M.INFORM, {"rows": rows, "eof": eof})
        if eof:
            self.complete(len(self.results))


# ------------------------------------------------------- whole-graph bootstrap


class TransferGraphClient(Activity):
    """Whole-graph bootstrap (ref ``peer/cact/TransferGraph.java`` +
    ``SubgraphManager.java:57``): a joining peer pulls the ENTIRE remote
    graph in pages of serialized atoms — dependencies first, type atoms
    mapped onto local type atoms, record-type schemas installed on the fly.
    On completion the replication clock for the server jumps to the
    server's op-log head AT SNAPSHOT TIME, so a follow-up catch-up replays
    only what committed during/after the transfer — the convergence story
    for a peer whose incremental catch-up fell past the log floor.

    Self-healing (hgfault): pages are POSITION-addressed — every pull
    carries the client's next wanted position and every chunk echoes the
    position it starts at, so a dropped or duplicated chunk is detected
    and idempotently re-requested instead of corrupting the stream. The
    :meth:`tick` watchdog (driven by the ActivityManager's ticker) resumes
    a stalled transfer: re-pull the current page, or re-open the whole
    conversation when the opening exchange itself was eaten."""

    TYPE = "cact-transfer"

    def __init__(self, peer, target: Optional[str] = None, page: int = 256,
                 activity_id: Optional[str] = None,
                 retry_after_s: float = 1.0, max_resumes: int = 8):
        super().__init__(peer, activity_id)
        self.target = target
        self.page = page
        self.stored = 0
        self.log_head: Optional[int] = None
        self.expected = 0            # next page START we will apply
        self._snap: Optional[str] = None  # the server snapshot token
        self.retry_after_s = float(retry_after_s)
        self.max_resumes = int(max_resumes)
        self._resumes = 0
        self._last_rx = 0.0
        self._trace = None
        self._tctx: Optional[dict] = None

    def initiate(self) -> None:
        import time as _time

        self._last_rx = _time.monotonic()
        # the whole transfer is ONE cross-process trace: every client
        # send carries the context (resumes may reach a FRESH server
        # activity — it must still join the same tree)
        tracer = self.peer.tracer
        if tracer.enabled:
            self._trace = tr = tracer.start_trace(
                "peer.transfer", target=self.target, page=self.page,
            )
            if tr is not None:
                tr.marks["root"] = tr.start_span("transfer",
                                                 target=self.target)
                self._tctx = tr.context()
        self.send(self.target, M.QUERY_REF,
                  {"page": self.page, "pos": 0}, trace_ctx=self._tctx)

    @from_state(STARTED, M.INFORM)
    def on_chunk(self, sender: str, msg: dict) -> None:
        import time as _time

        self._last_rx = _time.monotonic()
        c = msg["content"]
        tok = c.get("snap")
        if self._snap is not None and tok != self._snap:
            # the server re-snapshotted (fresh activity after a lost eof
            # or a restart): positions from the old snapshot are NOT
            # comparable — removals shift every later index, so resuming
            # mid-stream could silently skip atoms. Restart from 0: the
            # gid-keyed write-through makes the re-apply idempotent, and
            # the new snapshot's log_head re-anchors catch-up.
            self._snap = tok
            self.log_head = int(c.get("log_head", 0))
            self.expected = 0
            if int(c.get("pos", -1)) != 0:
                self.reply(sender, msg, M.CONFIRM, {"pos": 0},
                           trace_ctx=self._tctx)
                return
        elif self._snap is None:
            self._snap = tok
        if self.log_head is None:
            self.log_head = int(c.get("log_head", 0))
        pos = int(c.get("pos", self.expected))
        if pos != self.expected:
            # duplicated/stale chunk (a redelivered page we already
            # applied, or one past a gap): applying would double-store or
            # skip — idempotently re-request OUR position instead
            self.reply(sender, msg, M.CONFIRM, {"pos": self.expected},
                       trace_ctx=self._tctx)
            return
        # the peer's apply mutex: replication pushes arriving WHILE the
        # transfer streams (a bootstrapping replica with its interest
        # already published) must not race a chunk's store of the same
        # gid — store_closure's check-then-act is idempotent only when
        # serialized
        with self.peer.apply_lock:
            n_applied = len(
                transfer.store_closure(self.peer.graph, c["atoms"])
            )
        self.stored += n_applied
        tr = self._trace
        if tr is not None:
            tr.start_span("apply_chunk", parent=tr.marks.get("root"),
                          pos=pos, atoms=n_applied).end()
        self.expected = int(c.get("next", self.expected))
        self._resumes = 0  # progress: the resume budget is PER STALL —
        # a long transfer over a mildly lossy link must not exhaust a
        # cumulative budget while every individual resume succeeds
        if c["eof"]:
            rep = getattr(self.peer, "replication", None)
            if rep is not None and self.log_head:
                # the transferred snapshot covers everything up to the
                # server's head at open; catch-up resumes from there
                if self.log_head > rep.last_seen.get(sender, 0):
                    rep.last_seen.set(sender, self.log_head)
                if self.log_head > rep.peer_heads.get(sender, 0):
                    rep.peer_heads[sender] = self.log_head
                rep.needs_full_sync.discard(sender)
            if tr is not None:
                tr.finish_terminal("resolve", stored=self.stored)
            self.complete(self.stored)
        else:
            self.reply(sender, msg, M.CONFIRM, {"pos": self.expected},
                       trace_ctx=self._tctx)

    @from_state(STARTED, M.FAILURE)
    def on_failure(self, sender: str, msg: dict) -> None:
        if self._trace is not None:
            self._trace.finish_terminal("error", error="RemoteFailure")
        self.fail(RuntimeError(str(msg["content"])))

    def tick(self, now: Optional[float] = None) -> bool:
        """Stall watchdog (ActivityManager ticker / tests call directly):
        when no chunk has arrived for ``retry_after_s``, re-request the
        current position — bounded by ``max_resumes`` consecutive
        no-progress resumes (the counter resets on every applied chunk),
        after which the transfer fails typed (``TransientFault``) instead
        of hanging the caller's future forever. Returns whether a resume
        was sent."""
        import time as _time

        from hypergraphdb_tpu_torch.fault import TransientFault

        with self._handle_lock:
            if self.state != STARTED:
                return False
            if now is None:
                now = _time.monotonic()
            if now - self._last_rx < self.retry_after_s:
                return False
            self._resumes += 1
            if self._resumes > self.max_resumes:
                exc = TransientFault(
                    f"graph transfer from {self.target} stalled after "
                    f"{self.max_resumes} resume attempts"
                )
                if self._trace is not None:
                    self._trace.finish_error(exc)
                self.fail(exc)
                return False
            self._last_rx = now
            self.peer.graph.metrics.incr("peer.transfer_resumes")
            tr = self._trace
            if tr is not None:
                tr.start_span("resume", parent=tr.marks.get("root"),
                              pos=self.expected, attempt=self._resumes
                              ).end()
            if self.log_head is None and self.expected == 0:
                # nothing ever arrived: the opening exchange itself was
                # eaten — re-open (the server side re-opens idempotently)
                self.send(self.target, M.QUERY_REF,
                          {"page": self.page, "pos": 0},
                          trace_ctx=self._tctx)
            else:
                self.send(self.target, M.CONFIRM, {"pos": self.expected},
                          trace_ctx=self._tctx)
            return True


class TransferGraphServer(Activity):
    """Server side: snapshots the atom id list ONCE (ascending handle order
    IS dependencies-first — links are created after their targets), then
    streams serialized pages on position-addressed CONFIRM pulls (a pull
    may rewind ``pos`` — that is exactly what a client resuming past a
    dropped chunk does)."""

    TYPE = "cact-transfer"

    def __init__(self, peer, activity_id: Optional[str] = None):
        super().__init__(peer, activity_id)
        self.handles: Optional[list[int]] = None
        self.pos = 0
        self.page = 256
        self.log_head = 0
        self.snap_token: Optional[str] = None
        self._trace = None

    def _adopt_trace(self, msg: dict) -> None:
        """Join the client's transfer trace (remote-child): the serve
        subtree hangs under the client's ``transfer`` span. A fresh
        server reached by a resume adopts the same context — one tree
        per logical transfer, however many server activities it took."""
        if self._trace is not None:
            return
        tracer = self.peer.tracer
        if not tracer.enabled:
            return
        tr = tracer.start_remote_trace("peer.transfer.serve",
                                       M.trace_context(msg))
        if tr is not None:
            tr.marks["root"] = tr.start_span("transfer_serve")
            self._trace = tr

    def _snapshot(self) -> None:
        import uuid

        rep = getattr(self.peer, "replication", None)
        # head BEFORE the snapshot: anything later re-ships via catch-up
        self.log_head = rep.log.head if rep is not None else 0
        self.handles = sorted(int(h) for h in self.peer.graph.atoms())
        # snapshot identity: positions are only comparable WITHIN one
        # handle-list snapshot — a re-snapshot (fresh server after a lost
        # eof / restart) may have shifted positions past removals, so
        # chunks carry the token and the client restarts on a change
        self.snap_token = uuid.uuid4().hex

    @from_state(STARTED, M.QUERY_REF)
    def on_open(self, sender: str, msg: dict) -> None:
        c = msg["content"] or {}
        self._adopt_trace(msg)
        try:
            self.page = max(1, int(c.get("page", 256)))
            self._snapshot()
        except Exception as e:
            self.reply(sender, msg, M.FAILURE, f"{type(e).__name__}: {e}")
            if self._trace is not None:
                self._trace.finish_error(e)
            self.fail(e)
            return
        self.state = "Streaming"
        self._send_page(sender, msg, pos=int(c.get("pos", 0)))

    @from_state("Streaming", M.QUERY_REF)
    def on_reopen(self, sender: str, msg: dict) -> None:
        # the client's opening chunk(s) were lost and it re-opened: serve
        # from its requested position over the SAME snapshot (idempotent)
        c = msg["content"] or {}
        self._send_page(sender, msg, pos=int(c.get("pos", 0)))

    @from_state(STARTED, M.CONFIRM)
    def on_resume_fresh(self, sender: str, msg: dict) -> None:
        """A pull for a conversation this side no longer holds (the
        server completed on an eof chunk the client never saw, or
        restarted mid-transfer): re-snapshot and serve from the requested
        position. The fresh ``snap`` token on every chunk tells the
        client positions changed meaning — it restarts from 0
        (idempotent) rather than trusting indices a removal may have
        shifted."""
        c = msg["content"] or {}
        self._adopt_trace(msg)
        try:
            self._snapshot()
        except Exception as e:
            self.reply(sender, msg, M.FAILURE, f"{type(e).__name__}: {e}")
            if self._trace is not None:
                self._trace.finish_error(e)
            self.fail(e)
            return
        self.state = "Streaming"
        self._send_page(sender, msg, pos=int(c.get("pos", 0)))

    @from_state("Streaming", M.CONFIRM)
    def on_pull(self, sender: str, msg: dict) -> None:
        self._send_page(sender, msg,
                        pos=(msg["content"] or {}).get("pos"))

    @from_state("Streaming", M.CANCEL)
    def on_cancel(self, sender: str, msg: dict) -> None:
        if self._trace is not None:
            self._trace.finish_terminal("cancelled")
        self.complete(None)

    def _send_page(self, sender: str, msg: dict, pos=None) -> None:
        g = self.peer.graph
        if pos is not None:
            self.pos = max(0, min(int(pos), len(self.handles)))
        start = self.pos

        def page():
            # one transaction a page: the gids it mints commit together
            # (one commit, not one an atom); a retry starts the page over
            atoms, p = [], start
            while p < len(self.handles) and len(atoms) < self.page:
                h = self.handles[p]
                p += 1
                if not g.contains(h):
                    continue  # removed mid-transfer; catch-up replays it
                try:
                    atoms.append(
                        transfer.serialize_atom(g, h, self.peer.identity))
                except KeyError:
                    continue
            return atoms, p

        atoms, self.pos = g.txman.ensure_transaction(page)
        eof = self.pos >= len(self.handles)
        g.metrics.incr("peer.transfer_chunks")
        tr = self._trace
        if tr is not None:
            tr.start_span("chunk", parent=tr.marks.get("root"),
                          pos=start, atoms=len(atoms), eof=eof).end()
        self.reply(sender, msg, M.INFORM, {
            "atoms": atoms, "eof": eof, "log_head": self.log_head,
            "pos": start, "next": self.pos, "snap": self.snap_token,
        })
        if eof:
            if tr is not None:
                tr.finish_terminal("served", atoms=self.pos)
            self.complete(self.pos)
