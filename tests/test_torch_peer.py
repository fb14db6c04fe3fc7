"""The port's peer plane against the reference's: every case of
``tests/test_peer.py`` runs as one scenario on both packages, each with
the reference test's own assertions; the peers each run builds are then
observed (their atom maps by gid, op-log entries ``(seq, kind,
payload)``, seen-map intervals, content digests and the stable
counters) and the port's record must equal the reference's, as must what
the scenario returns (remote query results). The timing-bound ingest case
runs the port alone under the reference's bound.

This file also holds the parity harness the other ``test_torch_peer*``
files import: ``both`` re-binds a scenario's package names (``hg``,
``HyperGraphPeer``, ``transfer``, ``q``, ...) to each package in turn.

Tolerance: exact equality.
"""

from __future__ import annotations

import contextlib
import importlib
import inspect
import threading
import time
import types
from dataclasses import dataclass as _dataclass

import pytest

# -- the parity harness --------------------------------------------------

PKGS = ("hypergraphdb_tpu", "hypergraphdb_tpu_torch")
#: generator fixtures a scenario may name as an argument, run once per
#: package around its scenario
GEN_FIXTURES = ("two_peers", "faults")
#: counters compared between the packages (the rest count retries, ticks
#: and wake-ups, which follow thread timing)
STABLE_COUNTERS = ("graph.mutations", "peer.transfer_chunks",
                   "peer.ack_send_failures", "peer.redelivery_dropped")


def namespace(pkg: str) -> dict:
    """The names a scenario reads, bound to ``pkg``."""
    def mod(sub: str = ""):
        return importlib.import_module(pkg + ("." + sub if sub else ""))

    def imp_from(sub: str, name: str):
        m = mod(sub)
        if hasattr(m, name):
            return getattr(m, name)
        return mod(f"{sub}.{name}" if sub else name)

    peer = mod("peer")
    return dict(
        PKG=pkg, PORT=pkg == PKGS[1], mod=mod, imp_from=imp_from,
        hg=mod(), HyperGraphPeer=peer.HyperGraphPeer,
        LoopbackNetwork=peer.LoopbackNetwork,
        TCPPeerInterface=peer.TCPPeerInterface,
        transfer=mod("peer.transfer"), M=mod("peer.messages"),
        SeenMap=mod("peer.replication").SeenMap, q=mod("query.dsl"),
        qser=mod("query.serialize"), global_faults=mod("fault").global_faults,
        Tracer=mod("obs.trace").Tracer)


def bind(scope: dict, pkg: str) -> dict:
    """``scope`` (a test module's globals) with the package names bound to
    ``pkg`` and every helper and scenario of the peer parity files re-bound
    to read them."""
    G = dict(globals())
    G.update(scope)
    G.update(namespace(pkg))
    for k, v in list(G.items()):
        if (isinstance(v, types.FunctionType) and not k.startswith("test_")
                and v.__module__.rsplit(".", 1)[-1].startswith(
                    "test_torch_")):
            G[k] = types.FunctionType(v.__code__, G, v.__name__,
                                      v.__defaults__, v.__closure__)
    return G


def counters(g) -> dict:
    c = g.metrics.counters
    return dict(c() if callable(c) else c)


def observe(p) -> dict:
    """What a peer holds, by gid: its atom map, op log, seen map, content
    digest and stable counters (after its pipelines drained)."""
    pkg = type(p).__module__.split(".")[0]
    tr = importlib.import_module(pkg + ".peer.transfer")
    rep = p.replication
    if p._started:
        rep.flush(10.0)
    g = p.graph
    gids = sorted(k.decode() for k, hs in tr._atom_map(g).bulk_items()
                  for _ in hs.tolist())
    c = counters(g)
    return {
        "identity": p.identity, "gids": gids,
        "log": [[s, k, pl] for s, k, pl in rep.log.since(0)],
        "head": rep.log.head, "floor": rep.log.floor,
        "seen": {pid: rep.last_seen.intervals(pid)
                 for pid, _ in sorted(rep.last_seen.items())},
        "digest": tr.content_digest(g),
        "counters": {k: c.get(k, 0) for k in STABLE_COUNTERS},
    }


def observe_safe(p):
    try:
        return observe(p)
    except Exception as e:  # a scenario that closed its graph early
        return {"identity": p.identity, "unobservable": type(e).__name__}


@contextlib.contextmanager
def tracked(pkg: str):
    """Every peer the scenario builds, each observed just before its first
    ``stop`` (or at the scenario's end)."""
    cls = importlib.import_module(pkg + ".peer.peer").HyperGraphPeer
    seen: list = []
    init0, stop0 = cls.__init__, cls.stop

    def init(self, *a, **k):
        init0(self, *a, **k)
        seen.append([self, None])

    def stop(self):
        for e in seen:
            if e[0] is self and e[1] is None and self._started:
                e[1] = observe_safe(self)
        stop0(self)

    cls.__init__, cls.stop = init, stop
    try:
        yield seen
    finally:
        cls.__init__, cls.stop = init0, stop0


def run_scenario(scope: dict, name: str, pkg: str, fx: dict) -> dict:
    G = bind(scope, pkg)
    fn = G[name]
    with tracked(pkg) as seen, contextlib.ExitStack() as stack:
        args = {}
        for p in inspect.signature(fn).parameters:
            if p in GEN_FIXTURES:
                args[p] = stack.enter_context(
                    contextlib.contextmanager(G[p])())
            elif p == "tmp_path":
                d = fx["tmp_path"] / pkg
                d.mkdir()
                args[p] = d
            elif p == "monkeypatch":
                mp = pytest.MonkeyPatch()
                stack.callback(mp.undo)
                args[p] = mp
            else:
                args[p] = fx[p]
        out = fn(**args)
        for e in seen:
            if e[1] is None:
                e[1] = observe_safe(e[0])
    return {"result": out, "peers": [e[1] for e in seen]}


def both(scope: dict, name: str, unstable=(), **fx) -> None:
    """Run scenario ``name`` on the reference and on the port, each with
    the reference test's own assertions, then hold the port's record
    against the reference's: exact equality, but for the peer-record
    fields named in ``unstable`` (thread timing decides them)."""
    recs = [run_scenario(scope, name, pkg, fx) for pkg in PKGS]
    for rec in recs:
        for pr in rec["peers"]:
            for k in unstable:
                pr.pop(k, None)
    assert recs[1] == recs[0]


def alone(scope: dict, name: str, **fx) -> None:
    """A timing-bound scenario: the port alone, under the reference's own
    bound."""
    run_scenario(scope, name, PKGS[1], fx)


# -- the reference scenarios -------------------------------------------------


def two_peers():
    net = LoopbackNetwork()
    g1, g2 = hg.HyperGraph(), hg.HyperGraph()
    p1 = HyperGraphPeer.loopback(g1, net, identity="peer-1")
    p2 = HyperGraphPeer.loopback(g2, net, identity="peer-2")
    p1.start()
    p2.start()
    yield p1, p2
    p1.stop()
    p2.stop()
    g1.close()
    g2.close()


def _wait(cond, timeout=5.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.01)
    return False


# ---------------------------------------------------------------- serialization


def sc_condition_json_roundtrip():
    cond = q.and_(q.type_("string"), q.or_(q.incident(3), q.arity(2, "gte")),
                  q.not_(q.value("x")))
    js = qser.to_json(cond)
    import json

    js = json.loads(json.dumps(js))  # wire round-trip
    back = qser.from_json(js)
    assert back == cond


def sc_predicate_not_serializable():
    QueryError = imp_from("core.errors", "QueryError")

    with pytest.raises(QueryError):
        qser.to_json(q.predicate(lambda g, h: True))


# ---------------------------------------------------------------- CACT ops


def sc_define_and_get_atom(two_peers):
    p1, p2 = two_peers
    a = p1.graph.add("hello")
    b = p1.graph.add("world")
    l = p1.graph.add_link((a, b), value=7)

    handles = p1.define_remote("peer-2", l)
    assert len(handles) == 3
    # remote now answers queries over the transferred closure
    assert p2.graph.get(handles[-1]).targets == tuple(handles[:2])
    assert p2.graph.get(handles[0]) == "hello"

    # get_remote round-trips the atom back by global id
    gid = transfer.global_id("peer-1", int(a))
    local = transfer.lookup_local(p2.graph, gid)
    assert local is not None and p2.graph.get(int(local)) == "hello"


def sc_remote_query_streams_pages(two_peers):
    p1, p2 = two_peers
    vals = [f"item-{i}" for i in range(157)]
    p2.graph.add_nodes_bulk(vals)

    rows = p1.run_remote_query("peer-2", q.type_("string"), page=16)
    assert len(rows) == 157
    got = sorted(p2.graph.get(h) for h in rows)
    assert got == sorted(vals)


def sc_remote_count_and_incidence(two_peers):
    p1, p2 = two_peers
    x = p2.graph.add("x")
    y = p2.graph.add("y")
    l = p2.graph.add_link((x, y))
    assert p1.count_remote("peer-2", q.type_("string")) == 2
    assert p1.remote_incidence_set("peer-2", int(x)) == [int(l)]


def sc_remote_remove(two_peers):
    p1, p2 = two_peers
    a = p2.graph.add("doomed")
    gid = transfer.global_id("peer-2", int(a))
    transfer._atom_map(p2.graph).add_entry(gid.encode(), int(a))
    assert p1.remove_remote("peer-2", gid)
    assert not p2.graph.contains(int(a))


def sc_remote_op_failure_surfaces(two_peers):
    p1, _ = two_peers
    # fetching a nonexistent remote atom fails the activity, and the
    # client future surfaces the server's FAILURE reply
    with pytest.raises(Exception, match="not found"):
        p1.get_remote("peer-2", "peer-2:999999")


# ---------------------------------------------------------------- replication


def sc_interest_based_replication(two_peers):
    p1, p2 = two_peers
    # peer-2 wants every string atom from peer-1
    p2.replication.publish_interest(q.type_("string"))
    assert _wait(lambda: "peer-2" in p1.replication.peer_interests)

    h = p1.graph.add("replicate-me")
    gid = transfer.global_id("peer-1", int(h))
    assert _wait(lambda: transfer.lookup_local(p2.graph, gid) is not None)
    local = transfer.lookup_local(p2.graph, gid)
    assert p2.graph.get(int(local)) == "replicate-me"

    # non-matching atoms are NOT pushed
    p1.graph.add(12345)
    time.sleep(0.1)
    gid2 = transfer.global_id("peer-1", int(h) + 1)
    assert transfer.lookup_local(p2.graph, gid2) is None


def sc_replicated_remove(two_peers):
    p1, p2 = two_peers
    p2.replication.publish_interest(q.type_("string"))
    assert _wait(lambda: "peer-2" in p1.replication.peer_interests)

    h = p1.graph.add("to-be-removed")
    gid = transfer.global_id("peer-1", int(h))
    assert _wait(lambda: transfer.lookup_local(p2.graph, gid) is not None)
    p1.graph.remove(int(h))
    assert _wait(lambda: (
        (lh := transfer.lookup_local(p2.graph, gid)) is None
        or not p2.graph.contains(int(lh))
    ))


def sc_offline_catchup(two_peers):
    p1, p2 = two_peers
    # peer-1 writes while peer-2 is "offline" (no interest yet → no push)
    h1 = p1.graph.add("missed-1")
    h2 = p1.graph.add("missed-2")
    assert p1.replication.flush()  # pushes are async off the mutation path
    assert p1.replication.log.head >= 2

    # peer-2 comes online and catches up from peer-1's op log
    p2.replication.catch_up("peer-1")
    gid1 = transfer.global_id("peer-1", int(h1))
    gid2 = transfer.global_id("peer-1", int(h2))
    assert _wait(lambda: transfer.lookup_local(p2.graph, gid1) is not None)
    assert _wait(lambda: transfer.lookup_local(p2.graph, gid2) is not None)
    assert p2.replication.last_seen.get("peer-1") >= 2

    # a second catch-up is a no-op (vector clock advanced)
    before = p2.graph.atom_count()
    p2.replication.catch_up("peer-1")
    time.sleep(0.15)
    assert p2.graph.atom_count() == before


def sc_no_echo_loop(two_peers):
    """Mutual interest must not ping-pong atoms forever."""
    p1, p2 = two_peers
    p1.replication.publish_interest(q.type_("string"))
    p2.replication.publish_interest(q.type_("string"))
    assert _wait(lambda: "peer-2" in p1.replication.peer_interests)
    assert _wait(lambda: "peer-1" in p2.replication.peer_interests)

    h = p1.graph.add("ping")
    gid = transfer.global_id("peer-1", int(h))
    assert _wait(lambda: transfer.lookup_local(p2.graph, gid) is not None)
    time.sleep(0.2)  # give any echo time to happen
    # peer-1's log has exactly the one local add; no replicated echoes
    adds = [e for e in p1.replication.log.since(0) if e[1] == "add"]
    assert len(adds) == 1
    # and peer-2 holds exactly one copy
    assert len(q.find_all(p2.graph, q.value("ping"))) == 1


# ---------------------------------------------------------------- TCP transport


def sc_tcp_transport_remote_query():
    g1, g2 = hg.HyperGraph(), hg.HyperGraph()
    p1 = HyperGraphPeer.tcp(g1, identity="tcp-1")
    p2 = HyperGraphPeer.tcp(g2, identity="tcp-2")
    p1.start()
    p2.start()
    try:
        p1.interface.connect("tcp-2", p2.interface.addr)
        assert _wait(lambda: "tcp-1" in p2.interface.peers())
        g2.add_nodes_bulk(["a", "b", "c"])
        rows = p1.run_remote_query("tcp-2", q.type_("string"))
        assert len(rows) == 3
    finally:
        p1.stop()
        p2.stop()
        g1.close()
        g2.close()


def sc_no_duplicate_on_round_trip(two_peers):
    """An atom pushed A→B and then back B→A must keep ONE identity — the
    return push must update A's original, not mint a duplicate."""
    p1, p2 = two_peers
    a = p1.graph.add("orig")
    p1.define_remote("peer-2", a)
    twin = transfer.lookup_local(
        p2.graph, transfer.global_id("peer-1", int(a))
    )
    assert twin is not None
    p2.define_remote("peer-1", int(twin))
    assert len(q.find_all(p1.graph, q.value("orig"))) == 1


def sc_affirm_identity_handshake(two_peers):
    """Peers exchange identities at start (AffirmIdentityBootstrap)."""
    p1, p2 = two_peers
    assert _wait(lambda: "peer-2" in p1.known_peers)
    assert _wait(lambda: "peer-1" in p2.known_peers)
    assert p1.known_peers["peer-2"]["identity"] == "peer-2"


def sc_replication_off_mutation_path(two_peers):
    """The event listener must only enqueue: no serialization, log append,
    or network send happens on the mutating thread."""
    tr = imp_from("peer", "transfer")

    p1, p2 = two_peers
    calls = []
    orig = tr.serialize_atom

    def spy(*a, **k):
        calls.append(threading.current_thread().name)
        return orig(*a, **k)

    tr.serialize_atom = spy
    try:
        p1.graph.add("tracked")
        assert p1.replication.flush()
    finally:
        tr.serialize_atom = orig
    assert calls, "nothing was serialized at all"
    assert all(n == "replication-push" for n in calls), calls


def sc_replication_ingest_overhead_bounded():
    """Ingest with replication attached must not collapse: the listener
    only enqueues (lock-free deque append) and the debounced worker defers
    serialization/logging to quiet gaps. The old synchronous push path
    measured 3-4x; the bound below catches a regression to it while
    staying robust to CI timing noise (the event-dispatch machinery itself
    costs ~10-20% under the GIL — the <10%-class target properly belongs
    to the native runtime, where the worker runs on its own core)."""
    def ingest(g, n=1500):
        t0 = time.perf_counter()
        nodes = [g.add(i) for i in range(n)]
        for i in range(0, n - 1, 2):
            g.add_link((nodes[i], nodes[i + 1]), value=i)
        return time.perf_counter() - t0

    ratios = []
    for _ in range(3):
        g_plain = hg.HyperGraph()
        t_plain = ingest(g_plain)
        g_plain.close()
        net = LoopbackNetwork()
        g_repl = hg.HyperGraph()
        p = HyperGraphPeer.loopback(g_repl, net, identity="solo")
        p.start()
        t_repl = ingest(g_repl)
        assert p.replication.flush()
        p.stop()
        g_repl.close()
        ratios.append(t_repl / t_plain)
    assert min(ratios) < 2.0, ratios


def sc_contract_net_conversation():
    """FIPA contract-net (ProposalConversation analogue): CFP → bids →
    accept lowest → perform → result; losers are rejected cleanly."""
    ContractNet = imp_from("peer.contractnet", "ContractNet")
    TaskParticipant = imp_from("peer.contractnet", "TaskParticipant")

    class Worker(TaskParticipant):
        COSTS = {"w1": 5, "w2": 2, "w3": 9}

        def bid(self, task):
            me = self.peer.identity
            if task.get("kind") != "count":
                return None
            return {"cost": self.COSTS[me]}

        def perform(self, task):
            return {"by": self.peer.identity,
                    "n": self.peer.graph.atom_count()}

    net = LoopbackNetwork()
    peers = []
    for pid in ("boss", "w1", "w2", "w3"):
        g = hg.HyperGraph()
        p = HyperGraphPeer.loopback(g, net, identity=pid)
        if pid != "boss":
            p.activities.register_type(
                ContractNet.TYPE,
                lambda peer, activity_id=None: Worker(
                    peer, activity_id=activity_id),
            )
        p.start()
        peers.append((p, g))
    boss = peers[0][0]
    try:
        act = boss.activities.initiate(ContractNet(
            boss, task={"kind": "count"},
            participants=["w1", "w2", "w3"],
        ))
        winner, result = act.future.result(timeout=10)
        assert winner == "w2"  # lowest cost bid
        assert result["by"] == "w2"
        assert isinstance(result["n"], int)
    finally:
        for p, g in peers:
            p.stop()
            g.close()


def sc_contract_net_all_refuse():
    ContractNet = imp_from("peer.contractnet", "ContractNet")
    TaskParticipant = imp_from("peer.contractnet", "TaskParticipant")

    class Refuser(TaskParticipant):
        def bid(self, task):
            return None

    net = LoopbackNetwork()
    g1, g2 = hg.HyperGraph(), hg.HyperGraph()
    boss = HyperGraphPeer.loopback(g1, net, identity="boss")
    w = HyperGraphPeer.loopback(g2, net, identity="w")
    w.activities.register_type(
        ContractNet.TYPE,
        lambda peer, activity_id=None: Refuser(peer, activity_id=activity_id),
    )
    boss.start()
    w.start()
    try:
        act = boss.activities.initiate(ContractNet(
            boss, task={"kind": "anything"}, participants=["w"]))
        with pytest.raises(Exception, match="refused"):
            act.future.result(timeout=10)
    finally:
        boss.stop()
        w.stop()
        g1.close()
        g2.close()


# ------------------------------------------------------- op-log lifecycle (r5)


def sc_oplog_cursor_and_reopen_flat(tmp_path):
    """A durable log with thousands of entries opens by reading only the
    head/floor markers (no payload materialization) and serves `since` by
    index cursor."""
    OpLog = imp_from("peer.replication", "OpLog")

    g = hg.HyperGraph()
    log = OpLog(g)
    batch = [(log.append_mem("add", {"i": i}), "add", {"i": i})
             for i in range(2000)]
    log.persist_many(batch)
    assert log.head == 2000

    # reopen: head restored from the meta marker, no in-RAM entry list
    log2 = OpLog(g)
    assert log2.head == 2000
    assert log2._mem == []  # durable mode never materializes entries
    tail = log2.since(1995)
    assert [s for s, _, _ in tail] == [1996, 1997, 1998, 1999, 2000]
    assert log2.since(1990, limit=3)[0][0] == 1991

    # truncation drops entries + data records and persists the floor
    dropped = log2.truncate_below(1900)
    assert dropped == 1900
    assert log2.floor == 1900
    assert log2.since(0)[0][0] == 1901
    log3 = OpLog(g)
    assert (log3.head, log3.floor) == (2000, 1900)
    g.close()


def sc_ack_driven_truncation(two_peers):
    p1, p2 = two_peers
    p2.replication.publish_interest(None)  # interested in everything
    assert _wait(lambda: "peer-2" in p1.replication.peer_interests)
    p1.replication.truncate_batch = 8
    for i in range(40):
        p1.graph.add(f"t{i}")
    # generous timeouts: under full-suite CPU contention the push→apply→
    # ack round trips legitimately take longer than the defaults
    assert p1.replication.flush(30)
    assert p2.replication.flush(30)
    # p2's acks flowed back and let p1 reclaim acknowledged entries
    assert _wait(
        lambda: p1.replication.peer_acks.get("peer-2", 0) >= 30, timeout=15
    )
    assert _wait(lambda: p1.replication.log.floor > 0, timeout=15)
    # a catch-up from before the floor flags the full-sync path. The
    # rewind must cover BOTH SeenMap views (contiguous map + applied
    # ranges) and is re-applied each poll: a catch-up continuation or
    # gap-repair page still in flight (sent before flush, applied
    # after) can restore the clock via record_applied and turn one
    # rewound catch-up into a no-op — re-rewinding wins once the
    # stragglers run dry, since nothing new is being pushed.
    def rewound_catchup_flags_full_sync():
        seen = p2.replication.last_seen
        with seen._lock:
            seen._map["peer-1"] = 0
            seen._ranges["peer-1"] = [[0, 0]]
        p2.replication.catch_up("peer-1")
        return "peer-1" in p2.replication.needs_full_sync

    assert _wait(rewound_catchup_flags_full_sync, timeout=15)


def sc_slow_apply_does_not_stall_dispatch(two_peers):
    """A slow closure store on the apply path must not
    block unrelated peer messages (applies run off the dispatch thread)."""
    p1, p2 = two_peers
    p2.replication.publish_interest(None)
    assert _wait(lambda: "peer-2" in p1.replication.peer_interests)

    R = imp_from("peer", "replication")

    gate = threading.Event()
    entered = threading.Event()
    orig = R.transfer.store_closure

    def slow_store(g, atoms):
        entered.set()
        gate.wait(5.0)
        return orig(g, atoms)

    try:
        R.transfer.store_closure = slow_store
        p1.graph.add("slow-one")
        assert p1.replication.flush()
        assert _wait(entered.is_set)  # p2's apply worker is stuck in store
        # dispatch thread must still serve other traffic: an interest
        # published by p1 lands in p2 while the apply is blocked
        p1.replication.publish_interest(q.type_("string"))
        assert _wait(lambda: "peer-1" in p2.replication.peer_interests)
    finally:
        gate.set()
        R.transfer.store_closure = orig
    assert p2.replication.flush()
    assert len(q.find_all(p2.graph, q.value("slow-one"))) == 1


def sc_catchup_pages_through_large_log(two_peers):
    """Catch-up is served in pages: a rejoining peer
    pulls the whole log through repeated page requests, transparently."""
    p1, p2 = two_peers
    p1.replication.catchup_page = 7  # force many pages for 30 entries
    handles = [p1.graph.add(f"paged-{i}") for i in range(30)]
    assert p1.replication.flush()
    assert p1.replication.log.head >= 30

    p2.replication.catch_up("peer-1")
    gids = [transfer.global_id("peer-1", int(h)) for h in handles]
    assert _wait(
        lambda: all(
            transfer.lookup_local(p2.graph, g) is not None for g in gids
        ),
        timeout=10.0,
    )
    assert p2.replication.last_seen.get("peer-1") >= 30
    assert "peer-1" not in p2.replication.needs_full_sync


# --------------------------------------------------------------------------
# CACT breadth: SyncTypes / ReplaceAtom / GetAtomType / TransferGraph
# (the reference's peer/cact/SyncTypes.java, ReplaceAtom.java,
# GetAtomType.java, TransferGraph.java)
# --------------------------------------------------------------------------



@_dataclass(frozen=True)
class _Person:
    name: str = ""
    age: int = 0


def sc_sync_types_installs_record_schema(two_peers):
    p1, p2 = two_peers
    p1.graph.add(_Person("ada", 36))  # auto-binds the record type on A
    tname = p1.graph.typesystem.infer(_Person()).name
    assert tname not in p2.graph.typesystem._by_name

    installed = p1.sync_types_to("peer-2")
    assert tname in installed
    t2 = p2.graph.typesystem.get_type(tname)
    assert tuple(t2.fields) == ("name", "age")


def sc_record_atom_pushes_with_schema(two_peers):
    """A record atom defined only on A transfers to B: the wire schema
    installs the type, the value revives as a field dict."""
    p1, p2 = two_peers
    h = p1.graph.add(_Person("grace", 47))
    handles = p1.define_remote("peer-2", h)
    got = p2.graph.get(handles[-1])
    assert got == {"name": "grace", "age": 47} or getattr(
        got, "name", None
    ) == "grace"
    # and B can query it by type
    tname = p1.graph.typesystem.infer(_Person()).name
    th2 = p2.graph.typesystem.handle_of(tname)
    assert handles[-1] in {int(x) for x in q.find_all(
        p2.graph, q.type_(int(th2))
    )}


def sc_replace_remote_and_get_type(two_peers):
    p1, p2 = two_peers
    a = p2.graph.add("before")
    gid = transfer.global_id("peer-2", int(a))
    transfer._atom_map(p2.graph).add_entry(gid.encode(), int(a))

    info = p1.get_remote_type("peer-2", gid)
    assert info["type"] == "string"
    assert p1.replace_remote("peer-2", gid, "after")
    assert p2.graph.get(int(a)) == "after"
    # missing gid → replaced False
    assert not p1.replace_remote("peer-2", "peer-2:999999", "x")


def sc_transfer_graph_bootstraps_empty_peer(two_peers):
    """B starts empty, TransferGraph +
    catch-up converge it to A's graph INCLUDING a dataclass record type
    defined only on A."""
    p1, p2 = two_peers
    g1 = p1.graph
    nodes = [g1.add(f"n{i}") for i in range(12)]
    links = [
        g1.add_link((nodes[i], nodes[(i + 1) % 12]), value=i)
        for i in range(12)
    ]
    person = g1.add(_Person("ada", 36))
    g1.add_link((person, nodes[0]), value="author-of")
    assert p1.replication.flush()

    before = p2.graph.atom_count()
    stored = p2.transfer_graph_from("peer-1", page=7)
    assert stored >= 12 + 12 + 2

    # structure converged: every A-atom resolves by gid with same topology
    for l in links:
        gid = transfer.gid_of(g1, int(l), "peer-1")
        lb = transfer.lookup_local(p2.graph, gid)
        assert lb is not None
        ta = [transfer.gid_of(g1, t, "peer-1") for t in g1.get_targets(int(l))]
        tb = [
            transfer.gid_of(p2.graph, t, "peer-2")
            for t in p2.graph.get_targets(int(lb))
        ]
        assert ta == tb
    # the record atom arrived with its type installed
    pgid = transfer.gid_of(g1, int(person), "peer-1")
    pb = transfer.lookup_local(p2.graph, pgid)
    got = p2.graph.get(int(pb))
    assert got == {"name": "ada", "age": 36} or getattr(
        got, "name", None
    ) == "ada"

    # post-transfer mutations converge via CATCH-UP ONLY (clock jumped to
    # the server's log head at snapshot time — no full replay)
    seen_at_transfer = p2.replication.last_seen.get("peer-1")
    assert seen_at_transfer >= p1.replication.log.head - 1
    extra = g1.add("late-arrival")
    assert p1.replication.flush()
    p2.replication.catch_up("peer-1")
    egid = transfer.global_id("peer-1", int(extra))
    assert _wait(lambda: transfer.lookup_local(p2.graph, egid) is not None)
    assert "peer-1" not in p2.replication.needs_full_sync


def sc_transfer_graph_maps_type_atoms_not_duplicates(two_peers):
    """Transferred TYPE atoms map onto the receiver's own type atoms:
    no duplicate 'string' type atom after a full bootstrap."""
    p1, p2 = two_peers
    p1.graph.add("x")
    p2.transfer_graph_from("peer-1")

    def type_atoms(g, name):
        ts = g.typesystem
        return [
            h for h in g.atoms()
            if ts._type_atom_name(int(h)) == name
        ]

    assert len(type_atoms(p2.graph, "string")) == 1


def sc_replace_remote_keeps_record_type_on_schemaless_peer(two_peers):
    """Replacing a record atom on a peer that holds
    only the wire schema must NOT retype it to 'dict'."""
    p1, p2 = two_peers
    h = p1.graph.add(_Person("ada", 36))
    handles = p1.define_remote("peer-2", h)
    tname = p1.graph.typesystem.infer(_Person()).name
    hb = handles[-1]
    assert p2.graph.typesystem.name_of(
        p2.graph.get_type_handle_of(hb)
    ) == tname

    gid = transfer.gid_of(p1.graph, int(h), "peer-1")
    assert p1.replace_remote("peer-2", gid, _Person("ada", 37))
    # still the record type, still findable by it, new value visible
    assert p2.graph.typesystem.name_of(
        p2.graph.get_type_handle_of(hb)
    ) == tname
    th2 = p2.graph.typesystem.handle_of(tname)
    assert int(hb) in {int(x) for x in q.find_all(
        p2.graph, q.type_(int(th2))
    )}
    got = p2.graph.get(int(hb))
    age = got["age"] if isinstance(got, dict) else got.age
    assert age == 37


def sc_remote_graph_view(two_peers):
    """RemoteGraphView (PeerHyperNode analogue): CRUD + queries execute on
    the remote peer; nothing is replicated into the local graph."""
    remote_view = imp_from("peer.remote_view", "remote_view")

    p1, p2 = two_peers
    view = remote_view(p1, "peer-2")

    # create remote nodes + a link between them
    ga = view.add("alpha")
    gb = view.add("beta")
    gl = view.add("bond", targets=(ga, gb))
    assert view.get(ga) == "alpha"
    assert view.get_targets(gl) == [ga, gb]
    assert view.get_type_name(ga) == "string"

    # the atoms live ONLY on peer-2
    before = p1.graph.atom_count()
    assert transfer.lookup_local(p1.graph, ga) is None
    assert p1.graph.atom_count() == before
    assert len(q.find_all(p2.graph, q.value("alpha"))) == 1

    # remote query through the view sees them
    rows = view.find_all(q.value("alpha"))
    assert len(rows) == 1
    assert view.count(q.type_("string")) >= 3
    lb = transfer.lookup_local(p2.graph, gl)
    ab = transfer.lookup_local(p2.graph, ga)
    assert view.incidence(int(ab)) == [int(lb)]

    # replace + remove round-trip
    assert view.replace(ga, "alpha2")
    assert view.get(ga) == "alpha2"
    assert view.remove(gl)
    assert view.incidence(int(ab)) == []

    # a record value defined only locally still round-trips (schema rides)
    view2 = remote_view(p2, "peer-1")
    gp = view2.add(_Person("lin", 29))
    got = view2.get(gp)
    name = got["name"] if isinstance(got, dict) else got.name
    assert name == "lin"


# -- the parity cases ---------------------------------------------------------


def test_condition_json_roundtrip():
    both(globals(), "sc_condition_json_roundtrip")


def test_predicate_not_serializable():
    both(globals(), "sc_predicate_not_serializable")


def test_define_and_get_atom():
    both(globals(), "sc_define_and_get_atom")


def test_remote_query_streams_pages():
    both(globals(), "sc_remote_query_streams_pages")


def test_remote_count_and_incidence():
    both(globals(), "sc_remote_count_and_incidence")


def test_remote_remove():
    both(globals(), "sc_remote_remove")


def test_remote_op_failure_surfaces():
    both(globals(), "sc_remote_op_failure_surfaces")


def test_interest_based_replication():
    both(globals(), "sc_interest_based_replication")


def test_replicated_remove():
    both(globals(), "sc_replicated_remove")


def test_offline_catchup():
    both(globals(), "sc_offline_catchup")


def test_no_echo_loop():
    both(globals(), "sc_no_echo_loop")


def test_tcp_transport_remote_query():
    both(globals(), "sc_tcp_transport_remote_query")


def test_no_duplicate_on_round_trip():
    both(globals(), "sc_no_duplicate_on_round_trip")


def test_affirm_identity_handshake():
    both(globals(), "sc_affirm_identity_handshake")


def test_replication_off_mutation_path():
    both(globals(), "sc_replication_off_mutation_path")


def test_replication_ingest_overhead_bounded():
    alone(globals(), "sc_replication_ingest_overhead_bounded")


def test_contract_net_conversation():
    both(globals(), "sc_contract_net_conversation")


def test_contract_net_all_refuse():
    both(globals(), "sc_contract_net_all_refuse")


def test_oplog_cursor_and_reopen_flat(tmp_path):
    both(globals(), "sc_oplog_cursor_and_reopen_flat", tmp_path=tmp_path)


def test_ack_driven_truncation():
    # where the floor lands (so what the log still serves) and the seen
    # map after the rewinds follow the acks' timing
    both(globals(), "sc_ack_driven_truncation",
         unstable=("log", "floor", "seen"))


def test_slow_apply_does_not_stall_dispatch():
    both(globals(), "sc_slow_apply_does_not_stall_dispatch")


def test_catchup_pages_through_large_log():
    both(globals(), "sc_catchup_pages_through_large_log")


def test_sync_types_installs_record_schema():
    both(globals(), "sc_sync_types_installs_record_schema")


def test_record_atom_pushes_with_schema():
    both(globals(), "sc_record_atom_pushes_with_schema")


def test_replace_remote_and_get_type():
    both(globals(), "sc_replace_remote_and_get_type")


def test_transfer_graph_bootstraps_empty_peer():
    both(globals(), "sc_transfer_graph_bootstraps_empty_peer")


def test_transfer_graph_maps_type_atoms_not_duplicates():
    both(globals(), "sc_transfer_graph_maps_type_atoms_not_duplicates")


def test_replace_remote_keeps_record_type_on_schemaless_peer():
    both(globals(), "sc_replace_remote_keeps_record_type_on_schemaless_peer")


def test_remote_graph_view():
    both(globals(), "sc_remote_graph_view")
