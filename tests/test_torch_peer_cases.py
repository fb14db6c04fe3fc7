"""Peer-plane cases beyond the reference's peer test files, on both
packages, and the port's own fixes.

- The two peer cases of ``tests/test_exc_fixes.py`` (a failed ack send
  and a failed catch-up continuation are counted) and the three journal
  cases of ``tests/test_wire_fixes.py`` (the redelivery journal's stamp,
  a legacy record, a future record), run as scenarios on both packages
  through ``test_torch_peer``'s harness; a journal either package writes
  is byte for byte the other's and replays in it.
- Two faults of the reference that the port does not copy: ``OpLog.since``
  cut its page after reading whole sequence groups, so a page could split
  the entries of one seq; and a sender whose seen-map update failed was
  asked for its next catch-up page at once, from the same cursor, again
  and again.
- The transaction overlay's (index, value) → keys map behind
  ``find_by_value``: the same keys as the reference over nested
  transactions mixing adds, removes and ``remove_all_entries``, and 20,000
  ``gid_of`` calls in one transaction in seconds (the reference walks
  every entry the transaction wrote on each call).
- The memory index's inverse map, built on first use, loses no entry a
  writer adds while it is being built.
- ``HyperGraphPeer.from_config`` starts the peer a configuration's
  ``peer`` section describes (port only: nothing in the reference reads
  the section), and raises on settings it cannot honour.
- Conversation ids are version-4 UUIDs that a forked child does not
  repeat.

Tolerance: exact equality; the lookup case's bound is 5 s.
"""

from __future__ import annotations

import importlib
import json
import sys
import threading
import time
import types
from collections import deque

import numpy as np

from tests.test_torch_peer import PKGS, both, counters, run_scenario  # noqa: F401
from tests.test_torch_peer import _wait, two_peers  # noqa: F401


def mod(pkg: str, sub: str):
    return importlib.import_module(f"{pkg}.{sub}")


# -- tests/test_exc_fixes.py: swallowed peer failures are counted ----------


def sc_ack_send_failure_is_counted(two_peers):
    p1, p2 = two_peers
    p2.replication.publish_interest(None)
    assert _wait(lambda: "peer-2" in p1.replication.peer_interests)

    orig_send = p2.interface.send

    def flaky_send(to, msg):
        if "ack" in str(msg):
            raise ConnectionError("ack pipe torn")
        return orig_send(to, msg)

    p2.interface.send = flaky_send
    p1.graph.add("hello")
    assert _wait(
        lambda: counters(p2.graph).get("peer.ack_send_failures", 0) >= 1
    ), "ack-send failure left no counter evidence"


def sc_catch_up_failure_is_counted(two_peers):
    _, p2 = two_peers
    p2.replication._apply = lambda sender, kind, entry: None

    def gone(pid):
        raise ConnectionError("peer gone")

    p2.replication.catch_up = gone
    # a continuation page: applied items + continue_catchup=True drives
    # the drain loop into the catch-up pull that now fails
    p2.replication._enqueue_apply(
        "peer-1", [("record", {}, 999, None)], True)
    assert _wait(
        lambda: counters(p2.graph).get("peer.catch_up_failures", 0) >= 1
    ), "catch-up failure left no counter evidence"
    return counters(p2.graph)["peer.catch_up_failures"]


def test_ack_send_failure_is_counted():
    both(globals(), "sc_ack_send_failure_is_counted")


def test_catch_up_failure_is_counted():
    both(globals(), "sc_catch_up_failure_is_counted")


# -- tests/test_wire_fixes.py: the redelivery journal's stamp ---------------


def make_replication(pkg, journal_path):
    r = mod(pkg, "peer.replication").Replication(
        types.SimpleNamespace(graph=mod(pkg, "core.graph").HyperGraph()))
    r.journal_path = str(journal_path)
    return r


def journal_records(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def test_journal_save_stamps_and_replay_restores(tmp_path):
    raw = []
    for pkg in PKGS:
        path = tmp_path / f"{pkg}.jsonl"
        r = make_replication(pkg, path)
        r._redelivery["peer-x"] = deque(
            [({"op": "push", "seq": 1}, 1), ({"op": "push", "seq": 2}, 3)])
        r._journal_save()
        recs = journal_records(path)
        assert [rec["schema_version"] for rec in recs] == [1, 1]
        assert recs[0]["schema_version"] == mod(
            pkg, "peer.replication").JOURNAL_SCHEMA_VERSION
        raw.append(path.read_bytes())
    assert raw[1] == raw[0]
    # each package replays the journal the other wrote
    for pkg, other in zip(PKGS, PKGS[::-1]):
        r2 = make_replication(pkg, tmp_path / f"{other}.jsonl")
        r2._journal_replay()
        assert dict(r2._redelivery) == {
            "peer-x": deque([({"op": "push", "seq": 1}, 1),
                             ({"op": "push", "seq": 2}, 3)]),
        }
        assert r2._redelivery_n == 2


def replay(pkg, path):
    r = make_replication(pkg, path)
    r._journal_replay()
    return dict(r._redelivery), r._redelivery_n


def test_journal_legacy_unstamped_record_still_replays(tmp_path):
    # a journal written before the stamp parses as version 1
    path = tmp_path / "redelivery.jsonl"
    path.write_text(json.dumps(
        {"pid": "peer-y", "attempt": 2, "message": {"op": "push"}}) + "\n")
    got = [replay(pkg, path) for pkg in PKGS]
    assert got[1] == got[0]
    assert got[1][0] == {"peer-y": deque([({"op": "push"}, 2)])}


def test_journal_future_version_is_skipped_not_guessed(tmp_path):
    # a future stamp is skipped (catch-up repairs the loss); the records
    # this build understands still replay
    path = tmp_path / "redelivery.jsonl"
    path.write_text(
        json.dumps({"schema_version": 99, "pid": "peer-z", "attempt": 1,
                    "message": {"op": "push", "seq": 1}}) + "\n"
        + json.dumps({"schema_version": 1, "pid": "peer-z", "attempt": 1,
                      "message": {"op": "push", "seq": 2}}) + "\n")
    got = [replay(pkg, path) for pkg in PKGS]
    assert got[1] == got[0]
    assert got[1] == ({"peer-z": deque([({"op": "push", "seq": 2}, 1)])}, 1)


# -- reference faults the port does not copy --------------------------------


def split_log(pkg):
    """A durable op log of 3 entries whose seq 2 holds two data records
    (as a seq shared by several records would)."""
    g = mod(pkg, "core.graph").HyperGraph()
    log = mod(pkg, "peer.replication").OpLog(g)
    log.persist_many([(log.append_mem("add", {"i": i}), "add", {"i": i})
                      for i in range(3)])

    def second_record():
        dh = g.handles.make()
        g.store.store_data(dh, json.dumps(["add", {"i": "1b"}]).encode())
        g.store.get_index(log.IDX).add_entry((2).to_bytes(8, "big"), dh)

    g.txman.ensure_transaction(second_record)
    return g, log


def test_oplog_page_keeps_sequence_groups_whole():
    """``since(seq, limit)`` stops after the key that reaches the limit and
    returns every record of it: a client resumes after the highest seq it
    applied, so a cut record of that seq would never be served."""
    g, log = split_log(PKGS[1])
    page = log.since(0, limit=2)
    assert [(s, p["i"]) for s, _, p in page] == [(1, 0), (2, 1), (2, "1b")]
    assert [s for s, _, _ in log.since(1, limit=1)] == [2, 2]
    assert [s for s, _, _ in log.since(0)] == [1, 2, 2, 3]
    g.close()
    # the reference cuts the page at `limit` and drops seq 2's second record
    g, log = split_log(PKGS[0])
    assert [(s, p["i"]) for s, _, p in log.since(0, limit=2)] == [
        (1, 0), (2, 1)]
    g.close()


def sc_failed_seen_map_update_waits_for_next_catch_up(two_peers):
    """A page applied while the seen map cannot record it leaves the
    cursor where it was: asking for the next page at once would fetch the
    same page, so the port waits for the next scheduled catch-up."""
    p1, p2 = two_peers
    p1.replication.catchup_page = 3
    for i in range(10):
        p1.graph.add(f"paged-{i}")
    assert p1.replication.flush()

    def broken(*a, **k):
        raise RuntimeError("seen map unwritable")

    p2.replication.last_seen.record_applied = broken
    p2.replication.catch_up("peer-1")
    assert _wait(lambda: counters(p2.graph).get("peer.applies", 0) >= 3)
    if PORT:
        time.sleep(0.5)
        assert p2.replication.flush()
        assert counters(p2.graph)["peer.catchups"] == 1
        assert counters(p1.graph)["peer.catchup_pages"] == 1
        assert p2.replication.last_seen.get("peer-1") == 0
    else:
        # the reference asks again and again for the same first page
        assert _wait(
            lambda: counters(p1.graph).get("peer.catchup_pages", 0) >= 3)
        p2.replication.catch_up = lambda pid: True  # end the loop
        assert p2.replication.flush()


def test_failed_seen_map_update_waits_for_next_catch_up():
    for pkg in PKGS:
        run_scenario(globals(), "sc_failed_seen_map_update_waits_for_next"
                     "_catch_up", pkg, {})


# -- the overlay's (index, value) -> keys map --------------------------------


def overlay_script(seed: int, n_ops: int = 400):
    """Nested transactions over one index: each step adds, removes or wipes
    a key at a random depth; ``find_by_value`` of every value is read at
    each level, and after each nested commit or abort."""
    r = np.random.default_rng(seed)
    keys = [f"k{i}".encode() for i in range(12)]
    ops = []
    for _ in range(n_ops):
        ops.append((int(r.integers(0, 6)), keys[int(r.integers(0, 12))],
                    int(r.integers(1, 9))))
    return keys, ops


def run_overlay(pkg: str, seed: int):
    g = mod(pkg, "core.graph").HyperGraph()
    idx = g.store.get_index("t.overlay")
    keys, ops = overlay_script(seed)
    for k in keys[:6]:
        g.txman.transact(lambda k=k: [idx.add_entry(k, v) for v in (1, 2, 3)])
    reads = []

    def read():
        reads.append([idx.find_by_value(v) for v in range(1, 9)])

    tm = g.txman
    depth = 0
    for op, k, v in ops:
        if op == 0:
            idx.add_entry(k, v)
        elif op == 1:
            idx.remove_entry(k, v)
        elif op == 2:
            idx.remove_all_entries(k)
        elif op == 3 and depth < 3:
            tm.begin()
            depth += 1
        elif op == 4 and depth:
            tm.commit(tm.current())
            depth -= 1
        elif op == 5 and depth:
            tm.abort(tm.current())
            depth -= 1
        read()
    while depth:
        tm.commit(tm.current())
        depth -= 1
    read()
    g.close()
    return reads


def test_find_by_value_overlay_matches_reference():
    for seed in (3, 17, 29):
        got = [run_overlay(pkg, seed) for pkg in PKGS]
        assert got[1] == got[0]
        assert any(any(r) for r in got[1])


def test_gid_of_in_one_transaction_is_linear():
    """20,000 fresh gids minted inside one transaction: each lookup reads
    the overlay map, not every entry the transaction wrote."""
    g = mod(PKGS[1], "core.graph").HyperGraph()
    transfer = mod(PKGS[1], "peer.transfer")
    hs = [int(h) for h in g.bulk_import(values=list(range(20_000)))]
    t0 = time.perf_counter()
    gids = g.txman.transact(
        lambda: [transfer.gid_of(g, h, "A") for h in hs])
    took = time.perf_counter() - t0
    assert gids == [f"A:{h}" for h in hs]
    assert [transfer.existing_gid(g, h) for h in hs[::997]] == gids[::997]
    assert took < 5.0, took
    g.close()


# -- the memory index's inverse map beside a writer --------------------------


def test_inverse_map_built_beside_a_writer_loses_nothing():
    MemIndex = mod(PKGS[1], "storage.memstore").MemIndex
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the two threads finely
    try:
        inverse_map_rounds(MemIndex)
    finally:
        sys.setswitchinterval(switch)


def inverse_map_rounds(MemIndex):
    for attempt in range(3):
        idx = MemIndex("t")
        for v in range(20_000):
            idx.add_entry(f"a{v}".encode(), v)
        go = threading.Event()

        def writer():
            go.wait()
            for v in range(20_000, 60_000):
                idx.add_entry(f"b{v}".encode(), v)
                if v % 3 == 0:
                    idx.remove_entry(f"b{v}".encode(), v)

        t = threading.Thread(target=writer)
        t.start()
        go.set()
        idx.find_by_value(0)  # builds the map while the writer runs
        t.join(timeout=60)
        assert not t.is_alive()
        for v in range(0, 60_000, 7):
            want = ([] if v >= 20_000 and v % 3 == 0 else
                    [(f"a{v}" if v < 20_000 else f"b{v}").encode()])
            assert idx.find_by_value(v) == want, (attempt, v)


# -- PeerConfig starts the peer it describes ---------------------------------


def config_graph(**peer):
    cfg = mod(PKGS[1], "core.config")
    raw = json.loads(cfg.HGConfiguration().to_json())
    raw["peer"].update(peer)
    return mod(PKGS[1], "core.graph").HyperGraph(
        cfg.HGConfiguration.from_json(json.dumps(raw)))


def test_peer_config_starts_tcp_peers_that_replicate():
    """A configuration file's ``peer`` section over TCP: A listens where
    it says, B dials A from its bootstrap list and, with ``replicate``,
    catches up on what A logged before B started and receives A's later
    writes."""
    HyperGraphPeer = mod(PKGS[1], "peer").HyperGraphPeer
    transfer = mod(PKGS[1], "peer.transfer")
    ga = config_graph(name="cfg-a", transport="tcp",
                      listen_address="127.0.0.1:0")
    A = HyperGraphPeer.from_config(ga)
    early = ga.add("before B")
    A.replication.flush()  # logged before B's interest: history
    host, port = A.interface.addr
    gb = config_graph(name="cfg-b", transport="tcp", replicate=True,
                      bootstrap=[f"cfg-a@{host}:{port}"])
    B = HyperGraphPeer.from_config(gb)
    try:
        assert (A.identity, B.identity) == ("cfg-a", "cfg-b")
        assert _wait(lambda: "cfg-a" in B.known_peers
                     and "cfg-b" in A.known_peers)
        assert _wait(lambda: "cfg-b" in A.replication.peer_interests)
        for h in (early, ga.add("after B")):  # caught up, then pushed
            gid = transfer.global_id("cfg-a", int(h))
            assert _wait(lambda: transfer.lookup_local(gb, gid) is not None)
            A.replication.flush()
        assert _wait(lambda: transfer.content_digest(ga)
                     == transfer.content_digest(gb))
    finally:
        B.stop()
        A.stop()
        ga.close()
        gb.close()


def test_peer_config_loopback_and_its_errors():
    """Over loopback the bootstrap names peers on the network; an unknown
    transport, a missing network, a malformed address and an absent
    bootstrap peer raise instead of starting a peer that ignores them."""
    import pytest

    peer_mod = mod(PKGS[1], "peer")
    HyperGraphPeer, net = peer_mod.HyperGraphPeer, peer_mod.LoopbackNetwork()
    ga = config_graph(name="lo-a")
    gb = config_graph(name="lo-b", replicate=True, bootstrap=["lo-a"])
    bad = [config_graph(transport="grpc"), config_graph(),
           config_graph(transport="tcp", listen_address="127.0.0.1"),
           config_graph(transport="tcp", bootstrap=["127.0.0.1:9"]),
           config_graph(name="lo-c", bootstrap=["nobody"])]
    for g, network in zip(bad, (net, None, None, None, net)):
        with pytest.raises(ValueError):
            HyperGraphPeer.from_config(g, network)
    A = HyperGraphPeer.from_config(ga, net)
    B = HyperGraphPeer.from_config(gb, net)
    try:
        h = ga.add("over loopback")
        A.replication.flush()
        gid = mod(PKGS[1], "peer.transfer").global_id("lo-a", int(h))
        assert _wait(lambda: mod(PKGS[1], "peer.transfer").lookup_local(
            gb, gid) is not None)
        assert net.peer_ids() == ["lo-a", "lo-b"]
    finally:
        B.stop()
        A.stop()
        for g in [ga, gb, *bad]:
            g.close()


# -- conversation ids ----------------------------------------------------------


def test_message_ids_are_uuid4_and_differ_after_fork():
    """``new_id`` gives distinct version-4 UUIDs, and a forked child
    does not repeat the ids its parent draws next."""
    import os
    import uuid

    M = mod(PKGS[1], "peer.messages")
    ids = [M.new_id() for _ in range(3000)]  # crosses a buffer refill
    assert len(set(ids)) == len(ids)
    assert all(str(uuid.UUID(i)) == i and uuid.UUID(i).version == 4
               and uuid.UUID(i).variant == uuid.RFC_4122 for i in ids)
    M.new_id()  # the buffer holds ids the child inherits
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        os.write(w, json.dumps([M.new_id() for _ in range(8)]).encode())
        os._exit(0)
    os.close(w)
    with os.fdopen(r) as f:
        child = json.loads(f.read())
    os.waitpid(pid, 0)
    parent = [M.new_id() for _ in range(8)]
    assert not set(child) & set(parent)
