"""Gap-aware replication in the port against the reference's: every case of
``tests/test_replication_gaps.py`` (SeenMap contiguity, targeted catch-up
repair of a lost push, the anti-entropy digest, the crash-surviving
redelivery journal, the replication lag) runs as one scenario on both
packages with the reference test's assertions, and the peers' records
(atom maps by gid, op logs, seen maps, digests, stable counters) must be
equal.

Tolerance: exact equality.
"""

from __future__ import annotations

import json
import time

import pytest

from tests.test_torch_peer import both


def faults():
    f = global_faults()
    f.reset()
    yield f
    f.reset()
    f.disable()


def make_pair(a="peer-a", b="peer-b"):
    net = LoopbackNetwork()
    ga, gb = hg.HyperGraph(), hg.HyperGraph()
    pa = HyperGraphPeer.loopback(ga, net, identity=a)
    pb = HyperGraphPeer.loopback(gb, net, identity=b)
    for p in (pa, pb):
        p.replication.send_backoff_s = 0.001
        p.replication.send_backoff_max_s = 0.005
        p.replication.debounce_s = 0.005
        p.replication.redelivery_interval_s = 0.01
        p.replication.down_peer_grace_s = 0.05
    pa.start()
    pb.start()
    return net, pa, pb


def wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


def to_b_only(ctx):
    """Fault filter: eat replication traffic TOWARD peer-b only (B's
    acks and catch-up requests still flow)."""
    return (ctx.get("activity") == "replication"
            and ctx.get("target") == "peer-b")


# ------------------------------------------------------------ SeenMap unit


def sc_seenmap_contiguity_and_gaps():
    sm = SeenMap()
    assert sm.get("p") == 0 and not sm.has_gap("p")
    sm.record_applied("p", 1)
    sm.record_applied("p", 2)
    assert sm.get("p") == 2 and not sm.has_gap("p")
    sm.record_applied("p", 5)           # 3, 4 missing
    assert sm.get("p") == 2             # ack NEVER crosses the hole
    assert sm.max_applied("p") == 5
    assert sm.has_gap("p")
    assert sm.gaps("p") == [(3, 4)]
    sm.record_applied("p", 4)
    assert sm.gaps("p") == [(3, 3)]
    sm.record_applied("p", 3)           # hole closed → ack jumps
    assert sm.get("p") == 5 and not sm.has_gap("p")
    # duplicates are no-ops (idempotent apply)
    sm.record_applied("p", 4)
    assert sm.get("p") == 5 and sm.intervals("p") == [(0, 5)]


def sc_seenmap_anchor_covers_prefix():
    sm = SeenMap()
    sm.record_applied("p", 9)
    assert sm.get("p") == 0 and sm.has_gap("p")
    sm.set("p", 8)                      # snapshot transfer anchored at 8:
    # [0,8] is adjacent to the applied [9,9] — everything contiguous
    assert sm.get("p") == 9 and not sm.has_gap("p")


def sc_seenmap_anchor_gap_stays_open():
    sm = SeenMap()
    sm.record_applied("p", 10)
    sm.set("p", 7)
    assert sm.get("p") == 7
    assert sm.gaps("p") == [(8, 9)]


def sc_seenmap_durable_contiguous_ack():
    g = hg.HyperGraph()
    try:
        sm = SeenMap(g)
        sm.record_applied("p", 1)
        sm.record_applied("p", 3)       # gap at 2: durable ack stays 1
        sm2 = SeenMap(g)                # reopen
        assert sm2.get("p") == 1
        assert not sm2.has_gap("p")     # RAM intervals do not persist —
        # a restart re-fetches from the contiguous ack (idempotent)
    finally:
        g.close()


# ------------------------------------------- gap detection + targeted repair


def sc_lost_push_detected_and_repaired_by_later_push(faults):
    net, pa, pb = make_pair()
    try:
        # tight budgets: the drop exhausts in milliseconds
        pa.replication.send_attempts = 1
        pa.replication.max_redeliveries = 1
        pb.replication.publish_interest(None)
        assert wait_for(lambda: "peer-b" in pa.replication.peer_interests)
        pa.graph.add("before-outage")
        assert pa.replication.flush()
        assert wait_for(
            lambda: q.find_all(pb.graph, q.value("before-outage")) != [])
        # total outage toward B: this push drops past the budget
        faults.enable(seed=0)
        faults.arm("peer.transport.send", prob=1.0, when=to_b_only)
        pa.graph.add("lost-in-outage")
        assert pa.replication.flush(timeout=30)
        assert pa.graph.metrics.counters.get(
            "peer.redelivery_dropped", 0) >= 1
        # B is oblivious — max-applied semantics would have stayed so
        assert q.find_all(pb.graph, q.value("lost-in-outage")) == []
        # wire heals; the NEXT push's seq skips past the hole
        faults.disarm("peer.transport.send")
        pa.graph.add("after-outage")
        assert pa.replication.flush(timeout=30)
        # contiguity sees the hole → targeted catch-up repairs it
        assert wait_for(
            lambda: q.find_all(pb.graph, q.value("lost-in-outage")) != [])
        assert wait_for(
            lambda: q.find_all(pb.graph, q.value("after-outage")) != [])
        assert pb.graph.metrics.counters.get("peer.gaps_detected", 0) >= 1
        assert wait_for(
            lambda: not pb.replication.last_seen.has_gap("peer-a"))
        assert pb.replication.flush()
        assert (transfer.content_digest(pa.graph)
                == transfer.content_digest(pb.graph))
        # the repaired ack reaches the sender's full head
        assert wait_for(lambda: pb.replication.last_seen.get("peer-a")
                        == pa.replication.log.head)
    finally:
        pa.stop()
        pb.stop()


def sc_gap_pins_sender_truncation(faults):
    """A receiver stuck behind a hole acks only the contiguous prefix,
    so the sender's auto-truncation cannot reclaim the entries the
    repair catch-up still needs."""
    net, pa, pb = make_pair()
    try:
        pa.replication.send_attempts = 1
        pa.replication.max_redeliveries = 1
        pa.replication.truncate_batch = 1   # eager truncation
        pb.replication.publish_interest(None)
        assert wait_for(lambda: "peer-b" in pa.replication.peer_interests)
        pa.graph.add("t-base")
        assert pa.replication.flush()
        assert wait_for(
            lambda: q.find_all(pb.graph, q.value("t-base")) != [])
        base_ack = pb.replication.last_seen.get("peer-a")
        faults.enable(seed=0)
        faults.arm("peer.transport.send", prob=1.0, when=to_b_only)
        pa.graph.add("t-lost")
        assert pa.replication.flush(timeout=30)
        faults.disarm("peer.transport.send")
        pa.graph.add("t-after")
        assert pa.replication.flush(timeout=30)
        assert wait_for(
            lambda: q.find_all(pb.graph, q.value("t-lost")) != [])
        # the log floor never crossed the gap while it was open: the
        # repair could always be served (floor <= base_ack at drop time)
        assert pa.replication.log.floor <= pa.replication.log.head
        assert pb.replication.last_seen.get("peer-a") > base_ack
        # once the hole is repaired B acks the head, and the eager
        # truncation follows on A's own thread: wait for it, or the peer
        # record read at stop depends on which thread ran first
        assert wait_for(
            lambda: pa.replication.log.floor == pa.replication.log.head)
    finally:
        pa.stop()
        pb.stop()


# ---------------------------------------------------- anti-entropy backstop


def sc_anti_entropy_digest_repairs_silent_loss(faults):
    """The nastiest loss: the LAST pushes before a silence drop past the
    budget — no later push ever exposes the hole, contiguity alone
    cannot help. The periodic digest probe does."""
    net, pa, pb = make_pair()
    try:
        pa.replication.send_attempts = 1
        pa.replication.max_redeliveries = 1
        pb.replication.publish_interest(None)
        assert wait_for(lambda: "peer-b" in pa.replication.peer_interests)
        pa.graph.add("ae-base")
        assert pa.replication.flush()
        assert wait_for(
            lambda: q.find_all(pb.graph, q.value("ae-base")) != [])
        faults.enable(seed=0)
        faults.arm("peer.transport.send", prob=1.0, when=to_b_only)
        pa.graph.add("ae-lost-1")
        pa.graph.add("ae-lost-2")
        assert pa.replication.flush(timeout=30)
        faults.disarm("peer.transport.send")
        # silence: NO further mutations. B probes the digest instead.
        assert q.find_all(pb.graph, q.value("ae-lost-2")) == []
        pb.replication.anti_entropy("peer-a")
        assert wait_for(
            lambda: q.find_all(pb.graph, q.value("ae-lost-1")) != [])
        assert wait_for(
            lambda: q.find_all(pb.graph, q.value("ae-lost-2")) != [])
        assert pb.graph.metrics.counters.get(
            "peer.anti_entropy_probes", 0) >= 1
        assert pb.replication.flush()
        assert (transfer.content_digest(pa.graph)
                == transfer.content_digest(pb.graph))
    finally:
        pa.stop()
        pb.stop()


# ------------------------------------------------------- redelivery journal


def sc_redelivery_journal_roundtrip_and_replay(faults, tmp_path):
    """The queue survives a process death: while the wire is down the
    journal mirrors the in-memory queue exactly (crash-atomic rewrite);
    a restarted peer replays it and delivers once the wire heals — no
    catch-up needed, per-peer order preserved."""
    journal = str(tmp_path / "redelivery.jsonl")
    net, pa, pb = make_pair()
    try:
        pa.replication.journal_path = journal
        pa.replication.send_attempts = 1
        pa.replication.max_redeliveries = 10**6  # keep them QUEUED
        pb.replication.publish_interest(None)
        assert wait_for(lambda: "peer-b" in pa.replication.peer_interests)
        faults.enable(seed=0)
        faults.arm("peer.transport.send", prob=1.0, when=to_b_only)
        pa.graph.add("journal-1")
        pa.graph.add("journal-2")
        # both pushes end up queued for redelivery (budget is deep)
        assert wait_for(lambda: pa.replication._redelivery_n >= 2)

        def journal_lines():
            with open(journal, encoding="utf-8") as f:
                return [json.loads(line) for line in f if line.strip()]

        # "kill" A: stop freezes the queue; the journal mirrors it
        # (attempt counters may trail by the in-flight probe — the
        # (pid, seq) content and ORDER are the replay contract)
        pa.stop()
        q_mem = [
            (pid, msg["content"]["seq"])
            for pid, dq in pa.replication._redelivery.items()
            for msg, _attempt in dq
        ]
        q_disk = [
            (r["pid"], r["message"]["content"]["seq"])
            for r in journal_lines()
        ]
        assert q_disk == q_mem and len(q_disk) == 2
        seqs = [s for _, s in q_disk]
        assert seqs == sorted(seqs)              # per-peer order on disk
        # restart on the same graph: the journal replays into the queue
        ga = pa.graph
        pa2 = HyperGraphPeer.loopback(ga, net, identity="peer-a")
        pa2.replication.journal_path = journal
        pa2.replication.send_backoff_s = 0.001
        pa2.replication.redelivery_interval_s = 0.01
        # what the replay loaded, read as it returns: start() replays the
        # journal before it starts the push worker, which may drain the
        # healed queue at once
        rep2, loaded = pa2.replication, {}
        replay = rep2._journal_replay

        def recorded_replay():
            replay()
            loaded["n"] = rep2._redelivery_n
            loaded["queue"] = [(pid, msg["content"]["seq"])
                               for pid, dq in rep2._redelivery.items()
                               for msg, _attempt in dq]

        rep2._journal_replay = recorded_replay
        faults.disarm("peer.transport.send")     # wire healed
        pa2.start()
        assert loaded["n"] == 2                      # replayed
        assert loaded["queue"] == q_disk             # in the journal's order
        assert pa2.replication.flush(timeout=30)
        assert wait_for(
            lambda: q.find_all(pb.graph, q.value("journal-1")) != [])
        assert wait_for(
            lambda: q.find_all(pb.graph, q.value("journal-2")) != [])
        # delivered queue → journal rewritten empty
        assert wait_for(lambda: journal_lines() == [])
        pa2.stop()
    finally:
        pb.stop()


def sc_replication_lag_tracks_peer_head():
    net, pa, pb = make_pair()
    try:
        pb.replication.publish_interest(None)
        assert wait_for(lambda: "peer-b" in pa.replication.peer_interests)
        pa.graph.add("lag-1")
        pa.graph.add("lag-2")
        assert pa.replication.flush()
        # wait on the advertised head, not on lag == 0: lag reads 0
        # vacuously while peer_heads has no entry yet (the push carrying
        # the head may still be in flight on the apply thread)
        assert wait_for(lambda: pb.replication.peer_heads.get("peer-a")
                        == pa.replication.log.head)
        assert wait_for(lambda: pb.replication.replication_lag("peer-a")
                        == 0)
    finally:
        pa.stop()
        pb.stop()


def sc_gap_repair_mark_clears_when_request_cannot_send():
    """A repair catch-up that never left the process (reliable-send
    budget spent) must drop the in-flight mark — otherwise no
    catchup-result can ever clear it and the hole wedges unrepaired."""
    net, pa, pb = make_pair()
    try:
        rep = pb.replication
        rep.last_seen.record_applied("peer-a", 1)
        rep.last_seen.record_applied("peer-a", 3)   # 2 lost
        assert rep.last_seen.has_gap("peer-a")
        calls = []

        def unsendable(pid):
            calls.append(pid)
            return False

        orig, rep.catch_up = rep.catch_up, unsendable
        try:
            rep._check_gap("peer-a")
            assert calls == ["peer-a"]
            # mark dropped: the NEXT apply cycle re-triggers
            assert "peer-a" not in rep._gap_repairs

            def sendable(pid):
                calls.append(pid)
                return True

            rep.catch_up = sendable
            rep._check_gap("peer-a")
            assert "peer-a" in rep._gap_repairs     # awaiting the page
            rep._check_gap("peer-a")                # no double-fire
            assert calls == ["peer-a", "peer-a"]
        finally:
            rep.catch_up = orig
    finally:
        pa.stop()
        pb.stop()


def sc_anti_entropy_skips_repair_while_position_advances():
    """The digest backstop repairs a STALLED position (and the first
    sight of one), not ordinary in-flight lag: behind-the-head while
    still advancing means pushes are flowing and a catch-up would just
    shadow them with duplicate traffic."""
    M = imp_from("peer", "messages")

    net, pa, pb = make_pair()
    try:
        rep = pb.replication
        calls = []
        orig, rep.catch_up = rep.catch_up, lambda pid: (
            calls.append(pid), True)[1]
        try:
            def digest(head):
                rep.handle("peer-a", M.make_message(
                    M.INFORM, rep.ACTIVITY_TYPE,
                    {"what": "digest-result", "head": head, "floor": 0},
                ))

            digest(10)                    # first sight, mine=0 → repair
            assert calls == ["peer-a"]
            for s in range(1, 6):         # progress: mine advances to 5
                rep.last_seen.record_applied("peer-a", s)
            digest(10)                    # advancing → in-flight lag, skip
            assert calls == ["peer-a"]
            digest(12)                    # stalled at 5 since last probe
            assert calls == ["peer-a", "peer-a"]
            assert pb.graph.metrics.counters.get(
                "peer.anti_entropy_repairs", 0) == 2
        finally:
            rep.catch_up = orig
    finally:
        pa.stop()
        pb.stop()


def sc_seenmap_deferred_persist_batches_store_writes():
    """``persist=False`` covers positions in RAM only; ONE explicit
    :meth:`SeenMap.persist` per sender makes the batch durable — the
    apply worker's cost model (one store tx per drained cycle, not one
    per in-order push)."""
    g = hg.HyperGraph()
    try:
        sm = SeenMap(g)
        for s in range(1, 6):
            sm.record_applied("p", s, persist=False)
        assert sm.get("p") == 5                 # RAM view advanced
        assert SeenMap(g).get("p") == 0         # nothing durable yet
        sm.persist("p")
        assert SeenMap(g).get("p") == 5         # one write, all covered
        sm.persist("p")                         # no-op when unadvanced
        assert SeenMap(g).get("p") == 5
    finally:
        g.close()


# -- the parity cases ---------------------------------------------------------


def test_seenmap_contiguity_and_gaps():
    both(globals(), "sc_seenmap_contiguity_and_gaps")


def test_seenmap_anchor_covers_prefix():
    both(globals(), "sc_seenmap_anchor_covers_prefix")


def test_seenmap_anchor_gap_stays_open():
    both(globals(), "sc_seenmap_anchor_gap_stays_open")


def test_seenmap_durable_contiguous_ack():
    both(globals(), "sc_seenmap_durable_contiguous_ack")


def test_lost_push_detected_and_repaired_by_later_push():
    both(globals(), "sc_lost_push_detected_and_repaired_by_later_push")


def test_gap_pins_sender_truncation():
    both(globals(), "sc_gap_pins_sender_truncation")


def test_anti_entropy_digest_repairs_silent_loss():
    both(globals(), "sc_anti_entropy_digest_repairs_silent_loss")


def test_redelivery_journal_roundtrip_and_replay(tmp_path):
    both(globals(), "sc_redelivery_journal_roundtrip_and_replay", tmp_path=tmp_path)


def test_replication_lag_tracks_peer_head():
    both(globals(), "sc_replication_lag_tracks_peer_head")


def test_gap_repair_mark_clears_when_request_cannot_send():
    both(globals(), "sc_gap_repair_mark_clears_when_request_cannot_send")


def test_anti_entropy_skips_repair_while_position_advances():
    both(globals(), "sc_anti_entropy_skips_repair_while_position_advances")


def test_seenmap_deferred_persist_batches_store_writes():
    both(globals(), "sc_seenmap_deferred_persist_batches_store_writes")
