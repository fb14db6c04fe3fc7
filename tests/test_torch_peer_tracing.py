"""Cross-process trace propagation over the port's peer plane against the
reference's: every case of ``tests/test_peer_tracing.py`` (a push, a
catch-up page, a snapshot transfer and a remote op each render as one
connected span tree across the two peers) runs as one scenario on both
packages with the reference test's assertions, and the peers' records
(atom maps by gid, op logs, seen maps, digests, stable counters) must be
equal.

Tolerance: exact equality.
"""

from __future__ import annotations

import time

import pytest

from tests.test_torch_peer import both


def make_pair():
    net = LoopbackNetwork()
    ga, gb = hg.HyperGraph(), hg.HyperGraph()
    pa = HyperGraphPeer.loopback(ga, net, identity="trace-a")
    pb = HyperGraphPeer.loopback(gb, net, identity="trace-b")
    for p in (pa, pb):
        p.replication.debounce_s = 0.005
        p.tracer = Tracer(max_finished=256).enable()
    pa.start()
    pb.start()
    return pa, pb


def stop_pair(pa, pb):
    pa.stop()
    pb.stop()


def wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


def by_name(traces, name):
    return [t for t in traces if t.name == name]


def span(trace, name):
    sp = trace.find(name)
    assert sp is not None, (trace.name, name,
                            [s.name for s in trace.spans()])
    return sp


# --------------------------------------------------------- wire format


def sc_context_attach_and_extract_roundtrip():
    tr = Tracer().enable().start_trace("peer.push")
    root = tr.start_span("push")
    tr.marks["root"] = root
    msg = M.make_message(M.INFORM, "replication", {"what": "push"})
    M.attach_trace(msg, tr.context())
    # survives the loopback/TCP wire constraint (JSON round trip)
    import json

    wired = json.loads(json.dumps(msg))
    ctx = M.trace_context(wired)
    assert ctx == {"tid": tr.trace_id, "sid": root.span_id, "s": 1}
    assert M.trace_context(M.make_message(M.INFORM, "replication", {})) \
        is None  # pre-tracing peers carry no context


def sc_remote_trace_joins_on_id_and_parent():
    ta, tb = Tracer().enable(), Tracer().enable()
    tr = ta.start_trace("peer.push")
    root = tr.start_span("push")
    tr.marks["root"] = root
    remote = tb.start_remote_trace("peer.apply", tr.context())
    assert remote.trace_id == tr.trace_id
    child = remote.start_span("apply")   # parentless → remote parent
    assert child.parent_id == root.span_id
    grand = remote.start_span("inner", parent=child)
    assert grand.parent_id == child.span_id


# ------------------------------------------------- replication push


def sc_replication_push_one_connected_tree():
    pa, pb = make_pair()
    try:
        pb.replication.publish_interest(None)
        assert wait_for(lambda: "trace-b" in pa.replication.peer_interests)
        pa.graph.add("traced-push")
        assert pa.replication.flush()
        assert wait_for(
            lambda: q.find_all(pb.graph, q.value("traced-push")) != [])
        assert pb.replication.flush()

        pushes = by_name(pa.tracer.drain(), "peer.push")
        applies = by_name(pb.tracer.drain(), "peer.apply")
        assert pushes and applies
        # join on trace id: at least one push tree has its apply subtree
        joined = 0
        apply_by_tid = {t.trace_id: t for t in applies}
        for push in pushes:
            recv = apply_by_tid.get(push.trace_id)
            if recv is None:
                continue
            joined += 1
            # remote-child parenting: the receiver's apply root hangs
            # under the sender's push span
            assert span(recv, "apply").parent_id == \
                span(push, "push").span_id
            assert span(push, "sent") is not None  # sender terminal
            assert span(recv, "applied") is not None
        assert joined >= 1
    finally:
        stop_pair(pa, pb)


def sc_push_sampling_decision_propagates():
    """Head decision is the SENDER's: an unsampled push drops BOTH
    halves of the tree (receiver honors ctx, no local draw)."""
    pa, pb = make_pair()
    try:
        pa.tracer.set_sample_rate("peer.push", 0.0)
        pb.replication.publish_interest(None)
        assert wait_for(lambda: "trace-b" in pa.replication.peer_interests)
        pa.graph.add("unsampled-push")
        assert pa.replication.flush()
        assert wait_for(
            lambda: q.find_all(pb.graph, q.value("unsampled-push")) != [])
        assert pb.replication.flush()
        assert by_name(pa.tracer.drain(), "peer.push") == []
        assert by_name(pb.tracer.drain(), "peer.apply") == []
        assert pa.tracer.traces_dropped >= 1
        assert pb.tracer.traces_dropped >= 1
    finally:
        stop_pair(pa, pb)


# ------------------------------------------------------- catch-up


def sc_catchup_page_one_connected_tree():
    pa, pb = make_pair()
    try:
        # no interest: mutations land in A's log only
        pa.graph.add("cu-1")
        pa.graph.add("cu-2")
        assert pa.replication.flush()
        pb.replication.catch_up("trace-a")
        assert wait_for(
            lambda: q.find_all(pb.graph, q.value("cu-2")) != [])
        assert pb.replication.flush()

        b_traces = pb.tracer.drain()
        (req,) = by_name(b_traces, "peer.catchup")
        (serve,) = by_name(pa.tracer.drain(), "peer.catchup.serve")
        applies = by_name(b_traces, "peer.apply")
        # one tree: request (B) → serve (A) → applies (B)
        assert serve.trace_id == req.trace_id
        assert span(serve, "catchup_serve").parent_id == \
            span(req, "catchup_request").span_id
        assert serve.find("served").attrs["entries"] >= 2
        assert applies and all(t.trace_id == req.trace_id for t in applies)
        for ap in applies:
            assert span(ap, "apply").parent_id == \
                span(serve, "catchup_serve").span_id
    finally:
        stop_pair(pa, pb)


# ------------------------------------------------- snapshot transfer


def sc_snapshot_transfer_one_connected_tree():
    pa, pb = make_pair()
    try:
        handles = [pa.graph.add(f"tr-{i}") for i in range(20)]
        pa.graph.add_link(handles[:2], value="tr-link")
        n = pb.transfer_graph_from("trace-a", page=8, timeout=30.0)
        assert n >= 21

        (client,) = by_name(pb.tracer.drain(), "peer.transfer")
        (server,) = by_name(pa.tracer.drain(), "peer.transfer.serve")
        assert server.trace_id == client.trace_id
        # remote-child parenting across the wire
        assert span(server, "transfer_serve").parent_id == \
            span(client, "transfer").span_id
        # the client applied every streamed page, the server chunked them
        client_chunks = [s for s in client.spans()
                         if s.name == "apply_chunk"]
        server_chunks = [s for s in server.spans() if s.name == "chunk"]
        assert len(server_chunks) >= 3          # 21 atoms / page 8
        assert len(client_chunks) == len(server_chunks)
        assert client.find("resolve").attrs["stored"] == n
        assert server.find("served") is not None
    finally:
        stop_pair(pa, pb)


# ------------------------------------------------- remote ops (views)


def sc_remote_op_one_connected_tree():
    pa, pb = make_pair()
    try:
        h = pa.graph.add("op-me")
        gid = None
        transfer = imp_from("peer", "transfer")

        gid = transfer.gid_of(pa.graph, int(h), pa.identity)
        view = mod("peer.remote_view").remote_view(pb, "trace-a")
        assert view.get(gid) == "op-me"
        (client,) = by_name(pb.tracer.drain(), "peer.op")
        (server,) = by_name(pa.tracer.drain(), "peer.op.serve")
        assert server.trace_id == client.trace_id
        assert span(server, "op_serve").parent_id == \
            span(client, "op").span_id
        assert client.attrs["op"] == "peek_atom"
        assert server.find("served") is not None
    finally:
        stop_pair(pa, pb)


def sc_tracing_off_peer_plane_untouched():
    """Off-gate: with both tracers disabled (the default), peer traffic
    carries no context key and nothing is buffered."""
    net = LoopbackNetwork()
    ga, gb = hg.HyperGraph(), hg.HyperGraph()
    pa = HyperGraphPeer.loopback(ga, net, identity="off-a")
    pb = HyperGraphPeer.loopback(gb, net, identity="off-b")
    seen = []
    orig = pb.interface.__class__._deliver

    def spy(self, sender, message):
        seen.append(message)
        orig(self, sender, message)

    pb.interface._deliver = spy.__get__(pb.interface)
    pa.start()
    pb.start()
    try:
        pb.replication.publish_interest(None)
        assert wait_for(lambda: "off-b" in pa.replication.peer_interests)
        pa.graph.add("untraced")
        assert pa.replication.flush()
        assert wait_for(
            lambda: q.find_all(pb.graph, q.value("untraced")) != [])
        assert all(M.TRACE_KEY not in m for m in seen)
        assert pa.tracer.finished_count() == 0
        assert pb.tracer.finished_count() == 0
    finally:
        stop_pair(pa, pb)


# -- the parity cases ---------------------------------------------------------


def test_context_attach_and_extract_roundtrip():
    both(globals(), "sc_context_attach_and_extract_roundtrip")


def test_remote_trace_joins_on_id_and_parent():
    both(globals(), "sc_remote_trace_joins_on_id_and_parent")


def test_replication_push_one_connected_tree():
    both(globals(), "sc_replication_push_one_connected_tree")


def test_push_sampling_decision_propagates():
    both(globals(), "sc_push_sampling_decision_propagates")


def test_catchup_page_one_connected_tree():
    both(globals(), "sc_catchup_page_one_connected_tree")


def test_snapshot_transfer_one_connected_tree():
    both(globals(), "sc_snapshot_transfer_one_connected_tree")


def test_remote_op_one_connected_tree():
    both(globals(), "sc_remote_op_one_connected_tree")


def test_tracing_off_peer_plane_untouched():
    both(globals(), "sc_tracing_off_peer_plane_untouched")
