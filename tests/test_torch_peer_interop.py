"""The port's peer plane speaks the reference's wire format: in one
process, a peer of the reference and a peer of the port talk over
``TCPPeerInterface`` (newline-delimited JSON on 127.0.0.1).

- The port's peer bootstraps from the reference's by ``transfer_graph_from``
  (the port as client, the reference as server), and the reference's from
  the port's;
- replication runs both ways under ``publish_interest(None)``: atoms and a
  removal written on either side arrive on the other;
- remote queries page typed conditions both ways;
- at the end both graphs hold the same replicated content (equal
  ``content_digest``), with the same gids.

Tolerance: exact equality. Every wait is bounded.
"""

from __future__ import annotations

import importlib
import time

PKGS = ("hypergraphdb_tpu", "hypergraphdb_tpu_torch")


def mod(pkg: str, sub: str):
    return importlib.import_module(f"{pkg}.{sub}")


def wait_for(cond, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def tcp_peer(pkg: str, identity: str):
    g = mod(pkg, "core.graph").HyperGraph()
    p = mod(pkg, "peer").HyperGraphPeer.tcp(g, identity=identity)
    p.start()
    return g, p


def gids(pkg: str, g) -> list[str]:
    tr = mod(pkg, "peer.transfer")
    return sorted(k.decode() for k, hs in tr._atom_map(g).bulk_items()
                  if any(g.contains(int(h)) for h in hs.tolist()))


def digests_equal(a, b):
    return (mod(PKGS[0], "peer.transfer").content_digest(a)
            == mod(PKGS[1], "peer.transfer").content_digest(b))


def test_reference_and_port_peers_interoperate_over_tcp():
    ref, port = PKGS
    ga, pa = tcp_peer(ref, "ref-peer")
    gb, pb = tcp_peer(port, "port-peer")
    try:
        # the reference's graph: strings, ints and links over them
        nodes = [ga.add(f"n{i}") for i in range(40)]
        nodes += [ga.add(i) for i in range(40)]
        for i in range(60):
            ga.add_link((nodes[i], nodes[(7 * i + 3) % 80]), value=i)
        assert pa.replication.flush()

        pb.interface.connect("ref-peer", pa.interface.addr)
        assert wait_for(lambda: "port-peer" in pa.interface.peers())
        # the port bootstraps from the reference
        stored = pb.transfer_graph_from("ref-peer", page=32)
        assert stored >= 140
        assert digests_equal(ga, gb)
        assert gids(ref, ga) == gids(port, gb)

        # replication both ways
        pb.replication.publish_interest(None)
        pa.replication.publish_interest(None)
        assert wait_for(lambda: "port-peer" in pa.replication.peer_interests
                        and "ref-peer" in pb.replication.peer_interests)
        na = [ga.add(f"from-ref-{i}") for i in range(10)]
        ga.add_link((na[0], na[1]), value="ref-link")
        nb = [gb.add(f"from-port-{i}") for i in range(10)]
        gb.add_link((nb[0], nb[1]), value="port-link")
        gb.remove(nb[9])
        ga.remove(na[9])
        q_ref, q_port = mod(ref, "query.dsl"), mod(port, "query.dsl")
        assert wait_for(lambda: len(q_port.find_all(
            gb, q_port.value("from-ref-8"))) == 1)
        assert wait_for(lambda: len(q_ref.find_all(
            ga, q_ref.value("from-port-8"))) == 1)
        assert pa.replication.flush() and pb.replication.flush()
        assert wait_for(lambda: digests_equal(ga, gb))
        assert gids(ref, ga) == gids(port, gb)
        assert not q_ref.find_all(ga, q_ref.value("from-port-9"))
        assert not q_port.find_all(gb, q_port.value("from-ref-9"))

        # remote queries both ways page a typed condition
        rows = pb.run_remote_query("ref-peer", q_ref.type_("string"), page=8)
        assert sorted(rows) == sorted(
            int(h) for h in q_ref.find_all(ga, q_ref.type_("string")))
        rows = pa.run_remote_query("port-peer", q_ref.type_("string"),
                                   page=8)
        assert sorted(rows) == sorted(
            int(h) for h in q_port.find_all(gb, q_port.type_("string")))
        assert len(rows) == 40 + 9 + 1 + 9 + 1  # nodes and string links
        assert pb.count_remote("ref-peer", q_ref.type_("int")) == 40 + 60

        # and the reference bootstraps a fresh peer from the port
        gc, pc = tcp_peer(ref, "ref-fresh")
        try:
            pc.interface.connect("port-peer", pb.interface.addr)
            assert wait_for(lambda: "ref-fresh" in pb.interface.peers())
            assert pc.transfer_graph_from("port-peer", page=32) >= 150
            assert (mod(ref, "peer.transfer").content_digest(gc)
                    == mod(port, "peer.transfer").content_digest(gb))
        finally:
            pc.stop()
            gc.close()
    finally:
        pa.stop()
        pb.stop()
        ga.close()
        gb.close()
