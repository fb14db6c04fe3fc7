"""HyperGraphPeer — the peer runtime.

Re-expression of ``peer/HyperGraphPeer.java:57``: owns a local graph, a
persisted identity, a pluggable transport, the activity scheduler, and the
bootstrap services (identity handshake, CACT responders, replication) —
``HyperGraphPeer.start()`` at :307-353.

Usage::

    peer = HyperGraphPeer(graph, interface=LoopbackNetwork().interface("p1"))
    peer.start()
    handles = peer.run_remote_query(other_id, q.type_("string"))
"""

from __future__ import annotations

import uuid
from typing import Any, Optional

from hypergraphdb_tpu_torch.obs import global_tracer
from hypergraphdb_tpu_torch.peer import cact
from hypergraphdb_tpu_torch.peer.activity import ActivityManager
from hypergraphdb_tpu_torch.peer.replication import Replication
from hypergraphdb_tpu_torch.peer.transport import (
    LoopbackNetwork,
    PeerInterface,
    TCPPeerInterface,
)


class HyperGraphPeer:
    def __init__(
        self,
        graph,
        interface: PeerInterface,
        identity: Optional[str] = None,
    ):
        self.graph = graph
        self.interface = interface
        #: the hgobs tracer the peer plane reports into — the process
        #: tracer by default, injectable per peer (two-peer tests give
        #: each side its own so the joined span tree can be asserted
        #: from both halves); every peer-plane site gates on ONE
        #: ``tracer.enabled`` read
        self.tracer = global_tracer()
        #: persisted peer identity (HGPeerIdentity analogue)
        self.identity = identity or self._load_identity()
        #: serializes REPLICATED writes into the local graph across the
        #: peer's threads: the replication apply worker and a snapshot
        #: transfer both ``store_closure`` — unserialized, two threads
        #: racing the same gid's check-then-act would twin the atom
        #: (a bootstrapping replica receives pushes WHILE its transfer
        #: streams; both are idempotent only under this mutex)
        import threading

        self.apply_lock = threading.Lock()
        #: serializes start()/stop() (check-and-set on ``_started``)
        self._lifecycle_lock = threading.Lock()
        self.activities = ActivityManager(self)
        self.replication = Replication(self)
        #: peers whose identity handshake completed (AffirmIdentity
        #: bootstrap, ``peer/bootstrap/AffirmIdentityBootstrap``): id → info
        self.known_peers: dict[str, dict] = {}
        self._started = False

        # bootstrap: server-side activity factories (CACTBootstrap analogue)
        self.activities.register_type("cact", lambda peer, activity_id=None:
                                      cact.RemoteOpServer(peer, activity_id))
        self.activities.register_type("cact-query",
                                      lambda peer, activity_id=None:
                                      cact.RemoteQueryServer(peer, activity_id))
        self.activities.register_type("cact-transfer",
                                      lambda peer, activity_id=None:
                                      cact.TransferGraphServer(peer, activity_id))

    def _load_identity(self) -> str:
        """Stable identity persisted in the graph (one per database)."""
        idx = self.graph.store.get_index("hg.peer.identity")
        existing = idx.find_first(b"self")
        if existing is not None:
            data = self.graph.store.get_data(int(existing))
            if data:
                return data.decode("utf-8")
        ident = uuid.uuid4().hex

        def run():
            h = self.graph.handles.make()
            self.graph.store.store_data(h, ident.encode("utf-8"))
            idx.add_entry(b"self", h)

        self.graph.txman.ensure_transaction(run)
        return ident

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        with self._lifecycle_lock:
            if self._started:
                return
            self.interface.peer_id = self.identity
            if getattr(self.interface, "metrics", None) is None:
                # peer.* observability rides the graph's metrics registry —
                # one Prometheus scrape covers graph + tx + peer planes
                self.interface.metrics = self.graph.metrics
            self.interface.on_message(self._dispatch)
            self.interface.start()
            self.activities.start()
            self.replication.attach()
            self._started = True
        self.affirm_identity()

    def stop(self) -> None:
        # the WHOLE teardown runs under the lifecycle lock: flipping
        # _started first and tearing down outside it would let a racing
        # start() rebuild the components in the gap, only for this
        # in-flight stop to tear the fresh ones down (none of the joined
        # workers take this lock, so holding it across the joins is safe)
        with self._lifecycle_lock:
            if not self._started:
                return
            self.replication.detach()  # flush pushes, stop the worker
            self.activities.stop()
            self.interface.stop()
            self._started = False

    # -- identity handshake (AffirmIdentityBootstrap) --------------------------
    def affirm_identity(self) -> None:
        """Announce this peer's identity to every reachable peer; receivers
        record it and acknowledge with their own (the reference's
        AffirmIdentity bootstrap handshake that precedes other activity)."""
        for pid in self.interface.peers():
            if pid != self.identity:
                self.interface.send(pid, {
                    "activity_type": "identity",
                    "content": {"what": "affirm",
                                "identity": self.identity},
                })

    def _handle_identity(self, sender: str, msg: dict) -> bool:
        if msg.get("activity_type") != "identity":
            return False
        content = msg.get("content") or {}
        what = content.get("what")
        if what == "affirm":
            self.known_peers[sender] = {"identity": content.get("identity")}
            self.interface.send(sender, {
                "activity_type": "identity",
                "content": {"what": "affirm-ack",
                            "identity": self.identity},
            })
        elif what == "affirm-ack":
            self.known_peers[sender] = {"identity": content.get("identity")}
        else:
            return False
        return True

    def _dispatch(self, sender: str, msg: dict) -> None:
        # identity handshake first, then replication service traffic;
        # everything else is conversation-scoped and goes through the
        # activity scheduler
        if self._handle_identity(sender, msg):
            return
        if self.replication.handle(sender, msg):
            return
        self.activities.on_message(sender, msg)

    # -- remote op façade (the cact client calls) -----------------------------
    def _run_op(self, target: str, op: dict, timeout: float = 10.0) -> Any:
        act = self.activities.initiate(
            cact.RemoteOpClient(self, target=target, op=op)
        )
        return act.future.result(timeout=timeout)

    def define_remote(self, target: str, handle, timeout: float = 10.0) -> list[int]:
        """Push an atom closure to a remote peer (AddAtom/DefineAtom)."""
        from hypergraphdb_tpu_torch.peer import transfer

        atoms = transfer.serialize_closure(self.graph, int(handle), self.identity)
        return self._run_op(target, {"op": "define_atom", "atoms": atoms},
                            timeout)["handles"]

    def get_remote(self, target: str, gid: str, timeout: float = 10.0) -> list[int]:
        """Fetch a remote atom closure and store it locally (GetAtom)."""
        from hypergraphdb_tpu_torch.peer import transfer

        result = self._run_op(target, {"op": "get_atom", "gid": gid}, timeout)
        return transfer.store_closure(self.graph, result["atoms"])

    def remove_remote(self, target: str, gid: str, timeout: float = 10.0) -> bool:
        return self._run_op(target, {"op": "remove_atom", "gid": gid},
                            timeout)["removed"]

    def remote_incidence_set(self, target: str, handle: int,
                             timeout: float = 10.0) -> list[int]:
        return self._run_op(
            target, {"op": "get_incidence_set", "handle": int(handle)}, timeout
        )["incidence"]

    def count_remote(self, target: str, condition, timeout: float = 10.0) -> int:
        from hypergraphdb_tpu_torch.query import serialize as qser

        return self._run_op(
            target, {"op": "query_count", "condition": qser.to_json(condition)},
            timeout,
        )["count"]

    def run_remote_query(self, target: str, condition, page: int = 64,
                         timeout: float = 10.0) -> list[int]:
        """Streaming remote query (RemoteQueryExecution): pages a server-held
        result cursor; returns all remote handles."""
        act = self.activities.initiate(
            cact.RemoteQueryClient(self, target=target, condition=condition,
                                   page=page)
        )
        return act.future.result(timeout=timeout)

    def replace_remote(self, target: str, gid: str, value,
                       timeout: float = 10.0) -> bool:
        """Replace a remote atom's value by global id (ReplaceAtom)."""
        import base64

        from hypergraphdb_tpu_torch.peer import transfer

        atype = self.graph.typesystem.infer(value)
        if atype is None:
            raise TypeError(f"no type for value {value!r}")
        payload = atype.store(value) if value is not None else None
        op = {
            "op": "replace_atom",
            "gid": gid,
            "type": atype.name,
            "value_b64": (
                base64.b64encode(payload).decode("ascii")
                if payload is not None else None
            ),
        }
        schema = transfer.describe_type(self.graph, atype.name)
        if schema is not None and schema["schema"] != "builtin":
            op["type_schema"] = schema
        return self._run_op(target, op, timeout)["replaced"]

    def get_remote_type(self, target: str, gid: str,
                        timeout: float = 10.0) -> dict:
        """Type name + schema of a remote atom (GetAtomType)."""
        return self._run_op(target, {"op": "get_atom_type", "gid": gid},
                            timeout)

    def sync_types_to(self, target: str, names=None,
                      timeout: float = 10.0) -> list[str]:
        """Push local type schemas to a peer (SyncTypes): record types
        install there class-less, so atoms of those types resolve before
        any push/transfer arrives. ``names=None`` sends every local record
        type."""
        from hypergraphdb_tpu_torch.peer import transfer
        from hypergraphdb_tpu_torch.types.record import RecordType

        ts = self.graph.typesystem
        if names is None:
            names = [
                n for n, t in ts._by_name.items()
                if isinstance(t, RecordType)
            ]
        descs = [d for d in (
            transfer.describe_type(self.graph, n) for n in names
        ) if d is not None]
        return self._run_op(
            target, {"op": "sync_types", "types": descs}, timeout
        )["installed"]

    def transfer_graph_from(self, target: str, page: int = 256,
                            timeout: float = 60.0,
                            retry_after_s: float = 1.0,
                            max_resumes: int = 8) -> int:
        """Pull the ENTIRE remote graph (TransferGraph bootstrap): pages of
        dependency-ordered atoms; on completion the replication clock for
        ``target`` advances to the server's log head at snapshot time, so a
        follow-up ``replication.catch_up(target)`` converges the tail.
        Self-healing: a chunk lost on the wire is re-requested after
        ``retry_after_s`` of silence (the activity ticker drives the
        watchdog), up to ``max_resumes`` times before failing typed.
        Returns how many atoms were stored."""
        act = self.activities.initiate(
            cact.TransferGraphClient(self, target=target, page=page,
                                     retry_after_s=retry_after_s,
                                     max_resumes=max_resumes)
        )
        return act.future.result(timeout=timeout)

    # -- convenience constructors ---------------------------------------------
    @staticmethod
    def loopback(graph, network: LoopbackNetwork,
                 identity: Optional[str] = None) -> "HyperGraphPeer":
        peer = HyperGraphPeer(graph, network.interface("pending"), identity)
        peer.interface.peer_id = peer.identity
        return peer

    @staticmethod
    def tcp(graph, host: str = "127.0.0.1", port: int = 0,
            identity: Optional[str] = None) -> "HyperGraphPeer":
        peer = HyperGraphPeer(
            graph, TCPPeerInterface("pending", host, port), identity
        )
        peer.interface.peer_id = peer.identity
        return peer

    @staticmethod
    def from_config(graph, network: Optional[LoopbackNetwork] = None
                    ) -> "HyperGraphPeer":
        """A started peer as ``graph.config.peer`` (``PeerConfig``) sets it:

        - ``name``: its identity (empty: the one persisted in the graph);
        - ``transport``: ``"loopback"`` joins ``network``; ``"tcp"``
          listens on ``listen_address`` (``"host:port"``; empty:
          127.0.0.1 on a free port);
        - ``bootstrap``: the peers it reaches at start and affirms its
          identity to, ``"peer_id@host:port"`` over TCP, a peer id already
          on the network over loopback;
        - ``replicate``: it publishes an interest in every atom to those
          peers and catches up from each.

        An unknown transport, a loopback peer without a network, a
        malformed address or a loopback bootstrap peer that is not on the
        network raises ``ValueError``."""
        cfg = graph.config.peer
        identity = cfg.name or None
        if cfg.transport == "loopback":
            if network is None:
                raise ValueError("a loopback peer needs a LoopbackNetwork")
            missing = sorted(set(cfg.bootstrap) - set(network.peer_ids()))
            if missing:
                raise ValueError(f"bootstrap peers {missing} are not on "
                                 f"the loopback network")
            peer = HyperGraphPeer.loopback(graph, network, identity)
            dial = {}
        elif cfg.transport == "tcp":
            host, port = _address(cfg.listen_address or "127.0.0.1:0")
            dial = {}
            for entry in cfg.bootstrap:
                pid, at, addr = str(entry).partition("@")
                if not pid or not at:
                    raise ValueError(f"bootstrap entry {entry!r} is not "
                                     f"'peer_id@host:port'")
                dial[pid] = _address(addr)
            peer = HyperGraphPeer.tcp(graph, host, port, identity)
        else:
            raise ValueError(f"unknown peer transport {cfg.transport!r}: "
                             f"'loopback' or 'tcp'")
        peer.start()  # affirms its identity to the loopback network
        for pid, addr in dial.items():
            peer.interface.connect(pid, addr)
        if dial:
            peer.affirm_identity()
        if cfg.replicate:
            peer.replication.publish_interest(None)
            for pid in dial or cfg.bootstrap:
                peer.replication.catch_up(pid)
        return peer


def _address(text: str) -> tuple[str, int]:
    """``"host:port"`` as ``(host, port)``; ``ValueError`` if malformed."""
    host, colon, port = text.rpartition(":")
    if not host or not colon or not port.isdigit():
        raise ValueError(f"address {text!r} is not 'host:port'")
    return host, int(port)
