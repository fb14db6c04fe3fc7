"""Peer transport SPI: pluggable message fabric between peers.

Re-expression of the reference's ``PeerInterface``
(``peer/PeerInterface.java:27``) — an async point-to-point message fabric
with presence — minus XMPP: the reference's only real transport is Smack
chat rooms (``peer/xmpp/XMPPPeerInterface.java:58``) and its tests need a
live XMPP server. Here:

- :class:`LoopbackNetwork` — in-process fabric; multi-peer tests run
  without any cluster or server (each peer still has its own graph).
- :class:`TCPPeerInterface` — newline-delimited JSON over TCP sockets for
  real multi-process/multi-host deployments (the control plane between hosts;
  the device data plane is ``parallel/``).

Messages are JSON-serializable dicts. Delivery is async and at-most-once;
ordering is per-sender-pair (both transports preserve send order).

Fault story: both transports carry the ``peer.transport.send`` fault
point — a fired fault IS a dropped wire message (``send`` returns False,
nothing delivered), which is how the chaos tests model lossy networks
deterministically. The TCP transport additionally bounds every connect
and send with ``connect_timeout`` and retries a stale connection with
capped backoff; the layers above (replication retry/redelivery, transfer
resume) own end-to-end healing. ``metrics`` (an optional
``utils.metrics.Metrics``, wired to the graph's by ``HyperGraphPeer``)
records ``peer.transport_*`` counters.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
import time
from typing import Callable, Optional

from hypergraphdb_tpu_torch.fault import FaultError, global_faults

MessageHandler = Callable[[str, dict], None]  # (sender_id, message)

#: the process fault registry, bound once (module-global: the singleton
#: contract makes the enabled gate ONE attribute read per send)
_FAULTS = global_faults()


class PeerInterface:
    """Transport contract. Implementations deliver ``send()`` payloads to the
    target peer's registered handler on a receiver thread."""

    peer_id: str
    #: optional utils.metrics.Metrics surface (peer.transport_* counters);
    #: HyperGraphPeer.start() wires the graph's in
    metrics = None

    def start(self) -> None: ...
    def stop(self) -> None: ...

    def _dropped_by_fault(self, target: str, message: dict) -> bool:
        """Shared injection hook: True when the armed schedule ate this
        message (the wire dropped it)."""
        if not _FAULTS.enabled:
            return False
        try:
            _FAULTS.check(
                "peer.transport.send", target=target,
                performative=message.get("performative"),
                activity=message.get("activity_type"),
            )
        except FaultError:
            m = self.metrics
            if m is not None:
                m.incr("peer.transport_drops")
            return True
        return False

    def send(self, target: str, message: dict) -> bool:
        """Queue a message; False if the target is unknown/unreachable."""
        raise NotImplementedError

    def on_message(self, handler: MessageHandler) -> None:
        self._handler = handler

    def peers(self) -> list[str]:
        """Currently-present peer ids (roster/presence analogue)."""
        raise NotImplementedError


class LoopbackNetwork:
    """In-process message fabric: the test/loopback transport the reference
    lacks. Thread-safe; messages delivered on a single dispatcher thread per
    network (preserves global order, mimics a broker)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._peers: dict[str, "LoopbackPeerInterface"] = {}

    def interface(self, peer_id: str) -> "LoopbackPeerInterface":
        return LoopbackPeerInterface(self, peer_id)

    def _register(self, iface: "LoopbackPeerInterface") -> None:
        with self._lock:
            self._peers[iface.peer_id] = iface

    def _unregister(self, peer_id: str) -> None:
        with self._lock:
            self._peers.pop(peer_id, None)

    def _route(self, sender: str, target: str, message: dict) -> bool:
        with self._lock:
            iface = self._peers.get(target)
        if iface is None:
            return False
        iface._deliver(sender, message)
        return True

    def peer_ids(self) -> list[str]:
        with self._lock:
            return list(self._peers)


class LoopbackPeerInterface(PeerInterface):
    def __init__(self, network: LoopbackNetwork, peer_id: str):
        self.network = network
        self.peer_id = peer_id
        self._handler: Optional[MessageHandler] = None
        self._queue: list[tuple[str, dict]] = []
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._running = False

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self.network._register(self)
        self._thread = threading.Thread(
            target=self._pump, name=f"loopback-{self.peer_id}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if not self._running:
            return
        self._running = False
        self.network._unregister(self.peer_id)
        with self._cv:
            self._cv.notify_all()
        if self._thread:
            self._thread.join(timeout=5)

    def send(self, target: str, message: dict) -> bool:
        if self._dropped_by_fault(target, message):
            return False
        # serialize/deserialize to enforce the same wire constraints as TCP
        payload = json.loads(json.dumps(message))
        ok = self.network._route(self.peer_id, target, payload)
        m = self.metrics
        if m is not None:
            m.incr("peer.transport_sends" if ok
                   else "peer.transport_drops")
        return ok

    def peers(self) -> list[str]:
        return [p for p in self.network.peer_ids() if p != self.peer_id]

    def _deliver(self, sender: str, message: dict) -> None:
        with self._cv:
            self._queue.append((sender, message))
            self._cv.notify()

    def _pump(self) -> None:
        while True:
            with self._cv:
                while self._running and not self._queue:
                    self._cv.wait(timeout=0.5)
                if not self._running and not self._queue:
                    return
                sender, msg = self._queue.pop(0)
            if self._handler is not None:
                try:
                    self._handler(sender, msg)
                except Exception:  # handler bugs must not kill the pump
                    import logging

                    logging.getLogger("hypergraphdb_tpu_torch.peer").exception(
                        "message handler failed"
                    )


class _TCPHandler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        iface: "TCPPeerInterface" = self.server.iface  # type: ignore[attr-defined]
        for line in self.rfile:
            try:
                envelope = json.loads(line.decode("utf-8"))
                sender = envelope["from"]
                msg = envelope["msg"]
            except (ValueError, KeyError):
                continue
            if envelope.get("hello"):
                iface._learn(sender, tuple(envelope["addr"]))
            if msg is not None and iface._handler is not None:
                try:
                    iface._handler(sender, msg)
                except Exception:
                    import logging

                    logging.getLogger("hypergraphdb_tpu_torch.peer").exception(
                        "message handler failed"
                    )


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class TCPPeerInterface(PeerInterface):
    """JSON-over-TCP transport: one listening socket per peer, one
    connection per outgoing peer (kept open, reconnected on failure)."""

    def __init__(self, peer_id: str, host: str = "127.0.0.1", port: int = 0,
                 connect_timeout: float = 5.0, send_attempts: int = 2,
                 retry_backoff_s: float = 0.05,
                 retry_backoff_max_s: float = 0.5):
        self.peer_id = peer_id
        #: bounds BOTH the connect and every subsequent sendall (the
        #: timeout sticks to the socket): a hung peer costs a bounded
        #: wait, never a wedged sender thread
        self.connect_timeout = float(connect_timeout)
        self.send_attempts = max(1, int(send_attempts))
        self.retry_backoff_s = float(retry_backoff_s)
        self.retry_backoff_max_s = float(retry_backoff_max_s)
        self._handler: Optional[MessageHandler] = None
        self._server = _TCPServer((host, port), _TCPHandler)
        self._server.iface = self  # type: ignore[attr-defined]
        self.addr: tuple[str, int] = self._server.server_address  # bound
        self._known: dict[str, tuple[str, int]] = {}
        self._conns: dict[str, socket.socket] = {}
        self._lock = threading.Lock()
        # one lock per target: sendall must not interleave two threads'
        # newline-framed messages on the same socket
        self._send_locks: dict[str, threading.Lock] = {}
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        # check-and-set under the lock: two concurrent start() calls would
        # otherwise both pass the None check and spawn two serve loops
        with self._lock:
            if self._thread:
                return
            self._thread = t = threading.Thread(
                target=self._server.serve_forever,
                name=f"tcp-{self.peer_id}", daemon=True,
            )
        t.start()

    def stop(self) -> None:
        self._server.shutdown()
        with self._lock:
            for s in self._conns.values():
                try:
                    s.close()
                except OSError:
                    pass
            self._conns.clear()
        self._server.server_close()

    def connect(self, peer_id: str, addr: tuple[str, int]) -> None:
        """Bootstrap: learn another peer's address and say hello (so it
        learns ours — the identity handshake)."""
        self._learn(peer_id, addr)
        self._write(peer_id, {"from": self.peer_id, "msg": None,
                              "hello": True, "addr": list(self.addr)})

    def _learn(self, peer_id: str, addr: tuple[str, int]) -> None:
        with self._lock:
            self._known[peer_id] = addr

    def send(self, target: str, message: dict) -> bool:
        if self._dropped_by_fault(target, message):
            return False
        return self._write(target, {"from": self.peer_id, "msg": message})

    def _write(self, target: str, envelope: dict) -> bool:
        with self._lock:
            addr = self._known.get(target)
            send_lock = self._send_locks.setdefault(target, threading.Lock())
        if addr is None:
            return False
        data = (json.dumps(envelope) + "\n").encode("utf-8")
        m = self.metrics
        with send_lock:
            # reconnect-with-backoff on stale/refused connections; every
            # attempt's connect AND send are bounded by connect_timeout
            for attempt in range(self.send_attempts):
                if attempt:
                    if m is not None:
                        m.incr("peer.transport_reconnects")
                    time.sleep(min(
                        self.retry_backoff_s * (2.0 ** (attempt - 1)),
                        self.retry_backoff_max_s,
                    ))
                with self._lock:
                    conn = self._conns.get(target)
                try:
                    if conn is None:
                        conn = socket.create_connection(
                            addr, timeout=self.connect_timeout
                        )
                        with self._lock:
                            self._conns[target] = conn
                    conn.sendall(data)
                    if m is not None:
                        m.incr("peer.transport_sends")
                    return True
                except OSError:
                    with self._lock:
                        self._conns.pop(target, None)
                    conn = None
        if m is not None:
            m.incr("peer.transport_drops")
        return False

    def peers(self) -> list[str]:
        with self._lock:
            return list(self._known)
