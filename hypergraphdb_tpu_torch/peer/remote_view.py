"""Remote graph view — a HyperNode-over-the-wire façade.

Re-expression of the reference's ``PeerHyperNode``
(``p2p/src/java/org/hypergraphdb/peer/PeerHyperNode.java``): a local object
with graph-like CRUD + query methods whose every call executes on a REMOTE
peer through the CACT ops, addressing atoms by global id. Values travel in
the transfer wire format (type name + payload bytes + optional record
schema), so a dataclass record defined only on the remote side still
round-trips as a field dict locally.

The view deliberately does NOT write through the local graph (unlike
``HyperGraphPeer.get_remote``, which stores fetched closures): it is a
window onto the remote database, not a replica.

Observability: every call runs over ``cact.RemoteOpClient``, so with
tracing on (``obs.enable()``, or an injected ``peer.tracer``) each view
operation roots a ``peer.op`` trace whose context propagates to the
serving peer — the remote ``op_serve`` span joins the same tree
(remote-child parenting, joined on trace id). Nothing extra to wire
here; the window is traced because the transport it rides is.
"""

from __future__ import annotations

import base64
from typing import Any, Optional

from hypergraphdb_tpu_torch.peer import transfer


class RemoteGraphView:
    """Graph-like façade over one remote peer (``PeerHyperNode``)."""

    def __init__(self, peer, target: str, timeout: float = 10.0):
        self.peer = peer
        self.target = target
        self.timeout = timeout

    # -- encoding helpers ------------------------------------------------------
    def _encode_value(self, value: Any) -> dict:
        ts = self.peer.graph.typesystem
        atype = ts.infer(value)
        if atype is None:
            raise TypeError(f"no type for value {value!r}")
        payload = atype.store(value) if value is not None else None
        out = {
            "type": atype.name,
            "value_b64": (
                base64.b64encode(payload).decode("ascii")
                if payload is not None else None
            ),
        }
        schema = transfer.describe_type(self.peer.graph, atype.name)
        if schema is not None and schema["schema"] != "builtin":
            out["type_schema"] = schema
        return out

    def _decode_atom(self, wire: dict) -> Any:
        g = self.peer.graph
        ts = g.typesystem
        if (
            wire["type"] not in ts._by_name
            and wire.get("type_schema") is not None
        ):
            transfer.install_type(g, wire["type_schema"])
        atype = ts.get_type(wire["type"])
        if wire.get("value_b64") is None:
            return None
        return atype.make(base64.b64decode(wire["value_b64"]))

    def _op(self, op: dict) -> Any:
        return self.peer._run_op(self.target, op, self.timeout)

    # -- CRUD ------------------------------------------------------------------
    def add(self, value: Any, targets: tuple = ()) -> str:
        """Create an atom (node or link) ON the remote peer; returns its
        global id."""
        op = {"op": "add_atom", "targets": [str(t) for t in targets]}
        op.update(self._encode_value(value))
        return self._op(op)["gid"]

    def get(self, gid: str) -> Any:
        """The remote atom's VALUE — a peek, nothing is stored locally."""
        wire = self._op({"op": "peek_atom", "gid": gid})["atom"]
        return self._decode_atom(wire)

    def get_targets(self, gid: str) -> list[str]:
        wire = self._op({"op": "peek_atom", "gid": gid})["atom"]
        return list(wire.get("targets", ()))

    def replace(self, gid: str, value: Any) -> bool:
        op = {"op": "replace_atom", "gid": gid}
        op.update(self._encode_value(value))
        return self._op(op)["replaced"]

    def remove(self, gid: str) -> bool:
        return self._op({"op": "remove_atom", "gid": gid})["removed"]

    def get_type_name(self, gid: str) -> str:
        return self.peer.get_remote_type(self.target, gid, self.timeout)["type"]

    # -- queries ---------------------------------------------------------------
    def find_all(self, condition, page: int = 64) -> list[int]:
        """Remote handles matching ``condition`` (streamed in pages)."""
        return self.peer.run_remote_query(
            self.target, condition, page=page, timeout=self.timeout
        )

    def count(self, condition) -> int:
        return self.peer.count_remote(self.target, condition, self.timeout)

    def incidence(self, handle: int) -> list[int]:
        return self.peer.remote_incidence_set(
            self.target, handle, self.timeout
        )


def remote_view(peer, target: str, timeout: float = 10.0) -> RemoteGraphView:
    """Open a :class:`RemoteGraphView` of ``target`` through ``peer``."""
    return RemoteGraphView(peer, target, timeout)
