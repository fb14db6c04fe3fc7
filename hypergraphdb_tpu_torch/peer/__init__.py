"""P2P distribution layer: peer runtime, pluggable transports
(loopback + TCP), FIPA-ACL messages, activity state machines, remote graph
ops (CACT), interest-based replication with op-log catch-up.

This is the host-side control plane between hosts; the on-device data
plane (collectives between cards) lives in ``hypergraphdb_tpu_torch.parallel``."""

from hypergraphdb_tpu_torch.peer.peer import HyperGraphPeer
from hypergraphdb_tpu_torch.peer.transport import (
    LoopbackNetwork,
    PeerInterface,
    TCPPeerInterface,
)

__all__ = [
    "HyperGraphPeer",
    "LoopbackNetwork",
    "PeerInterface",
    "TCPPeerInterface",
]
