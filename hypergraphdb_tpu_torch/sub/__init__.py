"""hgsub: standing queries, a streaming subscription tier over the ingest
delta.

The port of ``hypergraphdb_tpu/sub``. A standing query is a serve lane
that re-fires on its dirty set: registered pattern / range / BFS queries
are re-evaluated against graph mutations through the SAME bucketed device
lanes as ad-hoc traffic, and set deltas stream to consumers over bounded
per-subscription queues with resume-seq anchoring and shed-not-hang
backpressure. See ``sub/manager.py`` for the evaluation model and
``sub/wire.py`` for the wire contract.
"""

from hypergraphdb_tpu_torch.sub.manager import SubConfig, SubscriptionManager
from hypergraphdb_tpu_torch.sub.registry import (
    Subscription,
    SubscriptionRegistry,
    match_digest,
)
from hypergraphdb_tpu_torch.sub.stats import DOTTED_NAMES, SubStats
from hypergraphdb_tpu_torch.sub.wire import poll_payload, subscribe_payload

__all__ = [
    "SubConfig",
    "SubscriptionManager",
    "Subscription",
    "SubscriptionRegistry",
    "match_digest",
    "DOTTED_NAMES",
    "SubStats",
    "poll_payload",
    "subscribe_payload",
]
