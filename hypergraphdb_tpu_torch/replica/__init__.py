"""hgreplica — the fault-tolerant replicated serving tier (the port of
``hypergraphdb_tpu/replica``; host Python over the port's ``peer/``,
``serve/``, ``fault/``, ``obs/`` and ``sub/``).

The composition: the ``peer/*`` plane (replication push,
catch-up, snapshot transfer) finally MEETS the ``serve/*`` runtime, so
one process death no longer takes down all serving. Three parts:

- **node** (:mod:`~hypergraphdb_tpu_torch.replica.node`): a
  :class:`ReplicaNode` composes an ingest-following peer (snapshot
  transfer to bootstrap, then replication push + gap-aware catch-up)
  with its OWN :class:`~hypergraphdb_tpu_torch.serve.ServeRuntime`. Reads are
  pinned at a bounded replication lag — the cross-process twin of the
  single-node ``max_lag_edges`` staleness contract: a replica past its
  lag bound refuses admission (typed
  :class:`~hypergraphdb_tpu_torch.serve.AdmissionGated`) instead of serving
  answers staler than it promised, and its ``/healthz`` advertises the
  lag so the router can see it coming;
- **router** (:mod:`~hypergraphdb_tpu_torch.replica.router`): the
  :class:`FrontDoor` — ONE submit surface over the primary + N
  replicas. Placement spreads read load across healthy replicas by
  advertised lag (round-robin within the least-lagged group), a
  per-replica :class:`~hypergraphdb_tpu_torch.fault.CircuitBreaker` re-routes
  a dead or degraded replica's load within a bounded number of probes,
  and the primary remains the exact-answer fallback — degraded, never
  down: zero caller-visible errors for in-budget requests;
- **httpd** (:mod:`~hypergraphdb_tpu_torch.replica.httpd`): the stdlib HTTP
  skin — ``POST /submit`` + ``GET /healthz`` — worn by both a replica
  node and the front door, so the tier runs over real sockets (a
  primary, two replica processes and a front door in
  ``tests/test_torch_replica_live.py`` and ``chip_smoke.py`` phase 24)
  while tests drive the same objects in-process.

Each node's serve runtime takes the port's ``ServeConfig`` device policy:
the card unless the caller asks for ``device="cpu"``.

Underneath sits the gap-aware convergence this tier requires
(``peer/replication.py``): receiver-side applied-seq contiguity in the
SeenMap (ack = max *contiguous* seq), targeted catch-up repair of
detected holes, and a periodic anti-entropy digest as the backstop — a
push dropped past the redelivery budget is detected and repaired, never
a silent divergence. The two threads of the tier that the reference
logs and drops on a failure (a replica's anti-entropy loop, the front
door's health poll) count it instead (``replica.anti_entropy_errors`` in
the replica graph's metrics, ``router.poll_errors`` in the door's) and
live on.
"""

from hypergraphdb_tpu_torch.replica.httpd import (
    SubmitServer,
    frontdoor_server,
    node_server,
)
from hypergraphdb_tpu_torch.replica.node import ReplicaConfig, ReplicaNode
from hypergraphdb_tpu_torch.replica.router import (
    FrontDoor,
    HTTPBackend,
    LocalBackend,
    RouterConfig,
    submit_payload,
)

__all__ = [
    "FrontDoor",
    "HTTPBackend",
    "LocalBackend",
    "ReplicaConfig",
    "ReplicaNode",
    "RouterConfig",
    "SubmitServer",
    "frontdoor_server",
    "node_server",
    "submit_payload",
]
