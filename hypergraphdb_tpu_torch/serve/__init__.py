"""Query-serving runtime: async micro-batching with admission control.

The port of ``hypergraphdb_tpu/serve``: the single-device executor and
the sharded one (``sharded.py``: serve buckets over a mesh). The
kernels under ``ops/`` are batch-native (K seeds / K queries per dispatch);
this package turns them into a service using the continuous-batching shape
of inference stacks:

- requests enter a **bounded admission queue** (``admission.py``) with
  per-request deadlines and optional **priorities**; expired requests are
  shed IN the queue with a typed :class:`DeadlineExceeded` — never a
  wasted device dispatch;
- a batcher (``batcher.py``) coalesces compatible requests and flushes
  **shape-bucketed micro-batches** (pad-to-bucket K ∈ {64, 256, 1024}) on
  batch-full or max-linger timeout;
- a dedicated dispatch thread (``runtime.py``) double-buffers: host-side
  assembly of batch N+1 overlaps device execution of batch N;
- every batch pins a consistent read view via
  ``SnapshotManager.pinned_view(max_lag_edges=...)`` so no request ever
  straddles a compaction swap;
- ``stats.py`` records queue depth, batch occupancy, shed counts, and
  latency percentiles into one registry (``serve.*`` namespace), and with
  tracing on every request carries a ``submit → queue_wait → batch_form →
  launch [→ device] → collect → resolve`` span chain.

Entry point::

    from hypergraphdb_tpu_torch.serve import ServeRuntime, ServeConfig

    with ServeRuntime(graph, ServeConfig(max_lag_edges=0)) as rt:
        # ServeConfig(device="cpu") runs the lanes' plain versions
        fut = rt.submit_bfs(seed, max_hops=2, deadline_s=0.1)
        res = fut.result()          # ServeResult | raises DeadlineExceeded
"""

from hypergraphdb_tpu_torch.serve.types import (
    AdmissionGated,
    BFSRequest,
    Clock,
    DeadlineExceeded,
    JoinRequest,
    JoinResult,
    PatternRequest,
    QueueFull,
    RuntimeClosed,
    ServeError,
    ServeResult,
    Unservable,
)
from hypergraphdb_tpu_torch.serve.stats import ServeStats
from hypergraphdb_tpu_torch.serve.admission import AdmissionQueue
from hypergraphdb_tpu_torch.serve.batcher import Batcher, MicroBatch, bucket_for
from hypergraphdb_tpu_torch.serve.runtime import (
    DeviceExecutor,
    ServeConfig,
    ServeRuntime,
)
from hypergraphdb_tpu_torch.serve.sharded import ShardedExecutor

__all__ = [
    "AdmissionGated",
    "AdmissionQueue",
    "Batcher",
    "BFSRequest",
    "Clock",
    "DeadlineExceeded",
    "DeviceExecutor",
    "JoinRequest",
    "JoinResult",
    "MicroBatch",
    "PatternRequest",
    "QueueFull",
    "RuntimeClosed",
    "ServeConfig",
    "ServeError",
    "ServeResult",
    "ServeRuntime",
    "ServeStats",
    "ShardedExecutor",
    "Unservable",
    "bucket_for",
]
