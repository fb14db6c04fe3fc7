"""Device operators of the port: plain PyTorch, plus the CUDA kernels of
``csrc/`` behind wrappers that run their plain version on CPU tensors.

The reference's re-exports, but for ``pallas_bfs_ok``: it reads
``HG_PALLAS_BFS`` to gate the Pallas kernel, and the port's K2 is never
gated (on a CUDA tensor it launches or raises). ``bfs_pull_fused`` is
``fused_bfs.bfs_pull_fused``."""

from hypergraphdb_tpu_torch.ops.snapshot import CSRSnapshot, DeviceSnapshot
from hypergraphdb_tpu_torch.ops.frontier import bfs_levels, expand_frontier
from hypergraphdb_tpu_torch.ops.bitfrontier import (
    bfs_memory_bytes,
    bfs_packed,
    unpack_visited,
)
from hypergraphdb_tpu_torch.ops.ellbfs import (
    PullBFSResult,
    bfs_pull,
    visited_rows,
)
from hypergraphdb_tpu_torch.ops.incremental import (
    PinnedView,
    SnapshotManager,
    bfs_levels_delta,
)
from hypergraphdb_tpu_torch.ops.aot_cache import AOTCache
from hypergraphdb_tpu_torch.ops.fused_bfs import bfs_pull_fused
from hypergraphdb_tpu_torch.ops.serving import (
    bfs_serve_batch,
    bfs_serve_batch_fused,
    pattern_serve_batch,
)
from hypergraphdb_tpu_torch.ops.setops import (
    and_incident_pattern,
    collect_pattern,
    execute_pattern,
    plan_pattern,
)
from hypergraphdb_tpu_torch.ops.checkpoint import (
    copy_subgraph,
    export_graph,
    import_graph,
    load_snapshot,
    save_snapshot,
)

__all__ = [
    "AOTCache",
    "CSRSnapshot",
    "DeviceSnapshot",
    "PinnedView",
    "PullBFSResult",
    "SnapshotManager",
    "bfs_pull_fused",
    "bfs_serve_batch",
    "bfs_serve_batch_fused",
    "pattern_serve_batch",
    "and_incident_pattern",
    "bfs_levels",
    "bfs_pull",
    "collect_pattern",
    "execute_pattern",
    "plan_pattern",
    "visited_rows",
    "bfs_memory_bytes",
    "bfs_packed",
    "unpack_visited",
    "bfs_levels_delta",
    "copy_subgraph",
    "expand_frontier",
    "export_graph",
    "import_graph",
    "load_snapshot",
    "save_snapshot",
]
