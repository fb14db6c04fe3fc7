"""Sharded execution over a mesh of devices.

The data plane: row and edge sharded CSR snapshots, packed frontier
exchange between shards, candidate-sharded pattern matching. The port of
``hypergraphdb_tpu/parallel``; the mesh is ``parallel.sharded.Mesh``, a
tuple of ``torch.device``s, and ``parallel.multihost`` joins processes
through ``torch.distributed``.
"""

from hypergraphdb_tpu_torch.parallel.sharded import (
    AXIS,
    ShardedDelta,
    ShardedSnapshot,
    and_incident_pattern_sharded,
    and_incident_pattern_sharded_delta,
    bfs_levels_sharded,
    bfs_levels_sharded_delta,
    bfs_packed_sharded,
    bfs_packed_sharded_delta,
    make_mesh,
    match_candidates_sharded,
    shard_host_delta,
)

__all__ = [
    "AXIS",
    "ShardedDelta",
    "ShardedSnapshot",
    "and_incident_pattern_sharded",
    "and_incident_pattern_sharded_delta",
    "bfs_levels_sharded",
    "bfs_levels_sharded_delta",
    "bfs_packed_sharded",
    "bfs_packed_sharded_delta",
    "make_mesh",
    "match_candidates_sharded",
    "shard_host_delta",
]
