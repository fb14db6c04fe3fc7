"""Device operators of the port: plain PyTorch, plus the CUDA kernels of
``csrc/`` behind wrappers that run their plain version on CPU tensors."""

from hypergraphdb_tpu_torch.ops.bitfrontier import (
    bfs_memory_bytes,
    bfs_packed,
    unpack_visited,
)

__all__ = ["bfs_memory_bytes", "bfs_packed", "unpack_visited"]
