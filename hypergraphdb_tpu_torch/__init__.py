"""hypergraphdb_tpu_torch — the PyTorch / CUDA port of hypergraphdb_tpu.

The port runs the hypergraph database on an NVIDIA H100: the host graph
layer (store, transactions, types, the bulk loader, indexers and the
query compiler behind ``HyperGraph.find_all``) is plain Python and
numpy, plain tensor code is PyTorch, and each kernel that the JAX package
wrote in Pallas for the TPU is a hand-written CUDA kernel under
``csrc/``. It stands alone: it imports neither ``jax`` nor anything of
``hypergraphdb_tpu``, and keeps its own copies of the host code it needs.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU every kernel wrapper runs its plain PyTorch version. A graph keeps
its store in memory, or on disk through the durable native engine
(``HGEnvironment.get(location)``, or ``store_backend="native"`` with a
``location``).
"""

from hypergraphdb_tpu_torch.core.config import HGConfiguration
from hypergraphdb_tpu_torch.core.environment import HGEnvironment
from hypergraphdb_tpu_torch.core.errors import (
    HGException,
    NotFoundError,
    TransactionConflict,
)
from hypergraphdb_tpu_torch.core.graph import HGLink, HyperGraph
from hypergraphdb_tpu_torch.core.handles import (
    NULL_HANDLE,
    HandleFactory,
    HGHandle,
    SequentialHandleFactory,
    UUIDHandleFactory,
)
from hypergraphdb_tpu_torch.device import resolve_device

__all__ = ["HGConfiguration", "HGEnvironment", "HGException", "HGHandle",
           "HGLink", "HandleFactory", "HyperGraph", "NULL_HANDLE",
           "NotFoundError", "SequentialHandleFactory", "TransactionConflict",
           "UUIDHandleFactory", "resolve_device"]
