"""hypergraphdb_tpu_torch — the PyTorch / CUDA port of hypergraphdb_tpu.

The port runs the hypergraph database's device plane on an NVIDIA H100:
plain tensor code is PyTorch, and each kernel that the JAX package wrote in
Pallas for the TPU is a hand-written CUDA kernel under ``csrc/``. It stands
alone: it imports neither ``jax`` nor anything of ``hypergraphdb_tpu``, and
keeps its own copies of the host code it needs.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU every kernel wrapper runs its plain PyTorch version.
"""

from hypergraphdb_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
