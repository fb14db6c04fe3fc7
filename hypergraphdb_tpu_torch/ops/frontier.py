"""Batched BFS frontier expansion as CSR hyperedge message passing: the
dense path.

The port of ``hypergraphdb_tpu/ops/frontier.py``. One hop over all seeds is
two fixed-shape scatter-max ops over the flattened incidence and target
relations:

    link_active[l]  = OR_{(a,l) ∈ incidence} frontier[a]      (atom → link)
    neighbor[t]     = OR_{(l,t) ∈ targets}   link_active[l]   (link → target)

Frontiers are dense (K, N+1) bool bitmaps; the dummy row ``N`` absorbs padded
edges and is cleared after every hop. Plain PyTorch: the reference has no
Pallas kernel here. Tensors stay on the device of the ``DeviceSnapshot``.
"""

from __future__ import annotations

import torch

from hypergraphdb_tpu_torch.ops.snapshot import DeviceSnapshot


def _scatter_or(dst_index: torch.Tensor, values: torch.Tensor,
                n: int) -> torch.Tensor:
    """(K, n) bool: OR of ``values[:, e]`` into column ``dst_index[e]``."""
    K = values.shape[0]
    out = torch.zeros((K, n), dtype=torch.bool, device=values.device)
    return out.scatter_reduce(1, dst_index.expand(K, -1), values, "amax")


def expand_frontier(dev: DeviceSnapshot, frontier: torch.Tensor) -> torch.Tensor:
    """One hop: frontier bitmap (..., N+1) bool → neighbor bitmap (..., N+1)."""
    shape = frontier.shape
    f = frontier.reshape(-1, shape[-1])
    n1 = shape[-1]
    inc_links, inc_src = dev.inc_links.long(), dev.inc_src.long()
    tgt_flat, tgt_src = dev.tgt_flat.long(), dev.tgt_src.long()
    link_active = _scatter_or(inc_links, f[:, inc_src], n1)
    nbrs = _scatter_or(tgt_flat, link_active[:, tgt_src], n1)
    nbrs[:, dev.num_atoms] = False  # clear the dummy slot
    return nbrs.reshape(shape)


def _seed_frontier(dev: DeviceSnapshot, seeds: torch.Tensor) -> torch.Tensor:
    K = seeds.shape[0]
    n1 = dev.type_of.shape[0]
    frontier = torch.zeros((K, n1), dtype=torch.bool, device=seeds.device)
    frontier[torch.arange(K, device=seeds.device), seeds.long()] = True
    return frontier


def bfs_levels(dev: DeviceSnapshot, seeds: torch.Tensor,
               max_hops: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched K-seed BFS. Returns (levels, visited):

    - ``levels``: (K, N+1) int32, hop distance from each seed (-1 unreached),
    - ``visited``: (K, N+1) bool reachable-within-max_hops mask.
    """
    frontier = _seed_frontier(dev, seeds)
    visited = frontier.clone()
    levels = torch.where(frontier, 0, -1).to(torch.int32)
    for i in range(max_hops):
        nxt = expand_frontier(dev, frontier) & ~visited
        levels = torch.where(nxt, i + 1, levels).to(torch.int32)
        visited |= nxt
        frontier = nxt
    return levels, visited


def frontier_edge_counts(dev: DeviceSnapshot, seeds: torch.Tensor,
                         max_hops: int) -> torch.Tensor:
    """Incidence edges touched by the live frontiers, per seed: Σ degree(a)
    over each hop's frontier, (K,) int32."""
    inc_degree = (dev.inc_offsets[1:] - dev.inc_offsets[:-1]).to(torch.int64)
    frontier = _seed_frontier(dev, seeds)
    visited = frontier.clone()
    total = torch.zeros(seeds.shape[0], dtype=torch.int64, device=seeds.device)
    for _ in range(max_hops):
        total += (frontier.to(torch.int64) * inc_degree[None, :]).sum(1)
        nxt = expand_frontier(dev, frontier) & ~visited
        visited |= nxt
        frontier = nxt
    return total.to(torch.int32)
