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

A hop runs lane-transposed, rows for atoms and columns for seeds, so each
gather reads whole rows; :func:`scatter_or` streams the relation in edge
chunks of at most :data:`CHUNK_BYTES` of gathered rows. CUDA has no
scatter-max on ``bool``, so the scatter runs on ``uint8`` views.
:func:`scatter_relation` scatters a relation without its padding: a
coarsely padded one (a snapshot manager pads to 2^19 entries) would send
every pad entry into the dummy row, where the atomics serialise.
"""

from __future__ import annotations

import torch

from hypergraphdb_tpu_torch.ops.snapshot import DeviceSnapshot

#: bytes of the (edges, lanes) gather transient of one scatter chunk
CHUNK_BYTES = 1 << 31


def scatter_or(out: torch.Tensor, dst: torch.Tensor, src: torch.Tensor,
               values: torch.Tensor) -> None:
    """``out[dst[e]] |= values[src[e]]`` for every entry e, in place.
    ``out`` (n, L) and ``values`` (m, L) are bool, ``dst`` int64, ``src``
    int32 or int64."""
    L = out.shape[1]
    o, v = out.view(torch.uint8), values.view(torch.uint8)
    step = max(1, CHUNK_BYTES // max(L, 1))
    for s in range(0, dst.shape[0], step):
        d = dst[s : s + step]
        o.scatter_reduce_(0, d[:, None].expand(-1, L),
                          v.index_select(0, src[s : s + step]), "amax")


def scatter_relation(out: torch.Tensor, holder, dst_name: str,
                     src_name: str, values: torch.Tensor,
                     n: int | None) -> None:
    """:func:`scatter_or` over the first ``n`` entries of one relation of
    ``holder`` (a device snapshot or delta; ``None`` takes them all): the
    rest is padding. A pad entry joins the dummy row to itself, which every
    hop clears, so skipping it changes no other row."""
    scatter_or(out, holder.index64(dst_name)[:n],
               getattr(holder, src_name)[:n], values)


def expand_frontier(dev: DeviceSnapshot, frontier: torch.Tensor) -> torch.Tensor:
    """One hop: frontier bitmap (..., N+1) bool → neighbor bitmap (..., N+1)."""
    shape = frontier.shape
    f = frontier.reshape(-1, shape[-1]).T.contiguous()
    link_active = torch.zeros_like(f)
    scatter_relation(link_active, dev, "inc_links", "inc_src", f,
                     dev.n_inc)
    nbrs = torch.zeros_like(f)
    scatter_relation(nbrs, dev, "tgt_flat", "tgt_src", link_active,
                     dev.n_tgt)
    nbrs[dev.num_atoms] = False  # clear the dummy slot
    return nbrs.T.reshape(shape)


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
