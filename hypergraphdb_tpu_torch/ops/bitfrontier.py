"""Bit-packed BFS frontiers: the push BFS that stores every per-seed bitmap
in 32-bit words.

The port of ``hypergraphdb_tpu/ops/bitfrontier.py``. Same GraphBLAS
push-BFS semantics as the dense ``ops/frontier.py`` (SimpleALGenerator's
neighbour rule, ``HGBreadthFirstTraversal.java:49-66``), at 1/32 of its
state:

- per-seed ``frontier`` and ``visited`` bitmaps of ``W = ceil((N+1)/32)``
  words each;
- the scatter destination is the only dense array, one byte per (atom,
  seed) of a ``k_block``-wide seed block, so K runs in blocks;
- each relation streams in ``edge_chunk`` slices, so the gather transient
  is (edge_chunk, k_block) words, not (E, k_block);
- levels, when asked for, are int8 (at most 127 hops).

Edges touched per seed (the edges/s numerator) fall out of the scatter:
each incidence entry whose source bit is live is counted as it is
gathered.

Differences from the reference, all deliberate:

- Words are int32 (the bits of the reference's uint32), as everywhere in
  the port: every right shift is masked with ``& 1``, and packing ORs one
  bit plane at a time with the plane's int32 weight, so bit 31 never
  overflows a sum.
- Inside a block the bitmaps lie atom-major, (W, K) words and an (M, K)
  byte destination, so a gather reads whole rows and a scatter writes
  them; :func:`bfs_packed_block` returns the reference's seed-major
  (K, W) layout. CUDA has no scatter-max on ``bool``: the destination is
  ``uint8``.
- The hop loop and the chunk scan are Python loops of eager launches (the
  reference's ``lax.fori_loop`` and ``lax.scan``), over each relation's
  real entries only (its padding joins the dummy row to itself).
- Results stay on the device as tensors; edge counts are int64.
- The sharded variant lives in ``parallel/sharded``: each shard runs
  :func:`_scatter_relation` over its own edge slice, with no
  ``varying_axis`` (that argument serves JAX's replication checker).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from hypergraphdb_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from hypergraphdb_tpu_torch.ops.snapshot import CSRSnapshot, DeviceSnapshot

WORD = 32
#: int32 word with only bit b set, for b in 0..31 (uint32 bits viewed signed)
_BITS = np.left_shift(np.uint32(1), np.arange(WORD, dtype=np.uint32)).view(
    np.int32)


def words_for(nbits: int) -> int:
    """32-bit words needed to hold ``nbits`` bits."""
    return (nbits + WORD - 1) // WORD


# ------------------------------------------------------------------ bit ops


def _pack(bits: torch.Tensor, dim: int) -> torch.Tensor:
    """Pack ``bits`` (bool or 0/1 uint8) along ``dim``, whose size is a
    multiple of 32, into int32 words: bit j of word i is element
    ``i*32 + j``. One bit plane at a time, each times its int32 weight."""
    dim = dim % bits.dim()
    m = bits.shape[dim]
    planes = bits.unflatten(dim, (m // WORD, WORD))
    shape = list(bits.shape)
    shape[dim] = m // WORD
    out = torch.zeros(shape, dtype=torch.int32, device=bits.device)
    for j in range(WORD):
        out |= planes.select(dim + 1, j).to(torch.int32) * int(_BITS[j])
    return out


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., M) bool with M % 32 == 0 → (..., M//32) int32."""
    return _pack(bits, -1)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """(..., W) int32 → (..., W*32) bool."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.to(torch.bool).flatten(-2)


def test_bits(packed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather bits: packed (..., W) int32, idx (I,) int → (..., I) bool."""
    word = packed[..., idx >> 5]
    return ((word >> (idx & 31).to(torch.int32)) & 1).to(torch.bool)


def popcount(packed: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Population count of int32 words, summed along ``axis`` (int32). The
    SWAR steps: each mask clears the sign bits an arithmetic shift brings
    in, so a word with bit 31 set counts like its unsigned bits."""
    x = packed.to(torch.int32)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = (x + (x >> 16)) & 0x3F
    return x.sum(dim=axis, dtype=torch.int32)


def valid_word_mask(n_valid: int, w: int, offset: int = 0) -> np.ndarray:
    """(w,) int32 mask with bit j of word i set iff
    ``offset + i*32 + j < n_valid``: clears the dummy row and pad bits.
    Host-side (numpy), for host callers and tests; the BFS builds its mask
    on the device."""
    ids = offset + np.arange(w * WORD, dtype=np.int64)
    bits = ids < n_valid
    return np.packbits(
        bits.reshape(w, WORD), axis=-1, bitorder="little"
    ).view("<u4").reshape(w).view(np.int32)


# ------------------------------------------------------------------ the hop


def _scatter_relation(src: torch.Tensor, dst: torch.Tensor,
                      f_packed: torch.Tensor, m_dest: int, edge_chunk: int,
                      count: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Stream one relation's entries in ``edge_chunk`` slices: OR each
    entry's source bit into a dense destination,
    ``dest[dst[e], k] |= bit(src[e], k)``.

    ``src`` (E,) int32 and ``dst`` (E,) int64 are the relation's real
    entries; ``f_packed`` (W_src, K) int32 the atom-major source bitmaps.
    Returns (the packed destination (m_dest//32, K) int32, per-seed
    live-entry counts (K,) int64, zeros when ``count`` is False). The
    scatter takes the max over a ``uint8`` view, so repeated destinations
    OR, whatever order the writes land in."""
    K = f_packed.shape[1]
    dev = f_packed.device
    dest = torch.zeros((m_dest, K), dtype=torch.uint8, device=dev)
    cnt = torch.zeros(K, dtype=torch.int64, device=dev)
    for s in range(0, src.shape[0], edge_chunk):
        sc = src[s : s + edge_chunk]
        word = f_packed.index_select(0, sc >> 5)       # (chunk, K)
        word >>= (sc & 31)[:, None]
        word &= 1
        bit = word.to(torch.uint8)
        del word
        d = dst[s : s + edge_chunk]
        dest.scatter_reduce_(0, d[:, None].expand(-1, K), bit, "amax")
        if count:
            cnt += bit.sum(0, dtype=torch.int64)
    return _pack(dest, 0), cnt


class PackedBFSResult(NamedTuple):
    visited: torch.Tensor        # (K, W) int32: packed reachable-set bitmaps
    edges_touched: torch.Tensor  # (K,) int64: incidence entries, live source
    levels: Optional[torch.Tensor]  # (K, M) int8 or None: hops, -1 unreached


def _set_levels(levels: torch.Tensor, nxt: torch.Tensor, hop: int) -> None:
    """``levels[v, k] = hop`` where bit v of lane k is set in ``nxt``
    ((W, K) words; ``levels`` (M, K) int8, atom-major), one bit plane at a
    time."""
    planes = levels.unflatten(0, (nxt.shape[0], WORD))
    for j in range(WORD):
        hit = ((nxt >> j) & 1).to(torch.bool)
        planes[:, j].masked_fill_(hit, hop)


def bfs_packed_block(dev: DeviceSnapshot, seeds: torch.Tensor, max_hops: int,
                     edge_chunk: int = 1 << 19,
                     with_levels: bool = False) -> PackedBFSResult:
    """One seed block of the bit-packed multi-hop BFS on ``seeds``'
    device: per hop, two relation scans (atom → link, link → target),
    each ending in a bit pack. ``max_hops`` is at most 127, so levels fit
    int8."""
    if max_hops > 127:
        raise ValueError("bfs_packed: max_hops > 127 would overflow int8 levels")
    K = seeds.shape[0]
    N = dev.num_atoms
    w = words_for(N + 1)
    m = w * WORD
    device = seeds.device
    inc_src = dev.inc_src[: dev.n_inc]
    inc_links = dev.index64("inc_links")[: dev.n_inc]
    tgt_src = dev.tgt_src[: dev.n_tgt]
    tgt_flat = dev.index64("tgt_flat")[: dev.n_tgt]
    # (w, 1) words clearing the dummy slot N and the pad bits
    valid = torch.from_numpy(valid_word_mask(N, w)).to(device)[:, None]

    lanes = torch.arange(K, device=device)
    s64 = seeds.to(torch.int64)
    bits = torch.from_numpy(_BITS).to(device)
    frontier = torch.zeros((w, K), dtype=torch.int32, device=device)
    # one bit per lane, so an add into a (word, lane) slot is an OR
    frontier.index_put_((s64 >> 5, lanes), bits[s64 & 31], accumulate=True)
    visited = frontier.clone()
    levels = None
    if with_levels:
        levels = torch.full((m, K), -1, dtype=torch.int8, device=device)
        _set_levels(levels, frontier, 0)
    counts = torch.zeros(K, dtype=torch.int64, device=device)
    for hop in range(max_hops):
        link_packed, c = _scatter_relation(inc_src, inc_links, frontier, m,
                                           edge_chunk, count=True)
        nbr_packed, _ = _scatter_relation(tgt_src, tgt_flat, link_packed, m,
                                          edge_chunk, count=False)
        del link_packed
        nxt = nbr_packed & valid & ~visited
        if with_levels:
            _set_levels(levels, nxt, hop + 1)
        visited |= nxt
        counts += c
        frontier = nxt
    return PackedBFSResult(
        visited.T.contiguous(), counts,
        None if levels is None else levels.T.contiguous())


# ------------------------------------------------------------------ host API


def bfs_packed(snap: CSRSnapshot, seeds: np.ndarray, max_hops: int,
               k_block: int = 256, edge_chunk: int = 1 << 19,
               with_levels: bool = False,
               device: str | torch.device = DEFAULT_DEVICE
               ) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The entry point: K seeds in ``k_block`` slices, so the dense scatter
    destination stays ``k_block`` bytes an atom whatever K is. Runs on the
    card unless the caller asks for the CPU.

    Returns (visited (K, W) int32, edges_touched (K,) int64, levels
    (K, N+1) int8 or None), tensors on ``device``."""
    dev = resolve_device(device)
    dsnap = snap.device(dev)
    seeds = np.asarray(seeds, dtype=np.int32)
    K = len(seeds)
    vis_out, cnt_out, lev_out = [], [], []
    for s in range(0, K, k_block):
        block = seeds[s : s + k_block]
        pad = k_block - len(block)
        if pad:
            block = np.concatenate([block, np.zeros(pad, dtype=np.int32)])
        res = bfs_packed_block(dsnap, torch.from_numpy(block).to(dev),
                               max_hops, edge_chunk=edge_chunk,
                               with_levels=with_levels)
        take = k_block - pad
        vis_out.append(res.visited[:take])
        cnt_out.append(res.edges_touched[:take])
        if with_levels:
            lev_out.append(res.levels[:take, : snap.num_atoms + 1])
        del res
    levels = torch.cat(lev_out) if with_levels else None
    return torch.cat(vis_out), torch.cat(cnt_out), levels


def unpack_visited(visited_packed: torch.Tensor, n: int) -> torch.Tensor:
    """(K, W) int32 → (K, n) bool, where the bitmap lives."""
    return unpack_bits(visited_packed)[:, :n]


# ------------------------------------------------------------------ planning


def bfs_memory_bytes(
    n_atoms: int,
    e_inc: int,
    e_tgt: int,
    k_block: int = 256,
    n_dev: int = 1,
    edge_chunk: int = 1 << 19,
    with_levels: bool = False,
) -> dict:
    """Per-device memory plan of the packed BFS at a given scale, the
    reference's arithmetic: packed state (frontier, visited, next), the
    all-gathered bitmaps of the sharded variant, the dense scatter
    destination, the per-chunk gather transient, the relations' COO
    columns, the per-atom columns and, with levels, the int8 level
    table."""
    w_full = words_for(n_atoms + 1)
    n_loc = -(-(n_atoms + 1) // (n_dev * 128)) * 128
    w_loc = n_loc // WORD if n_dev > 1 else w_full
    m_loc = n_loc if n_dev > 1 else w_full * WORD
    state = 3 * k_block * w_loc * 4            # frontier, visited, next (packed)
    gathered = 2 * k_block * w_full * 4        # all-gathered packed bitmaps
    scatter_dest = k_block * m_loc             # dense byte destination
    edge_transient = k_block * edge_chunk * 5  # gathered words + byte bits
    edges = (e_inc + e_tgt) * 2 * 4 // n_dev   # COO src+dst per relation
    atoms = (n_atoms // n_dev) * (4 * 3 + 1 + 8)  # type/arity/offsets,flag,rank
    levels = k_block * m_loc if with_levels else 0
    total = (
        state + gathered + scatter_dest + edge_transient + edges + atoms
        + levels
    )
    return {
        "state": state, "gathered": gathered, "scatter_dest": scatter_dest,
        "edge_transient": edge_transient, "edges": edges, "atoms": atoms,
        "levels": levels, "total": total,
    }
