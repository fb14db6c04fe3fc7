"""Sharded execution: a CSR snapshot and the BFS state split over a mesh of
devices by gid range.

The port of ``hypergraphdb_tpu/parallel/sharded.py``. The layout is the
reference's:

- **Row partitioning.** The id space ``[0, N]`` splits into ``n_dev``
  contiguous ranges of ``n_loc`` ids (``PartitionMap.for_mesh``, a
  multiple of 128). Each shard owns its range's slice of every per-atom
  column and of the frontier, visited and level state.
- **Edges live with their destination.** Each COO relation is split by
  the owner of its destination id, destinations rewritten to local ids, so
  a hop's scatter is local to the shard.
- **Only packed bitmaps move.** Per hop each shard all-gathers the packed
  frontier words (atom → link), scatters its own edge slice, packs, then
  all-gathers the link words (link → target) and scatters again.
- **Candidate parallelism** for the conjunctive pattern: the candidates
  split across shards, each probing the (small, replicated) anchor rows.

What the JAX mesh becomes here:

- :class:`Mesh` is a small frozen tuple of ``torch.device``s, one for
  each local shard; a device may repeat, so several shards can share one
  card (or the CPU). Each ``shard_map`` body is a plain loop over the
  local shards, and ``axis_index`` is the shard's index.
- :func:`all_gather` (``all_gather(..., tiled=True)``) concatenates the
  shards' tensors once for each distinct device: shards that share a
  device share one gathered tensor. :func:`psum` is a sum.
- When ``torch.distributed`` is initialized with more than one process,
  the mesh counts every process's shards and each process holds its own;
  the two collectives then finish with ``all_gather_into_tensor`` and
  ``all_reduce`` (``parallel/multihost`` sets the group up: nccl on the
  cards, gloo when asked for a mesh of CPUs).

The reference's ``_SHARD_MAP_KW`` / ``pcast``, its pytree registrations
and ``_scatter_relation``'s ``varying_axis`` serve JAX's checker and have
no counterpart: the hop is ``ops/bitfrontier._scatter_relation`` over a
shard's real entries, in the atom-major (words, lanes) layout of the
port's packed BFS.

A delta sharded from a memtable carries the memtable's epoch, and
:func:`shard_host_delta` refuses one of another epoch than the sharded
base. The reference compares capacities there, which padding keeps equal
across compactions, so it cannot see a stale base.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from hypergraphdb_tpu_torch import verify as hgverify
from hypergraphdb_tpu_torch.device import resolve_device
from hypergraphdb_tpu_torch.ops.bitfrontier import (
    WORD,
    PackedBFSResult,
    _scatter_relation,
    _set_levels,
    unpack_bits,
    valid_word_mask,
)
from hypergraphdb_tpu_torch.ops.setops import (
    SENTINEL,
    _bucket,
    member_mask,
    pad_sorted,
)
from hypergraphdb_tpu_torch.ops.snapshot import CSRSnapshot
from hypergraphdb_tpu_torch.storage.partitioned import PartitionMap

#: name of the mesh axis rows, edges and candidates are sharded over
AXIS = "shard"


# ------------------------------------------------------------------ the mesh


def _process_group() -> tuple[int, int]:
    """(world size, rank) of the initialized process group, else (1, 0)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _norm_device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class Mesh:
    """One mesh axis of shards. ``devices`` holds this process's shards in
    order (a device may repeat); with a process group of ``world``
    processes, process ``rank`` holds shards ``rank * len(devices)`` on."""

    devices: tuple
    axis_names: tuple = (AXIS,)
    world: int = 1
    rank: int = 0

    @property
    def n_dev(self) -> int:
        """Shards on the whole mesh, every process's."""
        return self.world * len(self.devices)

    @property
    def first_shard(self) -> int:
        """The global index of this process's first shard."""
        return self.rank * len(self.devices)

    @property
    def distinct(self) -> tuple:
        """This process's distinct devices, in first-use order."""
        return tuple(dict.fromkeys(self.devices))

    @property
    def home(self) -> torch.device:
        """The device results are gathered onto: the first shard's."""
        return self.devices[0]

    def local_shards(self):
        """(local index, global shard index, device) of every local shard."""
        for i, dev in enumerate(self.devices):
            yield i, self.first_shard + i, dev


def make_mesh(devices=None, axis: str = AXIS) -> Mesh:
    """A one-axis mesh over ``devices`` (``torch.device``s or their names;
    repeats allowed). ``None`` takes every visible CUDA device and raises
    when there is none."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass the devices, "
                "e.g. ['cpu'] * 8")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = tuple(_norm_device(d) for d in devices)
    if not devs:
        raise ValueError("make_mesh: a mesh needs at least one device")
    world, rank = _process_group()
    return Mesh(devs, (axis,), world, rank)


def _dist_all_gather(t: torch.Tensor, dim: int, world: int) -> torch.Tensor:
    import torch.distributed as dist

    moved = t.movedim(dim, 0).contiguous()
    flag = moved.dtype == torch.bool
    if flag:
        moved = moved.to(torch.uint8)
    out = torch.empty((world * moved.shape[0],) + tuple(moved.shape[1:]),
                      dtype=moved.dtype, device=moved.device)
    dist.all_gather_into_tensor(out, moved)
    if flag:
        out = out.to(torch.bool)
    return out.movedim(0, dim)


def all_gather(mesh: Mesh, parts: list, dim: int = 0) -> list:
    """``all_gather(..., tiled=True)``: every shard's part concatenated
    along ``dim`` in shard order, given for each local shard on its
    device. Shards that share a device share one tensor."""
    world = mesh.world
    out: dict = {}
    first = None
    for dev in mesh.distinct:
        if first is None:
            local = (torch.cat([p.to(dev) for p in parts], dim)
                     if len(parts) > 1 else parts[0].to(dev))
            if world > 1:
                local = _dist_all_gather(local, dim, world)
            first = out[dev] = local
        else:
            out[dev] = first.to(dev)
    return [out[d] for d in mesh.devices]


def psum(mesh: Mesh, parts: list) -> torch.Tensor:
    """The sum of every shard's part, on the mesh's home device."""
    home = mesh.home
    total = parts[0].to(home)
    for p in parts[1:]:
        total = total + p.to(home)
    if mesh.world > 1:
        import torch.distributed as dist

        dist.all_reduce(total)
    return total


# ------------------------------------------------------------ the snapshot


def _partition_by_owner(src: np.ndarray, dst: np.ndarray, n_dev: int,
                        n_loc: int) -> list:
    """Split a COO relation by ``owner(dst) = dst // n_loc``, destinations
    rewritten to local ids: one (src int32, local dst int64) pair for
    each shard, its real entries only (the hop scans nothing else)."""
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int64)
    owner = dst // n_loc
    order = np.argsort(owner, kind="stable")
    src_s, dst_s = src[order], dst[order]
    bounds = np.concatenate(
        [[0], np.cumsum(np.bincount(owner, minlength=n_dev))])
    return [(src_s[bounds[d] : bounds[d + 1]],
             dst_s[bounds[d] : bounds[d + 1]] - d * n_loc)
            for d in range(n_dev)]


def _put_local(mesh: Mesh, per_shard: list) -> list:
    """The local shards' host arrays as tensors on their devices."""
    return [torch.from_numpy(np.ascontiguousarray(per_shard[g])).to(dev)
            for _, g, dev in mesh.local_shards()]


@dataclass
class ShardedSnapshot:
    """The row and edge sharded twin of a :class:`CSRSnapshot`'s
    topology.

    Rows split into ranges of ``n_loc`` ids; COO edges sit with their
    destination row's owner, destinations in local ids. Every list holds
    one tensor for each local shard, on its device. ``epoch`` is the
    snapshot manager's compaction count the base belongs to (None when the
    caller did not name one). The reference also shards the per-atom
    type, link, arity and rank columns, which none of its sharded programs
    reads; the port leaves them on the host snapshot."""

    mesh: Mesh
    num_atoms: int         # N: the id space (the dummy row is N)
    n_loc: int             # ids of a shard's range (a multiple of 128)
    edge_chunk: int        # entries of one scatter slice
    inc_src: list          # (E_d,) int32: global source atom
    inc_dst: list          # (E_d,) int64: local destination link
    tgt_src: list          # (E_d,) int32: global source link
    tgt_dst: list          # (E_d,) int64: local destination atom
    valid: list            # (n_loc / 32,) int32: the ids below N set
    epoch: Optional[int] = None

    @property
    def n_dev(self) -> int:
        return self.mesh.n_dev

    @property
    def partition_map(self) -> PartitionMap:
        """The gid-range owner map these rows follow (derived: the layout
        is ``PartitionMap.for_mesh``'s by construction)."""
        return PartitionMap(n_parts=self.n_dev, part_size=self.n_loc,
                            capacity=self.num_atoms + 1)

    def nbytes(self) -> int:
        """Device bytes of this process's shards."""
        return sum(int(t.numel() * t.element_size())
                   for name in ("inc_src", "inc_dst", "tgt_src", "tgt_dst",
                                "valid")
                   for t in getattr(self, name))

    @staticmethod
    def from_host(snap: CSRSnapshot, mesh: Mesh, edge_chunk: int = 1 << 16,
                  epoch: Optional[int] = None) -> "ShardedSnapshot":
        n_dev = mesh.n_dev
        N = snap.num_atoms
        # the row layout is the storage partition map
        n_loc = PartitionMap.for_mesh(N + 1, n_dev).part_size
        e_inc, e_tgt = snap.n_edges_inc, snap.n_edges_tgt
        inc = _partition_by_owner(snap.inc_src[:e_inc],
                                  snap.inc_links[:e_inc], n_dev, n_loc)
        tgt = _partition_by_owner(snap.tgt_src[:e_tgt],
                                  snap.tgt_flat[:e_tgt], n_dev, n_loc)
        return ShardedSnapshot(
            mesh=mesh, num_atoms=N, n_loc=n_loc, edge_chunk=edge_chunk,
            inc_src=_put_local(mesh, [s for s, _ in inc]),
            inc_dst=_put_local(mesh, [d for _, d in inc]),
            tgt_src=_put_local(mesh, [s for s, _ in tgt]),
            tgt_dst=_put_local(mesh, [d for _, d in tgt]),
            valid=_put_local(mesh, valid_word_mask(
                N, n_dev * n_loc // WORD).reshape(n_dev, n_loc // WORD)),
            epoch=None if epoch is None else int(epoch),
        )


# ------------------------------------------------------- the sharded delta


@dataclass
class ShardedDelta:
    """The row and edge sharded twin of ``ops.incremental.DeviceDelta``:
    delta COO edges split by the owner of their destination row (the
    base's partition), destinations in local ids, and the tombstones as
    each shard's packed words."""

    epoch: int            # the compaction count the memtable belongs to
    edge_chunk: int       # entries of one delta scatter slice
    inc_src: list         # (D_d,) int32: global source atom
    inc_dst: list         # (D_d,) int64: local destination link
    tgt_src: list         # (D_d,) int32: global source link
    tgt_dst: list         # (D_d,) int64: local destination atom
    dead: list            # (n_loc / 32,) int32: packed tombstones


def shard_host_delta(sdev: ShardedSnapshot, hd: dict,
                     edge_chunk: int = 4096) -> ShardedDelta:
    """Shard a memtable's ``host_delta()`` over ``sdev``'s mesh. The
    delta must belong to the base's epoch (and id space): a compaction
    after ``sdev`` was built means the caller re-shards the base."""
    if hd["capacity"] != sdev.num_atoms:
        raise ValueError(
            f"delta capacity {hd['capacity']} != sharded base "
            f"{sdev.num_atoms}: epochs diverged, re-shard the base")
    if sdev.epoch is not None and int(hd["epoch"]) != sdev.epoch:
        raise ValueError(
            f"delta epoch {hd['epoch']} != sharded base epoch {sdev.epoch}: "
            f"re-shard the base")
    mesh, n_dev, n_loc = sdev.mesh, sdev.n_dev, sdev.n_loc
    # atom → link lands on the link's owner, link → target on the target's
    inc = _partition_by_owner(hd["inc_src"], hd["inc_links"], n_dev, n_loc)
    tgt = _partition_by_owner(hd["tgt_src"], hd["tgt_flat"], n_dev, n_loc)
    dead_bits = np.zeros(n_dev * n_loc, dtype=bool)
    dd = np.asarray(hd["dead"], dtype=np.int64)
    if len(dd):
        dead_bits[dd[(dd >= 0) & (dd < n_dev * n_loc)]] = True
    words = np.packbits(dead_bits.reshape(-1, WORD), axis=-1,
                        bitorder="little").view("<u4").view(np.int32)
    return ShardedDelta(
        epoch=int(hd["epoch"]), edge_chunk=edge_chunk,
        inc_src=_put_local(mesh, [s for s, _ in inc]),
        inc_dst=_put_local(mesh, [d for _, d in inc]),
        tgt_src=_put_local(mesh, [s for s, _ in tgt]),
        tgt_dst=_put_local(mesh, [d for _, d in tgt]),
        dead=_put_local(mesh, words.reshape(n_dev, n_loc // WORD)),
    )


# ------------------------------------------------------------ sharded BFS


def _check_hops(max_hops: int) -> None:
    if max_hops > 127:
        raise ValueError(
            "bfs_packed_sharded: max_hops > 127 would overflow int8 levels")


def _bfs_local(sdev: ShardedSnapshot, sdelta: Optional[ShardedDelta],
               seeds, max_hops: int, with_levels: bool):
    """The multi-hop loop on the local shards: returns each shard's packed
    visited words (w_loc, K), the per-seed incidence entries touched
    (psum'd, int64) and each shard's int8 levels (n_loc, K) or None."""
    _check_hops(max_hops)
    mesh = sdev.mesh
    n_loc = sdev.n_loc
    w_loc = n_loc // WORD
    if not torch.is_tensor(seeds):
        seeds = torch.from_numpy(np.asarray(seeds, dtype=np.int32))
    K = int(seeds.shape[0])
    frontier, visited, live, levels = [], [], [], []
    for i, d, dev in mesh.local_shards():
        row_start = d * n_loc
        valid = sdev.valid[i]
        if sdelta is not None:
            valid = valid & ~sdelta.dead[i]
        live.append(valid[:, None])
        s64 = seeds.to(dev, torch.int64)
        mine = (s64 >= row_start) & (s64 < row_start + n_loc)
        sl = torch.where(mine, s64 - row_start, 0)
        # the word's bit as int32 (bit 31 wraps to the sign), made on the
        # device: no host copy waits for the work queued before it
        bit = torch.where(mine, (torch.ones_like(sl) << (sl & 31)).to(
            torch.int32), 0)
        f = torch.zeros((w_loc, K), dtype=torch.int32, device=dev)
        # one bit per lane (0 off the shard), so an add into a (word,
        # lane) slot is an OR
        f.index_put_((sl >> 5, torch.arange(K, device=dev)), bit,
                     accumulate=True)
        if sdelta is not None:
            f &= live[i]  # a dead seed emits nothing
        frontier.append(f)
        visited.append(f.clone())
        if with_levels:
            lv = torch.full((n_loc, K), -1, dtype=torch.int8, device=dev)
            _set_levels(lv, f, 0)
            levels.append(lv)
    counts = torch.zeros(K, dtype=torch.int64, device=mesh.home)
    chunk = sdev.edge_chunk
    for hop in range(max_hops):
        f_full = all_gather(mesh, frontier, 0)
        link_loc, c = [], []
        for i, _, _ in mesh.local_shards():
            lk, ci = _scatter_relation(sdev.inc_src[i], sdev.inc_dst[i],
                                       f_full[i], n_loc, chunk, count=True)
            if sdelta is not None:
                dl, dc = _scatter_relation(
                    sdelta.inc_src[i], sdelta.inc_dst[i], f_full[i], n_loc,
                    sdelta.edge_chunk, count=True)
                lk = (lk | dl) & live[i]
                ci = ci + dc
            link_loc.append(lk)
            c.append(ci)
        del f_full
        l_full = all_gather(mesh, link_loc, 0)
        del link_loc
        for i, _, _ in mesh.local_shards():
            nb, _ = _scatter_relation(sdev.tgt_src[i], sdev.tgt_dst[i],
                                      l_full[i], n_loc, chunk, count=False)
            if sdelta is not None:
                dn, _ = _scatter_relation(
                    sdelta.tgt_src[i], sdelta.tgt_dst[i], l_full[i], n_loc,
                    sdelta.edge_chunk, count=False)
                nb = nb | dn
            nxt = nb & live[i] & ~visited[i]
            if with_levels:
                _set_levels(levels[i], nxt, hop + 1)
            visited[i] |= nxt
            frontier[i] = nxt
        del l_full
        counts += psum(mesh, c)
    return visited, counts, (levels if with_levels else None)


def _gathered(mesh: Mesh, parts: list) -> torch.Tensor:
    """Atom-major per-shard (rows, K) parts as one seed-major (K, rows)
    tensor on the home device."""
    return all_gather(mesh, parts, 0)[0].T.contiguous()


@hgverify.entry(
    shapes=lambda device, seed: (
        hgverify.sharded_snapshot_exemplar(device, seed),
        hgverify.sharded_seeds(device, seed, 32)),
    statics={"max_hops": 2},
    mesh=(AXIS,),
)
def bfs_packed_sharded(sdev: ShardedSnapshot, seeds, max_hops: int,
                       with_levels: bool = False) -> PackedBFSResult:
    """Batched K-seed BFS over the mesh with row-sharded packed state.

    Returns (visited (K, n_dev * n_loc / 32) int32 in the shards' row
    layout, edges_touched (K,) int64, levels (K, n_dev * n_loc) int8 or
    None), on the mesh's home device. Per hop two all-gathers of packed
    words cross between shards and two local edge scans do the work.
    ``max_hops`` is at most 127, so levels fit int8."""
    vis, counts, lev = _bfs_local(sdev, None, seeds, max_hops, with_levels)
    mesh = sdev.mesh
    return PackedBFSResult(
        _gathered(mesh, vis), counts,
        None if lev is None else _gathered(mesh, lev))


def bfs_packed_sharded_delta(sdev: ShardedSnapshot, sdelta: ShardedDelta,
                             seeds, max_hops: int,
                             with_levels: bool = False) -> PackedBFSResult:
    """Batched K-seed BFS over base ∪ delta minus tombstones on the mesh:
    the contract of :func:`bfs_packed_sharded`, each hop OR-ing the local
    delta scatters in before the exchange and clearing tombstoned rows.
    The sharded twin of ``ops.incremental.bfs_levels_delta``."""
    vis, counts, lev = _bfs_local(sdev, sdelta, seeds, max_hops, with_levels)
    mesh = sdev.mesh
    return PackedBFSResult(
        _gathered(mesh, vis), counts,
        None if lev is None else _gathered(mesh, lev))


def _dense(sdev: ShardedSnapshot, res: PackedBFSResult):
    n1 = sdev.num_atoms + 1
    visited = unpack_bits(res.visited)[:, :n1]
    return res.levels.to(torch.int32)[:, :n1], visited


def bfs_levels_sharded(sdev: ShardedSnapshot, seeds, max_hops: int):
    """The contract of ``ops.frontier.bfs_levels`` on the mesh: (levels
    (K, N+1) int32, visited (K, N+1) bool), dense, for graphs small enough
    to hold them; large callers use :func:`bfs_packed_sharded`."""
    return _dense(sdev, bfs_packed_sharded(sdev, seeds, max_hops,
                                           with_levels=True))


def bfs_levels_sharded_delta(sdev: ShardedSnapshot, sdelta: ShardedDelta,
                             seeds, max_hops: int):
    """The dense (levels, visited) contract of
    ``ops.incremental.bfs_levels_delta`` on the mesh."""
    return _dense(sdev, bfs_packed_sharded_delta(sdev, sdelta, seeds,
                                                 max_hops, with_levels=True))


def device_memory_stats(mesh: Optional[Mesh] = None) -> dict:
    """Measured allocator stats of each distinct CUDA device of ``mesh``
    (every visible card when None), keyed by the device index: the bytes
    in use now and the process's peak since its last reset. Empty on the
    CPU."""
    if mesh is not None:
        devs = [d for d in mesh.distinct if d.type == "cuda"]
    elif torch.cuda.is_available():
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = []
    out = {}
    for d in devs:
        stats = torch.cuda.memory_stats(d)
        out[str(d.index)] = {
            "process_peak_bytes_in_use": int(
                stats.get("allocated_bytes.all.peak", 0)),
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        }
    return out


def bfs_packed_sharded_blocked(sdev: ShardedSnapshot, seeds, max_hops: int,
                               k_block: int = 256):
    """Seed-blocked driver of :func:`bfs_packed_sharded`: ceil(K /
    ``k_block``) runs one after another, concatenated along the seeds.

    Returns (visited (K, n_dev * n_loc / 32) int32, edges_touched (K,)
    int64 on the host, the measured memory report: each device's bytes in
    use before and after and the process peak)."""
    if k_block <= 0 or k_block % WORD:
        raise ValueError(
            f"k_block must be a positive multiple of {WORD}; got {k_block}")
    seeds = np.asarray(seeds, dtype=np.int32)
    K = len(seeds)
    mesh = sdev.mesh
    before = device_memory_stats(mesh)
    if K == 0:
        w = sdev.n_dev * sdev.n_loc // WORD
        return (torch.zeros((0, w), dtype=torch.int32, device=mesh.home),
                np.zeros(0, dtype=np.int64),
                {did: {"bytes_in_use_before": st["bytes_in_use"],
                       "bytes_in_use_after": st["bytes_in_use"],
                       "process_peak_bytes_in_use":
                           st["process_peak_bytes_in_use"]}
                 for did, st in before.items()})
    pads = (-K) % WORD
    if pads:
        seeds = np.concatenate(
            [seeds, np.full(pads, sdev.num_atoms, dtype=np.int32)])
    vis_blocks, cnt_blocks = [], []
    for s in range(0, len(seeds), k_block):
        res = bfs_packed_sharded(sdev, seeds[s : s + k_block], max_hops)
        vis_blocks.append(res.visited)
        cnt_blocks.append(res.edges_touched.cpu().numpy())
    after = device_memory_stats(mesh)
    report = {
        did: {
            "bytes_in_use_before": before.get(did, {}).get("bytes_in_use", 0),
            "bytes_in_use_after": st["bytes_in_use"],
            "process_peak_bytes_in_use": st["process_peak_bytes_in_use"],
        }
        for did, st in after.items()
    }
    visited = torch.cat(vis_blocks)[:K]
    return visited, np.concatenate(cnt_blocks)[:K], report


# ------------------------------------------- sharded conjunctive patterns


@hgverify.entry(shapes=hgverify.match_args, mesh=(AXIS,))
def match_candidates_sharded(sdev: ShardedSnapshot, candidates,
                             anchor_rows) -> torch.Tensor:
    """``And(type, incident(a1), ..., incident(ak))`` on the mesh: the
    candidates (the by-type sorted ids, host numpy) split across shards,
    each testing its slice against every anchor's sorted, SENTINEL-padded
    row (``anchor_rows`` (A, L)) with ``setops.member_mask``. Returns the
    (C,) bool mask on the home device."""
    mesh = sdev.mesh
    n_dev = mesh.n_dev
    cand = np.asarray(candidates, dtype=np.int32)
    C = len(cand)
    c_loc = -(-max(C, 1) // n_dev)
    padded = np.full(n_dev * c_loc, SENTINEL, dtype=np.int32)
    padded[:C] = cand
    rows_h = np.ascontiguousarray(anchor_rows, dtype=np.int32)
    parts = []
    for _, d, dev in mesh.local_shards():
        sl = torch.from_numpy(padded[d * c_loc : (d + 1) * c_loc]).to(dev)
        rows = torch.from_numpy(rows_h).to(dev)
        hits = member_mask(rows, sl[None, :].expand(rows.shape[0], -1)
                           .contiguous())
        parts.append(hits.all(dim=0))
    return all_gather(mesh, parts, 0)[0][:C]


def and_incident_pattern_sharded(snap: CSRSnapshot, sdev: ShardedSnapshot,
                                 type_handle: int, anchors) -> np.ndarray:
    """The ids of the atoms of ``type_handle`` incident to every anchor."""
    cands = snap.type_set(type_handle)
    if len(cands) == 0 or not anchors:
        return np.empty(0, dtype=np.int32)
    rows = [snap.incidence_row(a) for a in anchors]
    L = _bucket(max((len(r) for r in rows), default=1))
    padded = np.stack([pad_sorted(r, L) for r in rows])
    mask = match_candidates_sharded(sdev, cands, padded)
    return np.asarray(cands)[mask.cpu().numpy()]


def and_incident_pattern_sharded_delta(mgr, sdev: ShardedSnapshot,
                                       type_handle: int,
                                       anchors) -> np.ndarray:
    """The (base, delta) form: the mesh answers the base, the host merges
    the memtable (tombstoned and revalued candidates drop, new and
    revalued atoms are evaluated against the live graph), as
    ``query/compiler.DeviceValueConjPlan`` does on one device. ``sdev``
    must be the sharded twin of the manager's current base: its epoch
    when it names one, else its id space, is checked."""
    if not anchors:
        # an anchorless conjunction is a by-type query: answering it with
        # the post-base memtable subset alone would be wrong
        raise ValueError(
            "and_incident_pattern_sharded_delta needs >= 1 anchor; use a "
            "type query for the anchorless form")
    view = mgr.pinned_view(sync_delta=False)
    base = view.base
    if (base.num_atoms != sdev.num_atoms
            or (sdev.epoch is not None and view.epoch != sdev.epoch)):
        raise ValueError(
            f"sharded base (epoch {sdev.epoch}) and manager epoch "
            f"{view.epoch} diverged: re-shard the base")
    out = and_incident_pattern_sharded(base, sdev, type_handle, anchors)
    dead, revalued = view.dead, view.revalued
    drop = dead | revalued
    if drop and len(out):
        out = out[~np.isin(out, np.fromiter(drop, dtype=np.int64))]
    g = mgr.graph
    fresh = []
    for h in (set(view.new_atoms) | revalued) - dead:
        if g.store.get_link(h) is None:
            continue  # removed since the view was pinned
        if int(g.get_type_handle_of(h)) != int(type_handle):
            continue
        ts = {int(t) for t in g.get_targets(h)}
        if all(int(a) in ts for a in anchors):
            fresh.append(h)
    if fresh:
        out = np.union1d(out.astype(np.int64),
                         np.asarray(fresh, dtype=np.int64)).astype(
            out.dtype if len(out) else np.int64)
    return out
