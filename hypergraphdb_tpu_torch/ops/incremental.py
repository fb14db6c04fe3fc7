"""Incremental snapshots: a delta over a base snapshot, the dense base ∪
delta BFS, and the memtable that builds the delta.

The port of the delta half of ``hypergraphdb_tpu/ops/incremental.py``. A
base snapshot is packed with id-space headroom (``capacity``), so links
added after the pack keep ids inside its bitmaps. Until the next compaction
they live in a *delta*: four COO arrays padded to a power-of-two bucket with
the dummy row ``N``, and a tombstone mask over the id space.

- :class:`DeviceDelta` (reference :41) holds the arrays on a device.
- :func:`expand_frontier_delta` (:64) and :func:`bfs_levels_delta` (:92)
  run the reference's dense sweep over base ∪ delta: dead links emit
  nothing, dead atoms are never reached, a dead seed is cleared before hop
  1, and the dummy row is cleared after every hop (a pad lane keeps its
  seed bit at ``N``).
- :class:`DeltaMemtable` is the graph-free memtable half of the reference's
  ``SnapshotManager`` (:177): it buffers link records and removals and
  refreshes the device delta under the reference's bucket, tail-splice and
  drift rules. Event wiring, compaction and pinned views belong to the
  manager, which wraps it.

The dense sweep keeps the reference's results, not its layout. The
reference holds a (K, N+1) bool frontier and gathers a (K, E) bool array
per relation: 49 GB at 1024 seeds over 10M atoms. Here seed lanes run in
blocks of at most :data:`DENSE_LANE_BLOCK`, each an (N+1, lanes) bool
frontier whose rows are atoms, through ``frontier.scatter_or`` (edge
chunks, ``uint8`` views). Plain PyTorch: the reference has no Pallas
kernel on this path.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from hypergraphdb_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from hypergraphdb_tpu_torch.ops.frontier import scatter_or
from hypergraphdb_tpu_torch.ops.setops import _bucket
from hypergraphdb_tpu_torch.ops.snapshot import DeviceSnapshot, cached_index64

#: seed lanes of one dense block: the (N+1, lanes) frontier, visited set
#: and scatter targets stay a few bytes per atom and lane
DENSE_LANE_BLOCK = 256
#: the COO columns of a delta, in the reference's order
COLUMNS = ("inc_links", "inc_src", "tgt_flat", "tgt_src")
#: the smallest edge bucket of a delta (the reference manager's default)
BUCKET_MIN = 128


@dataclass(eq=False)
class DeviceDelta:
    """Fixed-shape overlay on one device: COO edge additions and a
    tombstone mask. Pad entries point at the dummy row ``N``. Treated as
    immutable: a refresh builds a new one, so caches on it stay valid."""

    inc_links: torch.Tensor  # (D_inc,) int32 — link of each incidence entry
    inc_src: torch.Tensor    # (D_inc,) int32 — the atom it targets
    tgt_flat: torch.Tensor   # (D_tgt,) int32 — target of each target entry
    tgt_src: torch.Tensor    # (D_tgt,) int32 — its link
    dead: torch.Tensor       # (N+1,) bool tombstones

    @property
    def n_atoms(self) -> int:
        return self.dead.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.dead.device

    def index64(self, name: str) -> torch.Tensor:
        """Column ``name`` as int64, converted once and cached."""
        return cached_index64(self, name)

    def has_tombstones(self) -> bool:
        """Is any id dead? One reduction and sync on first use, cached."""
        hit = self.__dict__.get("_has_tombstones")
        if hit is None:
            hit = bool(self.dead.any())
            self._has_tombstones = hit
        return hit


def _check_pair(dev: DeviceSnapshot, delta: DeviceDelta) -> None:
    n1 = dev.type_of.shape[0]
    if delta.dead.shape != (n1,) or delta.device != dev.type_of.device:
        raise ValueError(
            f"delta over {delta.dead.shape[0]} ids on {delta.device} does "
            f"not fit a snapshot of {n1} ids on {dev.type_of.device}")


# ------------------------------------------------------------ the dense sweep


def _hop(dev: DeviceSnapshot, delta: DeviceDelta, f: torch.Tensor,
         live: torch.Tensor) -> torch.Tensor:
    """One hop over base ∪ delta on an (N+1, L) bool frontier; ``live`` is
    ``~delta.dead``."""
    la = torch.zeros_like(f)
    scatter_or(la, dev.index64("inc_links"), dev.inc_src, f)
    scatter_or(la, delta.index64("inc_links"), delta.inc_src, f)
    la &= live[:, None]  # dead links emit nothing
    nb = torch.zeros_like(f)
    scatter_or(nb, dev.index64("tgt_flat"), dev.tgt_src, la)
    scatter_or(nb, delta.index64("tgt_flat"), delta.tgt_src, la)
    nb &= live[:, None]
    nb[dev.num_atoms] = False
    return nb


def expand_frontier_delta(dev: DeviceSnapshot, delta: DeviceDelta,
                          frontier: torch.Tensor) -> torch.Tensor:
    """One hop over base ∪ delta, minus tombstoned atoms: a (N+1,) or (K,
    N+1) bool frontier → the neighbour bitmap of the same shape."""
    _check_pair(dev, delta)
    f = frontier.reshape(-1, frontier.shape[-1]).T.contiguous()
    nb = _hop(dev, delta, f, ~delta.dead)
    return nb.T.reshape(frontier.shape)


def bfs_delta_lanes(dev: DeviceSnapshot, delta: DeviceDelta,
                    seeds: torch.Tensor, max_hops: int,
                    with_levels: bool = False):
    """One block of seed lanes through the dense sweep, lane-transposed:
    ``(visited (N+1, L) bool, levels (N+1, L) int32 or None)``, column k
    for ``seeds[k]``."""
    _check_pair(dev, delta)
    n1, L = dev.type_of.shape[0], seeds.shape[0]
    live = ~delta.dead
    frontier = torch.zeros((n1, L), dtype=torch.bool, device=seeds.device)
    frontier[seeds.to(torch.int64), torch.arange(L, device=seeds.device)] = True
    frontier &= live[:, None]  # a dead seed reaches nothing
    visited = frontier.clone()
    levels = None
    if with_levels:
        levels = torch.where(frontier, 0, -1).to(torch.int32)
    for i in range(max_hops):
        nxt = _hop(dev, delta, frontier, live) & ~visited
        if levels is not None:
            levels.masked_fill_(nxt, i + 1)
        visited |= nxt
        frontier = nxt
    return visited, levels


def bfs_levels_delta(dev: DeviceSnapshot, delta: DeviceDelta,
                     seeds: torch.Tensor, max_hops: int,
                     with_levels: bool = True):
    """Batched BFS over base ∪ delta, the contract of ``bfs_levels``:
    ``(levels (K, N+1) int32 or None, visited (K, N+1) bool)``, levels the
    hop distance from each seed (-1 unreached). ``with_levels=False`` skips
    the int32 matrix. Seeds run :data:`DENSE_LANE_BLOCK` at a time."""
    K, n1 = seeds.shape[0], dev.type_of.shape[0]
    visited = torch.empty((K, n1), dtype=torch.bool, device=seeds.device)
    levels = None
    if with_levels:
        levels = torch.empty((K, n1), dtype=torch.int32, device=seeds.device)
    for s in range(0, K, DENSE_LANE_BLOCK):
        v, lv = bfs_delta_lanes(dev, delta, seeds[s : s + DENSE_LANE_BLOCK],
                                max_hops, with_levels)
        visited[s : s + v.shape[1]] = v.T
        if levels is not None:
            levels[s : s + v.shape[1]] = lv.T
    return levels, visited


def _unpack_dead(words: torch.Tensor, n1: int) -> torch.Tensor:
    """(W,) int32 words of packed tombstones (bit b of word w is id 32·w +
    b) → (n1,) bool on the words' device: the host ships N/8 bytes."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[:, None] >> shifts) & 1).to(torch.bool).reshape(-1)[:n1]


def _splice(buf: torch.Tensor, tail: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of ``buf`` with ``tail`` written at ``offset``, on the device:
    the resident buffers of an earlier delta stay as they were."""
    if offset < 0 or offset + tail.shape[0] > buf.shape[0]:
        raise ValueError(f"_splice: {tail.shape[0]} entries at {offset} "
                         f"overrun a buffer of {buf.shape[0]}")
    out = buf.clone()
    out[offset : offset + tail.shape[0]] = tail
    return out


# ------------------------------------------------------------------ memtable


def _padded(xs, size: int, fill: int) -> np.ndarray:
    out = np.full(size, fill, dtype=np.int32)
    out[: len(xs)] = np.asarray(xs, dtype=np.int32)
    return out


class DeltaMemtable:
    """The host memtable of one base epoch and its device delta.

    ``capacity`` is the base's id space ``N``. :meth:`add_link` buffers a
    link record's incidence and target entries, :meth:`remove` tombstones
    an id, and :meth:`device` returns the device delta, refreshed when the
    memtable drifted more than ``max_lag_edges`` entries from what the
    device holds. A refresh pads the edge buffers to a power-of-two bucket
    (at least ``bucket_min``), ships tombstones bit-packed, and uploads only
    the appended tail while the bucket and epoch hold (``tail_uploads``),
    else everything (``full_uploads``). Thread-safe."""

    def __init__(self, capacity: int, bucket_min: int = BUCKET_MIN,
                 device: str | torch.device = DEFAULT_DEVICE):
        self.capacity = int(capacity)
        self.bucket_min = int(bucket_min)
        #: the base epoch the buffers belong to; a move forces a full upload
        self.epoch = 0
        self.torch_device = resolve_device(device)
        self._lock = threading.RLock()
        self._cols: dict[str, list[int]] = {c: [] for c in COLUMNS}
        self._dead: set[int] = set()
        self._delta_dirty = True
        self._device_delta: Optional[DeviceDelta] = None
        self._uploaded_marker = (-1, -1, -1)
        #: an id or target at or past ``capacity`` arrived: the device
        #: cannot see it until the base is repacked
        self.needs_recompact = False
        self.full_uploads = 0
        self.tail_uploads = 0

    @property
    def delta_edges(self) -> int:
        with self._lock:
            return len(self._cols["inc_links"])

    def add_link(self, h: int, targets) -> bool:
        """Buffer link ``h``'s entries, (t ← h) and (h → t) per target, and
        lift a tombstone on ``h``. Returns False, buffering nothing and
        setting ``needs_recompact``, when ``h`` or a target is outside the
        capacity."""
        h = int(h)
        targets = [int(t) for t in targets]
        with self._lock:
            if h >= self.capacity or any(t >= self.capacity for t in targets):
                self.needs_recompact = True
                return False
            c = self._cols
            for t in targets:
                c["inc_links"].append(h)
                c["inc_src"].append(t)
                c["tgt_flat"].append(t)
                c["tgt_src"].append(h)
            self._dead.discard(h)
            self._delta_dirty = True
            return True

    def remove(self, h: int) -> None:
        """Tombstone id ``h`` (ignored outside the capacity)."""
        h = int(h)
        with self._lock:
            if h < self.capacity:
                self._dead.add(h)
                self._delta_dirty = True

    def device(self, max_lag_edges: int = 0) -> DeviceDelta:
        """The device delta, re-uploaded first when the epoch moved or the
        memtable drifted more than ``max_lag_edges`` edge entries plus
        tombstones from what was last uploaded."""
        with self._lock:
            marker = (self.epoch, len(self._cols["inc_links"]),
                      len(self._dead))
            stale = (self._device_delta is None
                     or marker[0] != self._uploaded_marker[0])
            if not stale and self._delta_dirty:
                drift = (marker[1] - self._uploaded_marker[1]
                         + marker[2] - self._uploaded_marker[2])
                stale = drift > max_lag_edges
            if stale:
                self._refresh_locked(marker)
            return self._device_delta

    def _refresh_locked(self, marker) -> None:
        N, dev = self.capacity, self.torch_device
        cur_len = marker[1]
        bucket = _bucket(max(cur_len, 1), minimum=self.bucket_min)

        n_pad = -(-(N + 1) // 32) * 32
        dead_bits = np.zeros(n_pad, dtype=bool)
        if self._dead:
            dd = np.fromiter(self._dead, dtype=np.int64)
            dead_bits[dd[dd <= N]] = True
        words = np.packbits(dead_bits.reshape(-1, 32), axis=-1,
                            bitorder="little").view("<u4").reshape(-1)
        dead = _unpack_dead(torch.from_numpy(words.view(np.int32)).to(dev),
                            N + 1)

        prev = self._device_delta
        old_len = self._uploaded_marker[1]
        tail_n = max(cur_len - old_len, 0)
        # the tail pads to a coarse bucket with the buffers' own fill, and
        # must fit as is: a splice never moves its start
        t_pad = _bucket(max(tail_n, 1), minimum=256)
        can_append = (
            prev is not None
            and marker[0] == self._uploaded_marker[0]
            and prev.inc_links.shape[0] == bucket
            and old_len <= cur_len
            and old_len + t_pad <= bucket
        )
        if can_append and tail_n:
            cols = {c: _splice(getattr(prev, c), torch.from_numpy(_padded(
                        self._cols[c][old_len:cur_len], t_pad, N)).to(dev),
                        old_len)
                    for c in COLUMNS}
            self.tail_uploads += 1
        elif can_append:
            cols = {c: getattr(prev, c) for c in COLUMNS}
        else:
            cols = {c: torch.from_numpy(
                        _padded(self._cols[c], bucket, N)).to(dev)
                    for c in COLUMNS}
            self.full_uploads += 1
        self._device_delta = DeviceDelta(dead=dead, **cols)
        self._delta_dirty = False
        self._uploaded_marker = marker

    def host_delta(self) -> dict:
        """The memtable as host arrays, captured under one lock: the epoch,
        the capacity, the four unpadded COO columns (int32) and the dead ids
        (int64): the shape of the reference's ``host_delta()``."""
        with self._lock:
            out = {"epoch": self.epoch, "capacity": self.capacity}
            for c in COLUMNS:
                out[c] = np.asarray(self._cols[c], dtype=np.int32)
            out["dead"] = (np.fromiter(self._dead, dtype=np.int64)
                           if self._dead else np.empty(0, dtype=np.int64))
            return out


def delta_from_reference(arrays: dict,
                         device: str | torch.device = DEFAULT_DEVICE
                         ) -> DeviceDelta:
    """A :class:`DeviceDelta` from another implementation's delta, given as
    numpy arrays: either a device delta's five arrays (``dead`` an (N+1,)
    bool mask, the columns already padded with ``N``) or a ``host_delta()``
    dict (``capacity`` N, unpadded columns, ``dead`` a list of ids), whose
    columns pad to a power-of-two bucket of at least :data:`BUCKET_MIN`.
    Raises on an entry outside ``[0, N]`` or columns of unequal pairs."""
    dev = resolve_device(device)
    cols = {c: np.asarray(arrays[c]).astype(np.int64) for c in COLUMNS}
    if "capacity" in arrays:
        N = int(arrays["capacity"])
        size = _bucket(max(len(cols["inc_links"]), len(cols["tgt_flat"]), 1),
                       minimum=BUCKET_MIN)
        dead = np.zeros(N + 1, dtype=bool)
        ids = np.asarray(arrays["dead"], dtype=np.int64)
        dead[ids[(ids >= 0) & (ids <= N)]] = True
    else:
        dead = np.array(arrays["dead"], dtype=bool)
        N, size = dead.shape[0] - 1, None
    for a, b in (("inc_links", "inc_src"), ("tgt_flat", "tgt_src")):
        if cols[a].shape != cols[b].shape or cols[a].ndim != 1:
            raise ValueError(f"delta_from_reference: {a} and {b} must be "
                             f"1-D and of one length")
    for c, v in cols.items():
        if len(v) and (v.min() < 0 or v.max() > N):
            raise ValueError(f"delta_from_reference: {c} has entries "
                             f"outside [0, {N}]")

    def put(v):
        if size is not None:
            v = _padded(v, size, N)
        return torch.from_numpy(np.ascontiguousarray(v, dtype=np.int32)).to(dev)

    return DeviceDelta(dead=torch.from_numpy(dead).to(dev),
                       **{c: put(v) for c, v in cols.items()})
