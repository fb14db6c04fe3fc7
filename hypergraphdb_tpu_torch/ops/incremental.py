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
  drift rules.
- :class:`SnapshotManager` wraps one memtable per base epoch around a
  graph (``core/graph.py``): it listens to the graph's events, compacts
  (extract under the commit lock, assemble without it, swap), and hands
  out (base, delta) device pairs and :class:`PinnedView` read units; with
  a mesh attached (``attach_mesh``) a view may carry the row-sharded twins
  of ``parallel/sharded`` instead, re-sharded once an epoch.

The dense sweep keeps the reference's results, not its layout. The
reference holds a (K, N+1) bool frontier and gathers a (K, E) bool array
per relation: 49 GB at 1024 seeds over 10M atoms. Here seed lanes run in
blocks of at most :data:`DENSE_LANE_BLOCK`, each an (N+1, lanes) bool
frontier whose rows are atoms, through ``frontier.scatter_relation`` (edge
chunks, ``uint8`` views, padding skipped). Plain PyTorch: the reference
has no Pallas kernel on this path.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from hypergraphdb_tpu_torch import verify as hgverify
from hypergraphdb_tpu_torch.core import events as ev
from hypergraphdb_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from hypergraphdb_tpu_torch.obs.flight import global_flight
from hypergraphdb_tpu_torch.obs.trace import global_tracer
from hypergraphdb_tpu_torch.ops.frontier import scatter_relation
from hypergraphdb_tpu_torch.ops.setops import _bucket
from hypergraphdb_tpu_torch.ops.snapshot import (
    CSRSnapshot,
    DeviceSnapshot,
    cached_index64,
)

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
    #: real entries of each relation, the rest padding (None: all real)
    n_inc: Optional[int] = None
    n_tgt: Optional[int] = None

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
    N = dev.num_atoms
    la = torch.zeros_like(f)
    for holder in (dev, delta):
        scatter_relation(la, holder, "inc_links", "inc_src", f, holder.n_inc)
    la &= live[:, None]  # dead links emit nothing
    nb = torch.zeros_like(f)
    for holder in (dev, delta):
        scatter_relation(nb, holder, "tgt_flat", "tgt_src", la, holder.n_tgt)
    nb &= live[:, None]
    nb[N] = False
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
    frontier.index_put_((seeds.to(torch.int64),
                         torch.arange(L, device=seeds.device)),
                        torch.ones(L, dtype=torch.bool, device=seeds.device))
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


@hgverify.entry(
    shapes=lambda device, seed: (hgverify.dev_snapshot_exemplar(device, seed),
                                 hgverify.device_delta_exemplar(device, seed),
                                 hgverify.seeds_exemplar(device, seed, 8)),
    statics={"max_hops": 2, "with_levels": True},
)
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
                 device: str | torch.device = DEFAULT_DEVICE, epoch: int = 0):
        self.capacity = int(capacity)
        self.bucket_min = int(bucket_min)
        #: the base epoch the buffers belong to; a move forces a full upload
        self.epoch = int(epoch)
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

    def dead(self) -> set:
        """A copy of the tombstoned ids."""
        with self._lock:
            return set(self._dead)

    @property
    def n_dead(self) -> int:
        with self._lock:
            return len(self._dead)

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
        self._device_delta = DeviceDelta(dead=dead, n_inc=cur_len,
                                         n_tgt=cur_len, **cols)
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

    n = {} if size is None else {"n_inc": len(cols["inc_links"]),
                                 "n_tgt": len(cols["tgt_flat"])}
    return DeviceDelta(dead=torch.from_numpy(dead).to(dev), **n,
                       **{c: put(v) for c, v in cols.items()})


# ------------------------------------------------------------ the manager


class PinnedView(NamedTuple):
    """One consistent read unit for a serving batch, captured under one
    manager lock: the base snapshot, its device twin, the device delta and
    the host memtable correction sets. A batch built from one view never
    straddles a compaction swap. With ``host_delta`` asked for, the
    memtable's host arrays (:meth:`DeltaMemtable.host_delta`) captured in
    the same lock hold, after the device delta's refresh."""

    base: CSRSnapshot
    device: DeviceSnapshot
    delta: Optional[DeviceDelta]  # None when pinned with sync_delta=False
    epoch: int          # compaction count the pair belongs to
    dead: set           # tombstoned ids not yet baked into the base
    new_atoms: list     # handles added since the base pack, commit order
    revalued: set       # atoms whose value was replaced since the pack
    host_delta: Optional[dict] = None
    #: the row-sharded twins of a ``sharded=True`` view (``attach_mesh``):
    #: ``parallel.sharded.ShardedSnapshot`` and ``ShardedDelta``
    sharded_base: object = None
    sharded_delta: object = None

    def factorized_join_rels(self):
        """The join engine's prefix-grouped (trie) relation encodings for
        this view's base epoch — ``ops/join.factorized_relations``'s
        build, cached on the base snapshot like the device twin and the
        co-incidence CSR, so every view pinned within one epoch shares one
        build and a compaction swap invalidates them together. None until
        someone (the serve tier's plan step, or prewarm) builds them;
        readers treat None as "serve flat"."""
        return getattr(self.base, "_fact_rels", None)


class SnapshotManager:
    """The (base, delta) pair of one graph: an immutable packed base on
    the device and a memtable of what committed since, merged at read
    time (the LSM read model). Readers never stall on ingest: with
    ``background=True`` a compaction holds the commit lock only to extract
    the store's tables, and assembles the new base in a worker thread
    while readers keep the old epoch's pair.

    Each base epoch has its own :class:`DeltaMemtable` (its ``epoch`` the
    compaction count), so a device delta of one epoch can never pair with
    another epoch's base.

    Locks: commit lock → manager lock → memtable lock, everywhere. Event
    handlers run on the committing thread and take only the manager lock;
    they never start a compaction (a flag defers it to the next read).

    Device: every twin and delta lives on ``device``, the card unless the
    caller asks for the CPU. A compaction uploads the new base's twin on
    the compaction thread, before the swap, on the default stream: every
    kernel of the port runs there, so a reader's later launches are ordered
    after the upload, and the caching allocator reuses an old base's memory
    only for work queued after the reader's. A reader keeps its
    :class:`PinnedView` (the tensors it reads) until its batch has
    synchronised."""

    def __init__(self, graph, headroom: float = 2.0,
                 compact_ratio: float = 0.5, background: bool = False,
                 delta_bucket_min: int = BUCKET_MIN,
                 pack_pad_multiple: int = 128,
                 device: str | torch.device = DEFAULT_DEVICE):
        self.graph = graph
        self.headroom = headroom
        self.compact_ratio = compact_ratio
        self.background = background
        #: the delta buckets' floor: a large one keeps one device shape
        #: over a whole stream
        self.delta_bucket_min = delta_bucket_min
        #: id capacity and edge arrays round up to this multiple, so
        #: successive bases keep their shapes
        self.pack_pad_multiple = pack_pad_multiple
        self.torch_device = resolve_device(device)
        #: per pass: extract_s (commit lock held), assemble_swap_s,
        #: total_s; entry 0 is the first pack
        self.compaction_stats: list[dict] = []
        self.base: Optional[CSRSnapshot] = None
        self._lock = threading.RLock()
        self._compact_cv = threading.Condition(self._lock)
        self._compacting = False
        self._compact_thread = None
        self._mt = DeltaMemtable(0, delta_bucket_min, self.torch_device)
        self._new_atoms: list[int] = []   # handles added since the pack
        self._revalued: set[int] = set()
        self._device_delta: Optional[DeviceDelta] = None
        self._uploads_before = (0, 0)     # full, tail of retired memtables
        self._uploaded_atoms = 0
        self._pack_highwater = 0
        self.compactions = 0
        #: kind -> the cached delta value column (see value_delta)
        self._value_delta: dict = {}
        # the mesh twins (attach_mesh): the sharded base is rebuilt once an
        # epoch outside the lock, the sharded delta re-split from the
        # memtable under the device delta's drift rule
        self._mesh = None
        self._shard_edge_chunk = 1 << 16
        self._shard_delta_chunk = 4096
        self._sharded_base = None
        self._sharded_epoch = -1
        self._sharded_delta = None
        self._sharded_marker = (-1, -1, -1)
        self._events = ((ev.HGAtomAddedEvent, self._on_added),
                        (ev.HGAtomRemovedEvent, self._on_removed),
                        (ev.HGAtomReplacedEvent, self._on_replaced))
        for cls, fn in self._events:
            graph.events.add_listener(cls, fn)
        self._compact_sync()

    def close(self) -> None:
        """Wait for a compaction in flight and detach from the graph's
        events."""
        t = self._compact_thread
        if t is not None and t.is_alive():
            t.join()
        for cls, fn in self._events:
            self.graph.events.remove_listener(cls, fn)

    @property
    def full_uploads(self) -> int:
        return self._uploads_before[0] + self._mt.full_uploads

    @property
    def tail_uploads(self) -> int:
        return self._uploads_before[1] + self._mt.tail_uploads

    @property
    def _needs_recompact(self) -> bool:
        return self._mt.needs_recompact

    # -- event intake -----------------------------------------------------
    def _packed_locked(self, h: int, base=None) -> bool:
        """Whether ``base`` (the current one by default) holds atom ``h``.
        A handle under the high-water mark need not be packed: its
        transaction took the handle before the extraction and committed
        after it."""
        tp = (base or self.base).type_of
        return h < len(tp) and int(tp[h]) >= 0

    def _on_added(self, g, event) -> None:
        with self._lock:
            h = int(event.handle)
            if h < self._pack_highwater and self._packed_locked(h):
                # an echo of a batch the last compaction already packed
                return
            self._new_atoms.append(h)
            if h >= self._mt.capacity:
                # past the bitmaps: the device cannot see it until the next
                # compaction, which the flag asks the next read for
                self._mt.needs_recompact = True
                return
            self._buffer_edges_locked(g, h)

    def _buffer_edges_locked(self, g, h: int) -> None:
        """Atom ``h``'s record into the memtable (the caller holds the
        manager lock); one outside the capacity flags a compaction."""
        rec = g.store.get_link(h)
        if rec is not None:
            self._mt.add_link(h, rec[3:])

    def _on_removed(self, g, event) -> None:
        with self._lock:
            self._mt.remove(int(event.handle))

    def _on_replaced(self, g, event) -> None:
        # the device value ranks of this atom are stale
        with self._lock:
            self._revalued.add(int(event.handle))

    # -- compaction -------------------------------------------------------
    def _extract_locked(self) -> dict:
        """The store's tables and the memtable's state at extraction. The
        caller holds the commit lock, then the manager lock."""
        g = self.graph
        tables = CSRSnapshot.extract_tables(g)
        return {
            "tables": tables,
            "highwater": tables["peek"],
            "dead_at_extract": self._mt.dead(),
            "revalued_at_extract": set(self._revalued),
            "version": g._mutations,
        }

    def _assemble_and_swap(self, ext: dict) -> None:
        """Assemble and upload the new base without a lock, then swap under
        the manager lock. The new memtable is rebuilt from the store for
        every atom past the high-water mark (ones that committed during the
        assembly, or past the old capacity, are re-derived, not lost);
        removals and replaces recorded after the extraction carry over."""
        g = self.graph
        hw = ext["highwater"]
        pm = self.pack_pad_multiple
        cap = max(int(hw * self.headroom), 1024)
        cap = -(-cap // pm) * pm
        base = CSRSnapshot.pack(g, version=ext["version"], capacity=cap,
                                tables=ext["tables"], pad_multiple=pm)
        twin = base.device(self.torch_device)
        for name in ("inc_links", "tgt_flat"):  # what the dense sweep reads
            twin.index64(name)
        with self._lock:
            old = self._mt
            epoch = self.compactions + 1
            mt = DeltaMemtable(base.num_atoms, self.delta_bucket_min,
                               self.torch_device, epoch=epoch)
            self._mt = mt
            self._uploads_before = (
                self._uploads_before[0] + old.full_uploads,
                self._uploads_before[1] + old.tail_uploads)
            self.base = base
            self._pack_highwater = hw
            # an atom under the high-water mark that the new base lacks
            # and the store holds committed after the extraction: it stays
            # in the memtable (one the store lacks was removed)
            self._new_atoms = [
                h for h in self._new_atoms if h >= hw
                or (not self._packed_locked(h, base)
                    and g.store.get_link(h) is not None)]
            for h in self._new_atoms:
                self._buffer_edges_locked(g, h)
            for h in old.dead() - ext["dead_at_extract"]:
                mt.remove(h)
            self._revalued -= ext["revalued_at_extract"]
            self._device_delta = None
            self._uploaded_atoms = 0
            self._value_delta.clear()
            self.compactions = epoch

    def _compact_sync(self) -> None:
        tracer = global_tracer()
        tr = tracer.start_trace("compact") if tracer.enabled else None
        root = None if tr is None else tr.start_span("compact")
        try:
            t0 = time.perf_counter()
            drain = (None if tr is None
                     else tr.start_span("buffer_drain", parent=root))
            with self.graph.txman._commit_lock:
                with self._lock:
                    ext = self._extract_locked()
            if drain is not None:
                drain.end()
            t1 = time.perf_counter()
            swap = (None if tr is None
                    else tr.start_span("device_swap", parent=root))
            self._assemble_and_swap(ext)
            if swap is not None:
                swap.set(highwater=int(ext["highwater"])).end()
            t2 = time.perf_counter()
        except BaseException as e:
            # a failed pass is the trace worth keeping: it is exported
            # with an error terminal
            if tr is not None:
                tr.finish_error(e, parent=root)
            self.graph.metrics.incr("compact.failures")
            raise
        finally:
            if tr is not None:
                tr.finish()
        self.compaction_stats.append({
            "extract_s": t1 - t0,
            "assemble_swap_s": t2 - t1,
            "total_s": t2 - t0,
        })
        m = self.graph.metrics
        m.incr("compact.passes")
        m.observe("compact.extract_seconds", t1 - t0)
        m.observe("compact.assemble_swap_seconds", t2 - t1)
        fl = global_flight()
        if fl.enabled:
            # the swap is what serving consistency pivots on: an incident
            # dump shows every recent epoch
            fl.record("compact.swap", highwater=int(ext["highwater"]),
                      total_s=t2 - t0)

    def _request_compact(self) -> None:
        if not self.background:
            self._compact_sync()
            return
        with self._lock:
            if self._compacting:
                return
            self._compacting = True

        def work():
            # only this function clears _compacting, after checking that no
            # request coalesced into the flag meanwhile; the catch-up is
            # bounded, so a steady stream cannot keep it running
            try:
                for _ in range(4):
                    self._compact_sync()
                    with self._lock:
                        if not self._needs_recompact:
                            break
            finally:
                with self._compact_cv:
                    self._compacting = False
                    self._compact_cv.notify_all()

        t = threading.Thread(target=work, name="hgdb-compact", daemon=True)
        with self._lock:
            self._compact_thread = t
        t.start()

    def _maybe_compact(self) -> None:
        with self._lock:
            base_edges = max(self.base.n_edges_inc, 1)
            # every host-corrected set counts, not only edges
            memtable = (len(self._new_atoms) + len(self._revalued)
                        + self._mt.n_dead)
            need = (
                self._needs_recompact
                or self._mt.delta_edges > (self.compact_ratio * base_edges
                                           + 4096)
                or memtable > (self.compact_ratio
                               * max(self.base.num_atoms, 1) + 4096)
            )
        if need:
            self._request_compact()

    def wait_compacted(self, timeout: Optional[float] = None) -> bool:
        """Block until no compaction is in flight (its catch-up included);
        False on ``timeout`` seconds."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._compact_cv:
            while self._compacting:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._compact_cv.wait(remaining)
            return True

    # -- read views ---------------------------------------------------------
    def _sync_device_delta_locked(self, max_lag_edges: int) -> DeviceDelta:
        """The memtable's device delta, refreshed when it drifted past
        ``max_lag_edges`` (the caller holds the manager lock)."""
        mt = self._mt
        before = (mt.full_uploads, mt.tail_uploads)
        delta = mt.device(max_lag_edges)
        if delta is not self._device_delta:
            m = self.graph.metrics
            if mt.full_uploads != before[0]:
                m.incr("compact.full_uploads")
            elif mt.tail_uploads != before[1]:
                m.incr("compact.tail_uploads")
            m.gauge("compact.delta_edges", mt.delta_edges)
            self._device_delta = delta
            self._uploaded_atoms = len(self._new_atoms)
        return delta

    def device(self, max_lag_edges: int = 0
               ) -> tuple[DeviceSnapshot, DeviceDelta]:
        """The current (base, delta) device pair. ``max_lag_edges`` bounds
        staleness: the delta is re-uploaded only once the memtable drifted
        more than that many entries from what the device holds."""
        self._maybe_compact()
        with self._lock:
            delta = self._sync_device_delta_locked(max_lag_edges)
            return self.base.device(self.torch_device), delta

    # -- the mesh twins ------------------------------------------------------
    def attach_mesh(self, mesh, edge_chunk: int = 1 << 16,
                    delta_edge_chunk: int = 4096) -> None:
        """Give this manager a mesh (``parallel.sharded.Mesh``):
        ``pinned_view(sharded=True)`` then hands out the row-sharded (base,
        delta) twins beside the host correction sets. Attaching another
        mesh drops the sharded state (the next pin re-shards)."""
        with self._lock:
            if self._mesh != mesh:
                self._sharded_base = None
                self._sharded_epoch = -1
                self._sharded_delta = None
                self._sharded_marker = (-1, -1, -1)
            self._mesh = mesh
            self._shard_edge_chunk = edge_chunk
            self._shard_delta_chunk = delta_edge_chunk

    def _sync_sharded_delta_locked(self, max_lag_edges: int):
        """The sharded delta, re-split from the memtable when it drifted
        past ``max_lag_edges`` (the caller holds the manager lock and the
        sharded base is this epoch's): the mesh twin of
        :meth:`_sync_device_delta_locked`. A refresh re-splits the whole
        memtable: the shards' partitions interleave, so no tail splices."""
        from hypergraphdb_tpu_torch.parallel.sharded import shard_host_delta

        mt = self._mt
        marker = (self.compactions, mt.delta_edges, mt.n_dead)
        stale = (self._sharded_delta is None
                 or marker[0] != self._sharded_marker[0])
        if not stale:
            drift = (marker[1] - self._sharded_marker[1]
                     + marker[2] - self._sharded_marker[2])
            stale = drift > max_lag_edges
        if stale:
            self._sharded_delta = shard_host_delta(
                self._sharded_base, mt.host_delta(),
                edge_chunk=self._shard_delta_chunk)
            self._sharded_marker = marker
        return self._sharded_delta

    def _ensure_sharded_base(self) -> None:
        """Make the cached sharded base this epoch's, without the lock:
        sharding is an O(E) split and upload that would stall every
        committing writer. Shard, then swap in only if no compaction moved
        the epoch meanwhile."""
        from hypergraphdb_tpu_torch.parallel.sharded import ShardedSnapshot

        while True:
            with self._lock:
                if self._mesh is None:
                    raise ValueError(
                        "pinned_view(sharded=True) needs attach_mesh first")
                if self._sharded_epoch == self.compactions:
                    return
                base, epoch, mesh = self.base, self.compactions, self._mesh
                chunk = self._shard_edge_chunk
            sbase = ShardedSnapshot.from_host(base, mesh, edge_chunk=chunk,
                                              epoch=epoch)
            with self._lock:
                if self.compactions == epoch and self._mesh == mesh:
                    self._sharded_base = sbase
                    self._sharded_epoch = epoch
                    self._sharded_delta = None
                    self._sharded_marker = (-1, -1, -1)
                    return

    def pinned_view(self, max_lag_edges: int = 0, sync_delta: bool = True,
                    host_delta: bool = False,
                    sharded: bool = False) -> PinnedView:
        """The serving read unit (:class:`PinnedView`). ``sync_delta=False``
        skips the delta refresh (``delta=None``) for readers of the base and
        the host corrections alone; ``host_delta=True`` adds the memtable's
        host arrays.

        ``sharded=True`` (after :meth:`attach_mesh`) fills
        ``sharded_base`` and ``sharded_delta`` with this epoch's row-sharded
        twins, re-sharding the base when a compaction moved the epoch. Such
        a view syncs no single-device delta and leaves ``device`` None; the
        host correction sets are the same."""
        self._maybe_compact()
        while True:
            if sharded:
                self._ensure_sharded_base()
            with self._lock:
                if sharded and self._sharded_epoch != self.compactions:
                    continue  # a compaction swapped mid-shard: re-shard
                sbase = sdelta = delta = None
                if sharded:
                    sbase = self._sharded_base
                    sdelta = self._sync_sharded_delta_locked(max_lag_edges)
                elif sync_delta:
                    delta = self._sync_device_delta_locked(max_lag_edges)
                return PinnedView(
                    base=self.base,
                    device=(None if sharded
                            else self.base.device(self.torch_device)),
                    delta=delta,
                    epoch=self.compactions,
                    dead=self._mt.dead(),
                    new_atoms=list(self._new_atoms),
                    revalued=set(self._revalued),
                    host_delta=self._mt.host_delta() if host_delta else None,
                    sharded_base=sbase,
                    sharded_delta=sdelta,
                )

    def value_delta(self, view: PinnedView, kind: int,
                    max_lag_edges: int = 0):
        """The value index's delta column of one value kind for ``view``:
        its memtable atoms of that kind, sorted, on the device, covering a
        prefix of ``view.new_atoms`` and never more. A cached column serves
        while it falls at most ``max_lag_edges`` atoms short of the view;
        ``view.new_atoms[col.covered:]`` and ``view.revalued`` are the host
        correction the caller owes. Built without the manager lock (it
        walks the store); the cache keeps the widest column."""
        from hypergraphdb_tpu_torch.storage.value_index import (
            build_delta_column,
        )

        kind = int(kind)
        n_view = len(view.new_atoms)
        with self._lock:
            cached = self._value_delta.get(kind)
        if (cached is not None and cached.epoch == view.epoch
                and cached.covered <= n_view
                and n_view - cached.covered <= max_lag_edges):
            return cached
        col = build_delta_column(self.graph, view.new_atoms, kind,
                                 epoch=view.epoch, device=self.torch_device)
        with self._lock:
            prev = self._value_delta.get(kind)
            if (prev is None or prev.epoch != view.epoch
                    or prev.covered < col.covered):
                self._value_delta[kind] = col
        return col

    def host_delta(self) -> dict:
        """The memtable as host arrays: the epoch (compaction count), the
        capacity, the four COO columns and the dead ids."""
        with self._lock:
            return self._mt.host_delta()

    def device_visible_new_atoms(self) -> list[int]:
        """New atoms whose edges the device delta already holds (the
        buffers append in commit order): what a bounded-lag reader may
        expect to see."""
        with self._lock:
            cap = self._mt.capacity
            return [h for h in self._new_atoms[: self._uploaded_atoms]
                    if h < cap]

    def correction(self) -> tuple[set, list, set]:
        """(dead, new_atoms, revalued): what a reader of the base drops
        and re-evaluates on the host."""
        with self._lock:
            return self._mt.dead(), list(self._new_atoms), set(self._revalued)

    def read_view(self) -> tuple[CSRSnapshot, set, list, set]:
        """(base, dead, new_atoms, revalued) under one lock."""
        self._maybe_compact()
        with self._lock:
            return (self.base, self._mt.dead(), list(self._new_atoms),
                    set(self._revalued))

    @property
    def delta_edges(self) -> int:
        with self._lock:
            return self._mt.delta_edges
