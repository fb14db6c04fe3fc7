"""Entry-point registry and checks for the port's device functions.

The port of ``hypergraphdb_tpu/verify.py``, with the checks that
``tools/hgverify`` runs over the reference's jaxprs redone for eager
PyTorch. The device functions of ``ops/`` and ``parallel/`` register here
under the reference's registry names with an exemplar function; the
decorator records the function and returns it unchanged. Nothing is built
at import: an exemplar function runs when a check or a test calls it.

Usage, at a definition site::

    from hypergraphdb_tpu_torch import verify as hgverify

    @hgverify.entry(shapes=lambda device, seed: (
        hgverify.words(device, seed, (64, 1)),))
    def my_op(x): ...

A ``shapes`` function takes ``(device, seed)`` and returns the positional
arguments, or ``(args, kwargs)``; ``statics`` are keyword arguments bound
on every call. JAX traces abstract shapes; torch has no such thing for
data-dependent ops, so the exemplars are small concrete tensors made from
``np.random.default_rng(seed)`` on the device asked for.

The four families, each a function returning :class:`Finding` records:

- HV1xx, host syncs (:func:`check_syncs`): a ``TorchDispatchMode`` records
  every op that makes the host wait on the device or whose output shape
  depends on data (:data:`SYNC_OPS`), at its Python call site in this
  package. A site off :data:`SYNC_ALLOWLIST` fails. On the card
  ``torch.cuda.set_sync_debug_mode("warn")`` does the same job and also
  sees copies between host and device (:func:`sync_site` names the site).
- HV2xx, collectives (:func:`check_collectives`): the calls of
  ``parallel.sharded.all_gather`` and ``psum`` an entry makes, in order,
  with the mesh's axis names. A mesh entry must use its declared axis and
  make the same sequence on exemplars of two seeds; any other entry makes
  none.
- HV3xx, aliasing (:func:`check_aliasing`): an entry declaring ``donate``
  writes those arguments in place and returns a tensor sharing the first
  one's storage; no two outputs share storage; every other input is left
  unchanged.
- HV4xx, op budgets (:func:`check_costs`): each entry's aten op count, the
  bytes of inputs plus outputs summed over its ops and its FLOPs
  (``torch.utils.flop_counter.FlopCounterMode``) at its CPU exemplar,
  held within :data:`COST_TOLERANCE` of ``verify_costs.json``, which only
  :func:`write_costs` with ``update=True`` writes. These are the CPU
  route's plain PyTorch: a CUDA kernel's ``ctypes`` launch is opaque to
  dispatch, so they are not figures of the card.

This module imports torch and numpy only; the entry modules are imported
by :func:`load_entries`.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
from dataclasses import dataclass, fields, is_dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

PKG = "hypergraphdb_tpu_torch"
_PKG_DIR = os.path.dirname(os.path.abspath(__file__))


@dataclass(frozen=True)
class Entry:
    """One registered verification entry point."""

    name: str                  # registry key, e.g. "ops.frontier.bfs_levels"
    fn: Callable               # the function, unchanged
    shapes: Callable           # (device, seed) -> args or (args, kwargs)
    statics: dict              # keyword arguments bound on every call
    mesh: Optional[tuple]      # declared mesh axis names
    donate: tuple              # positions of the arguments written in place
    path: str                  # source file of the function
    line: int                  # first line of the function


class Registry:
    """Ordered, name-keyed entries. :data:`REGISTRY` holds the port's;
    tests build private ones for fixture entries."""

    def __init__(self):
        self._entries: dict[str, Entry] = {}

    def entry(self, name: Optional[str] = None, *,
              shapes: Callable,
              statics: Optional[dict] = None,
              mesh: Optional[Sequence[str]] = None,
              donate=False):
        """Decorator registering ``fn`` under ``name`` (default: its
        ``<module-tail>.<qualname>``). Returns ``fn`` as is. ``donate`` is
        False, True (the first argument) or a tuple of argument positions
        the entry writes in place, the first of them returned."""

        def deco(fn):
            path, line = _source_of(fn)
            key = name or _default_name(fn)
            if key in self._entries:
                raise ValueError(f"verify entry {key!r} registered twice")
            self._entries[key] = Entry(
                name=key, fn=fn, shapes=shapes,
                statics=dict(statics or {}),
                mesh=tuple(mesh) if mesh is not None else None,
                donate=_donated(donate), path=path, line=line,
            )
            return fn

        return deco

    def names(self) -> list:
        return list(self._entries)

    def get(self, name: str) -> Entry:
        return self._entries[name]

    def __iter__(self):
        return iter(self._entries.values())

    def __len__(self):
        return len(self._entries)


#: the port's registry
REGISTRY = Registry()

#: the decorator bound to :data:`REGISTRY`
entry = REGISTRY.entry

#: each reference entry name and the port function registered under it
#: (``<module>.<qualname>`` below the package)
PORT_OF = {
    "ops.frontier.bfs_levels": "ops.frontier.bfs_levels",
    "ops.frontier.reachable": "ops.frontier.reachable",
    "ops.frontier.frontier_edge_counts": "ops.frontier.frontier_edge_counts",
    "ops.bitfrontier.bfs_packed_block": "ops.bitfrontier.bfs_packed_block",
    "ops.pallas_gather.gather_or": "ops.gather_or.gather_or",
    "ops.ellbfs._seed_bitmap": "ops.ellbfs.seed_bitmap",
    "ops.ellbfs._deg_sum": "ops.ellbfs.bitdot",
    "ops.ellbfs._stage": "ops.ellbfs._apply_plan",
    "ops.ellbfs._visited_update": "ops.ellbfs._visited_update",
    "ops.ellbfs._reach_counts": "ops.ellbfs.bitdot",
    "ops.setops.member_mask": "ops.setops.member_mask",
    "ops.setops.segment_member_mask": "ops.setops.segment_member_mask",
    "ops.setops.incident_intersection_ell":
        "ops.setops.incident_intersection_ell",
    "ops.setops.incident_intersection": "ops.setops.incident_intersection",
    "ops.setops.incident_value_range": "ops.setops.incident_value_range",
    "ops.incremental.bfs_levels_delta": "ops.incremental.bfs_levels_delta",
    "ops.pallas_bfs._bfs_fused": "ops.fused_bfs.bfs_fused",
    "ops.serving.bfs_serve_batch": "ops.serving.bfs_serve_batch",
    "ops.serving.bfs_serve_batch_fused": "ops.serving.bfs_serve_batch_fused",
    "ops.serving.pattern_serve_batch": "ops.serving.pattern_serve_batch",
    "ops.join.join_expand_step": "ops.join.join_expand_step",
    "ops.join.join_hub_expand": "ops.join.join_hub_expand",
    "ops.join.join_bag_join": "ops.join.join_bag_join",
    "ops.join.join_finalize": "ops.join.join_finalize",
    "ops.value_index.range_probe_batch": "ops.value_index.range_probe_batch",
    "ops.value_index.ordered_topk_batch":
        "ops.value_index.ordered_topk_batch",
    "parallel.sharded.bfs_packed_sharded":
        "parallel.sharded.bfs_packed_sharded",
    "parallel.sharded.match_candidates_sharded":
        "parallel.sharded.match_candidates_sharded",
    "ops.sharded_serving.bfs_serve_batch_sharded":
        "ops.sharded_serving.bfs_serve_batch_sharded",
    "ops.sharded_serving.pattern_serve_batch_sharded":
        "ops.sharded_serving.pattern_serve_batch_sharded",
}


def load_entries() -> Registry:
    """Import the module of every function of :data:`PORT_OF` (which
    registers it in :data:`REGISTRY`) and return the registry."""
    import importlib

    for m in sorted({f.rsplit(".", 1)[0] for f in PORT_OF.values()}):
        importlib.import_module(f"{PKG}.{m}")
    return REGISTRY


def _donated(donate) -> tuple:
    if donate is True:
        return (0,)
    if not donate:
        return ()
    return tuple(int(i) for i in donate)


def _source_of(fn) -> tuple:
    code = getattr(fn, "__code__", None)
    if code is None:
        return "<unknown>", 0
    return code.co_filename, code.co_firstlineno


def _default_name(fn) -> str:
    """``<module>.<qualname>`` of ``fn`` below the package."""
    mod = getattr(fn, "__module__", "") or ""
    tail = mod.split(PKG + ".")[-1] if mod else "<mod>"
    return f"{tail}.{getattr(fn, '__qualname__', repr(fn))}"


# ---------------------------------------------------------------- exemplars


def tensor(a, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def ints(device, seed: int, shape, high: int, low: int = 0) -> torch.Tensor:
    """Random int32 in ``[low, high)``."""
    r = np.random.default_rng(seed)
    return tensor(r.integers(low, high, size=shape).astype(np.int32), device)


def words(device, seed: int, shape, density: float = 0.3) -> torch.Tensor:
    """Random packed bit words (the port's int32 view of uint32), each bit
    set with probability ``density``."""
    r = np.random.default_rng(seed)
    bits = r.random(tuple(shape) + (32,)) < density
    w = np.packbits(bits, axis=-1, bitorder="little").view("<u4")
    return tensor(w.reshape(shape).view(np.int32), device)


def snapshot_tables(seed: int = 0, n_nodes: int = 20, n_links: int = 11,
                    max_arity: int = 5, n_types: int = 4) -> dict:
    """The columnar tables of a small random hypergraph: ``n_nodes`` nodes
    then ``n_links`` links of arity 2..``max_arity`` over the nodes (the
    default 31 atoms stay inside 64 relation entries); node types
    ``0..n_types-2``, links of type ``n_types-1``; every atom an int
    value (kind ``i``) with a random rank below 64."""
    r = np.random.default_rng(seed)
    N = n_nodes + n_links
    type_of = np.full(N, n_types - 1, dtype=np.int32)
    type_of[:n_nodes] = r.integers(0, n_types - 1, size=n_nodes)
    is_link = np.zeros(N, dtype=bool)
    is_link[n_nodes:] = True
    arities = r.integers(2, max_arity + 1, size=n_links)
    offsets = np.zeros(N + 1, dtype=np.int64)
    offsets[n_nodes + 1:] = np.cumsum(arities)
    flat = np.concatenate([r.choice(n_nodes, size=a, replace=False)
                           for a in arities]).astype(np.int64)
    return {
        "type_of": type_of, "is_link": is_link, "tgt_offsets": offsets,
        "tgt_flat": flat,
        "value_rank": r.integers(0, 64, size=N).astype(np.uint64),
        "value_kind": np.full(N, ord("i"), dtype=np.uint8),
        "value_rank2": np.zeros(N, dtype=np.uint64),
        "value_ambig": np.zeros(N, dtype=bool),
    }


#: relation padding of the exemplar snapshots: 64-entry relations
SNAPSHOT_PAD = 64


def host_snapshot_exemplar(seed: int = 0, **kw):
    """The port's host ``CSRSnapshot`` of :func:`snapshot_tables`."""
    from hypergraphdb_tpu_torch.ops.snapshot import CSRSnapshot

    return CSRSnapshot.from_tables(**snapshot_tables(seed, **kw),
                                   pad_multiple=SNAPSHOT_PAD)


def dev_snapshot_exemplar(device, seed: int = 0):
    """A ``DeviceSnapshot`` of 31 atoms plus the dummy row, 64-entry
    relations, on ``device``."""
    from hypergraphdb_tpu_torch.ops.snapshot import DeviceSnapshot

    return DeviceSnapshot.from_host(host_snapshot_exemplar(seed), device)


def seeds_exemplar(device, seed: int, k: int, n_atoms: int = 31):
    """``k`` int32 seed ids below ``n_atoms``."""
    return ints(device, seed + 101, (k,), n_atoms)


def pattern_anchors(seed: int, k: int = 4) -> np.ndarray:
    """(k, 2) int32 anchor pairs of :func:`host_snapshot_exemplar`'s
    graph (:func:`pattern_anchors_of`)."""
    return pattern_anchors_of(host_snapshot_exemplar(seed), seed, k)


def pattern_anchors_of(snap, seed: int, k: int) -> np.ndarray:
    """(k, 2) int32 anchor pairs, each two targets of one link of
    ``snap``, the one with the smaller incidence row first (the ELL
    lane's contract)."""
    r = np.random.default_rng(seed + 7)
    N = snap.num_atoms
    links = np.flatnonzero(snap.is_link[:N])
    deg = np.diff(snap.inc_offsets[: N + 2])
    out = np.zeros((k, 2), dtype=np.int32)
    for i in range(k):
        lk = int(r.choice(links))
        ts = snap.tgt_flat[snap.tgt_offsets[lk]: snap.tgt_offsets[lk + 1]]
        a, b = (int(x) for x in r.choice(ts, size=2, replace=False))
        out[i] = (a, b) if deg[a] <= deg[b] else (b, a)
    return out


def ell_exemplar(device, seed: int = 0):
    """The (32, W) ELL target matrix of the exemplar snapshot."""
    from hypergraphdb_tpu_torch.ops.setops import ell_targets

    return ell_targets(host_snapshot_exemplar(seed), device)


def delta_arrays(seed: int = 0, n_atoms: int = 31, d: int = 16) -> dict:
    """A delta's five device arrays over :func:`snapshot_tables`'s id
    space: a few new target entries of existing links (each with its
    incidence twin), padded to ``d`` with the dummy row, and one
    tombstone."""
    tables = snapshot_tables(seed)
    r = np.random.default_rng(seed + 11)
    links = np.flatnonzero(tables["is_link"])
    n_nodes = int((~tables["is_link"]).sum())
    n = d // 2
    tl = r.choice(links, size=n).astype(np.int32)
    tt = r.integers(0, n_nodes, size=n).astype(np.int32)
    pad = np.full(d - n, n_atoms, dtype=np.int32)
    dead = np.zeros(n_atoms + 1, dtype=bool)
    dead[int(r.integers(0, n_nodes))] = True
    return {
        "inc_links": np.concatenate([tl, pad]),
        "inc_src": np.concatenate([tt, pad]),
        "tgt_flat": np.concatenate([tt, pad]),
        "tgt_src": np.concatenate([tl, pad]),
        "dead": dead,
    }


def device_delta_exemplar(device, seed: int = 0):
    """A ``DeviceDelta`` of d = 16 entries matching
    :func:`dev_snapshot_exemplar`'s id space."""
    from hypergraphdb_tpu_torch.ops.incremental import delta_from_reference

    return delta_from_reference(delta_arrays(seed), device)


def fused_exemplar(device, seed: int = 0):
    """``(DeviceFusedPlan, FusedGeom)`` of the exemplar snapshot."""
    from hypergraphdb_tpu_torch.ops.fused_bfs import device_fused_plan

    return device_fused_plan(host_snapshot_exemplar(seed), device)


#: the sharded exemplar: 4 shards of 128 ids, 28 of the last range past
#: the id space (a ragged tail exercises the valid mask)
SHARDS, N_LOC = 4, 128
SHARDED_ATOMS = SHARDS * N_LOC - 28


def sharded_host_exemplar(seed: int = 0):
    """The host snapshot the sharded exemplars split: 484 atoms."""
    n_links = 84
    return host_snapshot_exemplar(seed, n_nodes=SHARDED_ATOMS - n_links,
                                  n_links=n_links, max_arity=4)


def exemplar_mesh(device):
    """A 4-shard mesh that repeats ``device``."""
    from hypergraphdb_tpu_torch.parallel.sharded import make_mesh

    return make_mesh([device] * SHARDS)


def sharded_seeds(device, seed: int, k: int) -> torch.Tensor:
    """``k`` int32 seeds of the sharded exemplar, each a target of some
    link (most of its nodes have no link)."""
    snap = sharded_host_exemplar(seed)
    r = np.random.default_rng(seed + 101)
    pool = snap.tgt_flat[: snap.n_edges_tgt]
    return tensor(r.choice(pool, size=k).astype(np.int32), device)


def sharded_snapshot_exemplar(device, seed: int = 0, e_loc: int = 64):
    """A ``ShardedSnapshot`` of :func:`sharded_host_exemplar` over
    :func:`exemplar_mesh`, ``n_loc`` 128, edge slices of ``e_loc``."""
    from hypergraphdb_tpu_torch.parallel.sharded import ShardedSnapshot

    return ShardedSnapshot.from_host(sharded_host_exemplar(seed),
                                     exemplar_mesh(device), edge_chunk=e_loc)


def sharded_delta_host(seed: int = 0, d: int = 16) -> dict:
    """A ``host_delta()``-shaped dict over the sharded exemplar's id
    space: ``d`` new target entries of existing links with their
    incidence twins, and two tombstones."""
    snap = sharded_host_exemplar(seed)
    r = np.random.default_rng(seed + 13)
    N = snap.num_atoms
    links = np.flatnonzero(snap.is_link[:N])
    n_nodes = N - len(links)
    tl = r.choice(links, size=d).astype(np.int32)
    tt = r.integers(0, n_nodes, size=d).astype(np.int32)
    return {"capacity": N, "epoch": 0, "inc_links": tl, "inc_src": tt,
            "tgt_flat": tt, "tgt_src": tl,
            "dead": sorted(int(x) for x in r.choice(n_nodes, 2, False))}


def sharded_delta_exemplar(device, seed: int = 0, sdev=None, d_loc: int = 16):
    """A ``ShardedDelta`` of :func:`sharded_delta_host` over the sharded
    exemplar, delta slices of ``d_loc``."""
    from hypergraphdb_tpu_torch.parallel.sharded import shard_host_delta

    if sdev is None:
        sdev = sharded_snapshot_exemplar(device, seed)
    return shard_host_delta(sdev, sharded_delta_host(seed), edge_chunk=d_loc)


def _sentinel() -> int:
    from hypergraphdb_tpu_torch.ops.setops import SENTINEL

    return int(SENTINEL)


def sorted_rows(seed: int, n_rows: int, width: int,
                high: int) -> np.ndarray:
    """(n_rows, width) int32 rows of distinct sorted ids below ``high``,
    each SENTINEL-padded past a random length."""
    r = np.random.default_rng(seed)
    out = np.full((n_rows, width), _sentinel(), dtype=np.int32)
    for i in range(n_rows):
        n = int(r.integers(width // 2, width + 1))
        out[i, :n] = np.sort(r.choice(high, size=n, replace=False))
    return out


def member_args(device, seed: int = 0) -> tuple:
    """``(sorted_ref (16,), queries (16,))`` of ``setops.member_mask``."""
    r = np.random.default_rng(seed + 17)
    q = r.integers(0, 64, size=16).astype(np.int32)
    q[-2:] = _sentinel()
    return (tensor(sorted_rows(seed, 1, 16, 64)[0], device), tensor(q, device))


def segment_args(device, seed: int = 0) -> tuple:
    """``(flat (64,), starts (4,), ends (4,), queries (4, 8))`` of
    ``setops.segment_member_mask``: four sorted segments of at most 16."""
    r = np.random.default_rng(seed + 19)
    flat = np.sort(r.integers(0, 64, size=(4, 16)), axis=1).reshape(-1)
    starts = np.arange(0, 64, 16, dtype=np.int32)
    ends = starts + r.integers(0, 17, size=4).astype(np.int32)
    q = r.integers(0, 64, size=(4, 8)).astype(np.int32)
    q[:, -1] = _sentinel()
    return tuple(tensor(a, device) for a in (flat.astype(np.int32), starts,
                                             ends, q))


def fused_args(device, seed: int = 0, k: int = 32) -> tuple:
    """``(plan, seeds (k,), geom)`` of the exemplar snapshot's fused plan,
    the last lane a pad lane at the dummy row."""
    plan, geom = fused_exemplar(device, seed)
    seeds = seeds_exemplar(device, seed, k)
    seeds[-1] = geom.n_atoms
    return plan, seeds, geom


def pattern_type_vec(device, k: int = 4) -> torch.Tensor:
    """Per-request type handles: any type (-1) and the link type, in
    turn."""
    return tensor(np.array([-1, 3] * (k // 2), dtype=np.int32), device)


def join_args(device, seed: int = 0) -> tuple:
    """The positional arguments of ``ops.join.join_expand_step`` and
    ``join_hub_expand``: the exemplar's incidence CSR as the expansion
    relation and as the one filter (candidates: the links incident to
    the constant and to column 0), 8 binding rows of 4 lanes."""
    snap = host_snapshot_exemplar(seed)
    r = np.random.default_rng(seed + 23)
    n1 = snap.num_atoms + 1
    off = snap.inc_offsets[: n1 + 1].astype(np.int32)
    flat = snap.inc_links.astype(np.int32)
    cols = r.integers(0, 20, size=(8, 1)).astype(np.int32)
    lanes = np.sort(r.integers(0, 4, size=8)).astype(np.int32)
    valid = r.random(8) < 0.8
    consts = r.integers(0, 20, size=(4, 2)).astype(np.int32)
    t = lambda a: tensor(a, device)  # noqa: E731
    return (t(off), t(flat), t(cols), t(lanes), t(valid), t(consts),
            (t(off),), (t(flat),), t(snap.type_of[:n1]))


def bag_args(device, seed: int = 0) -> tuple:
    """``(cols, lanes, valid, bag_cols, bag_lanes, bag_valid)`` of 16 rows
    each, lanes grouped, for ``ops.join.join_bag_join``."""
    r = np.random.default_rng(seed + 29)
    out = []
    for _ in range(2):
        out += [r.integers(0, 31, size=(16, 1)).astype(np.int32),
                np.sort(r.integers(0, 4, size=16)).astype(np.int32),
                r.random(16) < 0.8]
    return tuple(tensor(a, device) for a in out)


def finalize_args(device, seed: int = 0) -> tuple:
    """``(cols (16, 2), lanes, valid)`` of ``ops.join.join_finalize``."""
    r = np.random.default_rng(seed + 31)
    return (tensor(r.integers(0, 31, size=(16, 2)).astype(np.int32), device),
            tensor(np.sort(r.integers(0, 4, size=16)).astype(np.int32),
                   device),
            tensor(r.random(16) < 0.8, device))


def value_columns_exemplar(device, seed: int = 0) -> tuple:
    """``(base, delta)`` value index columns of the exemplar snapshot's
    atoms, about a third of them in the delta (64 and 32 slots)."""
    from hypergraphdb_tpu_torch.storage.value_index import (
        _sorted_device_column,
    )

    snap = host_snapshot_exemplar(seed)
    N = snap.num_atoms
    r = np.random.default_rng(seed + 37)
    ids = np.arange(N)
    in_delta = r.random(N) < 0.3
    return tuple(_sorted_device_column(
        ord("i"), snap.value_rank[g], g.astype(np.int32), minimum=m,
        ranks2=snap.value_rank2[g], device=device)
        for g, m in ((ids[~in_delta], 64), (ids[in_delta], 32)))


def range_bounds(seed: int = 0, n_lanes: int = 8) -> dict:
    """Host bounds of 7 range requests in 8 lanes (``lane_bounds``):
    windows over the exemplar's ranks, one open, types and anchors on
    some lanes, both orders."""
    from hypergraphdb_tpu_torch.ops.value_index import lane_bounds

    r = np.random.default_rng(seed + 41)
    n = n_lanes - 1
    lo, hi = np.sort(r.integers(0, 64, size=(n, 2)), axis=1).T
    lo, hi = lo.astype(np.uint64), hi.astype(np.uint64)
    hi[0] = np.uint64(2**64 - 1)
    return lane_bounds(
        n_lanes, lo, r.random(n) < 0.5, hi, r.random(n) < 0.5,
        hi2=np.where(np.arange(n) == 0, np.uint64(2**64 - 1),
                     np.uint64(0)),
        type_vec=np.where(r.random(n) < 0.4, r.integers(0, 3, size=n), -1),
        anchor=np.where(r.random(n) < 0.4, r.integers(0, 20, size=n), -1),
        desc=r.random(n) < 0.5)


def bound_tensors(b: dict, device, keys: Sequence[str]) -> tuple:
    """The bound arrays of ``keys`` as tensors."""
    return tuple(tensor(b[k], device) for k in keys)


def match_args(device, seed: int = 0) -> tuple:
    """``(sdev, candidates (64,), anchor_rows (2, 16))`` of
    ``parallel.sharded.match_candidates_sharded``: the first 64 links of
    the sharded exemplar, and two incidence rows, SENTINEL-padded."""
    snap = sharded_host_exemplar(seed)
    N = snap.num_atoms
    r = np.random.default_rng(seed + 43)
    cand = np.flatnonzero(snap.is_link[:N])[:64].astype(np.int32)
    rows = np.full((2, 16), _sentinel(), dtype=np.int32)
    for i, a in enumerate(r.choice(N - 84, size=2, replace=False)):
        row = snap.incidence_row(int(a))[:16]
        rows[i, : len(row)] = row
    return sharded_snapshot_exemplar(device, seed), cand, rows


def pattern_sharded_args(device, seed: int = 0) -> tuple:
    """The mesh carrier and the host rows ``sharded_serving
    .pattern_host_rows`` assembles for 8 anchor pairs of the sharded
    exemplar (16 candidate slots), with per-lane types."""
    from hypergraphdb_tpu_torch.ops.sharded_serving import (
        mesh_carrier,
        pattern_host_rows,
    )

    snap = sharded_host_exemplar(seed)
    anchors = pattern_anchors_of(snap, seed, 8)
    rows0, types0, tgt = pattern_host_rows(snap, anchors, 16, SHARDS)
    type_vec = np.array([-1, 3] * 4, dtype=np.int32)
    return (mesh_carrier(exemplar_mesh(device)), rows0, types0, tgt, anchors,
            type_vec)


def exemplar(e: Entry, device, seed: int = 0) -> tuple:
    """``(args, kwargs)`` of entry ``e`` at seed ``seed`` on ``device``,
    statics included."""
    out = e.shapes(device, seed)
    if (isinstance(out, tuple) and len(out) == 2
            and isinstance(out[0], tuple) and isinstance(out[1], dict)):
        args, kwargs = out
    else:
        args, kwargs = tuple(out), {}
    return args, {**kwargs, **e.statics}


def run(e: Entry, device="cpu", seed: int = 0):
    """Entry ``e`` called once at its exemplar."""
    args, kwargs = exemplar(e, device, seed)
    return e.fn(*args, **kwargs)


# ----------------------------------------------------------------- findings


@dataclass(frozen=True)
class Finding:
    """One failed check: its code (HV1xx..HV4xx), the entry and what."""

    code: str
    entry: str
    message: str
    site: str = ""

    def render(self) -> str:
        at = f" at {self.site}" if self.site else ""
        return f"{self.code} {self.entry}{at}: {self.message}"


def tensors_of(obj) -> list:
    """Every tensor in ``obj``: tuples, lists, dicts and dataclasses are
    walked, in order."""
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for x in obj for t in tensors_of(x)]
    if isinstance(obj, dict):
        return [t for x in obj.values() for t in tensors_of(x)]
    if is_dataclass(obj) and not isinstance(obj, type):
        return [t for f in fields(obj)
                for t in tensors_of(getattr(obj, f.name))]
    return []


# ------------------------------------------------------------ HV1xx: syncs

#: aten ops that make the host wait on the device, or whose output shape
#: depends on the data (the host must read it to allocate)
SYNC_OPS = frozenset({
    "aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select",
    "aten::_unique", "aten::_unique2", "aten::unique_dim",
    "aten::unique_consecutive", "aten::bincount", "aten::equal",
    "aten::is_nonzero", "aten::repeat_interleave",
})

#: every known sync of an entry, by the function it is made in, with the
#: reason it stays. Any other site fails :func:`check_syncs` and the card's
#: sync-debug pass.
SYNC_ALLOWLIST = {
    "ops.fused_bfs._check_items":
        "K2's bounds check before a launch: item_off must hold in-range, "
        "non-decreasing chunk bounds or the kernel reads past idx",
    "ops._cuda.check_rows":
        "K1's and K2's row-id check before a launch: every gathered row "
        "inside the source bitmap, one aminmax read back a launch",
    "ops.linemask.mask_of_points":
        "the exact line mask of scattered points drops duplicates with "
        "torch.unique, whose length the host reads: once for a BFS's seed "
        "rows, once a hop for a delta's overlay rows",
    "ops.fused_bfs.fused_hop_plain":
        "K2's plain version, the CPU route only: the chunk-to-row map's "
        "length is the plan's chunk count",
    "ops.fused_bfs._segment_or":
        "K2's plain version, the CPU route only: the segmented scan stops "
        "once no run spans the step, one read a doubling",
    "parallel.sharded.match_candidates_sharded":
        "takes its candidates and anchor rows as host arrays (assembled a "
        "batch on the host): one upload of each to each shard",
    "ops.sharded_serving.pattern_serve_batch_sharded":
        "takes its candidate rows as host arrays (pattern_host_rows): one "
        "upload of each shard's slice",
}


def sync_site(skip_file: Optional[str] = None) -> str:
    """The innermost frame of this package on the calling thread's
    stack, as ``<module>.<qualname>:<line>`` (below the package); this
    module's own frames are skipped, and so are ``skip_file``'s."""
    f = sys._getframe(1)
    here = os.path.abspath(__file__)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if (fn.startswith(_PKG_DIR + os.sep) and fn != here
                and fn != skip_file):
            rel = os.path.relpath(fn, _PKG_DIR)[:-3].replace(os.sep, ".")
            # a nested function or generator counts as its outer function
            qual = f.f_code.co_qualname.split(".<locals>.")[0]
            return f"{rel}.{qual}:{f.f_lineno}"
        f = f.f_back
    return "<outside the package>"


def site_function(site: str) -> str:
    """A :func:`sync_site` without its line: the allowlist's key."""
    return site.rsplit(":", 1)[0]


#: indexing ops whose output shape depends on the data when an index is
#: a mask
_MASK_INDEX_OPS = frozenset({"aten::index", "aten::index_put",
                             "aten::index_put_", "aten::_index_put_impl_"})


def _is_sync(name: str, args, kwargs) -> bool:
    if name == "aten::repeat_interleave":
        return kwargs.get("output_size") is None
    if name in _MASK_INDEX_OPS and len(args) > 1:
        return any(torch.is_tensor(i) and i.dtype in (torch.bool, torch.uint8)
                   for i in (args[1] or ()))
    return name in SYNC_OPS


class _OpRecorder(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts every aten op, the bytes of its tensor inputs and outputs,
    and the sync ops with their call sites."""

    def __init__(self):
        super().__init__()
        self.ops: dict = {}
        self.bytes = 0
        self.syncs: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        self.ops[name] = self.ops.get(name, 0) + 1
        for t in tensors_of((args, kwargs)) + tensors_of(out):
            self.bytes += t.numel() * t.element_size()
        if _is_sync(name, args, kwargs):
            self.syncs.append((name, sync_site()))
        return out


def record(e: Entry, device="cpu", seed: int = 0) -> dict:
    """Run ``e`` once at its exemplar under the op recorder and the FLOP
    counter: ``{"ops", "op_counts", "bytes", "flops", "syncs", "out"}``."""
    from torch.utils.flop_counter import FlopCounterMode

    args, kwargs = exemplar(e, device, seed)
    rec = _OpRecorder()
    flops = FlopCounterMode(display=False)
    with flops, rec:
        out = e.fn(*args, **kwargs)
    return {"ops": sum(rec.ops.values()), "op_counts": dict(sorted(
        rec.ops.items())), "bytes": int(rec.bytes),
        "flops": int(flops.get_total_flops()), "syncs": rec.syncs,
        "out": out}


def check_syncs(registry: Registry = REGISTRY, device="cpu",
                allow: Optional[dict] = None) -> list:
    """HV101 for every sync op of an entry made at a site off the
    allowlist."""
    allow = SYNC_ALLOWLIST if allow is None else allow
    out = []
    for e in registry:
        for op, site in record(e, device)["syncs"]:
            if site_function(site) not in allow:
                out.append(Finding("HV101", e.name,
                                   f"{op} syncs the host", site))
    return out


# ------------------------------------------------------ HV2xx: collectives


@contextlib.contextmanager
def tracing_collectives():
    """Record every call of ``parallel.sharded.all_gather`` and ``psum``
    made inside the block as ``(name, axis names)``, wherever a module of
    the package bound them."""
    from hypergraphdb_tpu_torch.parallel import sharded

    calls: list = []
    originals = {"all_gather": sharded.all_gather, "psum": sharded.psum}

    def wrap(name, fn):
        def traced(mesh, *a, **k):
            calls.append((name, tuple(mesh.axis_names)))
            return fn(mesh, *a, **k)
        return traced

    wrapped = {n: wrap(n, f) for n, f in originals.items()}
    patched = []
    for mod in list(sys.modules.values()):
        if not (getattr(mod, "__name__", "") or "").startswith(PKG):
            continue
        for n, f in originals.items():
            if getattr(mod, n, None) is f:
                setattr(mod, n, wrapped[n])
                patched.append((mod, n, f))
    try:
        yield calls
    finally:
        for mod, n, f in patched:
            setattr(mod, n, f)


def collectives(e: Entry, device="cpu", seed: int = 0) -> list:
    """The collective calls of ``e`` at its exemplar of ``seed``."""
    args, kwargs = exemplar(e, device, seed)
    with tracing_collectives() as calls:
        e.fn(*args, **kwargs)
    return list(calls)


def check_collectives(registry: Registry = REGISTRY, device="cpu") -> list:
    """HV201: a mesh entry's collective off its declared axis; HV202: a
    mesh entry whose sequence differs between two seeds' exemplars (it
    depends on data); HV203: a collective in an entry that declares no
    mesh."""
    out = []
    for e in registry:
        seq = collectives(e, device, 0)
        if e.mesh is None:
            for name, axes in seq:
                out.append(Finding("HV203", e.name,
                                   f"{name} over {axes} with no mesh "
                                   f"declared"))
            continue
        for name, axes in seq:
            if not set(e.mesh) & set(axes):
                out.append(Finding("HV201", e.name,
                                   f"{name} over {axes}, declared {e.mesh}"))
        other = collectives(e, device, 1)
        if other != seq:
            out.append(Finding("HV202", e.name,
                               f"collective sequence depends on the data: "
                               f"{len(seq)} calls at seed 0, {len(other)} "
                               f"at seed 1"))
    return out


# ---------------------------------------------------------- HV3xx: aliasing


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def check_aliasing(registry: Registry = REGISTRY, device="cpu") -> list:
    """HV301: a donating entry returns no tensor sharing its first donated
    argument's storage; HV302: two outputs share storage; HV303: an input
    not declared donated changed."""
    out = []
    for e in registry:
        args, kwargs = exemplar(e, device)
        kept = set()
        for i in e.donate:
            kept.update(id(t) for t in tensors_of(args[i]))
        before = [(t, t.clone()) for t in tensors_of((args, kwargs))
                  if id(t) not in kept]
        res = e.fn(*args, **kwargs)
        outs = [t for t in tensors_of(res) if t.numel()]
        if e.donate:
            ptr = {_storage(t) for t in tensors_of(args[e.donate[0]])}
            if not any(_storage(t) in ptr for t in outs):
                out.append(Finding("HV301", e.name,
                                   f"declares argument {e.donate[0]} "
                                   f"donated but returns no tensor in its "
                                   f"storage"))
        seen: dict = {}
        for i, t in enumerate(outs):
            p = _storage(t)
            if p in seen and outs[seen[p]] is not t:
                out.append(Finding("HV302", e.name,
                                   f"outputs {seen[p]} and {i} share "
                                   f"storage"))
            seen.setdefault(p, i)
        for t, copy in before:
            if t.shape != copy.shape or not torch.equal(t, copy):
                out.append(Finding("HV303", e.name,
                                   f"an input of shape {tuple(copy.shape)} "
                                   f"changed and is not declared donated"))
    return out


# ---------------------------------------------------------- HV4xx: budgets

#: the committed budgets, next to this module
COSTS_PATH = os.path.join(_PKG_DIR, "verify_costs.json")
#: relative tolerance of each figure against its budget
COST_TOLERANCE = 0.15
#: the figures held to the budget
COST_KEYS = ("ops", "bytes", "flops")


def measure_costs(registry: Registry = REGISTRY) -> dict:
    """Each entry's ``{"ops", "bytes", "flops", "op_counts"}`` at its CPU
    exemplar (seed 0)."""
    out = {}
    for e in registry:
        r = record(e, "cpu")
        out[e.name] = {k: r[k] for k in COST_KEYS + ("op_counts",)}
    return out


def write_costs(registry: Registry = REGISTRY, path: str = COSTS_PATH,
                update: bool = False) -> dict:
    """Measure and write the budgets. Refuses unless ``update=True``: a
    budget is rewritten on purpose, never by a check."""
    if not update:
        raise ValueError("write_costs rewrites the committed budgets: pass "
                         "update=True")
    costs = measure_costs(registry)
    doc = {"torch": torch.__version__.split("+")[0],
           "tolerance": COST_TOLERANCE, "entries": costs}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return costs


def check_costs(registry: Registry = REGISTRY, path: str = COSTS_PATH,
                measured: Optional[dict] = None) -> list:
    """HV401: a figure outside :data:`COST_TOLERANCE` of its budget;
    HV402: an entry with no budget; HV403: a budget of no entry."""
    with open(path, encoding="utf-8") as f:
        budgets = json.load(f)["entries"]
    measured = measure_costs(registry) if measured is None else measured
    out = []
    for name, got in measured.items():
        want = budgets.get(name)
        if want is None:
            out.append(Finding("HV402", name, "no committed budget"))
            continue
        for k in COST_KEYS:
            lo = want[k] * (1 - COST_TOLERANCE)
            hi = want[k] * (1 + COST_TOLERANCE)
            if not lo <= got[k] <= hi:
                out.append(Finding("HV401", name,
                                   f"{k} {got[k]} outside {want[k]} "
                                   f"± {COST_TOLERANCE:.0%}"))
    for name in budgets.keys() - measured.keys():
        out.append(Finding("HV403", name, "budget of no registered entry"))
    return out


def check_all(registry: Registry = REGISTRY) -> list:
    """The four families on the CPU."""
    return (check_syncs(registry) + check_collectives(registry)
            + check_aliasing(registry) + check_costs(registry))
