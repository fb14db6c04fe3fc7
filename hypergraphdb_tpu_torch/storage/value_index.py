"""The value index's device columns: one sorted column per value kind.

The port of the device half of ``hypergraphdb_tpu/storage/value_index.py``.
For each value KIND byte, a snapshot's live atoms of that kind sorted
ascending by ``(rank, rank2, gid)`` and padded to a power-of-two bucket.
Range, ordered and top-k requests then run as batched binary searches over
the rank words plus bounded gathers (``ops/value_index.py``): one sorted
column serves every predicate shape over its dimension.

Rank semantics: ``rank`` is the order-preserving 64-bit payload rank of
``ops/snapshot.py``, ``rank2`` the second word (payload bytes 8..16) that
breaks rank ties of variable-width kinds (str/bytes) up to 16 payload
bytes. Both ride as the port's rank words (int64 with the sign bit
flipped, ``ops/snapshot.rank_words``), so one signed compare replaces the
reference's two uint32 compares. A column holding any ambiguous key
(payload over 16 bytes, or NUL among the first 16) clears
``device_exact``: its windows cannot be trusted on the device.

A delta column covers the snapshot manager's memtable atoms
(:func:`build_delta_column`, through ``SnapshotManager.value_delta``); it
and the base column share one constructor, :func:`_sorted_device_column`,
so they share a layout.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hypergraphdb_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from hypergraphdb_tpu_torch.ops.setops import _bucket
from hypergraphdb_tpu_torch.ops.snapshot import rank_words

#: value kinds whose 64-bit payload rank is the exact value order
FIXED_WIDTH_KINDS = frozenset(b"ifbt")

#: gid padding for column tails (int32 max: sorts last, never a real id)
GID_PAD = np.int32(np.iinfo(np.int32).max)

#: rank-word padding: the word of the all-ones rank, after every real one
RANK_PAD = np.int64(np.iinfo(np.int64).max)


@dataclass
class ValueIndexColumn:
    """One indexed dimension's sorted column, on a device.

    ``rank`` and ``rank2`` are the two rank words, ``gids`` the owning atom
    ids; all three sorted ascending by ``(rank, rank2, gid)`` and padded to
    a power-of-two bucket with :data:`RANK_PAD` / :data:`GID_PAD`. ``n`` is
    the real entry count: searches stop there, so pads are never probed.
    ``covered`` means something for delta columns only: how many leading
    entries of the memtable's new atoms the column accounts for.
    ``device_exact`` says the rank pair orders AND identifies every entry:
    always for fixed-width kinds, for variable-width ones only when no key
    is ambiguous."""

    kind: int               # value kind byte this column indexes
    n: int                  # real entries
    rank: torch.Tensor      # (M,) int64 rank words
    gids: torch.Tensor      # (M,) int32
    rank2: torch.Tensor     # (M,) int64 second rank words
    epoch: int = -1         # compaction epoch (delta columns)
    covered: int = 0        # new-atoms prefix scanned (delta columns)
    device_exact: bool = False


def _sorted_device_column(kind: int, ranks: np.ndarray, gids: np.ndarray,
                          epoch: int = -1, covered: int = 0,
                          minimum: int = 128,
                          ranks2: np.ndarray = None,
                          exact: bool = None,
                          device: str | torch.device = DEFAULT_DEVICE
                          ) -> ValueIndexColumn:
    """Sort host ``(rank uint64, rank2 uint64, gid)`` triples, pad to a
    bucket (``setops._bucket``) and upload to ``device``: the one
    constructor of base and delta columns, so the two always share a
    layout. ``ranks2`` defaults to zeros (fixed-width kinds carry no second
    word); ``exact`` defaults to the kind's fixed-width verdict."""
    dev = resolve_device(device)
    ranks = np.asarray(ranks, dtype=np.uint64)
    if ranks2 is None:
        ranks2 = np.zeros(len(ranks), dtype=np.uint64)
    ranks2 = np.asarray(ranks2, dtype=np.uint64)
    if exact is None:
        exact = int(kind) in FIXED_WIDTH_KINDS
    order = np.lexsort((gids, ranks2, ranks))
    n = len(order)
    m = _bucket(max(n, 1), minimum=minimum)
    rank = np.full(m, RANK_PAD, dtype=np.int64)
    rank2 = np.full(m, RANK_PAD, dtype=np.int64)
    gp = np.full(m, GID_PAD, dtype=np.int32)
    rank[:n] = rank_words(ranks[order])
    rank2[:n] = rank_words(ranks2[order])
    gp[:n] = np.asarray(gids)[order]
    return ValueIndexColumn(
        kind=int(kind), n=n,
        rank=torch.from_numpy(rank).to(dev),
        gids=torch.from_numpy(gp).to(dev),
        rank2=torch.from_numpy(rank2).to(dev),
        epoch=epoch, covered=covered, device_exact=bool(exact),
    )


def value_index_column(snap, kind: int,
                       device: str | torch.device = DEFAULT_DEVICE
                       ) -> ValueIndexColumn:
    """The BASE column of one kind for a snapshot, from its value columns
    (live atoms only), built once per kind and device and cached on the
    snapshot like ``setops.ell_targets``."""
    dev = resolve_device(device)
    cache = getattr(snap, "_value_index_cols", None)
    if cache is None:
        cache = {}
        object.__setattr__(snap, "_value_index_cols", cache)
    kind = int(kind)
    key = (kind, str(dev))
    if key in cache:
        return cache[key]
    N = snap.num_atoms
    sel = np.flatnonzero((snap.value_kind[:N] == kind)
                         & (snap.type_of[:N] >= 0))
    rank2, ambig = snap.value_rank2, snap.value_ambig
    if len(rank2) >= N:
        ranks2 = rank2[sel]
        exact = (kind in FIXED_WIDTH_KINDS
                 or (len(ambig) >= N and not bool(np.any(ambig[sel]))))
    else:
        # no second rank word: variable-width kinds cannot certify
        # device exactness
        ranks2 = None
        exact = kind in FIXED_WIDTH_KINDS
    col = _sorted_device_column(kind, snap.value_rank[sel], sel,
                                ranks2=ranks2, exact=exact, device=dev)
    cache[key] = col
    return col


def _twin_or_upload(snap, dev: torch.device, cache_name: str, pick):
    """``pick`` of the snapshot's device twin on ``dev`` where one exists,
    else of an upload of the host columns alone; cached per device."""
    cache = snap.__dict__.setdefault(cache_name, {})
    key = str(dev)
    if key not in cache:
        cache[key] = pick(getattr(snap, "_device_twins", {}).get(key))
    return cache[key]


def type_of_device(snap, device: str | torch.device = DEFAULT_DEVICE
                   ) -> torch.Tensor:
    """The snapshot's ``type_of`` column on ``device``, cached: the range
    lane's type filter reads it without forcing the whole device twin."""
    dev = resolve_device(device)
    return _twin_or_upload(
        snap, dev, "_type_of_dev",
        lambda twin: (twin.type_of if twin is not None
                      else torch.from_numpy(snap.type_of).to(dev)))


def inc_csr_device(snap, device: str | torch.device = DEFAULT_DEVICE
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The incidence CSR ``(offsets, links)`` on ``device``, cached under
    the rule of :func:`type_of_device`: the anchored range lane reads just
    these two arrays."""
    dev = resolve_device(device)
    return _twin_or_upload(
        snap, dev, "_inc_csr_dev",
        lambda twin: ((twin.inc_offsets, twin.inc_links) if twin is not None
                      else (torch.from_numpy(snap.inc_offsets).to(dev),
                            torch.from_numpy(snap.inc_links).to(dev))))


def value_key_of(graph, h: int):
    """One atom's order-preserving value key, or None when the atom is gone
    or its value has no key: the probe of :func:`build_delta_column` and
    of the host correction."""
    from hypergraphdb_tpu_torch.core.errors import HGException
    from hypergraphdb_tpu_torch.core.graph import HGLink

    try:
        v = graph.get(h)
        if isinstance(v, HGLink):
            v = v.value
        at = graph.typesystem.get_type(graph.get_type_handle_of(h))
        return at.to_key(v)
    except (HGException, TypeError, ValueError):  # a racing delete
        return None


def build_delta_column(graph, new_atoms, kind: int, epoch: int,
                       device: str | torch.device = DEFAULT_DEVICE
                       ) -> ValueIndexColumn:
    """The delta column of one kind over a captured prefix of the
    memtable's new atoms, sorted and on ``device``. ``covered`` is the
    whole scanned length: atoms of other kinds, gone atoms and keyless
    values are scanned too (they add nothing), so the host residual is
    exactly ``new_atoms[covered:]``."""
    from hypergraphdb_tpu_torch.utils.ordered_bytes import (
        rank128,
        rank_ambiguous,
    )

    ranks: list[int] = []
    ranks2: list[int] = []
    gids: list[int] = []
    kb = bytes([int(kind)])
    fixed = int(kind) in FIXED_WIDTH_KINDS
    exact = True
    for h in new_atoms:
        key = value_key_of(graph, int(h))
        if key is not None and key[:1] == kb:
            payload = key[1:]
            r1, r2 = rank128(payload)
            ranks.append(r1)
            ranks2.append(r2)
            gids.append(int(h))
            if not fixed and rank_ambiguous(payload):
                exact = False
    return _sorted_device_column(
        int(kind), np.asarray(ranks, dtype=np.uint64),
        np.asarray(gids, dtype=np.int64), epoch=epoch,
        covered=len(new_atoms), minimum=32,
        ranks2=np.asarray(ranks2, dtype=np.uint64), exact=fixed or exact,
        device=device)
