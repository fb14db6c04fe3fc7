"""CSRSnapshot — the immutable image of the hypergraph's topology, and its
tensor twin.

The port's copy of the topology part of ``hypergraphdb_tpu/ops/snapshot.py``.
Layout (int32, edge arrays padded to ``pad_multiple``; ``N`` is the id space
and row ``N`` is a dummy row that absorbs padding):

- ``inc_offsets[N+2]``, ``inc_links``, ``inc_src`` — incidence CSR (links
  pointing at each atom, sorted per row) and its row id per entry.
- ``tgt_offsets[N+2]``, ``tgt_flat``, ``tgt_src`` — target CSR: the ordered
  targets of each link atom, and its source link per entry.
- ``type_of[N+1]``, ``is_link[N+1]``, ``arity[N+1]``.
- ``value_rank[N+1]`` (uint64), ``value_kind[N+1]`` (uint8),
  ``value_rank2[N+1]`` (uint64) and ``value_ambig[N+1]`` (bool): each atom's
  order-preserving 64-bit value rank (payload bytes 0..8 of its key), the
  key's kind byte, the second rank word (payload bytes 8..16, the tie-break
  of variable-width kinds) and whether that pair fails to stand in for the
  whole key.
- ``by_type``: type handle → sorted array of atom ids (``type_set``).

On the device a 64-bit rank is ONE int64 with its sign bit flipped
(:func:`rank_words`): signed order is then the unsigned rank order, where
the reference splits each rank into two uint32 words (JAX without x64 has
no uint64) and compares them hi then lo. :func:`reference_words` maps the
port's words back to that pair.

:meth:`CSRSnapshot.pack` reads a port graph's committed store
(``core/graph.py``); :meth:`CSRSnapshot.from_tables` assembles generated
columns; :meth:`CSRSnapshot.from_reference_arrays` takes the reference
snapshot's numpy columns as a plain dict, so both packages can run on one
structure.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Optional

import numpy as np
import torch

from hypergraphdb_tpu_torch.device import DEFAULT_DEVICE, resolve_device

#: the sign bit a rank word flips
_SIGN = np.uint64(1 << 63)


def rank_words(ranks) -> np.ndarray:
    """64-bit ranks (uint64) as the port's rank words: int64 with the sign
    bit flipped, so one signed compare orders them as the ranks."""
    return (np.asarray(ranks, dtype=np.uint64) ^ _SIGN).view(np.int64)


def rank_word(rank: int) -> int:
    """One 64-bit rank, a python int in ``[0, 2**64)``, as a rank word."""
    rank = int(rank)
    if not 0 <= rank < 1 << 64:
        raise ValueError(f"rank {rank} is not a 64-bit unsigned value")
    return rank - (1 << 63)


def reference_words(words) -> tuple[np.ndarray, np.ndarray]:
    """The port's rank words back to the reference's ``(hi, lo)`` uint32
    pair of each 64-bit rank."""
    r = np.ascontiguousarray(words, dtype=np.int64).view(np.uint64) ^ _SIGN
    return ((r >> np.uint64(32)).astype(np.uint32),
            (r & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _pad_to(arr: np.ndarray, multiple: int, fill) -> np.ndarray:
    n = len(arr)
    m = ((n + multiple - 1) // multiple) * multiple if n else multiple
    if m == n:
        return arr
    out = np.full(m, fill, dtype=arr.dtype)
    out[:n] = arr
    return out


def _group_by_type(type_of_n: np.ndarray) -> dict[int, np.ndarray]:
    """type handle → sorted array of atom ids."""
    by_type: dict[int, np.ndarray] = {}
    live = type_of_n >= 0
    if live.any():
        th_arr = type_of_n[live]
        id_arr = np.nonzero(live)[0].astype(np.int32)
        order = np.lexsort((id_arr, th_arr))
        th_sorted, id_sorted = th_arr[order], id_arr[order]
        uniq, starts = np.unique(th_sorted, return_index=True)
        bounds = np.append(starts, len(th_sorted))
        for i, t in enumerate(uniq.tolist()):
            by_type[int(t)] = id_sorted[bounds[i] : bounds[i + 1]].copy()
    return by_type


def _incidence_transpose(
    tgt_src: np.ndarray, tgt_flat: np.ndarray, N: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Incidence CSR as the TRANSPOSE of the target relation: entry (t ← l)
    for every (l → t) edge, deduped, each row sorted by link id. Returns
    (inc_offsets (N+2,) int32, inc_links, inc_src)."""
    if len(tgt_flat):
        pair_order = np.lexsort((tgt_src, tgt_flat))
        pt = tgt_flat[pair_order].astype(np.int64)
        pl = tgt_src[pair_order].astype(np.int64)
        keep = np.ones(len(pt), dtype=bool)
        keep[1:] = (pt[1:] != pt[:-1]) | (pl[1:] != pl[:-1])
        pt, pl = pt[keep], pl[keep]
    else:
        pt = pl = np.empty(0, dtype=np.int64)
    inc_counts = np.bincount(pt, minlength=N + 1)
    inc_offsets = np.zeros(N + 2, dtype=np.int32)
    np.cumsum(inc_counts, out=inc_offsets[1 : N + 2])
    return inc_offsets, pl.astype(np.int32), pt.astype(np.int32)


def _value_columns(value_items, N: int) -> dict:
    """The four value columns of an id space of ``N`` from the by-value
    index's ``(key, handles)`` items (None: all zero): per key, the rank of
    its payload (the key minus its kind byte), the kind byte, the second
    rank word and, for variable-width kinds, whether the rank pair is
    ambiguous. A handle under several keys takes its last key's values."""
    from hypergraphdb_tpu_torch.storage.value_index import FIXED_WIDTH_KINDS
    from hypergraphdb_tpu_torch.utils.ordered_bytes import rank_ambiguous

    cols = {name: np.zeros(N + 1, dtype=dtype)
            for name, dtype in CSRSnapshot.VALUE_DTYPES.items()}
    if not value_items:
        return cols
    keys = [k for k, _ in value_items]
    hs = np.concatenate([h for _, h in value_items]).astype(np.int64)
    per_key = np.fromiter((len(h) for _, h in value_items), dtype=np.int64,
                          count=len(keys))
    # each key as 17 bytes, zero-padded: the kind byte, then the payload's
    # first 16 bytes, whose two big-endian words are rank64 of payload
    # bytes 0..8 and 8..16
    head = np.frombuffer(b"".join(k[:17].ljust(17, b"\x00") for k in keys),
                         dtype=np.uint8).reshape(-1, 17)
    kind = head[:, 0].copy()
    words = np.ascontiguousarray(head[:, 1:]).view(">u8")
    rank = words[:, 0].astype(np.uint64)
    rank2 = words[:, 1].astype(np.uint64)
    var = (np.fromiter(map(len, keys), dtype=np.int64, count=len(keys)) > 0
           ) & ~np.isin(kind, np.frombuffer(bytes(FIXED_WIDTH_KINDS),
                                            dtype=np.uint8))
    ambig = np.zeros(len(keys), dtype=bool)
    for i in np.flatnonzero(var).tolist():
        ambig[i] = rank_ambiguous(keys[i][1:])
    key_of = np.repeat(np.arange(len(keys)), per_key)
    keep = hs <= N
    hs, key_of = hs[keep], key_of[keep]

    def last(h, k):
        """Each handle once, with the last of its keys (items come in key
        order; a later key overwrites an earlier one)."""
        i = len(h) - 1 - np.unique(h[::-1], return_index=True)[1]
        return h[i], k[i]

    h, k = last(hs, key_of)
    cols["value_rank"][h] = rank[k]
    cols["value_kind"][h] = kind[k]
    cols["value_rank2"][h] = rank2[k]
    v = var[key_of]
    h, k = last(hs[v], key_of[v])
    cols["value_ambig"][h] = ambig[k]
    return cols


@dataclass
class CSRSnapshot:
    version: int
    num_atoms: int          # id space size (N); row N is the dummy slot
    inc_offsets: np.ndarray
    inc_links: np.ndarray
    inc_src: np.ndarray
    tgt_offsets: np.ndarray
    tgt_flat: np.ndarray
    tgt_src: np.ndarray
    type_of: np.ndarray
    is_link: np.ndarray
    arity: np.ndarray
    value_rank: np.ndarray
    value_kind: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.uint8))
    #: empty on snapshots without the tie-break word: their variable-width
    #: columns cannot certify device exactness
    value_rank2: np.ndarray = field(
        default_factory=lambda: np.empty(0, np.uint64))
    #: consulted for variable-width kinds only: a fixed-width kind's single
    #: rank word is exact by construction
    value_ambig: np.ndarray = field(
        default_factory=lambda: np.empty(0, bool))
    by_type: dict[int, np.ndarray] = field(default_factory=dict)
    n_edges_inc: int = 0    # real (unpadded) incidence entries
    n_edges_tgt: int = 0    # real (unpadded) target entries

    #: the columns :meth:`from_reference_arrays` reads (by_type is derived)
    REFERENCE_FIELDS = (
        "version", "num_atoms", "inc_offsets", "inc_links", "inc_src",
        "tgt_offsets", "tgt_flat", "tgt_src", "type_of", "is_link", "arity",
        "value_rank", "value_kind", "value_rank2", "value_ambig",
        "n_edges_inc", "n_edges_tgt",
    )
    #: the value columns' dtypes; all but ``value_rank`` may be empty
    VALUE_DTYPES = {"value_rank": np.uint64, "value_kind": np.uint8,
                    "value_rank2": np.uint64, "value_ambig": np.bool_}

    @staticmethod
    def from_tables(
        type_of: np.ndarray,      # (N,) int32 type handle per atom, -1 dead
        is_link: np.ndarray,      # (N,) bool
        tgt_offsets: np.ndarray,  # (N+1,) int — target CSR offsets
        tgt_flat: np.ndarray,     # (E,) int — ordered targets per link
        value_rank: Optional[np.ndarray] = None,   # (N,) uint64 ranks
        value_kind: Optional[np.ndarray] = None,   # (N,) uint8 kind bytes
        value_rank2: Optional[np.ndarray] = None,  # (N,) uint64 tie-break
        value_ambig: Optional[np.ndarray] = None,  # (N,) bool ambiguity
        version: int = 0,
        pad_multiple: int = 128,
    ) -> "CSRSnapshot":
        """Assemble a snapshot directly from columnar tables (the bulk
        path the benchmark generators use to build 10M-atom graphs).

        Callers that give kinds but neither the tie-break word nor the
        ambiguity flags carry no keys to derive them from: their
        variable-width atoms are marked ambiguous, so no device window
        over them claims exactness."""
        N = len(type_of)
        type_col = np.full(N + 1, -1, dtype=np.int32)
        type_col[:N] = type_of
        link_col = np.zeros(N + 1, dtype=bool)
        link_col[:N] = is_link
        arity = np.zeros(N + 1, dtype=np.int32)
        lens = np.asarray(tgt_offsets[1:]) - np.asarray(tgt_offsets[:-1])
        arity[:N] = lens.astype(np.int32)
        value = {}
        for name, col in (("value_rank", value_rank),
                          ("value_kind", value_kind),
                          ("value_rank2", value_rank2),
                          ("value_ambig", value_ambig)):
            value[name] = np.zeros(N + 1, dtype=CSRSnapshot.VALUE_DTYPES[name])
            if col is not None:
                value[name][:N] = col
        if value_ambig is None and value_kind is not None \
                and value_rank2 is None:
            # imported here: the storage module imports this one
            from hypergraphdb_tpu_torch.storage.value_index import (
                FIXED_WIDTH_KINDS,
            )

            kinds = value["value_kind"][:N]
            fixed = np.isin(kinds, np.frombuffer(bytes(FIXED_WIDTH_KINDS),
                                                 dtype=np.uint8))
            value["value_ambig"][:N] = (kinds != 0) & ~fixed
        off = np.zeros(N + 2, dtype=np.int32)
        off[1 : N + 1] = np.asarray(tgt_offsets[1:], dtype=np.int32)
        off[N + 1] = off[N]
        tgt_flat = np.asarray(tgt_flat, dtype=np.int32)
        tgt_src = np.repeat(
            np.arange(N, dtype=np.int32), lens.astype(np.int64)
        )
        inc_offsets, inc_links, inc_src = _incidence_transpose(
            tgt_src, tgt_flat, N
        )
        e_inc, e_tgt = len(inc_links), len(tgt_flat)
        return CSRSnapshot(
            version=version,
            num_atoms=N,
            inc_offsets=inc_offsets,
            inc_links=_pad_to(inc_links, pad_multiple, N),
            inc_src=_pad_to(inc_src, pad_multiple, N),
            tgt_offsets=off,
            tgt_flat=_pad_to(tgt_flat, pad_multiple, N),
            tgt_src=_pad_to(tgt_src, pad_multiple, N),
            type_of=type_col,
            is_link=link_col,
            arity=arity,
            **value,
            by_type=_group_by_type(type_col[:N]),
            n_edges_inc=e_inc,
            n_edges_tgt=e_tgt,
        )

    @staticmethod
    def from_reference_arrays(d: dict) -> "CSRSnapshot":
        """A snapshot from another implementation's columns, given as a
        plain dict of numpy arrays and ints keyed by
        :data:`REFERENCE_FIELDS` (extra keys are ignored). The arrays are
        copied, so the two snapshots share nothing."""
        missing = [k for k in CSRSnapshot.REFERENCE_FIELDS if k not in d]
        if missing:
            raise KeyError(f"from_reference_arrays: missing {missing}")
        N = int(d["num_atoms"])
        cols = {
            k: np.array(d[k], copy=True)
            for k in CSRSnapshot.REFERENCE_FIELDS
            if k not in ("version", "num_atoms", "n_edges_inc", "n_edges_tgt")
        }
        for k in ("inc_offsets", "tgt_offsets"):
            if cols[k].shape != (N + 2,):
                raise ValueError(f"{k} must have N+2 = {N + 2} entries, "
                                 f"got {cols[k].shape}")
        for k in ("type_of", "is_link", "arity", "value_rank"):
            if cols[k].shape != (N + 1,):
                raise ValueError(f"{k} must have N+1 = {N + 1} entries, "
                                 f"got {cols[k].shape}")
        for k, dtype in CSRSnapshot.VALUE_DTYPES.items():
            if cols[k].shape not in ((N + 1,), (0,)):
                raise ValueError(f"{k} must have N+1 = {N + 1} entries or "
                                 f"none, got {cols[k].shape}")
            cols[k] = cols[k].astype(dtype, copy=False)
        return CSRSnapshot(
            version=int(d["version"]),
            num_atoms=N,
            by_type=_group_by_type(cols["type_of"][:N]),
            n_edges_inc=int(d["n_edges_inc"]),
            n_edges_tgt=int(d["n_edges_tgt"]),
            **cols,
        )

    # ------------------------------------------------------------------ pack
    @staticmethod
    def extract_tables(graph, value_ranks: bool = True) -> dict:
        """The committed store as raw host tables: the one part of packing
        that needs a consistent store. A background compaction holds the
        commit lock for this alone and assembles (``pack(tables=...)``)
        without it."""
        from hypergraphdb_tpu_torch.core.graph import IDX_BY_VALUE

        backend = graph.backend
        ids, offsets, flat = backend.bulk_links()
        value_items = None
        if value_ranks:
            idx = backend.get_index(IDX_BY_VALUE, create=False)
            if idx is not None:
                value_items = list(idx.bulk_items())
        peek = int(getattr(graph.handles, "peek", 0))
        return {
            "ids": np.asarray(ids, dtype=np.int64),
            "offsets": np.asarray(offsets, dtype=np.int64),
            "flat": np.asarray(flat, dtype=np.int64),
            "peek": max(peek, int(backend.max_handle())),
            "value_items": value_items,
        }

    @staticmethod
    def pack(graph, version: Optional[int] = None, pad_multiple: int = 128,
             capacity: Optional[int] = None, value_ranks: bool = True,
             tables: Optional[dict] = None) -> "CSRSnapshot":
        """Pack the committed store into CSR arrays and value columns.

        ``capacity`` over-allocates the id space, so atoms added after the
        pack keep ids inside this snapshot's bitmaps (the delta's
        prerequisite). ``tables`` (from :meth:`extract_tables`) separates
        the store read from the assembly. Records are ``(type, value,
        flags, *targets)``; the value columns come from the by-value index,
        one rank per distinct key."""
        if tables is None:
            tables = CSRSnapshot.extract_tables(graph, value_ranks)
        ids, offsets, flat = tables["ids"], tables["offsets"], tables["flat"]
        N = tables["peek"] if capacity is None else max(tables["peek"],
                                                        int(capacity))
        type_of = np.full(N + 1, -1, dtype=np.int32)
        is_link = np.zeros(N + 1, dtype=bool)
        arity = np.zeros(N + 1, dtype=np.int32)

        starts = offsets[:-1]
        lens = offsets[1:] - starts
        ok = lens >= 3
        vids, vstarts, vlens = ids[ok], starts[ok], lens[ok]
        type_of[vids] = flat[vstarts].astype(np.int32)
        is_link[vids] = (flat[vstarts + 2] & 1).astype(bool)
        arities = (vlens - 3).astype(np.int32)
        arity[vids] = arities

        # target entries: positions 3.. of each record, records ascending
        pos = np.arange(int(vlens.sum())) - np.repeat(np.cumsum(vlens) - vlens,
                                                      vlens)
        tmask = pos >= 3
        tgt_flat = flat[np.repeat(vstarts, vlens)[tmask] + pos[tmask]
                        ].astype(np.int32)
        tgt_src = np.repeat(vids, vlens)[tmask].astype(np.int32)
        tgt_counts = np.zeros(N + 1, dtype=np.int64)
        tgt_counts[vids] = arities
        tgt_offsets = np.zeros(N + 2, dtype=np.int32)
        np.cumsum(tgt_counts, out=tgt_offsets[1 : N + 2])
        inc_offsets, inc_links, inc_src = _incidence_transpose(
            tgt_src, tgt_flat, N)

        value = _value_columns(tables["value_items"], N)
        return CSRSnapshot(
            version=version if version is not None else getattr(
                graph, "_mutations", 0),
            num_atoms=N,
            inc_offsets=inc_offsets,
            inc_links=_pad_to(inc_links, pad_multiple, N),
            inc_src=_pad_to(inc_src, pad_multiple, N),
            tgt_offsets=tgt_offsets,
            tgt_flat=_pad_to(tgt_flat, pad_multiple, N),
            tgt_src=_pad_to(tgt_src, pad_multiple, N),
            type_of=type_of,
            is_link=is_link,
            arity=arity,
            **value,
            by_type=_group_by_type(type_of[:N]),
            n_edges_inc=len(inc_links),
            n_edges_tgt=len(tgt_flat),
        )

    # ------------------------------------------------------------ host views
    def incidence_row(self, atom: int) -> np.ndarray:
        """The sorted ids of the links that target ``atom``."""
        s, e = int(self.inc_offsets[atom]), int(self.inc_offsets[atom + 1])
        return self.inc_links[s:e]

    def targets_row(self, atom: int) -> np.ndarray:
        """The ordered targets of ``atom`` (empty for a node)."""
        s, e = int(self.tgt_offsets[atom]), int(self.tgt_offsets[atom + 1])
        return self.tgt_flat[s:e]

    def type_set(self, type_handle: int) -> np.ndarray:
        """The sorted ids of the atoms of one type (empty if none)."""
        return self.by_type.get(int(type_handle), np.empty(0, dtype=np.int32))

    # ---------------------------------------------------------------- device
    def device(self, device: str | torch.device = DEFAULT_DEVICE
               ) -> "DeviceSnapshot":
        """The tensor twin on ``device``, uploaded once per device and
        cached on the snapshot (the card unless the caller asks for the
        CPU)."""
        dev = resolve_device(device)
        cache = getattr(self, "_device_twins", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_device_twins", cache)
        key = str(dev)
        if key not in cache:
            cache[key] = DeviceSnapshot.from_host(self, dev)
        return cache[key]


def cached_index64(holder, name: str) -> torch.Tensor:
    """``holder.<name>`` as int64, converted on first use and cached on
    ``holder`` (the columns of a device twin or delta never change)."""
    cache = holder.__dict__.setdefault("_index64", {})
    if name not in cache:
        cache[name] = getattr(holder, name).to(torch.int64)
    return cache[name]


@dataclass
class DeviceSnapshot:
    """The tensor twin of a :class:`CSRSnapshot`: the topology columns,
    the rank words (int64, :func:`rank_words`) and the kind bytes (uint8;
    zeros where the host column is not N+1 long). The second rank word
    stays on the host: the value index's columns carry it. ``n_inc`` and
    ``n_tgt`` are the host snapshot's real entry counts: past them
    ``inc_links`` and ``tgt_flat`` hold padding."""

    num_atoms: int
    n_inc: int
    n_tgt: int
    inc_offsets: torch.Tensor
    inc_links: torch.Tensor
    inc_src: torch.Tensor
    tgt_offsets: torch.Tensor
    tgt_flat: torch.Tensor
    tgt_src: torch.Tensor
    type_of: torch.Tensor
    is_link: torch.Tensor
    arity: torch.Tensor
    value_rank: torch.Tensor
    value_kind: torch.Tensor

    @staticmethod
    def from_host(snap: CSRSnapshot,
                  device: str | torch.device = DEFAULT_DEVICE
                  ) -> "DeviceSnapshot":
        dev = resolve_device(device)
        n1 = snap.num_atoms + 1
        host = {f.name: getattr(snap, f.name) for f in fields(DeviceSnapshot)
                if f.name not in _COUNTS}
        host["value_rank"] = rank_words(snap.value_rank)
        if len(snap.value_kind) != n1:
            host["value_kind"] = np.zeros(n1, dtype=np.uint8)
        cols = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in host.items()}
        return DeviceSnapshot(num_atoms=snap.num_atoms,
                              n_inc=snap.n_edges_inc, n_tgt=snap.n_edges_tgt,
                              **cols).to(dev)

    def index64(self, name: str) -> torch.Tensor:
        """Column ``name`` as int64, the index type of PyTorch's scatters,
        converted once and cached on this twin."""
        return cached_index64(self, name)

    def to(self, device: str | torch.device = DEFAULT_DEVICE
           ) -> "DeviceSnapshot":
        """This snapshot's tensors on ``device`` (the card unless the caller
        asks for the CPU)."""
        dev = resolve_device(device)
        return DeviceSnapshot(
            **{c: getattr(self, c) for c in _COUNTS},
            **{f.name: getattr(self, f.name).to(dev)
               for f in fields(self) if f.name not in _COUNTS},
        )


#: the scalar fields of a :class:`DeviceSnapshot`; the rest are tensors
_COUNTS = ("num_atoms", "n_inc", "n_tgt")
