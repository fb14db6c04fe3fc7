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
- ``by_type``: type handle → sorted array of atom ids.

Value columns (ranks, kinds) are not carried yet; ``pack(graph)`` waits for
the port's own graph layer. :meth:`CSRSnapshot.from_reference_arrays` takes
the reference snapshot's numpy columns as a plain dict, so both packages can
run on one structure.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields

import numpy as np
import torch

from hypergraphdb_tpu_torch.device import DEFAULT_DEVICE, resolve_device


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
    by_type: dict[int, np.ndarray] = field(default_factory=dict)
    n_edges_inc: int = 0    # real (unpadded) incidence entries
    n_edges_tgt: int = 0    # real (unpadded) target entries

    #: the columns :meth:`from_reference_arrays` reads (by_type is derived)
    REFERENCE_FIELDS = (
        "version", "num_atoms", "inc_offsets", "inc_links", "inc_src",
        "tgt_offsets", "tgt_flat", "tgt_src", "type_of", "is_link", "arity",
        "n_edges_inc", "n_edges_tgt",
    )

    @staticmethod
    def from_tables(
        type_of: np.ndarray,      # (N,) int32 type handle per atom, -1 dead
        is_link: np.ndarray,      # (N,) bool
        tgt_offsets: np.ndarray,  # (N+1,) int — target CSR offsets
        tgt_flat: np.ndarray,     # (E,) int — ordered targets per link
        version: int = 0,
        pad_multiple: int = 128,
    ) -> "CSRSnapshot":
        """Assemble a snapshot directly from columnar tables (the bulk
        path the benchmark generators use to build 10M-atom graphs)."""
        N = len(type_of)
        type_col = np.full(N + 1, -1, dtype=np.int32)
        type_col[:N] = type_of
        link_col = np.zeros(N + 1, dtype=bool)
        link_col[:N] = is_link
        arity = np.zeros(N + 1, dtype=np.int32)
        lens = np.asarray(tgt_offsets[1:]) - np.asarray(tgt_offsets[:-1])
        arity[:N] = lens.astype(np.int32)
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
        for k in ("type_of", "is_link", "arity"):
            if cols[k].shape != (N + 1,):
                raise ValueError(f"{k} must have N+1 = {N + 1} entries, "
                                 f"got {cols[k].shape}")
        return CSRSnapshot(
            version=int(d["version"]),
            num_atoms=N,
            by_type=_group_by_type(cols["type_of"][:N]),
            n_edges_inc=int(d["n_edges_inc"]),
            n_edges_tgt=int(d["n_edges_tgt"]),
            **cols,
        )


@dataclass
class DeviceSnapshot:
    """The tensor twin of a :class:`CSRSnapshot` (topology columns)."""

    num_atoms: int
    inc_offsets: torch.Tensor
    inc_links: torch.Tensor
    inc_src: torch.Tensor
    tgt_offsets: torch.Tensor
    tgt_flat: torch.Tensor
    tgt_src: torch.Tensor
    type_of: torch.Tensor
    is_link: torch.Tensor
    arity: torch.Tensor

    @staticmethod
    def from_host(snap: CSRSnapshot,
                  device: str | torch.device = DEFAULT_DEVICE
                  ) -> "DeviceSnapshot":
        dev = resolve_device(device)
        cols = {
            f.name: torch.from_numpy(np.ascontiguousarray(getattr(snap, f.name)))
            for f in fields(DeviceSnapshot) if f.name != "num_atoms"
        }
        return DeviceSnapshot(num_atoms=snap.num_atoms, **cols).to(dev)

    def to(self, device: str | torch.device = DEFAULT_DEVICE
           ) -> "DeviceSnapshot":
        """This snapshot's tensors on ``device`` (the card unless the caller
        asks for the CPU)."""
        dev = resolve_device(device)
        return DeviceSnapshot(
            num_atoms=self.num_atoms,
            **{f.name: getattr(self, f.name).to(dev)
               for f in fields(self) if f.name != "num_atoms"},
        )
