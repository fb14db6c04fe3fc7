"""Checkpoint and export: snapshot persistence and logical graph dumps.

The port of ``hypergraphdb_tpu/ops/checkpoint.py``:

- :func:`save_snapshot` / :func:`load_snapshot` persist a packed CSR
  snapshot as one ``.npz``, optionally with the pull-BFS plan pyramid
  beside it (``<path>.plans.npz``), so a restarted service serves without
  re-packing its store or rebuilding its plans;
- :func:`export_graph` / :func:`import_graph` write and read the logical
  dump: every atom as (type name, value bytes, targets), one JSON line
  each. Imports translate handles, so it doubles as the subgraph-transfer
  format;
- :func:`copy_subgraph` copies the reachable closure of root atoms into
  another graph (``CopyGraphTraversal``).

The files are the reference's: a checkpoint the port writes loads in the
reference and one the reference writes loads here. The snapshot npz holds
the reference's keys and dtypes (``value_rank`` uint64, one ``bt_<type>``
row per type), plus the port's two extra value columns (``value_rank2``,
``value_ambig``), which the reference ignores and a reference file lacks
(their absence reads as the reference's empty columns). Nothing is
unpickled on load. The reference compresses the snapshot's npz; the port
stores it, since a restart is what the file is for: at 10M atoms the
compressed write took 49–54 s on an H100 host and its load 7–8 s
(``chip_smoke.py`` phase 19). ``np.load`` reads either form, so the two
packages still read each other's files.

Both files publish crash-atomically (tmp, fsync, ``os.replace``), with
the crash points ``ckpt.save_npz`` and ``ckpt.save_plans`` on the
process fault registry. A corrupt sidecar is rebuilt and counted
(``ellbfs.read_sidecar``); only a damaged file's errors are caught.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Optional, Sequence

import numpy as np

from hypergraphdb_tpu_torch.core.errors import TypeError_
from hypergraphdb_tpu_torch.fault import global_faults
from hypergraphdb_tpu_torch.ops.snapshot import CSRSnapshot

#: process fault registry, bound once (one attribute read per crash point)
_FAULTS = global_faults()

#: the port's value columns beyond the reference's file; absent, they load
#: as the dataclass's empty defaults
_EXTRA_COLUMNS = ("value_rank2", "value_ambig")


# ------------------------------------------------------------- device snapshot


def _npz_path(path: str) -> str:
    # np.savez appends ".npz" when missing but np.load does not: normalize
    return path if path.endswith(".npz") else path + ".npz"


def _plans_path(path: str) -> str:
    return _npz_path(path)[:-4] + ".plans.npz"


def _atomic_write(path: str, writer, crash_point: str) -> None:
    """Crash-atomic publish: write a same-directory tmp, fsync, then
    ``os.replace``. A death at any instant, the ``crash_point`` between
    write and publish included (armed with ``fault.InjectedCrash``),
    leaves either the old complete file or the new one. An ordinary
    failure removes the tmp; a simulated crash (a ``BaseException``)
    leaves it behind as a real kill would: loaders never read ``*.tmp``
    and the next save overwrites it."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            writer(f)
            f.flush()
            os.fsync(f.fileno())
        if _FAULTS.enabled:
            _FAULTS.check(crash_point, path=path)
        os.replace(tmp, path)
    except Exception:
        try:
            os.unlink(tmp)
        except FileNotFoundError:
            pass
        raise


def save_snapshot(snap: CSRSnapshot, path: str,
                  with_plans: bool = False) -> None:
    """Persist the CSR arrays; ``with_plans=True`` also writes the pull-BFS
    plan pyramid beside the npz (``<path>.plans.npz``), so a restarted
    service skips the plan rebuild.

    The npz replaces first, the sidecar second: a crash between the two
    leaves a sidecar whose fingerprint does not match, which the loader
    treats as absent (a quiet rebuild), so every interleaving is safe."""
    by_type_keys = np.asarray(sorted(snap.by_type), dtype=np.int64)
    arrays = {
        "version": np.asarray([snap.version], dtype=np.int64),
        "num_atoms": np.asarray([snap.num_atoms], dtype=np.int64),
        "n_edges": np.asarray([snap.n_edges_inc, snap.n_edges_tgt],
                              dtype=np.int64),
        "inc_offsets": snap.inc_offsets,
        "inc_links": snap.inc_links,
        "inc_src": snap.inc_src,
        "tgt_offsets": snap.tgt_offsets,
        "tgt_flat": snap.tgt_flat,
        "tgt_src": snap.tgt_src,
        "type_of": snap.type_of,
        "is_link": snap.is_link,
        "arity": snap.arity,
        "value_rank": np.asarray(snap.value_rank, dtype=np.uint64),
        "value_kind": snap.value_kind,
        "by_type_keys": by_type_keys,
    }
    for name in _EXTRA_COLUMNS:
        arrays[name] = getattr(snap, name)
    for k in by_type_keys.tolist():
        arrays[f"bt_{k}"] = snap.by_type[int(k)]
    _atomic_write(
        _npz_path(path),
        lambda f: np.savez(f, **arrays),
        "ckpt.save_npz",
    )
    pp = _plans_path(path)
    if with_plans:
        from hypergraphdb_tpu_torch.ops.ellbfs import (
            plans_for,
            save_plans,
            snapshot_fingerprint,
        )

        plans = plans_for(snap)
        fp = snapshot_fingerprint(snap)
        _atomic_write(
            pp,
            lambda f: save_plans(plans, f, fingerprint=fp),
            "ckpt.save_plans",
        )
    elif os.path.exists(pp):
        # a snapshot saved without plans must not leave an older sidecar
        # for the loader (a crash before this remove leaves one whose
        # fingerprint does not match: treated as absent on load)
        os.remove(pp)


def load_snapshot(path: str) -> CSRSnapshot:
    """Restore a snapshot; a sibling ``.plans.npz`` (see
    :func:`save_snapshot`) is attached, so ``ellbfs.plans_for`` builds
    nothing. A stale sidecar (another snapshot's, or another plan format)
    rebuilds quietly; a corrupt or unreadable one is logged, counted
    (``fault.sidecar_corrupt``) and recorded as a flight incident, then
    rebuilt the same way: plans are derived data, the snapshot is
    intact."""
    with np.load(_npz_path(path), allow_pickle=False) as z:
        snap = _snapshot_from_npz(z)
    pp = _plans_path(path)
    if os.path.exists(pp):
        from hypergraphdb_tpu_torch.ops.ellbfs import (
            read_sidecar,
            snapshot_fingerprint,
        )

        plans = read_sidecar(pp, snapshot_fingerprint(snap))
        if plans is not None:
            object.__setattr__(snap, "_pull_plans", plans)
    return snap


def _snapshot_from_npz(z) -> CSRSnapshot:
    by_type = {
        int(k): z[f"bt_{int(k)}"] for k in z["by_type_keys"].tolist()
    }
    extra = {name: z[name] for name in _EXTRA_COLUMNS if name in z.files}
    return CSRSnapshot(
        version=int(z["version"][0]),
        num_atoms=int(z["num_atoms"][0]),
        inc_offsets=z["inc_offsets"],
        inc_links=z["inc_links"],
        inc_src=z["inc_src"],
        tgt_offsets=z["tgt_offsets"],
        tgt_flat=z["tgt_flat"],
        tgt_src=z["tgt_src"],
        type_of=z["type_of"],
        is_link=z["is_link"],
        arity=z["arity"],
        value_rank=z["value_rank"],
        # absent in the oldest reference checkpoints: kind "unknown"
        value_kind=(
            z["value_kind"] if "value_kind" in z.files
            else np.zeros(len(z["value_rank"]), dtype=np.uint8)
        ),
        by_type=by_type,
        n_edges_inc=int(z["n_edges"][0]),
        n_edges_tgt=int(z["n_edges"][1]),
        **extra,
    )


# ------------------------------------------------------------- logical dumps


def _atom_record(graph, h: int) -> Optional[dict]:
    rec = graph.store.get_link(h)
    if rec is None or len(rec) < 3:
        return None
    type_handle, value_handle, flags = rec[0], rec[1], rec[2]
    try:
        type_name = graph.typesystem.get_type(type_handle).name
    except TypeError_:
        return None  # a handle that is no type here: not an atom to dump
    data = graph.store.get_data(value_handle) if value_handle >= 0 else None
    return {
        "h": int(h),
        "type": type_name,
        "v": base64.b64encode(data).decode("ascii") if data is not None else None,
        "link": bool(flags & 1),
        "t": [int(t) for t in rec[3:]],
    }


def export_graph(graph, path: str) -> int:
    """Stream every atom (handle order: targets precede their links) to a
    JSONL file. Returns the number of atoms exported."""
    n = 0
    with open(path, "w", encoding="utf-8") as f:
        for h in graph.atoms():
            w = _atom_record(graph, int(h))
            if w is None:
                continue
            f.write(json.dumps(w) + "\n")
            n += 1
    return n


def _import_record(graph, w: dict, mapping: dict[int, int]) -> Optional[int]:
    # type atoms are re-created by the destination's own bootstrap: remap
    if w["type"] == "top":
        if w["v"] is not None:
            name = graph.typesystem.top.make(base64.b64decode(w["v"]))
            try:
                mapping[w["h"]] = int(graph.typesystem.handle_of(name))
            except TypeError_:
                pass  # not registered here: a link to it fails loudly at
                # the mapping lookup below
        return None
    atype = graph.typesystem.get_type(w["type"])
    value = atype.make(base64.b64decode(w["v"])) if w["v"] is not None else None
    try:
        targets = [mapping[t] for t in w["t"]]
    except KeyError as e:
        raise KeyError(
            f"import of atom {w['h']} references target {e.args[0]} that "
            "was not importable (its type is unknown here?)"
        ) from e
    if w["link"]:
        nh = graph.add_link(targets, value=value, type=w["type"])
    else:
        nh = graph.add_node(value, type=w["type"])
    mapping[w["h"]] = int(nh)
    return int(nh)


def import_graph(graph, path: str) -> dict[int, int]:
    """Load a JSONL dump; returns the old-handle → new-handle mapping. The
    whole import is ONE transaction: a failure part way (a bad record, an
    unknown type, an unresolvable target) rolls back every atom added so
    far."""
    mapping: dict[int, int] = {}

    def run() -> None:
        mapping.clear()  # retry-safe
        with open(path, encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    _import_record(graph, json.loads(line), mapping)

    graph.txman.transact(run)
    return mapping


def copy_subgraph(src, dst, roots: Sequence[int],
                  max_distance: Optional[int] = None) -> dict[int, int]:
    """Copy the traversal closure of ``roots`` from ``src`` into ``dst``
    (``CopyGraphTraversal.java:27``): every reached atom, the links that
    reached it, and the target closure their links need. Returns the
    handle mapping."""
    from hypergraphdb_tpu_torch.algorithms.traversals import (
        HGBreadthFirstTraversal,
    )

    wanted: set[int] = set(int(r) for r in roots)
    for r in roots:
        for link, a in HGBreadthFirstTraversal(src, int(r),
                                               max_distance=max_distance):
            wanted.add(int(a))
            if link is not None:
                wanted.add(int(link))
    # expand to the full target closure so links never dangle
    frontier = list(wanted)
    while frontier:
        h = frontier.pop()
        rec = src.store.get_link(h)
        if rec is None:
            continue
        for t in rec[3:]:
            if int(t) not in wanted:
                wanted.add(int(t))
                frontier.append(int(t))
    mapping: dict[int, int] = {}
    for h in sorted(wanted):  # ascending: targets precede links
        w = _atom_record(src, h)
        if w is not None:
            _import_record(dst, w, mapping)
    return mapping
