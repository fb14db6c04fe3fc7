"""Atom (sub)graph transfer: serialize atom closures between peers.

Re-expression of ``SubgraphManager`` (``peer/SubgraphManager.java:57``) —
atoms travel as (type name, value bytes, target refs) records and are
written through on the receiving side. Identity: local handles are dense
per-graph ints (not the reference's global UUIDs), so every transferred
atom carries a **global id** ``origin_peer:origin_handle``; each peer keeps
a persistent ``hg.peer.atommap`` index translating global ids to local
handles (created on first sight, updated on replace)."""

from __future__ import annotations

import base64
from typing import Optional

IDX_ATOM_MAP = "hg.peer.atommap"


def global_id(origin_peer: str, origin_handle: int) -> str:
    return f"{origin_peer}:{int(origin_handle)}"


def existing_gid(graph, h: int):
    """The atom's global id IF it ever crossed the replication boundary,
    else None — a pure lookup. Removal paths must use this: minting a
    fresh gid for a never-replicated atom would announce the death of an
    identity no peer has ever heard of AND permanently pollute the atom
    map with an entry for a now-gone handle."""
    keys = _atom_map(graph).find_by_value(int(h))
    return keys[0].decode("utf-8") if keys else None


def gid_of(graph, h: int, origin_peer: str) -> str:
    """The atom's global id. Atoms that arrived FROM another peer (or were
    exported before) already have a mapping in the atom map — reuse it, so
    a replicated atom keeps ONE identity everywhere instead of being
    re-minted (and duplicated) on push-back. Fresh local atoms are assigned
    ``origin_peer:handle`` and recorded for the same reason.

    A handle→gid memo rides on the graph: a gid never changes once
    assigned and handles are never reused, so positive results cache
    forever (the push worker calls this for every target of every
    mutation — an index lookup each was the hottest line in the profile)."""
    h = int(h)
    cache = getattr(graph, "_gid_cache", None)
    if cache is None:
        cache = graph._gid_cache = {}
    hit = cache.get(h)
    if hit is not None:
        return hit
    cur = graph.txman.current()
    keys = _atom_map(graph).find_by_value(h)
    if keys:
        gid = keys[0].decode("utf-8")
        if cur is None:
            cache[h] = gid
        else:
            # find_by_value merges the tx OVERLAY: this gid may only be
            # STAGED (e.g. minted earlier in this very tx) — caching now
            # would poison the forever-cache if the tx aborts/conflicts
            cur.on_commit.append(lambda: cache.__setitem__(h, gid))
        return gid
    gid = global_id(origin_peer, h)
    graph.txman.ensure_transaction(
        lambda: _atom_map(graph).add_entry(gid.encode("utf-8"), h)
    )
    if cur is not None:
        cur.on_commit.append(lambda: cache.__setitem__(h, gid))
    else:
        cache[h] = gid  # ensure_transaction committed before returning
    return gid


# -- type schemas over the wire (SyncTypes, ref peer/cact/SyncTypes.java) -----


def describe_type(graph, name: str) -> Optional[dict]:
    """Wire schema of a registered type: record types travel with their
    full shape (fields, declared supertypes) so a peer WITHOUT the
    defining dataclass can still install, store, query and index atoms of
    the type; everything else is named only (builtins exist everywhere)."""
    from hypergraphdb_tpu_torch.types.record import RecordType

    ts = graph.typesystem
    t = ts._by_name.get(name)
    if t is None:
        return None
    if isinstance(t, RecordType):
        return {
            "schema": "record",
            "name": name,
            "fields": list(t.fields),
            "supertype_names": list(t.supertype_names),
            "supertypes": sorted(ts._supertypes.get(name, ())),
        }
    return {"schema": "builtin", "name": name}


def install_type(graph, desc: dict) -> int:
    """Install a remote type schema locally (the receiving half of
    SyncTypes): record schemas register a class-less :class:`RecordType`
    (values revive as field dicts — the reference degrades the same way
    when the Java class is off the classpath); builtin names must already
    exist. Idempotent; returns the local type-atom handle."""
    from hypergraphdb_tpu_torch.core.errors import TypeError_
    from hypergraphdb_tpu_torch.types.record import RecordType

    ts = graph.typesystem
    name = desc["name"]
    if name in ts._by_name:
        return int(ts.handle_of(name))
    if desc.get("schema") != "record":
        raise TypeError_(
            f"cannot install remote type {name!r}: schema "
            f"{desc.get('schema')!r} has no local implementation"
        )
    rt = RecordType(
        name, None,
        tuple(desc.get("fields", ())),
        tuple(desc.get("supertype_names", ())),
    )
    return int(ts.register(rt, supertypes=tuple(desc.get("supertypes", ()))))


def serialize_atom(graph, h: int, origin_peer: str) -> dict:
    """One atom → wire dict; the atom and its targets are referenced by
    their global ids (existing mappings reused, see ``gid_of``). Record
    types ride along as schemas; type ATOMS are flagged so receivers map
    them onto their own type atoms instead of duplicating them."""
    h = int(h)
    rec = graph.store.get_link(h)
    if rec is None:
        raise KeyError(h)
    type_handle, value_handle, flags = rec[0], rec[1], rec[2]
    targets = rec[3:]
    data = graph.store.get_data(value_handle) if value_handle >= 0 else None
    ts = graph.typesystem
    type_name = ts.name_of(type_handle)
    wire = {
        "gid": gid_of(graph, h, origin_peer),
        "type": type_name,
        "value_b64": (
            base64.b64encode(data).decode("ascii") if data is not None else None
        ),
        "is_link": bool(flags & 1),
        "targets": [gid_of(graph, t, origin_peer) for t in targets],
    }
    schema = describe_type(graph, type_name)
    if schema is not None and schema["schema"] != "builtin":
        wire["type_schema"] = schema
    named = ts._type_atom_name(h)
    if named is not None:
        wire["is_type_atom"] = True
        atom_schema = describe_type(graph, named)
        if atom_schema is not None:
            wire["atom_schema"] = atom_schema
    return wire


def serialize_closure(graph, h: int, origin_peer: str) -> list[dict]:
    """The atom plus its transitive target closure, dependencies first."""
    out: list[dict] = []
    seen: set[int] = set()

    def visit(x: int) -> None:
        x = int(x)
        if x in seen:
            return
        seen.add(x)
        rec = graph.store.get_link(x)
        if rec is None:
            return
        for t in rec[3:]:
            visit(t)
        out.append(serialize_atom(graph, x, origin_peer))

    visit(h)
    return out


def _atom_map(graph):
    return graph.store.get_index(IDX_ATOM_MAP)


def lookup_local(graph, gid: str) -> Optional[int]:
    return _atom_map(graph).find_first(gid.encode("utf-8"))


def store_atom(graph, wire: dict) -> int:
    """Write one transferred atom in one transaction (see
    :func:`_store_atom`)."""
    return graph.txman.ensure_transaction(lambda: _store_atom(graph, wire))


def _store_atom(graph, wire: dict) -> int:
    """Write one transferred atom (write-through, ``HGStore.attachOverlayGraph``
    analogue): create or replace the local twin of ``wire['gid']``.
    Targets must already be mapped (send closures dependencies-first).

    Type handling (SyncTypes semantics): a transferred TYPE ATOM maps onto
    the receiver's own type atom for that name (never duplicated — links
    targeting it, e.g. Subsumes, land on the local type atom); an atom
    whose record type is unknown locally installs the schema shipped in
    ``type_schema`` first."""
    from hypergraphdb_tpu_torch.core.errors import TypeError_

    gid = wire["gid"]
    ts = graph.typesystem
    if wire.get("is_type_atom"):
        name = (
            ts.top.make(base64.b64decode(wire["value_b64"]))
            if wire.get("value_b64") is not None else None
        )
        if name is None:
            raise TypeError_(f"type atom {gid} carries no name")
        if wire.get("atom_schema") is not None:
            local_t = install_type(graph, wire["atom_schema"])
        elif name in ts._by_name:
            local_t = int(ts.handle_of(name))
        else:
            raise TypeError_(
                f"transferred type atom {name!r} has no local "
                "implementation and no wire schema"
            )
        prev = lookup_local(graph, gid)
        if prev is None:
            graph.txman.ensure_transaction(
                lambda: _atom_map(graph).add_entry(
                    gid.encode("utf-8"), local_t
                )
            )
        return local_t
    if wire["type"] not in ts._by_name and wire.get("type_schema") is not None:
        install_type(graph, wire["type_schema"])
    atype = graph.typesystem.get_type(wire["type"])
    value = (
        atype.make(base64.b64decode(wire["value_b64"]))
        if wire["value_b64"] is not None
        else None
    )
    targets = []
    for tg in wire["targets"]:
        lt = lookup_local(graph, tg)
        if lt is None:
            raise KeyError(f"unmapped target {tg}")
        targets.append(int(lt))

    local = lookup_local(graph, gid)
    if local is not None:
        if graph.contains(local):
            # explicit type: a dict-revived record value must not be
            # re-inferred as 'dict'
            graph.replace(local, value, type=wire["type"])
            return int(local)
        _atom_map(graph).remove_entry(gid.encode("utf-8"), local)
    if wire["is_link"]:
        h = graph.add_link(targets, value=value, type=wire["type"])
    else:
        h = graph.add_node(value, type=wire["type"])
    _atom_map(graph).add_entry(gid.encode("utf-8"), int(h))
    return int(h)


def store_closure(graph, atoms: list[dict]) -> list[int]:
    """Write a closure or a transfer page in ONE transaction: an atom and
    its atom-map entry commit together, so a listener woken by the atom
    (this peer's own push worker among them) always finds its gid and
    never mints a second one; and a page costs one commit, not two per
    atom."""
    return graph.txman.ensure_transaction(
        lambda: [_store_atom(graph, w) for w in atoms])


def content_digest(graph) -> str:
    """Order-insensitive digest of the graph's REPLICATED content: every
    LIVE atom with a global id hashes as (gid, type name, value bytes,
    sorted target gids), and the per-atom hashes combine by modular sum —
    so local handle assignment, atom-map iteration order, and the path an
    atom took here (push vs catch-up vs snapshot transfer) cannot change
    the digest. Two peers whose digests match hold identical replicated
    universes; the differential convergence tests and the chaos soaks
    assert exactly this (atoms that never crossed the replication
    boundary have no gid and are deliberately outside the digest)."""
    import hashlib

    # outside a transaction every read is of the committed state, so read
    # it from the backend itself (the transaction view's reads cost a
    # stack lookup and an overlay merge each)
    src = graph.backend if graph.txman.current() is None else graph.store
    idx = src.get_index(IDX_ATOM_MAP, create=False)
    gid_of_handle: dict[int, str] = {}
    pairs: list[tuple[str, int]] = []
    for key, hs in (idx.bulk_items() if idx is not None else ()):
        gid = key.decode("utf-8")
        for h in hs.tolist():
            gid_of_handle[int(h)] = gid
            pairs.append((gid, int(h)))
    total = 0
    for gid, h in pairs:
        rec = src.get_link(h)
        if rec is None:
            continue  # tombstoned twin: both sides skip it
        value_handle = rec[1]
        data = src.get_data(value_handle) if value_handle >= 0 else None
        tgids = sorted(
            gid_of_handle.get(int(t), str(int(t))) for t in rec[3:]
        )
        hh = hashlib.sha256()
        hh.update(gid.encode("utf-8"))
        hh.update(b"\x00")
        hh.update(graph.typesystem.name_of(rec[0]).encode("utf-8"))
        hh.update(b"\x00")
        hh.update(data if data is not None else b"\xff")
        hh.update(b"\x00")
        hh.update("|".join(tgids).encode("utf-8"))
        total = (total + int.from_bytes(hh.digest()[:16], "big")) % (1 << 128)
    return f"{total:032x}"
