"""Index manager: user-registered indexers maintained on every mutation.

Re-expression of the reference's ``HGIndexManager``
(``core/.../indexing/HGIndexManager.java:62-215`` — register/unregister +
``maybeIndex`` called from the add path at ``HyperGraph.java:1618``) and the
``HGIndexer`` family (``ByPartIndexer``, ``ByTargetIndexer``,
``DirectValueIndexer``, ``CompositeIndexer``, ``LinkIndexer``,
``TargetToTargetIndexer``).

An indexer projects an (atom, type, value, targets) tuple to zero or more
(key, value) entries in a named storage index. Registration is per type
handle; ``maybe_index`` fires only for atoms of that type (or its subtypes).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

from hypergraphdb_tpu_torch.core.handles import HGHandle
from hypergraphdb_tpu_torch.utils.ordered_bytes import encode_int


class HGIndexer:
    """SPI: project an atom into index entries (``HGKeyIndexer`` analogue)."""

    #: storage index name; must be unique
    name: str
    #: type handle this indexer applies to
    type_handle: HGHandle

    def keys(
        self, graph, h: HGHandle, value: Any, targets: Optional[Sequence[HGHandle]]
    ) -> list[bytes]:
        raise NotImplementedError

    def values(
        self, graph, h: HGHandle, value: Any, targets: Optional[Sequence[HGHandle]]
    ) -> list[HGHandle]:
        """Indexed values; default: the atom handle itself."""
        return [h]


class ByPartIndexer(HGIndexer):
    """Index atoms of a record type by a projection path
    (``indexing/ByPartIndexer.java``)."""

    def __init__(self, name: str, type_handle: HGHandle, dimension: str):
        self.name = name
        self.type_handle = int(type_handle)
        self.dimension = dimension

    def keys(self, graph, h, value, targets):
        atype = graph.typesystem.get_type(self.type_handle)
        part = atype.project(value, self.dimension)
        if part is None:
            return []
        pt = graph.typesystem.infer(part)
        if pt is None:
            return []
        return [pt.to_key(part)]


class ByTargetIndexer(HGIndexer):
    """Index links by the target at a fixed position
    (``indexing/ByTargetIndexer.java``)."""

    def __init__(self, name: str, type_handle: HGHandle, position: int):
        self.name = name
        self.type_handle = int(type_handle)
        self.position = position

    def keys(self, graph, h, value, targets):
        if targets is None or self.position >= len(targets):
            return []
        return [encode_int(int(targets[self.position]))]


class DirectValueIndexer(HGIndexer):
    """Index atoms by their full value key (``DirectValueIndexer.java``)."""

    def __init__(self, name: str, type_handle: HGHandle):
        self.name = name
        self.type_handle = int(type_handle)

    def keys(self, graph, h, value, targets):
        atype = graph.typesystem.get_type(self.type_handle)
        return [atype.to_key(value)]


class CompositeIndexer(HGIndexer):
    """Concatenation of several indexers' keys (``CompositeIndexer.java``)."""

    def __init__(self, name: str, type_handle: HGHandle, parts: Sequence[HGIndexer]):
        self.name = name
        self.type_handle = int(type_handle)
        self.parts = list(parts)

    def keys(self, graph, h, value, targets):
        parts = []
        for p in self.parts:
            ks = p.keys(graph, h, value, targets)
            if not ks:
                return []
            parts.append(ks[0])
        return [b"\x00".join(parts)]


class LinkIndexer(HGIndexer):
    """Index links of a type by their FULL ordered target tuple
    (``indexing/LinkIndexer.java``): one key per link, the concatenation
    of its targets' order-preserving encodings — an exact-tuple lookup
    ("find the link (a, b, c)") without intersecting incidence sets."""

    def __init__(self, name: str, type_handle: HGHandle):
        self.name = name
        self.type_handle = int(type_handle)

    def keys(self, graph, h, value, targets):
        if not targets:
            return []
        return [b"".join(encode_int(int(t)) for t in targets)]

    @staticmethod
    def tuple_key(targets: Sequence[HGHandle]) -> bytes:
        """The lookup key for an ordered target tuple."""
        return b"".join(encode_int(int(t)) for t in targets)


class TargetToTargetIndexer(HGIndexer):
    """Bidirectional target→target index over links of a type
    (``TargetToTargetIndexer.java``): key = target at ``key_pos``, value =
    target at ``value_pos``."""

    def __init__(self, name: str, type_handle: HGHandle, key_pos: int, value_pos: int):
        self.name = name
        self.type_handle = int(type_handle)
        self.key_pos = key_pos
        self.value_pos = value_pos

    def keys(self, graph, h, value, targets):
        if targets is None or max(self.key_pos, self.value_pos) >= len(targets):
            return []
        return [encode_int(int(targets[self.key_pos]))]

    def values(self, graph, h, value, targets):
        if targets is None or max(self.key_pos, self.value_pos) >= len(targets):
            return []
        return [int(targets[self.value_pos])]


# -- persistence ---------------------------------------------------------------

#: storage index holding one JSON descriptor per registered indexer — the
#: analogue of the reference persisting indexer atoms so registrations
#: survive reopen (``HGIndexManager.java:62-215`` ``loadIndexers``)
_REG_INDEX = "hg.sys.indexers"


def _to_config(ix: HGIndexer) -> Optional[dict]:
    """JSON-able descriptor for the built-in indexer kinds; custom
    subclasses may implement ``to_config()`` themselves (returning a dict
    with a ``cls`` naming an importable class with ``from_config``)."""
    own = getattr(ix, "to_config", None)
    if own is not None:
        return own()
    if isinstance(ix, ByPartIndexer):
        return {"cls": "ByPartIndexer", "name": ix.name,
                "type_handle": ix.type_handle, "dimension": ix.dimension}
    if isinstance(ix, ByTargetIndexer):
        return {"cls": "ByTargetIndexer", "name": ix.name,
                "type_handle": ix.type_handle, "position": ix.position}
    if isinstance(ix, LinkIndexer):
        return {"cls": "LinkIndexer", "name": ix.name,
                "type_handle": ix.type_handle}
    if isinstance(ix, DirectValueIndexer):
        return {"cls": "DirectValueIndexer", "name": ix.name,
                "type_handle": ix.type_handle}
    if isinstance(ix, TargetToTargetIndexer):
        return {"cls": "TargetToTargetIndexer", "name": ix.name,
                "type_handle": ix.type_handle,
                "key_pos": ix.key_pos, "value_pos": ix.value_pos}
    if isinstance(ix, CompositeIndexer):
        parts = [_to_config(p) for p in ix.parts]
        if any(p is None for p in parts):
            return None
        return {"cls": "CompositeIndexer", "name": ix.name,
                "type_handle": ix.type_handle, "parts": parts}
    return None


def indexer_from_config(cfg: dict) -> HGIndexer:
    """The indexer a descriptor of :func:`_to_config` describes: how a
    registration carries across, between graphs or from the JAX
    package."""
    cls = cfg["cls"]
    if cls == "ByPartIndexer":
        return ByPartIndexer(cfg["name"], cfg["type_handle"], cfg["dimension"])
    if cls == "ByTargetIndexer":
        return ByTargetIndexer(cfg["name"], cfg["type_handle"], cfg["position"])
    if cls == "LinkIndexer":
        return LinkIndexer(cfg["name"], cfg["type_handle"])
    if cls == "DirectValueIndexer":
        return DirectValueIndexer(cfg["name"], cfg["type_handle"])
    if cls == "TargetToTargetIndexer":
        return TargetToTargetIndexer(cfg["name"], cfg["type_handle"],
                                     cfg["key_pos"], cfg["value_pos"])
    if cls == "CompositeIndexer":
        return CompositeIndexer(cfg["name"], cfg["type_handle"],
                                [indexer_from_config(p)
                                 for p in cfg["parts"]])
    # dotted path to a user class exposing from_config
    import importlib

    mod, _, attr = cls.rpartition(".")
    klass = getattr(importlib.import_module(mod), attr)
    return klass.from_config(cfg)


def load_indexers(graph) -> int:
    """Open path: restore persisted registrations into the in-process
    registry WITHOUT rebuilding (the index data itself is already in the
    store). Returns how many were loaded."""
    import json

    idx = graph.store.get_index(_REG_INDEX, create=False)
    if idx is None:
        return 0
    n = 0
    reg = _registry(graph)
    for key, _hs in idx.bulk_items():
        try:
            ix = indexer_from_config(json.loads(key.decode("utf-8")))
        except Exception:
            import logging

            logging.getLogger("hypergraphdb_tpu_torch.indexing").warning(
                "could not restore indexer registration %r", key, exc_info=True
            )
            continue
        if any(x.name == ix.name for xs in reg.values() for x in xs):
            continue
        reg.setdefault(int(ix.type_handle), []).append(ix)
        n += 1
    if n:
        _bump_registry_version(graph)
    return n


# -- registration + hooks ------------------------------------------------------

def _bump_registry_version(graph) -> None:
    graph._indexer_reg_version = getattr(graph, "_indexer_reg_version", 0) + 1


def register(graph, indexer: HGIndexer, populate: bool = True) -> None:
    """Register and (optionally) build the index over existing atoms — the
    online equivalent of the reference's offline ``ApplyNewIndexer``
    maintenance op (``maintenance/ApplyNewIndexer.java:36``). The
    registration descriptor is persisted so it survives reopen."""
    import json

    reg = _registry(graph)
    reg.setdefault(int(indexer.type_handle), []).append(indexer)
    _bump_registry_version(graph)
    cfg = _to_config(indexer)
    if cfg is not None:
        key = json.dumps(cfg, sort_keys=True).encode("utf-8")
        graph.txman.ensure_transaction(
            lambda: graph.store.get_index(_REG_INDEX).add_entry(key, 0)
        )
    if populate:
        rebuild(graph, indexer)


def unregister(graph, indexer_name: str) -> None:
    import json

    reg = _registry(graph)
    dropped: list[HGIndexer] = []
    for th, idxs in list(reg.items()):
        dropped += [ix for ix in idxs if ix.name == indexer_name]
        reg[th] = [ix for ix in idxs if ix.name != indexer_name]
        if not reg[th]:
            del reg[th]
    _bump_registry_version(graph)
    for ix in dropped:
        cfg = _to_config(ix)
        if cfg is not None:
            key = json.dumps(cfg, sort_keys=True).encode("utf-8")
            graph.txman.ensure_transaction(
                lambda k=key: graph.store.get_index(_REG_INDEX)
                .remove_entry(k, 0)
            )
    graph.store.remove_index(_storage_name(indexer_name))


def indexers_of(graph, type_handle: HGHandle) -> list[HGIndexer]:
    """All indexers applying to a type, including via supertype registration.

    Called from the per-atom write path, so the empty-registry case (the
    common one) exits before any supertype walk, and non-empty lookups are
    memoized until the registry or the type hierarchy changes."""
    reg = _registry(graph)
    if not reg:
        return []
    version = (getattr(graph, "_indexer_reg_version", 0),
               getattr(graph.typesystem, "hierarchy_version", 0))
    cache = getattr(graph, "_indexers_of_cache", None)
    if cache is None or cache[0] != version:
        cache = (version, {})
        graph._indexers_of_cache = cache
    memo = cache[1]
    th = int(type_handle)
    hit = memo.get(th)
    if hit is not None:
        return hit
    out = list(reg.get(th, ()))
    try:
        name = graph.typesystem.name_of(type_handle)
    except KeyError:
        memo[th] = out
        return out
    for sup in graph.typesystem.supertypes_of(name):
        try:
            sh = graph.typesystem.handle_of(sup)
        except Exception:
            continue
        out.extend(reg.get(int(sh), ()))
    memo[th] = out
    return out


def get_index(graph, indexer_name: str):
    """The queryable storage index for a registered indexer."""
    return graph.store.get_index(_storage_name(indexer_name), create=True)


# -- index statistics ----------------------------------------------------------

#: persisted per-index cardinality: name → data record holding
#: {keys, entries, capped, version}; the HGIndexStats analogue
#: (``storage/HGIndexStats.java:37`` feeding ``ResultSizeEstimation``)
_STATS_INDEX = "hg.sys.indexstats"

#: scan-cost ceiling when (re)counting an index (entries touched)
STATS_COST_CAP = 1 << 20


def index_stats(graph, indexer_name: str, refresh: bool = False) -> dict:
    """Per-index cardinality for the planner and for observability:
    ``{"keys": int, "entries": int, "capped": bool, "version": int}``.

    Computed by a cost-capped scan, PERSISTED next to the registrations,
    and reused across calls — and across reopens —
    mirroring the reference's cached cost-capped ``IndexStats``. Validity
    is double-checked: the session mutation counter must not have drifted
    more than 25% past the recorded version, AND the live key count (O(1))
    must sit within 25% of the recorded one — the key check is the
    cross-session authority, since the mutation counter resets at reopen
    (a negative counter drift says nothing about how much the index
    changed in between). ``refresh=True`` forces a
    recount. A count made inside a read-only transaction (the planner's,
    under ``find_all``) cannot persist, since such a transaction drops its
    writes; the reference then recounts on every query. The port keeps it
    in the graph's memory under the same validity rules."""
    import json

    current = int(getattr(graph, "_mutations", 0))
    key = indexer_name.encode("utf-8")
    idx = graph.store.get_index(_storage_name(indexer_name), create=False)
    if idx is None:
        idx = graph.store.get_index(indexer_name, create=False)  # system ix
    sidx = graph.store.get_index(_STATS_INDEX, create=False)
    memo = graph.__dict__.setdefault("_index_stats_memo", {})
    if not refresh:
        recs = []
        if sidx is not None:
            for dh in sidx.find(key).array().tolist():
                raw = graph.store.get_data(int(dh))
                if raw is not None:
                    recs.append(json.loads(raw.decode("utf-8")))
        if indexer_name in memo:
            recs.append(memo[indexer_name])
        try:
            live_keys = idx.key_count() if idx is not None else 0
        except Exception:
            live_keys = None
        for rec in recs:
            drift = current - int(rec.get("version", 0))
            rec_keys = int(rec.get("keys", 0))
            keys_ok = live_keys is not None and abs(
                live_keys - rec_keys
            ) <= max(rec_keys // 4, 1024)
            mut_ok = drift < 0 or drift <= max(
                int(rec.get("entries", 0)) // 4, 1024
            )
            if keys_ok and mut_ok:
                return rec
    if idx is None:
        return {"keys": 0, "entries": 0, "capped": False, "version": current}
    keys = 0
    entries = 0
    capped = False
    for _k, hs in idx.bulk_items():
        keys += 1
        entries += len(hs)
        if entries >= STATS_COST_CAP:
            capped = True
            break
    rec = {
        "keys": keys, "entries": entries, "capped": capped,
        "version": current,
    }
    t = graph.txman.current()
    while t is not None and not t.readonly:
        t = t.parent
    if t is not None:
        # a read-only transaction (every query runs in one) drops its
        # writes: keep the count in memory, under the same validity rules
        memo[indexer_name] = rec
        return rec

    def persist() -> None:
        sidx = graph.store.get_index(_STATS_INDEX)
        for old in sidx.find(key).array().tolist():
            sidx.remove_entry(key, int(old))
            graph.store.remove_data(int(old))
        dh = graph.handles.make()
        graph.store.store_data(
            dh, json.dumps(rec, sort_keys=True).encode("utf-8")
        )
        sidx.add_entry(key, dh)

    try:
        graph.txman.ensure_transaction(persist)
    except Exception:
        import logging

        logging.getLogger("hypergraphdb_tpu_torch.indexing").warning(
            "could not persist index stats for %s", indexer_name,
            exc_info=True,
        )
    return rec


def rebuild(graph, indexer: HGIndexer, batch: int = 1024) -> int:
    """(Re)build an index from scratch in batches (resumable maintenance —
    ``ApplyNewIndexer`` used batch=100 with a lastProcessed cursor)."""
    idx = get_index(graph, indexer.name)
    n = 0
    applicable = {int(indexer.type_handle)}
    try:
        tname = graph.typesystem.name_of(indexer.type_handle)
        for sub in graph.typesystem.subtypes_closure(tname):
            applicable.add(int(graph.typesystem.handle_of(sub)))
    except KeyError:
        pass
    for h in graph.atoms():
        rec = graph.store.get_link(h)
        if rec is None or int(rec[0]) not in applicable:
            continue
        value = graph.get(h)
        targets = None
        from hypergraphdb_tpu_torch.core.graph import HGLink

        if isinstance(value, HGLink):
            targets = value.targets
            value = value.value
        for key in indexer.keys(graph, h, value, targets):
            for v in indexer.values(graph, h, value, targets):
                idx.add_entry(key, v)
        n += 1
    return n


def maybe_index(
    graph,
    h: HGHandle,
    type_handle: HGHandle,
    value: Any,
    targets: Optional[Sequence[HGHandle]],
    touched: Optional[set] = None,
    before_write: Optional[Callable] = None,
) -> None:
    """Called from the kernel's add path (``HyperGraph.java:1618``).
    ``touched`` (if given) collects the ``(index_name, key)`` cells written
    — bulk loaders bump their transaction versions so open readers fail
    validation instead of committing on stale index reads.
    ``before_write(storage_name, key, idx)`` (if given) runs before the
    first entry lands on a key — bulk loaders capture MVCC pre-images
    there so snapshot readers keep their begin-time view."""
    for indexer in indexers_of(graph, type_handle):
        idx = get_index(graph, indexer.name)
        for key in indexer.keys(graph, h, value, targets):
            if before_write is not None:
                before_write(_storage_name(indexer.name), key, idx)
            for v in indexer.values(graph, h, value, targets):
                idx.add_entry(key, v)
            if touched is not None:
                # the STORAGE name — readers note ("idx", storage_name, key)
                # (core/store.py), so bumps must use the same cell id
                touched.add((_storage_name(indexer.name), key))


def maybe_unindex(
    graph,
    h: HGHandle,
    type_handle: HGHandle,
    value: Any,
    targets: Optional[Sequence[HGHandle]],
) -> None:
    for indexer in indexers_of(graph, type_handle):
        idx = get_index(graph, indexer.name)
        for key in indexer.keys(graph, h, value, targets):
            for v in indexer.values(graph, h, value, targets):
                idx.remove_entry(key, v)


def _registry(graph) -> dict[int, list[HGIndexer]]:
    reg = getattr(graph, "_indexer_registry", None)
    if reg is None:
        reg = graph._indexer_registry = {}
    return reg


def _storage_name(indexer_name: str) -> str:
    return f"hg.user.{indexer_name}"
