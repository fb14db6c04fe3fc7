"""HyperGraph — the graph kernel: atom CRUD and incidence maintenance.

The port of the store path of ``hypergraphdb_tpu/core/graph.py``:

- Every datum is an atom with a dense int handle. A link is an atom that
  also holds an ordered tuple of target atoms (links may target links).
- The stored record is ``(type_handle, value_handle, flags, *targets)``;
  ``flags`` bit 0 marks a link, so a 0-arity link differs from a node.
- Every add, replace and remove maintains the by-type and by-value system
  indexes, which the pack reads.
- Handles are numbered as in the JAX package: bootstrap makes ``top``,
  ``null`` and the eight predefined type atoms, and every non-null value
  takes its own handle before its atom's record is written.
- User indexers (``indexing/manager.py``) are kept on every write, and a
  removed atom leaves every subgraph it was in.
- Queries (``find_all``, ``find_one``, ``count``, ``get_one``) compile
  through ``query/compiler.py``; its device plans run on
  ``config.query.device``.

- The storage is the in-memory backend, the durable native engine
  (``store_backend="native"`` at ``location``) or a partitioned grid of
  either; a reopened store goes on numbering from its ``max_handle``.
- Open runs the format check and migration chain
  (``maintenance/migration.py``) before the indexers and the declared type
  hierarchy are restored; a store that refuses to open shuts its backend
  and the memory watcher down again.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional, Sequence

from hypergraphdb_tpu_torch.atom.subgraph import IDX_SUBGRAPH, member_key
from hypergraphdb_tpu_torch.atom.utilities import load_subsumptions
from hypergraphdb_tpu_torch.core import events as ev
from hypergraphdb_tpu_torch.core.config import HGConfiguration
from hypergraphdb_tpu_torch.core.errors import HGException, NotFoundError
from hypergraphdb_tpu_torch.core.handles import (
    NULL_HANDLE,
    HandleFactory,
    HGHandle,
    SequentialHandleFactory,
    UUIDHandleFactory,
)
from hypergraphdb_tpu_torch.core.store import HGStore
from hypergraphdb_tpu_torch.device import DEFAULT_DEVICE
from hypergraphdb_tpu_torch.indexing.manager import (
    load_indexers,
    maybe_index,
    maybe_unindex,
)
from hypergraphdb_tpu_torch.query.compiler import compile_query
from hypergraphdb_tpu_torch.storage.api import (
    HGSortedResultSet,
    StorageBackend,
)
from hypergraphdb_tpu_torch.tx.manager import _TOMBSTONE, HGTransactionManager
from hypergraphdb_tpu_torch.types.system import HGTypeSystem
from hypergraphdb_tpu_torch.utils.cache import LRUCache
from hypergraphdb_tpu_torch.utils.metrics import Metrics
from hypergraphdb_tpu_torch.utils.ordered_bytes import encode_int

_FLAG_LINK = 1

#: layout version of ``partitions.json``; a marker without one is version 1
_PARTITION_MARKER_VERSION = 1

#: the system indexes
IDX_BY_TYPE = "hg.bytype"
IDX_BY_VALUE = "hg.byvalue"
#: type name → type atom handle
IDX_TYPE_NAME = "hg.typename"


@dataclass(frozen=True)
class HGLink:
    """A loaded link atom: its value and ordered targets."""

    targets: tuple[HGHandle, ...]
    value: Any = None

    @property
    def arity(self) -> int:
        return len(self.targets)

    def target_at(self, i: int) -> HGHandle:
        return self.targets[i]


@dataclass
class HGStats:
    """Access counters."""

    atom_accesses: int = 0
    atom_loads: int = 0


def _type_key(type_handle: HGHandle) -> bytes:
    return encode_int(int(type_handle))


def _partition_count(loc: str, n_config: int) -> int:
    """The partition count of the grid at ``loc``: handles route by
    ``h % n``, so ``n`` is part of the layout. The first open records it in
    ``partitions.json``; every later open uses the recorded count, and a
    marker of an unknown layout version refuses to open."""
    import json
    import os

    os.makedirs(loc, exist_ok=True)
    marker = os.path.join(loc, "partitions.json")
    if os.path.exists(marker):
        with open(marker, encoding="utf-8") as f:
            rec = json.load(f)
        if rec.get("schema_version", 1) != _PARTITION_MARKER_VERSION:
            raise HGException(
                f"unsupported partition-marker schema in {marker}; this "
                f"build reads version {_PARTITION_MARKER_VERSION}")
        return int(rec["n_partitions"])
    with open(marker, "w", encoding="utf-8") as f:
        json.dump({"schema_version": _PARTITION_MARKER_VERSION,
                   "n_partitions": n_config}, f)
    return n_config


class HyperGraph:
    """An open hypergraph database."""

    def __init__(self, config: Optional[HGConfiguration] = None,
                 backend: Optional[StorageBackend] = None):
        self.config = config or HGConfiguration()
        if backend is None:
            backend = self._make_backend(self.config)
        self.backend = backend
        backend.startup()
        # taken before the bootstrap writes type atoms: a store that held
        # nothing is stamped with the current format, never migrated
        self._fresh_store = backend.max_handle() == 0
        self.txman = HGTransactionManager(
            backend, enabled=self.config.transactional)
        self.store = HGStore(
            backend, self.txman,
            incidence_cache_entries=self.config.cache.incidence_cache_entries,
            max_cached_incidence_set_size=(
                self.config.cache.max_cached_incidence_set_size),
        )
        if self.config.handle_factory == "uuid":
            self.handles: HandleFactory = UUIDHandleFactory()
        else:
            self.handles = SequentialHandleFactory()
        self.handles.reset(backend.max_handle())
        self.events = ev.HGEventManager()
        self._atom_cache: LRUCache = LRUCache(
            self.config.cache.atom_cache_size)
        # set before the bootstrap, so its commits are counted too
        self.metrics = Metrics()
        self.txman.metrics = self.metrics
        self.typesystem = HGTypeSystem(self)
        self.typesystem.bootstrap()
        self.stats = HGStats()
        self._snapshot_cache = None
        self._snapshot_mgr = None
        self._mutations = 0  # bumped on every committed structural change
        self._type_column = None
        self._memwatch = None
        if self.config.cache.memory_warning_bytes > 0:
            from hypergraphdb_tpu_torch.utils.cache import MemoryWarningSystem

            self._memwatch = MemoryWarningSystem(
                self.config.cache.memory_warning_bytes,
                self.config.cache.memory_warning_interval_s,
                metrics=self.metrics)
            self._memwatch.add_listener(self._atom_cache.clear)
            if self.store._inc_cache is not None:
                self._memwatch.add_listener(self.store._inc_cache.clear)
            self._memwatch.start()
        self._open = True
        try:
            # the format check and migrations first: a migration may
            # rewrite what the loaders below read
            from hypergraphdb_tpu_torch.maintenance.migration import migrate

            migrate(self)
            # restore registered indexers and the declared type hierarchy
            # from the store
            load_indexers(self)
            load_subsumptions(self)
        except BaseException:
            # a store that refuses to open (a newer format) must not keep
            # its backend's files or the watcher's thread
            if self._memwatch is not None:
                self._memwatch.stop()
                self._memwatch = None
            self._open = False
            self.backend.shutdown()
            raise
        self.events.dispatch(self, ev.HGOpenedEvent(graph=self))

    @staticmethod
    def _make_backend(config: HGConfiguration) -> StorageBackend:
        kind = config.store_backend
        if kind == "native":
            from hypergraphdb_tpu_torch.storage.native import NativeStorage

            if not config.location:
                # no directory of the caller's choosing: nothing is written
                # into the working directory (the reference uses ./.hgdb)
                raise HGException("store_backend='native' needs a location")
            return NativeStorage(config.location)
        if kind == "partitioned":
            from hypergraphdb_tpu_torch.storage.partitioned import (
                PartitionedStorage,
            )

            if not config.location:
                return PartitionedStorage(n_partitions=config.n_partitions)
            import os

            from hypergraphdb_tpu_torch.storage.native import NativeStorage

            loc = config.location
            n = _partition_count(loc, int(config.n_partitions))
            return PartitionedStorage(
                n_partitions=n,
                factory=lambda i: NativeStorage(os.path.join(loc, f"part{i}")))
        if kind != "memory":
            raise HGException(
                f"unknown storage backend {kind!r}: use 'memory', 'native' "
                f"or 'partitioned'")
        from hypergraphdb_tpu_torch.storage.memstore import MemStorage

        return MemStorage()

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        if not getattr(self, "_open", False):
            return
        self.events.dispatch(self, ev.HGClosingEvent(graph=self))
        if self._memwatch is not None:
            self._memwatch.stop()
            self._memwatch = None
        if self._snapshot_mgr is not None:
            self._snapshot_mgr.close()
            self._snapshot_mgr = None
        if self._type_column is not None:
            self._type_column.close()
            self._type_column = None
        self.backend.shutdown()
        self._open = False

    def __enter__(self) -> "HyperGraph":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _check_open(self) -> None:
        if not getattr(self, "_open", True):
            raise HGException("database is closed")

    # ------------------------------------------------------------------ add
    def add(self, value: Any = None, type: Optional[Any] = None,  # noqa: A002
            targets: Sequence[HGHandle] = ()) -> HGHandle:
        """Add an atom; non-empty ``targets`` (or an ``HGLink`` value)
        make it a link."""
        if isinstance(value, HGLink):
            return self.add_link(value.targets, value.value, type)
        if targets:
            return self.add_link(targets, value, type)
        return self.add_node(value, type)

    def add_node(self, value: Any, type: Optional[Any] = None  # noqa: A002
                 ) -> HGHandle:
        return self._add_atom(value, type, None)

    def add_link(self, targets: Sequence[HGHandle], value: Any = None,
                 type: Optional[Any] = None) -> HGHandle:  # noqa: A002
        return self._add_atom(value, type, tuple(int(t) for t in targets))

    def _resolve_type_handle(self, value: Any, type_: Optional[Any]
                             ) -> HGHandle:
        if type_ is None:
            if value is None:
                return self.typesystem.handle_of("null")
            return self.typesystem.get_type_handle(value)
        if isinstance(type_, str):
            return self.typesystem.handle_of(type_)
        return int(type_)

    def _add_atom(self, value: Any, type_: Optional[Any],
                  targets: Optional[tuple[int, ...]]) -> HGHandle:
        self._check_open()
        if (self.events.dispatch(self, ev.HGAtomProposeEvent(NULL_HANDLE,
                                                             value))
                == ev.HGListener.CANCEL):
            raise HGException("atom add vetoed by listener")
        type_handle = self._resolve_type_handle(value, type_)

        def run() -> HGHandle:
            h = self.handles.make()
            self._write_atom(h, type_handle, value, targets)
            return h

        h = self.txman.ensure_transaction(run)
        self._after_commit(lambda: self._committed_mutation(
            ev.HGAtomAddedEvent(h, value)))
        return h

    def _after_commit(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` now, or at the enclosing transaction's commit."""
        tx = self.txman.current()
        if tx is None:
            fn()
        else:
            tx.on_commit.append(fn)

    def _committed_mutation(self, event: ev.HGEvent, n: int = 1) -> None:
        self._mutations += n
        self.metrics.incr("graph.mutations", n)
        self.events.dispatch(self, event)

    def _write_atom(self, h: HGHandle, type_handle: HGHandle, value: Any,
                    targets: Optional[tuple[int, ...]]) -> None:
        """Store the value payload, the record, the system index entries and
        one incidence entry per target."""
        atype = self.typesystem.get_type(type_handle)
        if value is None and atype.name == "null":
            value_handle = NULL_HANDLE
        else:
            value_handle = self.handles.make()
            self.store.store_data(value_handle, atype.store(value))
        flags = _FLAG_LINK if targets is not None else 0
        record = (int(type_handle), int(value_handle), flags) + (targets
                                                                 or ())
        self.store.store_link(h, record)
        self.store.get_index(IDX_BY_TYPE).add_entry(_type_key(type_handle), h)
        self.store.get_index(IDX_BY_VALUE).add_entry(atype.to_key(value), h)
        for t in targets or ():
            self.store.add_incidence_link(t, h)
        maybe_index(self, h, type_handle, value, targets)

    def _find_type_atom(self, name: str) -> Optional[HGHandle]:
        idx = self.store.get_index(IDX_TYPE_NAME, create=False)
        if idx is None:
            return None
        return idx.find_first(name.encode("utf-8"))

    def _add_type_atom(self, name: str) -> HGHandle:
        """Bootstrap's type atom; ``top`` is its own type."""

        def run() -> HGHandle:
            h = self.handles.make()
            type_handle = (h if name == "top"
                           else self.typesystem.handle_of("top"))
            top = self.typesystem.top
            value_handle = self.handles.make()
            self.store.store_data(value_handle, top.store(name))
            self.store.store_link(h, (int(type_handle), int(value_handle), 0))
            self.store.get_index(IDX_BY_TYPE).add_entry(
                _type_key(type_handle), h)
            self.store.get_index(IDX_BY_VALUE).add_entry(top.to_key(name), h)
            self.store.get_index(IDX_TYPE_NAME).add_entry(
                name.encode("utf-8"), h)
            return h

        return self.txman.ensure_transaction(run)

    # ------------------------------------------------------------------ get
    def _record(self, handle: HGHandle) -> tuple:
        rec = self.store.get_link(int(handle))
        if rec is None:
            raise NotFoundError(handle)
        return rec

    def get(self, handle: HGHandle) -> Any:
        """An atom's value: links load as ``HGLink``, nodes as their bare
        value. The shared cache holds committed state only, so reads inside
        a transaction bypass it."""
        h = int(handle)
        in_tx = self.txman.current() is not None
        if not in_tx and h in self._atom_cache:
            self.stats.atom_accesses += 1
            return self._atom_cache.get(h)
        rec = self._record(h)
        value = self._load_value(rec)
        if rec[2] & _FLAG_LINK:
            value = HGLink(targets=tuple(rec[3:]), value=value)
        if not in_tx:
            self._atom_cache.put(h, value)
        self.stats.atom_loads += 1
        self.events.dispatch(self, ev.HGAtomLoadedEvent(h, value))
        return value

    def get_one(self, condition) -> Any:
        h = self.find_one(condition)
        return None if h is None else self.get(h)

    def get_type_handle_of(self, handle: HGHandle) -> HGHandle:
        return self._record(handle)[0]

    def get_targets(self, handle: HGHandle) -> tuple[HGHandle, ...]:
        return tuple(self._record(handle)[3:])

    def arity(self, handle: HGHandle) -> int:
        return len(self.get_targets(handle))

    def is_link(self, handle: HGHandle) -> bool:
        return bool(self._record(handle)[2] & _FLAG_LINK)

    def contains(self, handle: HGHandle) -> bool:
        return self.store.contains_link(int(handle))

    def _load_value(self, rec: tuple) -> Any:
        """The bare value of a stored record."""
        atype = self.typesystem.get_type(rec[0])
        if rec[1] == NULL_HANDLE:
            return None
        data = self.store.get_data(rec[1])
        return None if data is None else atype.make(data)

    # -------------------------------------------------------------- replace
    def replace(self, handle: HGHandle, value: Any,
                type: Optional[Any] = None) -> None:  # noqa: A002
        """Replace an atom's value in place, keeping its identity and
        incidence. A link's targets do not change."""
        h = int(handle)
        if (self.events.dispatch(self, ev.HGAtomReplaceRequestEvent(h, value))
                == ev.HGListener.CANCEL):
            raise HGException("atom replace vetoed by listener")

        def run() -> None:
            rec = self._record(h)
            old_type_handle, old_value_handle, flags = rec[0], rec[1], rec[2]
            old_type = self.typesystem.get_type(old_type_handle)
            old_value = self._load_value(rec)
            inner = value.value if isinstance(value, HGLink) else value
            new_type_handle = self._resolve_type_handle(inner, type)
            new_type = self.typesystem.get_type(new_type_handle)
            by_value = self.store.get_index(IDX_BY_VALUE)
            by_value.remove_entry(old_type.to_key(old_value), h)
            if old_value_handle != NULL_HANDLE:
                self.store.remove_data(old_value_handle)
            if new_type_handle != old_type_handle:
                by_type = self.store.get_index(IDX_BY_TYPE)
                by_type.remove_entry(_type_key(old_type_handle), h)
                by_type.add_entry(_type_key(new_type_handle), h)
            if inner is None and new_type.name == "null":
                new_value_handle = NULL_HANDLE
            else:
                new_value_handle = self.handles.make()
                self.store.store_data(new_value_handle, new_type.store(inner))
            by_value.add_entry(new_type.to_key(inner), h)
            targets = tuple(rec[3:])
            self.store.store_link(h, (int(new_type_handle),
                                      int(new_value_handle), flags)
                                  + targets)
            maybe_unindex(self, h, old_type_handle, old_value,
                          targets or None)
            maybe_index(self, h, new_type_handle, inner, targets or None)

        self.txman.ensure_transaction(run)
        self._atom_cache.invalidate(h)
        self._after_commit(lambda: self._committed_mutation(
            ev.HGAtomReplacedEvent(h, value)))

    # --------------------------------------------------------------- remove
    def remove(self, handle: HGHandle,
               keep_incident_links: Optional[bool] = None) -> bool:
        """Remove an atom. Incident links are removed with it (recursively),
        or with ``keep_incident_links`` keep their records with this atom
        dropped from their targets. A type atom cannot be removed."""
        h = int(handle)
        self._check_open()
        if not self.store.contains_link(h):
            return False
        if self.typesystem.is_type_handle(h):
            raise HGException(
                f"handle {h} is a registered type atom; types in use cannot "
                "be removed")
        keep = (self.config.keep_incident_links_on_removal
                if keep_incident_links is None else keep_incident_links)
        removed: set[int] = set()
        rewritten: set[int] = set()
        vetoed: list[bool] = []

        def run() -> None:
            removed.clear()  # a retry starts over
            rewritten.clear()
            vetoed.clear()
            # the veto runs inside the removal's transaction: no commit
            # lands between the verdict and the removal
            if (self.events.dispatch(self, ev.HGAtomRemoveRequestEvent(h))
                    == ev.HGListener.CANCEL):
                vetoed.append(True)
                return
            self._remove_rec(h, keep, removed, rewritten)

        self.txman.ensure_transaction(run)
        if vetoed:
            return False

        def fire() -> None:
            # one event per removed atom, the cascade included, and a
            # replaced event per link whose targets were rewritten
            self._committed_mutation(ev.HGAtomRemovedEvent(h))
            for other in removed - {h}:
                self._committed_mutation(ev.HGAtomRemovedEvent(other))
            for link in rewritten - removed:
                self._committed_mutation(ev.HGAtomReplacedEvent(link))

        self._after_commit(fire)
        return True

    def _remove_rec(self, h: int, keep: bool, seen: set[int],
                    rewritten: set[int], root: bool = True) -> None:
        if h in seen:
            return
        seen.add(h)
        rec = self.store.get_link(h)
        if rec is None:
            return
        # a veto anywhere in the cascade aborts the whole removal
        if not root and (
                self.events.dispatch(self, ev.HGAtomRemoveRequestEvent(h))
                == ev.HGListener.CANCEL):
            raise HGException(f"cascade removal of atom {h} vetoed by "
                              f"listener")
        type_handle, value_handle = rec[0], rec[1]
        targets = tuple(rec[3:])
        for link in self.store.get_incidence_set(h).array().tolist():
            link = int(link)
            if not keep:
                self._remove_rec(link, keep, seen, rewritten, root=False)
                continue
            lrec = self.store.get_link(link)
            if lrec is None:
                continue
            old_targets = tuple(lrec[3:])
            newt = tuple(t for t in old_targets if t != h)
            # the user indexers run again: target positions shift
            lvalue = self._load_value(lrec)
            maybe_unindex(self, link, lrec[0], lvalue, old_targets)
            self.store.store_link(link, lrec[:3] + newt)
            maybe_index(self, link, lrec[0], lvalue, newt)
            self._atom_cache.invalidate(link)
            rewritten.add(link)
        atype = self.typesystem.get_type(type_handle)
        value = self._load_value(rec)
        if value_handle != NULL_HANDLE:
            self.store.remove_data(value_handle)
        self.store.get_index(IDX_BY_TYPE).remove_entry(_type_key(type_handle),
                                                       h)
        self.store.get_index(IDX_BY_VALUE).remove_entry(atype.to_key(value), h)
        maybe_unindex(self, h, type_handle, value, targets or None)
        # leave every subgraph, and if the atom is a subgraph, drop its
        # member list
        sub_idx = self.store.get_index(IDX_SUBGRAPH, create=False)
        if sub_idx is not None:
            for key in sub_idx.find_by_value(h):
                sub_idx.remove_entry(key, h)
            sub_idx.remove_all_entries(member_key(h))
        for t in targets:
            self.store.remove_incidence_link(t, h)
        self.store.remove_incidence_set(h)
        self.store.remove_link(h)
        self._atom_cache.invalidate(h)

    # ------------------------------------------------------- incidence, scans
    def get_incidence_set(self, handle: HGHandle) -> HGSortedResultSet:
        """The sorted links that point at ``handle``."""
        return self.store.get_incidence_set(int(handle))

    # -------------------------------------------------------------- queries
    def find_all(self, condition) -> list[HGHandle]:
        return list(compile_query(self, condition).execute())

    def find_one(self, condition) -> Optional[HGHandle]:
        for h in compile_query(self, condition).execute():
            return h
        return None

    def count(self, condition) -> int:
        return compile_query(self, condition).count()

    def atoms(self) -> Iterator[HGHandle]:
        """Every atom handle, ascending, as this thread's transaction sees
        them."""
        ids, _, _ = self.backend.bulk_links()
        tx = self.txman.current()
        if tx is None:
            yield from ids.tolist()
            return
        chain = []
        while tx is not None:
            chain.append(tx)
            tx = tx.parent
        overlay: dict[int, Any] = {}
        for t in reversed(chain):  # inner shadows outer
            overlay.update(t.links)
        extra = {h for h, v in overlay.items() if v is not _TOMBSTONE}
        dead = {h for h, v in overlay.items() if v is _TOMBSTONE}
        yield from sorted((set(ids.tolist()) - dead) | extra)

    def atom_count(self) -> int:
        return sum(1 for _ in self.atoms())

    # ------------------------------------------------------------ bulk ingest
    def _fire_added(self, r: range, values) -> None:
        """Added events for a bulk range, or one counter bump when nobody
        listens."""
        if self.events.has_listeners_for(ev.HGAtomAddedEvent):
            for i, h in enumerate(r):
                v = values[i] if values is not None else None
                self._committed_mutation(ev.HGAtomAddedEvent(h, v))
        else:
            self._mutations += len(r)
            self.metrics.incr("graph.mutations", len(r))

    def add_nodes_bulk(self, values: Sequence[Any],
                       type: Optional[Any] = None) -> range:  # noqa: A002
        """Nodes under contiguous handles."""

        def run() -> range:
            r = self.handles.make_many(len(values))
            for h, v in zip(r, values):
                self._write_atom(h, self._resolve_type_handle(v, type), v,
                                 None)
            return r

        r = self.txman.ensure_transaction(run)
        self._after_commit(lambda: self._fire_added(r, values))
        return r

    def add_links_bulk(self, target_lists: Sequence[Sequence[HGHandle]],
                       values: Optional[Sequence[Any]] = None,
                       type: Optional[Any] = None) -> range:  # noqa: A002
        def run() -> range:
            r = self.handles.make_many(len(target_lists))
            for i, (h, ts) in enumerate(zip(r, target_lists)):
                v = values[i] if values is not None else None
                self._write_atom(h, self._resolve_type_handle(v, type), v,
                                 tuple(int(t) for t in ts))
            return r

        r = self.txman.ensure_transaction(run)
        self._after_commit(lambda: self._fire_added(r, values))
        return r

    def bulk_import(self, values=None, target_lists=None,
                    type=None):  # noqa: A002
        """High-throughput single-type batch ingest (``core/bulkload``)."""
        from hypergraphdb_tpu_torch.core.bulkload import bulk_import

        return bulk_import(self, values=values, target_lists=target_lists,
                           type=type)

    # ------------------------------------------------------------- snapshots
    def enable_incremental(self, headroom: float = 2.0,
                           compact_ratio: float = 0.5,
                           background: bool = True,
                           device=DEFAULT_DEVICE, **kw):
        """Switch to incremental snapshot mode: from now on
        :meth:`snapshot` returns the current base of a (base, delta) pair
        kept by a :class:`~hypergraphdb_tpu_torch.ops.incremental.
        SnapshotManager` on ``device`` (the card unless the caller asks for
        the CPU). Returns the manager."""
        if self._snapshot_mgr is None:
            from hypergraphdb_tpu_torch.ops.incremental import SnapshotManager

            self._snapshot_mgr = SnapshotManager(
                self, headroom=headroom, compact_ratio=compact_ratio,
                background=background, device=device, **kw)
        return self._snapshot_mgr

    @property
    def incremental(self):
        """The active SnapshotManager, or None."""
        return self._snapshot_mgr

    def type_column(self):
        """The hot host handle → type column (``utils/typecolumn.py``),
        built on first use."""
        if self._type_column is None:
            from hypergraphdb_tpu_torch.utils.typecolumn import TypeColumn

            self._type_column = TypeColumn(self)
        return self._type_column

    def snapshot(self, refresh: bool = False):
        """The packed host snapshot, cached until the next mutation; in
        incremental mode the manager's current base."""
        from hypergraphdb_tpu_torch.ops.snapshot import CSRSnapshot

        if self._snapshot_mgr is not None and not refresh:
            self.metrics.incr("snapshot.cache_hits")
            return self._snapshot_mgr.base
        snap = self._snapshot_cache
        if snap is not None and not refresh and snap.version == self._mutations:
            self.metrics.incr("snapshot.cache_hits")
            return snap
        with self.metrics.timer("snapshot.pack"):
            snap = CSRSnapshot.pack(self, version=self._mutations)
        self.metrics.gauge("snapshot.num_atoms", snap.num_atoms)
        self.metrics.gauge("snapshot.incidence_edges", snap.n_edges_inc)
        self._snapshot_cache = snap
        return snap

    def type_handle(self, name: str) -> HGHandle:
        return self.typesystem.handle_of(name)
