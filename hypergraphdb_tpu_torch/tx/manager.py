"""MVCC / optimistic transactions over a storage backend.

The backend holds committed state only; every buffer and every check lives
here. A transaction records the version of each logical cell it reads
(``("link", h)``, ``("data", h)``, ``("inc", atom)``, ``("idx", name,
key)``); commit validates those versions under the commit lock, applies
the buffered writes and bumps the written cells. Reads inside a
transaction see the committed state as of its begin (the pre-images other
commits capture while it is open) plus its own writes.

Lock order in the graph layer: the commit lock (``_commit_lock``) comes
first, then a snapshot manager's lock, then its memtable's.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Callable, Optional, TypeVar

import numpy as np

from hypergraphdb_tpu_torch.core.errors import (
    TransactionAborted,
    TransactionConflict,
)
from hypergraphdb_tpu_torch.fault import global_faults
from hypergraphdb_tpu_torch.storage.api import StorageBackend

T = TypeVar("T")

#: process fault registry (singleton contract): a crash drill arms
#: ``tx.commit.pre`` / ``tx.commit.apply`` and fails the k-th write
#: commit — one attribute read per commit while disabled
_FAULTS = global_faults()

_TOMBSTONE = object()


class _IncDelta:
    __slots__ = ("added", "removed", "cleared")

    def __init__(self) -> None:
        self.added: set[int] = set()
        self.removed: set[int] = set()
        self.cleared = False

    def add(self, link: int) -> None:
        self.removed.discard(link)
        self.added.add(link)

    def remove(self, link: int) -> None:
        self.added.discard(link)
        self.removed.add(link)

    def clear(self) -> None:
        self.added.clear()
        self.removed.clear()
        self.cleared = True


class _IdxDelta:
    __slots__ = ("added", "removed", "removed_all")

    def __init__(self) -> None:
        self.added: set[int] = set()
        self.removed: set[int] = set()
        self.removed_all = False

    def add(self, v: int) -> None:
        self.removed.discard(v)
        self.added.add(v)

    def remove(self, v: int) -> None:
        self.added.discard(v)
        self.removed.add(v)


class HGTransaction:
    """One (possibly nested) transaction's buffered state."""

    def __init__(self, mgr: "HGTransactionManager",
                 parent: Optional["HGTransaction"], readonly: bool = False):
        self.mgr = mgr
        self.parent = parent
        self.readonly = readonly
        self.active = True
        # reads see the committed state as of this version; nested
        # transactions share the top level's
        self.start_version = (
            parent.start_version if parent is not None else mgr._clock)
        self.read_set: dict[tuple, int] = {}
        self.links: dict[int, Any] = {}            # h -> tuple | _TOMBSTONE
        self.data: dict[int, Any] = {}             # h -> bytes | _TOMBSTONE
        self.inc: dict[int, _IncDelta] = {}        # atom -> delta
        self.idx: dict[tuple[str, bytes], _IdxDelta] = {}
        #: (index, value) -> keys whose delta here names the value, and
        #: index -> keys wiped here: ``find_by_value`` reads these
        #: instead of walking ``idx`` (a superset; each key is then
        #: judged by its delta)
        self.idx_by_value: dict[tuple[str, int], set[bytes]] = {}
        self.idx_wiped: dict[str, set[bytes]] = {}
        #: run after (and dropped unless) the top-level commit: listeners
        #: never see atoms that do not commit
        self.on_commit: list[Callable[[], None]] = []

    def note_read(self, cell: tuple) -> None:
        if self.readonly:
            return
        v = self.mgr.cell_version(cell)
        # a cell already past this transaction's snapshot was read stale:
        # record a version that can never validate
        self.read_set.setdefault(cell, v if v <= self.start_version else -1)

    def is_empty(self) -> bool:
        return not (self.links or self.data or self.inc or self.idx)

    def merge_into(self, p: "HGTransaction") -> None:
        """A nested commit: fold this transaction into its parent."""
        for c, v in self.read_set.items():
            p.read_set.setdefault(c, v)
        p.links.update(self.links)
        p.data.update(self.data)
        for atom, d in self.inc.items():
            pd = p.inc.setdefault(atom, _IncDelta())
            if d.cleared:
                pd.clear()
            for link in d.added:
                pd.add(link)
            for link in d.removed:
                pd.remove(link)
        for key, d in self.idx.items():
            pd = p.idx.setdefault(key, _IdxDelta())
            if d.removed_all:
                pd.added.clear()
                pd.removed.clear()
                pd.removed_all = True
            for v in d.added:
                pd.add(v)
            for v in d.removed:
                pd.remove(v)
        for key, ks in self.idx_by_value.items():
            p.idx_by_value.setdefault(key, set()).update(ks)
        for name, ks in self.idx_wiped.items():
            p.idx_wiped.setdefault(name, set()).update(ks)
        p.on_commit.extend(self.on_commit)


class HGTransactionManager:
    """The commit lock, the version clock and per-thread transaction
    stacks."""

    def __init__(self, backend: StorageBackend, enabled: bool = True):
        self.backend = backend
        self.enabled = enabled
        self._commit_lock = threading.Lock()
        self._versions: dict[tuple, int] = {}
        self._clock = 0
        self._tls = threading.local()
        # per cell, ascending (version, pre-image): "just before commit
        # `version` the committed value was `pre-image`". Captured only
        # while another transaction is open, dropped once no open
        # snapshot can reach it.
        self._history: dict[tuple, list[tuple[int, Any]]] = {}
        #: id(tx) -> start_version of every open top-level transaction
        self._active: dict[int, int] = {}
        self.committed = 0
        self.conflicted = 0
        self.aborted = 0
        self.metrics = None  # utils.metrics.Metrics, set by the graph

    def _stack(self) -> list[HGTransaction]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current(self) -> Optional[HGTransaction]:
        st = self._stack()
        return st[-1] if st else None

    @contextmanager
    def scoped(self, tx: Optional[HGTransaction]):
        """Join ``tx`` from another thread for the block: the parallel
        union's workers run child plans under the caller's transaction.
        Safe for reads only; a worker must not write through it."""
        if tx is None:
            yield
            return
        st = self._stack()
        st.append(tx)
        try:
            yield
        finally:
            st.pop()

    def _incr(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.incr(name)

    def begin(self, readonly: bool = False) -> HGTransaction:
        tx = HGTransaction(self, self.current(), readonly=readonly)
        if tx.parent is None:
            # the snapshot version and the registration are atomic with
            # commits: a commit between them would skip the pre-images
            # this transaction needs
            with self._commit_lock:
                tx.start_version = self._clock
                self._active[id(tx)] = tx.start_version
        self._stack().append(tx)
        return tx

    def abort(self, tx: HGTransaction) -> None:
        st = self._stack()
        if not st or st[-1] is not tx:
            raise TransactionAborted("abort of non-innermost transaction")
        st.pop()
        tx.active = False
        if tx.parent is None:
            self._active.pop(id(tx), None)
        with self._commit_lock:
            self.aborted += 1
        self._incr("tx.aborts")

    def commit(self, tx: HGTransaction) -> None:
        st = self._stack()
        if not st or st[-1] is not tx:
            raise TransactionAborted("commit of non-innermost transaction")
        st.pop()
        tx.active = False
        if tx.parent is not None:
            tx.merge_into(tx.parent)
            return
        try:
            if tx.readonly or tx.is_empty():
                with self._commit_lock:
                    self.committed += 1
                self._incr("tx.commits")
                self._run_commit_hooks(tx)
                return
            if _FAULTS.enabled:
                # dying here loses this commit entirely (nothing staged)
                _FAULTS.check("tx.commit.pre")
            with self._commit_lock:
                for cell, observed in tx.read_set.items():
                    if self._versions.get(cell, 0) != observed:
                        self.conflicted += 1
                        self._incr("tx.conflicts")
                        raise TransactionConflict(f"cell {cell!r} changed")
                self._clock += 1
                v = self._clock
                self._capture_history(tx, v)
                if _FAULTS.enabled:
                    # dying mid-commit, after the conflict checks and
                    # before the write-through
                    _FAULTS.check("tx.commit.apply")
                self._apply(tx)
                for h in tx.links:
                    self._versions[("link", h)] = v
                for h in tx.data:
                    self._versions[("data", h)] = v
                for atom in tx.inc:
                    self._versions[("inc", atom)] = v
                for key in tx.idx:
                    self._versions[("idx",) + key] = v
                self.committed += 1
                self._incr("tx.commits")
                self._gc_history()
        finally:
            self._active.pop(id(tx), None)
        self._run_commit_hooks(tx)

    # -- MVCC history ----------------------------------------------------
    def _capture_history(self, tx: HGTransaction, v: int) -> None:
        """Pre-images of every cell this commit overwrites, if another open
        transaction might read them (under the commit lock, before
        ``_apply``)."""
        if not any(tid != id(tx) for tid in list(self._active)):
            return
        b = self.backend
        H = self._history
        for h in tx.links:
            H.setdefault(("link", h), []).append((v, b.get_link(h)))
        for h in tx.data:
            H.setdefault(("data", h), []).append((v, b.get_data(h)))
        for atom, d in tx.inc.items():
            if d.cleared:
                old = ("full", b.get_incidence_set(atom).array().copy())
            else:
                old = ("delta", set(d.added), set(d.removed))
            H.setdefault(("inc", atom), []).append((v, old))
        for (name, key), d in tx.idx.items():
            index = b.get_index(name, create=True)
            if d.removed_all:
                old = ("full", index.find(key).array().copy())
            else:
                old = ("delta", set(d.added), set(d.removed))
            H.setdefault(("idx", name, key), []).append((v, old))

    def _gc_history(self) -> None:
        """Drop pre-images no open snapshot reaches (under the commit
        lock)."""
        if not self._history:
            return
        floor = min(list(self._active.values()) or [self._clock])
        dead = []
        for cell, entries in self._history.items():
            keep = [e for e in entries if e[0] > floor]
            if keep:
                self._history[cell] = keep
            else:
                dead.append(cell)
        for cell in dead:
            del self._history[cell]

    def _value_at(self, cell: tuple, sv: int, current: Any) -> Any:
        """A link or data cell at snapshot ``sv``: the pre-image of the
        first commit after ``sv``. ``current`` must be read from the
        backend before the history is consulted (capture precedes apply)."""
        for ver, old in self._history.get(cell, ()):
            if ver > sv:
                return old
        return current

    def link_at(self, h: int, sv: int):
        current = self.backend.get_link(h)
        return self._value_at(("link", h), sv, current)

    def data_at(self, h: int, sv: int):
        current = self.backend.get_data(h)
        return self._value_at(("data", h), sv, current)

    def _set_at(self, cell: tuple, sv: int, current: set) -> set:
        """A set cell at ``sv``: newer commits undone newest first."""
        entries = self._history.get(cell)
        if not entries:
            return current
        vals = current
        for ver, old in reversed(entries):
            if ver <= sv:
                break
            if old[0] == "full":
                vals = set(old[1].tolist())
            else:
                _, added, removed = old
                vals = (vals - added) | removed
        return vals

    def inc_at(self, atom: int, sv: int) -> np.ndarray:
        """``atom``'s incidence set at ``sv``. The array may be the
        backend's cached one: callers never write through it."""
        arr = self.backend.get_incidence_set(atom).array()
        if ("inc", atom) not in self._history:
            return np.asarray(arr, dtype=np.int64)
        vals = self._set_at(("inc", atom), sv, set(arr.tolist()))
        return np.asarray(sorted(vals), dtype=np.int64)

    def idx_at(self, name: str, key: bytes, sv: int) -> np.ndarray:
        """The values of index ``name`` at ``key`` at ``sv``. As in
        :meth:`inc_at`, a cell without history is its backend array (read
        first, so a commit racing the read has published its pre-image)."""
        arr = self.backend.get_index(name, create=True).find(key).array()
        if ("idx", name, key) not in self._history:
            return np.asarray(arr, dtype=np.int64)
        vals = self._set_at(("idx", name, key), sv, set(arr.tolist()))
        return np.asarray(sorted(vals), dtype=np.int64)

    def idx_count_at(self, name: str, key: bytes, sv: int) -> int:
        """``len(idx_at(name, key, sv))``, without building the array
        when the cell has no history."""
        n = self.backend.get_index(name, create=True).count(key)
        if ("idx", name, key) not in self._history:
            return n
        return len(self.idx_at(name, key, sv))

    def idx_keys_changed_since(self, name: str, sv: int) -> list[bytes]:
        """Keys of index ``name`` whose membership moved after ``sv``: what
        a range or scan read under a snapshot re-reads."""
        # a point-in-time copy: committers change the history under the
        # commit lock, and readers run without it
        return [cell[2] for cell, entries in list(self._history.items())
                if cell[0] == "idx" and cell[1] == name and entries
                and entries[-1][0] > sv]

    @staticmethod
    def _run_commit_hooks(tx: HGTransaction) -> None:
        for hook in tx.on_commit:
            hook()

    def cell_version(self, cell: tuple) -> int:
        return self._versions.get(cell, 0)

    def cell_changed_since(self, cell: tuple, sv: int) -> bool:
        return self._versions.get(cell, 0) > sv

    @property
    def version(self) -> int:
        """The commit clock: the version the last commit wrote."""
        return self._clock

    def _apply(self, tx: HGTransaction) -> None:
        b = self.backend
        b.commit_batch_begin()
        try:
            self._apply_ops(tx, b)
        except BaseException:
            b.commit_batch_abort()
            raise
        else:
            b.commit_batch_end()

    @staticmethod
    def _apply_ops(tx: HGTransaction, b: StorageBackend) -> None:
        for h, v in tx.links.items():
            if v is _TOMBSTONE:
                b.remove_link(h)
            else:
                b.store_link(h, v)
        for h, v in tx.data.items():
            if v is _TOMBSTONE:
                b.remove_data(h)
            else:
                b.store_data(h, v)
        for atom, d in tx.inc.items():
            if d.cleared:
                b.remove_incidence_set(atom)
            for link in sorted(d.removed):
                b.remove_incidence_link(atom, link)
            for link in sorted(d.added):
                b.add_incidence_link(atom, link)
        for (name, key), d in tx.idx.items():
            index = b.get_index(name, create=True)
            if d.removed_all:
                index.remove_all_entries(key)
            for v in sorted(d.removed):
                index.remove_entry(key, v)
            for v in sorted(d.added):
                index.add_entry(key, v)

    def transact(self, fn: Callable[[], T], retries: int = 16,
                 readonly: bool = False) -> T:
        """Run ``fn`` in a transaction, retried on conflict."""
        if not self.enabled:
            return fn()
        last: Optional[Exception] = None
        for _ in range(retries):
            tx = self.begin(readonly=readonly)
            try:
                result = fn()
            except BaseException:
                if tx.active:
                    self.abort(tx)
                raise
            try:
                self.commit(tx)
                return result
            except TransactionConflict as e:
                last = e
        raise TransactionConflict(
            f"giving up after {retries} retries") from last

    def ensure_transaction(self, fn: Callable[[], T],
                           readonly: bool = False) -> T:
        """``fn`` inside the current transaction if there is one, else in
        a new one."""
        if not self.enabled or self.current() is not None:
            return fn()
        return self.transact(fn, readonly=readonly)
