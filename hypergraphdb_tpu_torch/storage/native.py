"""NativeStorage — the durable C++ storage backend (ctypes binding).

The engine (``native/hgstore.cpp``) is a log-structured columnar store:
committed state in host memory, a write-ahead log of every mutation
(written before a commit returns, so a commit survives a process kill),
and compacted checkpoints (``fsync``ed, file and directory, so they
survive an OS crash). ``bulk_links`` exports the link table as three flat
arrays in one call, the snapshot pack's feed. Its files are the JAX
package's: each package opens the other's stores.

It implements the same ``StorageBackend`` contract as ``MemStorage``
(``tests/test_torch_storage.py`` runs one suite over both). The engine is
single-writer: ``startup`` takes an exclusive ``flock`` on
:data:`LOCK_FILE` in the directory, and a second open of the directory,
in this process or another, raises until the first shuts down. The JAX
package takes no such lock.

Within the process, one engine call runs at a time on a store
(:class:`_Serialized`): the engine takes no lock of its own, and ctypes
releases the interpreter lock for each call, so a reader outside the
commit lock (a replica's op-log writer asking the atom map for a gid)
could otherwise run inside a writer's call and read a table mid-update.
The JAX package's binding has no such lock.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

from hypergraphdb_tpu_torch.core.errors import HGException
from hypergraphdb_tpu_torch.core.handles import HGHandle
from hypergraphdb_tpu_torch.native import lib
from hypergraphdb_tpu_torch.storage.api import (
    HGBidirectionalIndex,
    HGSortedResultSet,
    StorageBackend,
)

_i64p = ctypes.POINTER(ctypes.c_int64)

#: the file in a store's directory whose exclusive ``flock`` marks its writer
LOCK_FILE = "hgstore.lock"


def _take_i64_array(L, out_p, n: int) -> np.ndarray:
    """Copy a malloc'd i64 buffer into numpy and free it."""
    try:
        if n == 0:
            return np.empty(0, dtype=np.int64)
        return np.ctypeslib.as_array(out_p, shape=(n,)).astype(
            np.int64, copy=True
        )
    finally:
        L.hgs_free(out_p)


def _take_key_list(L, out_c, total: int, count: int) -> list[bytes]:
    """Decode the [u32 len][bytes]... key framing and free the buffer."""
    try:
        if count == 0:
            return []
        raw = ctypes.string_at(out_c, total)
        keys = []
        pos = 0
        for _ in range(count):
            ln = int.from_bytes(raw[pos : pos + 4], "little")
            pos += 4
            keys.append(raw[pos : pos + ln])
            pos += ln
        return keys
    finally:
        L.hgs_free(out_c)


class NativeIndex(HGBidirectionalIndex):
    def __init__(self, store: "NativeStorage", name: str):
        self._s = store
        self.name = name
        self._nm = name.encode()

    def add_entry(self, key: bytes, value: HGHandle) -> None:
        self._s._L.hgs_idx_add(self._s._h, self._nm, key, len(key), int(value))
        self._s._check_wal()

    def remove_entry(self, key: bytes, value: HGHandle) -> None:
        self._s._L.hgs_idx_remove(self._s._h, self._nm, key, len(key), int(value))
        self._s._check_wal()

    def remove_all_entries(self, key: bytes) -> None:
        self._s._L.hgs_idx_remove_all(self._s._h, self._nm, key, len(key))
        self._s._check_wal()

    def find(self, key: bytes) -> HGSortedResultSet:
        L = self._s._L
        out = _i64p()
        n = ctypes.c_uint32()
        L.hgs_idx_find(
            self._s._h, self._nm, key, len(key),
            ctypes.byref(out), ctypes.byref(n),
        )
        return HGSortedResultSet(_take_i64_array(L, out, n.value))

    def key_count(self) -> int:
        return int(self._s._L.hgs_idx_key_count(self._s._h, self._nm))

    def scan_keys(self) -> Iterator[bytes]:
        L = self._s._L
        out = ctypes.c_char_p()
        total = ctypes.c_uint32()
        count = ctypes.c_uint32()
        L.hgs_idx_scan_keys(
            self._s._h, self._nm,
            ctypes.byref(out), ctypes.byref(total), ctypes.byref(count),
        )
        return iter(_take_key_list(L, out, total.value, count.value))

    def bulk_items(self, lo: Optional[bytes] = None):
        # one native call for the (sorted) key list, bisect to the cursor
        # start, then per-key value fetches — O(result + one key scan in
        # C), not a Python skip-loop over every key (op-log cursor path)
        keys = list(self.scan_keys())
        if lo is not None:
            import bisect

            keys = keys[bisect.bisect_left(keys, lo):]
        for k in keys:
            yield k, self.find(k).array()

    def find_range(
        self,
        lo: Optional[bytes] = None,
        hi: Optional[bytes] = None,
        lo_inclusive: bool = True,
        hi_inclusive: bool = False,
    ) -> HGSortedResultSet:
        L = self._s._L
        out = _i64p()
        n = ctypes.c_uint32()
        L.hgs_idx_range(
            self._s._h, self._nm,
            lo if lo is not None else b"", len(lo or b""),
            1 if lo is not None else 0, 1 if lo_inclusive else 0,
            hi if hi is not None else b"", len(hi or b""),
            1 if hi is not None else 0, 1 if hi_inclusive else 0,
            ctypes.byref(out), ctypes.byref(n),
        )
        return HGSortedResultSet(_take_i64_array(L, out, n.value))

    def find_by_value(self, value: HGHandle) -> list[bytes]:
        L = self._s._L
        out = ctypes.c_char_p()
        total = ctypes.c_uint32()
        count = ctypes.c_uint32()
        L.hgs_idx_find_by_value(
            self._s._h, self._nm, int(value),
            ctypes.byref(out), ctypes.byref(total), ctypes.byref(count),
        )
        return _take_key_list(L, out, total.value, count.value)


class _Serialized:
    """The engine's entry points behind one lock: each call holds it for
    its whole run in the engine."""

    def __init__(self, L: ctypes.CDLL):
        self._L = L
        self._lock = threading.RLock()

    def __getattr__(self, name: str):
        fn = getattr(self._L, name)
        lock = self._lock

        def call(*args):
            with lock:
                return fn(*args)

        self.__dict__[name] = call
        return call


class NativeStorage(StorageBackend):
    """Durable storage backend over the C++ engine. Single-writer, as the
    SPI requires; see ``storage/api.py``."""

    def __init__(self, location: str):
        self.location = location
        self._L = _Serialized(lib())
        self._h = None
        self._lock_fd: Optional[int] = None

    # -- lifecycle ----------------------------------------------------------
    def startup(self) -> None:
        if self._h is not None:
            return
        os.makedirs(self.location, exist_ok=True)
        fd = os.open(os.path.join(self.location, LOCK_FILE),
                     os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError:
            os.close(fd)
            raise HGException(
                f"native store already open by another writer: "
                f"{self.location}"
            ) from None
        h = self._L.hgs_open(self.location.encode())
        if not h:
            os.close(fd)
            raise HGException(
                f"native store failed to open (corrupt log?): {self.location}"
            )
        self._h = h
        self._lock_fd = fd

    def shutdown(self) -> None:
        if self._h is not None:
            self._L.hgs_close(self._h)
            self._h = None
        if self._lock_fd is not None:
            os.close(self._lock_fd)   # releases the flock
            self._lock_fd = None

    def checkpoint(self) -> None:
        if self._h is not None and self._L.hgs_checkpoint(self._h) != 0:
            raise HGException(f"checkpoint failed: {self.location}")
        self._check_wal()

    def commit_batch_begin(self) -> None:
        self._L.hgs_batch_begin(self._h)

    def commit_batch_end(self) -> None:
        self._L.hgs_batch_commit(self._h)
        self._check_wal()

    def commit_batch_abort(self) -> None:
        self._L.hgs_batch_abort(self._h)

    def _check_wal(self) -> None:
        """Surface any latched WAL write failure (disk full, IO error) —
        silent durability loss is worse than a failing commit."""
        if self._h is not None and not self._L.hgs_wal_ok(self._h):
            raise HGException(
                f"write-ahead log write failed (disk full?): {self.location}; "
                "mutations since the failure are NOT durable"
            )

    # -- links --------------------------------------------------------------
    def store_link(self, h: HGHandle, targets: Sequence[HGHandle]) -> None:
        arr = (ctypes.c_int64 * len(targets))(*[int(t) for t in targets])
        self._L.hgs_store_link(self._h, int(h), arr, len(targets))
        self._check_wal()

    def get_link(self, h: HGHandle) -> Optional[tuple[HGHandle, ...]]:
        out = _i64p()
        n = ctypes.c_uint32()
        if not self._L.hgs_get_link(
            self._h, int(h), ctypes.byref(out), ctypes.byref(n)
        ):
            return None
        return tuple(_take_i64_array(self._L, out, n.value).tolist())

    def remove_link(self, h: HGHandle) -> None:
        self._L.hgs_remove_link(self._h, int(h))
        self._check_wal()

    def contains_link(self, h: HGHandle) -> bool:
        return bool(self._L.hgs_contains_link(self._h, int(h)))

    # -- data ---------------------------------------------------------------
    def store_data(self, h: HGHandle, data: bytes) -> None:
        self._L.hgs_store_data(self._h, int(h), data, len(data))
        self._check_wal()

    def get_data(self, h: HGHandle) -> Optional[bytes]:
        out = ctypes.c_char_p()
        n = ctypes.c_uint32()
        if not self._L.hgs_get_data(
            self._h, int(h), ctypes.byref(out), ctypes.byref(n)
        ):
            return None
        try:
            return ctypes.string_at(out, n.value)
        finally:
            self._L.hgs_free(out)

    def remove_data(self, h: HGHandle) -> None:
        self._L.hgs_remove_data(self._h, int(h))
        self._check_wal()

    # -- incidence ----------------------------------------------------------
    def add_incidence_link(self, atom: HGHandle, link: HGHandle) -> None:
        self._L.hgs_inc_add(self._h, int(atom), int(link))
        self._check_wal()

    def remove_incidence_link(self, atom: HGHandle, link: HGHandle) -> None:
        self._L.hgs_inc_remove(self._h, int(atom), int(link))
        self._check_wal()

    def remove_incidence_set(self, atom: HGHandle) -> None:
        self._L.hgs_inc_clear(self._h, int(atom))
        self._check_wal()

    def get_incidence_set(self, atom: HGHandle) -> HGSortedResultSet:
        out = _i64p()
        n = ctypes.c_uint32()
        self._L.hgs_inc_get(self._h, int(atom), ctypes.byref(out), ctypes.byref(n))
        return HGSortedResultSet(_take_i64_array(self._L, out, n.value))

    def incidence_count(self, atom: HGHandle) -> int:
        return int(self._L.hgs_inc_count(self._h, int(atom)))

    # -- indices ------------------------------------------------------------
    def get_index(self, name: str, create: bool = True) -> Optional[NativeIndex]:
        exists = bool(self._L.hgs_idx_exists(self._h, name.encode()))
        if not exists:
            if not create:
                return None
            self._L.hgs_idx_touch(self._h, name.encode())
        return NativeIndex(self, name)

    def remove_index(self, name: str) -> None:
        self._L.hgs_idx_drop(self._h, name.encode())
        self._check_wal()

    def index_names(self) -> list[str]:
        out = ctypes.c_char_p()
        total = ctypes.c_uint32()
        count = ctypes.c_uint32()
        self._L.hgs_idx_names(
            self._h, ctypes.byref(out), ctypes.byref(total), ctypes.byref(count)
        )
        return [
            k.decode() for k in _take_key_list(self._L, out, total.value, count.value)
        ]

    # -- bulk ---------------------------------------------------------------
    def bulk_links(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        ids_p, off_p, flat_p = _i64p(), _i64p(), _i64p()
        n_links = ctypes.c_uint64()
        n_flat = ctypes.c_uint64()
        self._L.hgs_bulk_links(
            self._h,
            ctypes.byref(ids_p), ctypes.byref(off_p), ctypes.byref(flat_p),
            ctypes.byref(n_links), ctypes.byref(n_flat),
        )
        nl = n_links.value
        ids = _take_i64_array(self._L, ids_p, nl)
        offsets = _take_i64_array(self._L, off_p, nl + 1)
        flat = _take_i64_array(self._L, flat_p, n_flat.value)
        return ids, offsets, flat

    def max_handle(self) -> int:
        return int(self._L.hgs_max_handle(self._h))
