"""HGEnvironment: the process's registry of open databases.

A map from location to open ``HyperGraph``: :func:`get` is idempotent, and
an ``atexit`` hook closes whatever is still open when the interpreter
exits. A directory is keyed by its real path, so ``"db"``, ``"./db"`` and
``"/abs/db"`` are one database; a second writer opened beside the
registry is refused by the engine's lock (``storage/native.py``).

A real filesystem location opens on the durable native engine. Where the
engine cannot be built, :func:`get` raises its ``NativeBuildError`` (an
``HGException``): it never opens such a location in memory, which would
lose every write at exit (the JAX package logs a warning and does so).
"""

from __future__ import annotations

import atexit
import copy
import os
import threading
from typing import Optional

from hypergraphdb_tpu_torch.core.config import HGConfiguration
from hypergraphdb_tpu_torch.core.graph import HyperGraph

_lock = threading.Lock()
_open: dict[str, HyperGraph] = {}

#: locations that name no directory: the in-memory backend
_MEMORY_LOCATIONS = ("", ":memory:")


def _key(location: str) -> str:
    if location in _MEMORY_LOCATIONS:
        return location
    return os.path.realpath(location)


def get(location: str, config: Optional[HGConfiguration] = None
        ) -> HyperGraph:
    """Open the database at ``location``, or return the one already open
    there. A directory with the default ``"memory"`` backend selects the
    native engine; the caller's ``config`` is copied, never changed."""
    key = _key(location)
    with _lock:
        g = _open.get(key)
        if g is not None:
            return g
        cfg = (copy.deepcopy(config) if config is not None
               else HGConfiguration())
        cfg.location = location
        if location not in _MEMORY_LOCATIONS and cfg.store_backend == "memory":
            cfg.store_backend = "native"
        g = HyperGraph(cfg)
        _open[key] = g
        return g


def is_open(location: str) -> bool:
    with _lock:
        return _key(location) in _open


def close(location: str) -> None:
    with _lock:
        g = _open.pop(_key(location), None)
    if g is not None:
        g.close()


def close_all() -> None:
    with _lock:
        graphs = list(_open.values())
        _open.clear()
    for g in graphs:
        g.close()


atexit.register(close_all)


class HGEnvironment:
    """The static API as a namespace."""

    get = staticmethod(get)
    is_open = staticmethod(is_open)
    close = staticmethod(close)
    close_all = staticmethod(close_all)
