"""On-disk format versioning + migration hooks.

The reference's ``maintenance/`` package pairs resumable operations with
explicit database upgrades; here the store carries a persisted FORMAT
VERSION (``hg.sys.format``) checked at every open:

- a fresh database is stamped with :data:`FORMAT_VERSION`;
- an older database runs the registered migration chain, one step per
  version, stamping after each completed step (a crash mid-chain resumes
  at the first unapplied step);
- a NEWER database refuses to open (downgrade protection — the WAL magic
  alone could not distinguish "new layout" from "corrupt").

Migrations are plain callables ``fn(graph) -> None`` registered per
from-version with :func:`register_migration`; they run inside the open
path after the backend is up but before indexer/subsumption restore, so a
migration may rewrite registry formats the loaders then read.
"""

from __future__ import annotations

from typing import Callable, Optional

from hypergraphdb_tpu_torch.core.errors import HGException

#: the CURRENT on-disk format this build reads and writes
FORMAT_VERSION = 1

#: version the pre-versioning databases are assumed to be at
_IMPLICIT_VERSION = 1

IDX_FORMAT = "hg.sys.format"
_KEY = b"version"

_MIGRATIONS: dict[int, Callable] = {}


class MigrationError(HGException):
    pass


def register_migration(from_version: int, fn: Callable) -> None:
    """Register the step migrating ``from_version`` → ``from_version + 1``.
    One step per version; re-registration replaces (tests)."""
    _MIGRATIONS[int(from_version)] = fn


def stored_format_version(graph) -> Optional[int]:
    idx = graph.store.get_index(IDX_FORMAT, create=False)
    if idx is None:
        return None
    vals = idx.find(_KEY).array()
    return int(vals.max()) if len(vals) else None


def stamp_format_version(graph, version: int) -> None:
    def run() -> None:
        idx = graph.store.get_index(IDX_FORMAT)
        for old in idx.find(_KEY).array().tolist():
            idx.remove_entry(_KEY, int(old))
        idx.add_entry(_KEY, int(version))

    graph.txman.ensure_transaction(run)


def migrate(graph, target: Optional[int] = None) -> int:
    """Bring the database to ``target`` (default :data:`FORMAT_VERSION`).
    Returns how many migration steps ran. Called from ``HyperGraph``'s
    open path; safe on every backend including memory."""
    target = FORMAT_VERSION if target is None else int(target)
    stored = stored_format_version(graph)
    if stored is None:
        # fresh database OR pre-versioning store: fresh stores (flagged by
        # the graph BEFORE bootstrap populated them) stamp the current
        # format; legacy populated ones sit at the implicit version and
        # may need the chain
        stored = (
            target if getattr(graph, "_fresh_store", False)
            else _IMPLICIT_VERSION
        )
        if stored >= target:
            stamp_format_version(graph, target)
            return 0
    if stored > target:
        raise MigrationError(
            f"database format {stored} is newer than this build's {target}: "
            "refusing to open (upgrade the library instead)"
        )
    steps = 0
    while stored < target:
        fn = _MIGRATIONS.get(stored)
        if fn is None:
            raise MigrationError(
                f"no migration registered for format {stored} → {stored + 1}"
            )
        fn(graph)
        stored += 1
        stamp_format_version(graph, stored)  # resumable: stamp per step
        steps += 1
    return steps
