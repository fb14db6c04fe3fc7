"""Maintenance: resumable offline operations, and the on-disk format
stamp with its migration chain (``migration.py``, run at every open).

A maintenance operation is persisted as an atom, executes in batches with
a persisted cursor, and, if the process dies mid-run, resumes from the
cursor at the next :func:`run_pending`.
"""

from hypergraphdb_tpu_torch.maintenance.operations import (
    ApplyNewIndexer,
    MaintenanceException,
    MaintenanceOperation,
    run_pending,
    schedule,
)

__all__ = [
    "ApplyNewIndexer",
    "MaintenanceException",
    "MaintenanceOperation",
    "run_pending",
    "schedule",
]
