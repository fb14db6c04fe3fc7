"""Resumable maintenance operations (see package docstring)."""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

from hypergraphdb_tpu_torch.core.errors import HGException


class MaintenanceException(HGException):
    pass


@dataclass(frozen=True)
class MaintenanceOperation:
    """Base persisted operation state. Subclasses are dataclasses so they
    serialize as record atoms; ``execute`` runs ONE batch and returns the
    updated state, or None when finished (the MaintenanceOperation.execute
    contract, batched like ApplyNewIndexer.java:36-41)."""

    last_processed: int = -1
    batch_size: int = 100

    def execute_batch(self, graph) -> Optional["MaintenanceOperation"]:
        raise NotImplementedError


@dataclass(frozen=True)
class ApplyNewIndexer(MaintenanceOperation):
    """Offline population of a newly-registered indexer: walks the atom id
    space in batches, indexing atoms of the indexer's type; the cursor
    (``last_processed``) persists between batches so a crash resumes."""

    indexer_name: str = ""
    type_handle: int = -1
    #: frozen id-space bound, captured on the first batch: persisting the
    #: cursor itself allocates handles, so a live ``handles.peek`` bound
    #: would recede forever (atoms added after scheduling are indexed by
    #: the normal ``maybe_index`` add path anyway)
    end_bound: int = -1

    def execute_batch(self, graph) -> Optional["ApplyNewIndexer"]:
        from hypergraphdb_tpu_torch.indexing.manager import get_index, indexers_of

        indexers = [
            ix for ix in indexers_of(graph, self.type_handle)
            if ix.name == self.indexer_name
        ]
        if not indexers:
            raise MaintenanceException(
                f"indexer {self.indexer_name!r} is not registered"
            )
        ix = indexers[0]
        if self.end_bound < 0:
            return replace(self, end_bound=int(graph.handles.peek))
        start = self.last_processed + 1
        end = min(start + self.batch_size, self.end_bound)
        if start >= end:
            return None
        idx = get_index(graph, ix.name)
        # subtype atoms are indexed too — same closure the online path and
        # rebuild() use, or the offline build silently disagrees with them
        applicable = {int(self.type_handle)}
        try:
            tname = graph.typesystem.name_of(self.type_handle)
            for sub in graph.typesystem.subtypes_closure(tname):
                applicable.add(int(graph.typesystem.handle_of(sub)))
        except KeyError:
            pass
        for h in range(start, end):
            rec = graph.store.get_link(h)
            if rec is None or len(rec) < 3 or int(rec[0]) not in applicable:
                continue
            try:
                value = graph.get(h)
                targets = getattr(value, "targets", None)
                value = getattr(value, "value", value)
            except Exception:
                continue
            for key in ix.keys(graph, h, value, targets):
                for v in ix.values(graph, h, value, targets):
                    idx.add_entry(key, v)
        return replace(self, last_processed=end - 1)


def schedule(graph, op: MaintenanceOperation) -> int:
    """Persist an operation atom; it runs at the next ``run_pending`` (the
    reference schedules them to run on open, ``HyperGraph.open`` step)."""
    return int(graph.add(op))


def run_pending(graph, max_batches: int = 1_000_000) -> int:
    """Run all persisted maintenance operations to completion, batch by
    batch, persisting the cursor after each batch (crash ⇒ resume). Returns
    the number of operations completed."""
    from hypergraphdb_tpu_torch.query import dsl as q

    done = 0
    for cls in _operation_classes():
        t = graph.typesystem.infer(cls())
        if t is None:
            continue
        for h in list(q.find_all(graph, q.type_(t.name))):
            op = graph.get(h)
            op = getattr(op, "value", op)
            batches = 0
            try:
                while op is not None and batches < max_batches:
                    nxt = op.execute_batch(graph)
                    if nxt is None:
                        graph.remove(h)
                        done += 1
                        break
                    graph.replace(h, nxt)  # persist the cursor
                    op = nxt
                    batches += 1
            except MaintenanceException:
                # e.g. its indexer is not registered in this session: the
                # op stays persisted for a later run, counted, and the other
                # pending operations still run
                graph.metrics.incr("maintenance.deferred")
                continue
    return done


def _operation_classes() -> list[type]:
    return [ApplyNewIndexer]
