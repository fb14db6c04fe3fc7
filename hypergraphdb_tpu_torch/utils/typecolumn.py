"""Hot host-side atom→type column — the typed-incidence annotation.

The reference's bdb-native extension annotates incidence-index entries with
(type, position) so ``And(Incident, AtomType)`` is answered from the
incidence index alone, never loading candidate links
(``storage/bdb-native/.../incidence/TypeAndPositionIncidenceAnnotator.java``).
Here it is columnar instead of one annotation per entry: a dense int32
handle→type array kept hot on the HOST, so an incidence row filters by one
vectorized gather + compare (``query/compiler.TypedIncidencePlan``) instead
of one store record read per candidate link.

Maintenance is post-commit event driven, so the column only ever reflects
COMMITTED state; ``-1`` means "not observed yet" and falls back to a store
read — staleness can cost time, never correctness.
"""

from __future__ import annotations

import threading

import numpy as np

from hypergraphdb_tpu_torch.core import events as ev


class TypeColumn:
    """Dense committed handle→type-handle column with store fallback."""

    def __init__(self, graph) -> None:
        self.graph = graph
        self._lock = threading.Lock()
        self._col = np.full(1024, -1, dtype=np.int32)
        graph.events.add_listener(ev.HGAtomAddedEvent, self._on_changed)
        graph.events.add_listener(ev.HGAtomReplacedEvent, self._on_changed)
        graph.events.add_listener(ev.HGAtomRemovedEvent, self._on_removed)
        self._build()

    def close(self) -> None:
        g = self.graph
        g.events.remove_listener(ev.HGAtomAddedEvent, self._on_changed)
        g.events.remove_listener(ev.HGAtomReplacedEvent, self._on_changed)
        g.events.remove_listener(ev.HGAtomRemovedEvent, self._on_removed)

    # -- build + maintenance ---------------------------------------------------
    def _build(self) -> None:
        """One vectorized committed-store scan (the same bulk_links fast
        path CSR packing uses; record layout = (type, value, flags,
        *targets), see core/graph.py)."""
        g = self.graph
        with g.txman._commit_lock:  # consistent extraction, same as packing
            ids, offsets, flat = g.backend.bulk_links()
            peek = max(
                int(getattr(g.handles, "peek", 0)), int(g.backend.max_handle())
            )
        ids = np.asarray(ids, dtype=np.int64)
        offsets = np.asarray(offsets, dtype=np.int64)
        flat = np.asarray(flat, dtype=np.int64)
        with self._lock:
            self._grow_locked(peek)
            if len(ids):
                # fill ONLY still-unknown slots: the listeners registered
                # before this scan, so a commit landing between the locked
                # extraction and this write may already have recorded a
                # NEWER type — overwriting it with the scanned (older)
                # value would leave a permanently stale non-(-1) entry
                vals = flat[offsets[:-1]].astype(np.int32)
                unknown = self._col[ids] == -1
                self._col[ids[unknown]] = vals[unknown]

    def _grow_locked(self, n: int) -> None:
        # the `_locked` suffix: every caller already holds self._lock
        if n < len(self._col):
            return
        new = np.full(max(n + 1024, len(self._col) * 2), -1, dtype=np.int32)
        new[: len(self._col)] = self._col
        self._col = new

    def _on_changed(self, g, event) -> None:
        h = int(event.handle)
        rec = g.store.get_link(h)
        with self._lock:
            self._grow_locked(h)
            self._col[h] = int(rec[0]) if rec is not None else -1

    def _on_removed(self, g, event) -> None:
        h = int(event.handle)
        with self._lock:
            self._grow_locked(h)
            self._col[h] = -1

    # -- reads -----------------------------------------------------------------
    def types_of(self, handles: np.ndarray) -> np.ndarray:
        """Vectorized handle→type gather; unknown entries (-1) re-check the
        store (and backfill), so results match committed state exactly."""
        handles = np.asarray(handles, dtype=np.int64)
        with self._lock:
            col = self._col  # snapshot reference; writers replace, not mutate len
        out = np.full(len(handles), -1, dtype=np.int32)
        in_range = handles < len(col)
        out[in_range] = col[handles[in_range]]
        unknown = np.nonzero(out == -1)[0]
        if len(unknown):
            g = self.graph
            for i in unknown.tolist():
                rec = g.store.get_link(int(handles[i]))
                if rec is not None:
                    out[i] = int(rec[0])
                    self._on_changed(g, ev.HGAtomAddedEvent(int(handles[i]), None))
        return out
