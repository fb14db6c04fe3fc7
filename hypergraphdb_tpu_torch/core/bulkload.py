"""Bulk loader: the high-throughput ingest path.

The per-atom path buffers every write in the transaction overlay and
replays it at commit. ``bulk_import`` loads a batch of one type in one
commit batch instead: one type resolution, direct backend writes, index
appends.

- It requires that no transaction is open on the calling thread (it falls
  back to the buffered bulk APIs when one is) and holds the commit lock
  for its whole run: committers queue behind it as behind one large
  commit.
- A transaction open on another thread keeps its begin-time view: the
  loader records the pre-image of every index and incidence cell it
  touches, and bumps those cells' versions, so such a transaction that
  read one fails validation instead of missing the load.
- Per-atom added events fire only when someone listens; user indexers
  run through the normal ``maybe_index``.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

from hypergraphdb_tpu_torch.core.errors import HGException


def bulk_import(graph, values: Optional[Sequence[Any]] = None,
                target_lists: Optional[Sequence[Sequence[int]]] = None,
                type: Optional[Any] = None,  # noqa: A002
                ) -> range:
    """Load ``values[i]`` (and, for links, ``target_lists[i]``) in one
    batch. Every atom has one type (``type``, or inferred from the first
    value). Returns the contiguous handle range."""
    from hypergraphdb_tpu_torch.core.graph import (
        _FLAG_LINK,
        IDX_BY_TYPE,
        IDX_BY_VALUE,
        _type_key,
    )
    from hypergraphdb_tpu_torch.indexing.manager import (
        indexers_of,
        maybe_index,
    )

    n = len(target_lists) if target_lists is not None else len(values)
    if n == 0:
        return range(0, 0)
    if (values is not None and target_lists is not None
            and len(values) != len(target_lists)):
        raise HGException("values and target_lists length mismatch")
    if graph.txman.current() is not None:
        if target_lists is None:
            return graph.add_nodes_bulk(values, type=type)
        return graph.add_links_bulk(target_lists, values=values, type=type)

    graph._check_open()
    sample = values[0] if values is not None else None
    type_handle = int(graph._resolve_type_handle(sample, type))
    atype = graph.typesystem.get_type(type_handle)
    backend = graph.backend
    txman = graph.txman
    has_indexers = bool(indexers_of(graph, type_handle))

    with txman._commit_lock:
        r = graph.handles.make_many(n)
        # any open transaction is a reader on another thread: give it the
        # full pre-image of each cell before the first write, tagged with
        # the tick this batch commits as
        capturing = bool(txman._active)
        vnext = txman._clock + 1
        captured: set = set()

        def cap(cell, read_pre):
            if capturing and cell not in captured:
                captured.add(cell)
                txman._history.setdefault(cell, []).append(
                    (vnext, ("full", read_pre())))

        def cap_user_idx(storage_name, key, idx):
            cap(("idx", storage_name, key),
                lambda: idx.find(key).array().copy())

        backend.commit_batch_begin()
        try:
            by_type = backend.get_index(IDX_BY_TYPE)
            by_value = backend.get_index(IDX_BY_VALUE)
            tkey = _type_key(type_handle)
            cap(("idx", IDX_BY_TYPE, tkey),
                lambda: by_type.find(tkey).array().copy())
            flags = _FLAG_LINK if target_lists is not None else 0
            null_type = atype.name == "null"
            value_keys: set = set()
            touched_targets: set = set()
            touched_user_idx: set = set()
            for i, h in enumerate(r):
                v = values[i] if values is not None else None
                vkey = atype.to_key(v)
                if v is None and null_type:
                    value_handle = -1
                else:
                    value_handle = graph.handles.make()
                    backend.store_data(value_handle, atype.store(v))
                targets = (tuple(int(t) for t in target_lists[i])
                           if target_lists is not None else ())
                backend.store_link(h, (type_handle, value_handle, flags)
                                   + targets)
                by_type.add_entry(tkey, h)
                if capturing:
                    cap(("idx", IDX_BY_VALUE, vkey),
                        lambda k=vkey: by_value.find(k).array().copy())
                by_value.add_entry(vkey, h)
                value_keys.add(vkey)
                for t in targets:
                    if capturing:
                        cap(("inc", t),
                            lambda a=t: backend.get_incidence_set(a).array()
                            .copy())
                    backend.add_incidence_link(t, h)
                    touched_targets.add(t)
                if has_indexers:
                    maybe_index(graph, h, type_handle, v, targets or None,
                                touched=touched_user_idx,
                                before_write=(cap_user_idx if capturing
                                              else None))
        except BaseException:
            backend.commit_batch_abort()
            # writes already applied are not rolled back in memory: keep the
            # pre-images and spend the tick, so open readers of the half
            # applied state fail validation
            if captured:
                txman._clock = vnext
                for cell in captured:
                    txman._versions[cell] = vnext
            raise
        else:
            backend.commit_batch_end()
        # one tick for the batch; every touched cell takes it
        txman._clock += 1
        clock = txman._clock
        versions = txman._versions
        versions[("idx", IDX_BY_TYPE, tkey)] = clock
        for vk in value_keys:
            versions[("idx", IDX_BY_VALUE, vk)] = clock
        for name, key in touched_user_idx:
            versions[("idx", name, key)] = clock
        for t in touched_targets:
            versions[("inc", t)] = clock

    graph._fire_added(r, values)
    return r
