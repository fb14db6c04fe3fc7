"""The sharded serving executor: serve buckets over a mesh of devices.

The port of ``hypergraphdb_tpu/serve/sharded.py``. :class:`ShardedExecutor`
is :class:`~.runtime.DeviceExecutor` with the lanes' dispatches rerouted
through ``ops/sharded_serving``: BFS batches pin the manager's sharded
(base, delta) twins (``SnapshotManager.attach_mesh`` and
``pinned_view(sharded=True)``) and exchange packed words between shards,
pattern candidates split along the candidate axis, join lanes split
across shards. Admission, batching, breakers, retries and the host-side
memtable corrections at collect are inherited unchanged: the sharded lanes
keep the single-device result contracts.

When it engages (``runtime._make_executor``): ``ServeConfig(sharded=True)``
forces it; ``sharded=None`` with ``hbm_budget_bytes`` set takes it when
more than one device is visible and the base snapshot's estimated bytes
exceed the budget. ``/healthz`` advertises the mesh, its gid-range
partition map and each shard's device memory in use (:meth:`mesh_report`).

A mesh may repeat a device (``parallel.sharded.make_mesh(["cuda:0"] *
4)``): the shards then run one after another on it, which exercises the
partition, gather and merge code on one card but measures no scaling.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from hypergraphdb_tpu_torch.serve.runtime import DeviceExecutor, ServeConfig
from hypergraphdb_tpu_torch.serve.stats import ServeStats


def snapshot_device_bytes(base) -> int:
    """Estimated single-device bytes of one packed base snapshot (the
    per-row columns and both CSR relations): what the AUTO shard trigger
    compares against ``ServeConfig.hbm_budget_bytes``."""
    n1 = base.num_atoms + 1
    per_row = 4 + 1 + 4 + 4 + 4 + 1      # type/is_link/arity/rank hi+lo/kind
    per_rel = 4 * 2                      # flat + src, int32 each
    return int(
        2 * (n1 + 1) * 4                 # the two offset arrays
        + n1 * per_row
        + base.n_edges_inc * per_rel
        + base.n_edges_tgt * per_rel
    )


def visible_devices(config: ServeConfig) -> list:
    """The devices of ``config.device``'s type this process sees (the CPU
    is one), capped at ``config.mesh_devices``."""
    import torch

    from hypergraphdb_tpu_torch.device import resolve_device

    dev = resolve_device(config.device)
    if dev.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    if config.mesh_devices is not None:
        devices = devices[: int(config.mesh_devices)]
    return devices


class ShardedExecutor(DeviceExecutor):
    """Serve-batch execution over a ``parallel.sharded.Mesh``.

    Construction attaches the mesh to the graph's snapshot manager; the
    first pinned BFS view pays the base's split and upload, or
    :meth:`prewarm` does at start. ``mesh=None`` meshes every visible
    device of ``config.device``'s type, capped by ``mesh_devices``."""

    #: device-served results count under ``serve.lane.<kind>.sharded``
    device_lane = "sharded"

    def __init__(self, graph, config: ServeConfig,
                 stats: Optional[ServeStats] = None, mesh=None):
        super().__init__(graph, config, stats)
        if mesh is None:
            from hypergraphdb_tpu_torch.parallel.sharded import make_mesh

            mesh = make_mesh(visible_devices(config))
        self.mesh = mesh
        self.n_dev = int(mesh.n_dev)
        self.prewarm_counts["runs"] = 0
        self.mgr.attach_mesh(mesh)

    # -- pinning ----------------------------------------------------------
    def _pin_view(self, kind: str, host_only: bool = False):
        # BFS reads the sharded (base ∪ delta) twins; the pattern and join
        # lanes read the base on the host (assembly) plus the host
        # corrections, and pay no delta split
        return self.mgr.pinned_view(
            self.config.max_lag_edges, sync_delta=False,
            sharded=(kind == "bfs") and not host_only)

    # -- BFS --------------------------------------------------------------
    def _fused_bfs_kwargs(self, view, width: int, count: bool = True):
        return None  # the fused chain (K2, K1) runs on one device only

    def _serve_bfs(self, view, seeds, max_hops: int, top_r: int):
        from hypergraphdb_tpu_torch.ops.sharded_serving import (
            bfs_serve_batch_sharded,
        )

        self.stats.record_sharded_dispatch()
        return bfs_serve_batch_sharded(view.sharded_base, view.sharded_delta,
                                       seeds, max_hops, top_r)

    # -- patterns ---------------------------------------------------------
    def _pattern_gate(self, view):
        from hypergraphdb_tpu_torch.ops.sharded_serving import (
            pattern_sharded_ok,
        )

        # a truthy sentinel: host-assembled candidate rows need no
        # device-resident ELL matrix, only the arity cap
        return True if pattern_sharded_ok(view.base) else None

    def _serve_pattern(self, view, ell, anchors: np.ndarray,
                       type_vec: np.ndarray):
        from hypergraphdb_tpu_torch.ops.sharded_serving import (
            mesh_carrier,
            pattern_host_rows,
            pattern_serve_batch_sharded,
        )

        rows0, row0_types, tgt = pattern_host_rows(
            view.base, anchors, self.config.pattern_pad, self.n_dev)
        self.stats.record_sharded_dispatch()
        return pattern_serve_batch_sharded(
            mesh_carrier(self.mesh), rows0, row0_types, tgt, anchors,
            type_vec, self.config.top_r)

    # -- joins ------------------------------------------------------------
    def _execute_join(self, view, plan, consts, n_real: int):
        from hypergraphdb_tpu_torch.ops.sharded_serving import (
            execute_join_sharded,
            mesh_carrier,
        )

        if int(consts.shape[0]) % self.n_dev or getattr(plan, "bags", None):
            # a bucket the mesh does not split, or a bushy plan (the
            # sharded lane program runs one flat chain): the single-device
            # executor serves it, with the same knobs
            return super()._execute_join(view, plan, consts, n_real)
        cfg = self.config
        fact = view.factorized_join_rels() if cfg.join_factorized else None
        self.stats.record_sharded_dispatch()
        return execute_join_sharded(
            view.base, mesh_carrier(self.mesh), plan, consts,
            top_r=cfg.top_r, n_real=n_real, row_cap=cfg.join_row_cap,
            pad_cap=cfg.join_pad_cap, hub_split=cfg.join_hub_split,
            hub_threshold=cfg.join_hub_threshold,
            factorized=None if fact is not None else False)

    # -- start-up ---------------------------------------------------------
    def prewarm(self, buckets, max_hops: Optional[int] = None) -> int:
        """Pay at start what the first sharded BFS dispatches would pay:
        the base's split and upload (pinning a sharded view), then one run
        of each bucket at each prewarm hop count on pad lanes. With a plan
        cache open, ``prewarm_pattern_arities`` set and the base within the
        sharded pattern lane's arity cap (``pattern_sharded_ok``), each
        bucket also runs the pattern lane once per arity on pad anchors
        (its rows are assembled a batch, so nothing is built). The port's
        plan cache holds host plans and the sharded lanes have none, so
        nothing comes from it: returns 0. ``prewarm_counts["built"]``
        counts the sharded bases built here, ``prewarm_counts["runs"]`` the
        bucket runs of both lanes. Raises whatever fails."""
        from hypergraphdb_tpu_torch.ops.sharded_serving import (
            bfs_serve_batch_sharded,
            mesh_carrier,
            pattern_host_rows,
            pattern_serve_batch_sharded,
            pattern_sharded_ok,
        )

        hops_list = ((int(max_hops),) if max_hops is not None
                     else tuple(self.config.prewarm_hops or ())
                     or (self.config.default_max_hops,))
        with self.mgr._lock:
            fresh = self.mgr._sharded_epoch != self.mgr.compactions
        view = self._pin_view("bfs")
        n = view.base.num_atoms
        top_r = min(self.config.top_r + 1, n + 1)
        runs = 0
        for b in buckets:
            seeds = np.full(int(b), n, dtype=np.int32)
            for hops in hops_list:
                counts, _ = bfs_serve_batch_sharded(
                    view.sharded_base, view.sharded_delta, seeds, hops, top_r)
                counts.cpu()
                runs += 1
        arities = (tuple(self.config.prewarm_pattern_arities or ())
                   if self.aot is not None and pattern_sharded_ok(view.base)
                   else ())
        for b in buckets:
            type_vec = np.full(int(b), -1, dtype=np.int32)
            for P in arities:
                anchors = np.full((int(b), int(P)), n, dtype=np.int32)
                rows0, row0_types, tgt = pattern_host_rows(
                    view.base, anchors, self.config.pattern_pad, self.n_dev)
                counts, _ = pattern_serve_batch_sharded(
                    mesh_carrier(self.mesh), rows0, row0_types, tgt, anchors,
                    type_vec, self.config.top_r)
                counts.cpu()
                runs += 1
        self.prewarm_counts["built"] += int(fresh)
        self.prewarm_counts["runs"] += runs
        return 0

    # -- health -----------------------------------------------------------
    def mesh_report(self) -> dict:
        """What ``/healthz`` advertises: the mesh, the gid-range partition
        map shard-aware routing places by, and each shard's measured
        device memory in use (none on the CPU). Shards that share a device
        read the same figure."""
        from hypergraphdb_tpu_torch.parallel.sharded import (
            device_memory_stats,
        )
        from hypergraphdb_tpu_torch.storage.partitioned import PartitionMap

        with self.mgr._lock:
            sbase = self.mgr._sharded_base
            base = self.mgr.base
            epoch = self.mgr._sharded_epoch
        pmap = (sbase.partition_map if sbase is not None
                else PartitionMap.for_mesh(base.num_atoms + 1, self.n_dev))
        stats = device_memory_stats(self.mesh)
        shards = []
        for _, part, dev in self.mesh.local_shards():
            lo, hi = pmap.range_of(part)
            rec = {"device": str(dev), "gid_lo": int(lo), "gid_hi": int(hi)}
            mem = stats.get(str(dev.index)) if dev.type == "cuda" else None
            if mem:
                rec["hbm_bytes_in_use"] = mem["bytes_in_use"]
            shards.append(rec)
        return {
            "axis": self.mesh.axis_names[0],
            "devices": self.n_dev,
            "partition_map": pmap.to_dict(),
            "sharded_epoch": epoch,
            "shards": shards,
        }
