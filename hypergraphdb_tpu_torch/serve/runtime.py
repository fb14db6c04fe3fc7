"""The serving runtime: dispatch loop, device executor, lifecycle.

The port of ``hypergraphdb_tpu/serve/runtime.py`` with its BFS, pattern,
range and join lanes. Request path::

    submit_*() → AdmissionQueue (bounded, deadline-shedding)
        → Batcher (coalesce + pad-to-bucket, flush on full/linger)
            → Executor.launch()  — pin view, assemble, async device dispatch
                → Executor.collect() — wait, LSM-correct, complete futures

The dispatch thread **double-buffers**: ``pump()`` launches batch N+1
BEFORE collecting batch N's results, so host-side assembly of the next
batch overlaps device execution of the current one. CUDA launches are
asynchronous, but a plain ``tensor.cpu()`` in ``collect`` would queue
behind batch N+1's kernels on the one stream and wait for them too. So
``launch`` ends by queueing non-blocking copies of the batch's compact
outputs into page-locked host buffers and recording a CUDA event after
them (:class:`StagedOut`); ``collect`` waits on that event only.

Consistency: every batch is assembled from ONE
:class:`~hypergraphdb_tpu_torch.ops.incremental.PinnedView` — base, device
delta, and the host memtable captured under a single manager lock — so a
background compaction swapping mid-batch cannot desync what the kernel
reads from what the host correction compensates. BFS requests see
base ∪ delta directly on the device (staleness bounded by
``max_lag_edges``); pattern requests run on the base and the memtable is
merged at collect time against candidate records CAPTURED when the batch
launched — never the live graph — so every answer in a batch reflects the
pinned view's single point in the manager's event stream.

BFS routes, decided before anything launches and counted in
``DeviceExecutor.routes``: the fused hop (K2 every hop, the delta's
overlay through K1) unless ``use_pallas_bfs`` is off, a tombstone is
pending, or ``fused_bfs.serve_fused_kwargs`` declines the bucket with a
reason; then the dense base ∪ delta sweep. A bucket that is not a multiple
of 32 lanes rides the fused route padded up to whole 32-lane words (pad
lanes at the dummy id), as the reference's fused plan pads any K.

Device: ``ServeConfig.device`` (the card by default; it must be the
snapshot manager's device). Nothing moves work to the CPU on its own, and
no device failure is swallowed on the way to the retry/breaker ladder: a
failing prewarm raises from the constructor.

Join batches (one pattern signature a batch) run ``ops/join.execute_join``
over the base; the memtable is corrected at collect: a small pure-add
dirty set (new links and their targets, at most ``join_dirty_max`` atoms)
merges the host-enumerated tuples touching it
(``join/host.host_join_touching``), while tombstones, revalues or a larger
set send the whole batch to the exact host enumerator
(``join/host.host_join``), as do anchors outside the base.

Cold start: with ``aot_cache_dir`` (or ``$HG_AOT_CACHE``) the prewarm reads
each bucket's fused plan from ``ops/aot_cache.AOTCache``, keyed by the
base snapshot's fingerprint, and stores what it builds; the reference
caches XLA executables there, the port host plans (its CUDA libraries are
cached by source hash already). ``stats_snapshot()["aot"]`` holds the
cache's counters. Opening the cache or fingerprinting the base raises on
failure; only a stale or corrupt entry is rebuilt, counted.

Standing queries: ``attach_subscriptions`` hooks a
``sub/manager.SubscriptionManager`` into every ``step`` and ``pump``
(one evaluator round before batch formation, one after a finalize). The
dispatch thread survives a failing round, but each is counted
(``sub.pump_errors``) and logged.

Out of this slice, each raising :class:`~.types.Unservable` that names its
ROADMAP queue 1 item: the planner (``attach_planner``, ``submit_planned``;
item 7), sharding (``sharded=True``, ``hbm_budget_bytes``; item 8) and
EXPLAIN records (``explain=True``; item 10).

Deterministic testing: ``ServeConfig(manual=True)`` starts no thread —
tests drive ``step()`` / ``pump()`` with an injected clock and a fake
executor, making deadline shedding, flush policy, and drains exactly
reproducible.
"""

from __future__ import annotations

import random
import threading
import time
from concurrent.futures import Future
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np

from hypergraphdb_tpu_torch.device import DEFAULT_DEVICE
from hypergraphdb_tpu_torch.fault import (
    OPEN,
    CircuitBreaker,
    global_faults,
    is_transient,
)
from hypergraphdb_tpu_torch.obs import global_tracer
from hypergraphdb_tpu_torch.obs.device import annotate, profiling
from hypergraphdb_tpu_torch.obs.flight import global_flight
from hypergraphdb_tpu_torch.serve.admission import AdmissionQueue
from hypergraphdb_tpu_torch.serve.batcher import BUCKETS, Batcher, MicroBatch
from hypergraphdb_tpu_torch.serve.stats import ServeStats
from hypergraphdb_tpu_torch.serve.types import (
    BFSRequest,
    Clock,
    JoinRequest,
    JoinResult,
    PatternRequest,
    RangeRequest,
    ServeResult,
    Ticket,
    Unservable,
)

#: process flight recorder, bound once (one attribute read per site when
#: quiet)
_FLIGHT = global_flight()

#: the no-annotation dispatch context — stateless, safe to re-enter, so
#: the common (un-profiled) path allocates nothing per dispatch
_NULL_CM = nullcontext()

#: lanes of one bitmap word: the fused route's seed-block granularity
_WORD = 32

#: where a join lane's answer came from (``DeviceExecutor.join_routes``):
#: the device (with or without a partial correction), or the exact host
#: enumerator because the memtable was dirty past the partial path, the
#: planner declined the signature, an anchor lies outside the base, the
#: device window was truncated, a dirty batch's window was a prefix, or
#: the correction's reduced pattern was not servable
JOIN_ROUTES = ("device", "dirty", "declined", "beyond_base", "truncated",
               "prefix", "correction")


def _later(item: int, what: str) -> Unservable:
    """The error of an entry point this port does not have yet."""
    return Unservable(f"{what} waits for ROADMAP queue 1, item {item}")


@dataclass
class ServeConfig:
    """Knobs of one runtime; defaults suit the streaming-bench scale."""

    buckets: Sequence[int] = BUCKETS        # pad-to-bucket request widths
    max_queue: int = 4096                   # admission queue bound
    policy: str = "block"                   # backpressure: "block" | "fail"
    max_linger_s: float = 0.002             # flush latency bound
    default_deadline_s: Optional[float] = None
    max_lag_edges: int = 0                  # delta staleness bound (BFS)
    top_r: int = 128                        # compact result window
    pattern_pad: int = 128                  # base-row budget per pattern
    default_max_hops: int = 2
    clock: Optional[Clock] = None           # injectable time source
    manual: bool = False                    # no thread; tests call step()
    latency_window: int = 4096
    #: pre-admission fitness gate: a callable returning None (admit) or
    #: a reason string (refuse with AdmissionGated)
    admission_gate: Optional[Callable[[], Optional[str]]] = None
    tracer: Optional[object] = None         # hgobs Tracer; None → global
    device_timing: bool = False             # launch→ready deltas per batch
    #: perf sentinel, duck-typed (``observe`` / ``observe_batch`` /
    #: ``maybe_tick``): every completed request feeds it, the completion
    #: path drives its evaluation. None disables (one attribute read per
    #: completion).
    perf: Optional[object] = None
    # -- self-healing (hgfault) ----------------------------------------------
    max_retries: int = 2                    # transient launch re-attempts
    retry_base_s: float = 0.005             # backoff seed: base * 2^(n-1)
    retry_max_s: float = 0.25               # backoff cap
    retry_jitter: float = 0.5               # multiplicative jitter frac
    retry_seed: int = 0                     # deterministic jitter stream
    breaker_threshold: int = 3              # consecutive failures → OPEN
    breaker_cooldown_s: float = 0.25        # OPEN → HALF_OPEN probe delay
    transient_errors: tuple = ()            # extra types to retry
    sleep: Optional[Callable] = None        # injectable backoff sleeper
    faults: Optional[object] = None         # fault registry; None → global
    # -- raw speed -----------------------------------------------------------
    use_pallas_bfs: bool = True             # the fused route (K2 + K1)
    aot_cache_dir: Optional[str] = None     # plan cache; None → $HG_AOT_CACHE
    prewarm_aot: bool = True                # prewarm every bucket at start
    prewarm_hops: Optional[tuple] = None    # hops to warm; None → (default,)
    #: build the co-incidence CSR (and, with ``join_factorized``, the
    #: factorized relations) on the device at startup, for deployments
    #: that serve joins: done lazily the build would land on the dispatch
    #: thread inside the first join batch's deadline window after every
    #: compaction. Opt-in: BFS/pattern-only tiers should not pay it.
    prewarm_join_nbr: bool = False
    #: value DIMENSIONS (kind bytes, e.g. ``(ord("i"),)``) whose sorted
    #: index columns build and upload at startup
    prewarm_range_dims: tuple = ()
    # -- the join lane (degree split / factorized / partial correction) -----
    #: build the prefix-grouped (trie) encoding of the co/tgt relations
    #: once per (signature-cache miss, base epoch) at plan time — lanes
    #: probing equal rows then touch one copy. Joins-light tiers can switch
    #: it off and keep the flat CSRs.
    join_factorized: bool = True
    #: degree-split plans: lanes whose const-keyed rows exceed the hub
    #: threshold run the chunked dense-frontier chain instead of
    #: truncating onto the host path (``ops/join.join_hub_expand``)
    join_hub_split: bool = True
    #: hub threshold override (row width); None = the executor's pad cap
    join_hub_threshold: Optional[int] = None
    #: executor shape caps for the join lane (``ops/join`` defaults: 2^15
    #: pooled binding rows, 2^10 expansion pad)
    join_row_cap: int = 1 << 15
    join_pad_cap: int = 1 << 10
    #: per-lane memtable correction: while the dirty set — new links plus
    #: their targets — stays at most this many atoms, join batches keep
    #: dispatching on the device and collect merges the host-enumerated
    #: tuples touching the dirty set (``join/host.host_join_touching``);
    #: past it (or on any tombstone/revalue) the whole batch takes the
    #: exact host path. 0 disables the partial path.
    join_dirty_max: int = 16
    # -- multi-chip serving: item 8 ------------------------------------------
    sharded: Optional[bool] = None
    hbm_budget_bytes: Optional[int] = None
    #: where the executor's batches run: the card unless the caller asks
    #: for the CPU; it must be the graph's snapshot manager's device
    device: str = DEFAULT_DEVICE


class StagedOut(NamedTuple):
    """A launched batch's compact outputs on their way to the host:
    page-locked host tensors filled by non-blocking copies, and the CUDA
    event recorded after those copies (None on the CPU, where the tensors
    are the outputs themselves)."""

    arrays: tuple
    event: object = None


@dataclass
class LaunchedBatch:
    """An in-flight batch: the staged device outputs plus everything
    ``collect`` needs to turn them into per-ticket results."""

    batch: MicroBatch
    view: object = None                  # ops.incremental.PinnedView
    dev_out: object = None               # StagedOut of the compact outputs
    lane_tickets: list = field(default_factory=list)   # [(lane, Ticket)]
    host_tickets: list = field(default_factory=list)   # exact-fallback path
    #: pattern batches: {handle: (target_set, type_handle)} of memtable
    #: candidates, captured AT LAUNCH so collect-time corrections never
    #: read the live graph mid-ingest
    cand_records: dict = field(default_factory=dict)
    #: (t_launch, t_ready) in the tracer's clock once collect waited —
    #: the batch's device-execution attribution (ServeConfig.device_timing)
    t_device: object = None
    _t_launch: object = None
    #: range batches: how many leading entries of the view's
    #: ``new_atoms`` the dispatched delta column covered
    range_covered: int = 0
    #: double-buffer slot of this dispatch (dispatch sequence mod 2)
    slot: int = -1
    #: BFS batches: "fused" or "dense"
    route: Optional[str] = None
    #: join batches: the ``join/planner.JoinPlan`` the lanes executed —
    #: collect needs its column order to permute tuples back into the
    #: request's variable order
    join_plan: object = None
    #: join batches dispatched under a SMALL pure-add dirty memtable: the
    #: sorted touched-atom list (new links + their targets, captured at
    #: launch) the per-lane collect correction enumerates against — None
    #: when the memtable was clean at pin
    join_dirty: object = None
    #: join batches: real lanes this dispatch routed through the
    #: degree-split hub chain, and collect-side partial memtable
    #: corrections merged
    join_hub_lanes: int = 0
    join_partials: int = 0


class DeviceExecutor:
    """The real executor: batched lanes over a pinned snapshot view.

    Requests the fixed-shape lanes cannot serve exactly — seeds/anchors
    beyond the base's id space (atoms newer than the last compaction),
    base rows wider than ``pattern_pad``, non-exact range bounds, or a
    snapshot without ELL targets — fall back to exact host execution at
    collect time, counted in ``stats.host_fallbacks``.

    ``routes`` counts the BFS batches of each route (``overlay_batches``
    the fused ones that carried a delta's overlay, K1's work) and
    ``declined`` the reasons the fused plan gave for the dense ones, and
    the reasons a join signature's factorized build gave (its plan then
    serves from the flat CSRs); ``timing`` holds, per batch kind, the
    batches launched and the wall seconds spent in ``launch``
    (``launch_s``; of it pinning the view, ``pin_s``, and running the lane
    up to its staged outputs, ``dispatch_s``) and in ``collect``
    (``collect_s``; of it waiting for the device, ``wait_s``); join
    batches also count the seconds of their launch spent planning
    (``plan_s``: a plan and its factorized build are made once per
    signature and base) and the device reads their launch made
    (``host_syncs``). ``join_routes`` counts join lanes by where their
    answer came from (:data:`JOIN_ROUTES`).
    """

    #: which lane family a device-served result counts under
    device_lane = "device"

    def __init__(self, graph, config: ServeConfig,
                 stats: Optional[ServeStats] = None):
        if graph is None:
            raise ValueError("DeviceExecutor needs a graph")
        from hypergraphdb_tpu_torch.device import resolve_device, same_device

        self.graph = graph
        self.config = config
        self.stats = stats or ServeStats()
        self.tracer = config.tracer or global_tracer()
        self.faults = config.faults or global_faults()
        self.device = resolve_device(config.device)
        # serving implies ingest-concurrent reads: the incremental
        # (base, delta) pair IS the consistency mechanism
        self.mgr = graph.incremental or graph.enable_incremental(
            device=self.device)
        if not same_device(self.mgr.torch_device, self.device):
            raise ValueError(
                f"ServeConfig.device {self.device} is not the snapshot "
                f"manager's device {self.mgr.torch_device}; set it to match")
        #: real device dispatches so far — slot = seq mod 2
        self._dispatch_seq = 0
        self.routes = {"fused": 0, "dense": 0}
        self.overlay_batches = 0
        self.declined: dict = {}
        self.timing: dict = {}
        self._timing_lock = threading.Lock()
        #: (epoch, new_atoms scanned, touched set | "full") —
        #: _join_dirty_info's memo
        self._join_dirty_memo: tuple = (-1, 0, frozenset())
        self.join_routes = dict.fromkeys(JOIN_ROUTES, 0)
        #: the prewarm's plans: built in this process, and read from the
        #: plan cache
        self.prewarm_counts = {"built": 0, "from_cache": 0}
        #: the persistent plan cache (``ops/aot_cache``): the configured
        #: directory, else ``$HG_AOT_CACHE``, else None; its content key
        #: pins entries to the base snapshot it was opened on
        self._aot_base = None
        self.aot = self._open_aot_cache()

    def _open_aot_cache(self):
        import os

        from hypergraphdb_tpu_torch.ops.aot_cache import (
            CACHE_ENV,
            AOTCache,
            default_cache,
        )

        if not self.config.aot_cache_dir and not os.environ.get(CACHE_ENV):
            # decided before the content fingerprint, an O(E) CRC over the
            # whole CSR
            return None
        self._aot_base = self.mgr.base
        fp = self._content_key()
        if self.config.aot_cache_dir:
            return AOTCache(root=self.config.aot_cache_dir, content_key=fp,
                            device=self.device)
        return default_cache(content_key=fp, device=self.device)

    def _content_key(self) -> str:
        """Content fingerprint of the base the cache was opened on, the
        ``snapshot_fingerprint`` half of every cache key: a restart over
        the same graph hits, one over another graph rebuilds quietly."""
        from hypergraphdb_tpu_torch.ops.ellbfs import snapshot_fingerprint

        return snapshot_fingerprint(self._aot_base)

    def _time(self, kind: str, **add) -> None:
        with self._timing_lock:
            t = self.timing.setdefault(kind, {})
            for k, v in add.items():
                t[k] = t.get(k, 0) + v

    # -- the lanes ------------------------------------------------------------
    def _serve_bfs(self, view, seeds, max_hops: int, top_r: int):
        """One BFS batch over base ∪ delta by the dense sweep."""
        from hypergraphdb_tpu_torch.ops.serving import bfs_serve_batch

        return bfs_serve_batch(view.device, view.delta, seeds, max_hops,
                               top_r)

    def _serve_bfs_fused(self, kw: dict, seeds, max_hops: int, top_r: int):
        """One BFS batch through the fused hop (K2), the delta's edges on
        its overlay (K1)."""
        from hypergraphdb_tpu_torch.ops.serving import bfs_serve_batch_fused

        return bfs_serve_batch_fused(kw["plan"], seeds, kw["geom"], max_hops,
                                     top_r, overlay=kw["overlay"])

    def _serve_pattern(self, view, ell, anchors: np.ndarray,
                       type_vec: np.ndarray):
        """One pattern batch through the ELL route; ``anchors`` and
        ``type_vec`` arrive as host numpy."""
        import torch

        from hypergraphdb_tpu_torch.ops.serving import pattern_serve_batch

        return pattern_serve_batch(
            view.device, ell, torch.from_numpy(anchors).to(self.device),
            torch.from_numpy(type_vec).to(self.device),
            self.config.pattern_pad, self.config.top_r)

    def _serve_range(self, view, bcol, dcol, bounds: dict):
        """One range batch (``ops/value_index.serve_range_batch``: the
        ordered top-k over the base + delta value columns; an anchor-free
        batch passes the dummy incidence CSR)."""
        from hypergraphdb_tpu_torch.ops.value_index import serve_range_batch

        return serve_range_batch(view.base, bcol, dcol, bounds,
                                 top_r=self.config.top_r, device=self.device)

    def _execute_join(self, view, plan, consts, n_real: int):
        """One join batch through the lane executor. The view's
        epoch-cached factorized encodings (built at plan time or prewarm
        when ``join_factorized``) serve when present; absent (or disabled)
        the flat CSRs do — never a build on the dispatch path."""
        from hypergraphdb_tpu_torch.ops.join import execute_join

        cfg = self.config
        fact = (view.factorized_join_rels()
                if cfg.join_factorized else None)
        return execute_join(view.base, plan, consts,
                            top_r=cfg.top_r, n_real=n_real,
                            row_cap=cfg.join_row_cap,
                            pad_cap=cfg.join_pad_cap,
                            hub_split=cfg.join_hub_split,
                            hub_threshold=cfg.join_hub_threshold,
                            factorized=(None if fact is not None
                                        else False),
                            device=self.device)

    def _range_win_pad(self) -> int:
        """Candidate gather width per column: the smallest power-of-two
        bucket holding ``top_r``."""
        from hypergraphdb_tpu_torch.ops.value_index import range_win_pad

        return range_win_pad(self.config.top_r)

    def _pattern_gate(self, view):
        """The pattern lanes' device-path gate: the base's ELL targets, or
        None → every lane takes the exact host path."""
        from hypergraphdb_tpu_torch.ops.setops import ell_targets

        return ell_targets(view.base, self.device)

    def _pin_view(self, kind: str, host_only: bool = False):
        """Pin the batch's consistent read unit."""
        return self.mgr.pinned_view(
            self.config.max_lag_edges,
            sync_delta=(kind == "bfs") and not host_only,
        )

    @staticmethod
    def _fused_width(bucket: int) -> int:
        """The fused route's seed width for a bucket: whole 32-lane
        words."""
        return -(-int(bucket) // _WORD) * _WORD

    def prewarm(self, buckets, max_hops: Optional[int] = None) -> int:
        """Build, before the first request, what the first dispatches of
        each bucket would otherwise build on the dispatch thread: with
        ``prewarm_join_nbr`` the co-incidence CSR and the factorized
        relations on the device (unless the snapshot is over the pair
        budget, where the join lane serves on the host), the range
        columns of ``prewarm_range_dims``, and for BFS the fused plan (read
        from the plan cache when one is open, once a bucket as the
        reference warms each bucket's executable), the device twin and
        each bucket's overlay on the current view; then run each bucket's
        route once on pad seeds, so K2 (and, with a delta, K1 on the
        overlay) is built and launched at start.

        Returns the number of plans served from the cache, the
        reference's figure; ``prewarm_counts`` holds it beside the number
        of plans built. Raises whatever fails: a kernel that does not
        build or launch fails the runtime's construction."""
        import torch

        from hypergraphdb_tpu_torch.ops.fused_bfs import (
            fused_plans_for,
            plan_supported,
        )
        from hypergraphdb_tpu_torch.storage.value_index import (
            value_index_column,
        )

        built = warm = 0
        if self.config.prewarm_join_nbr:
            from hypergraphdb_tpu_torch.ops.join import (
                factorized_relations_device,
                nbr_max_pairs,
                nbr_pair_count,
                neighbor_csr_device,
            )

            base = self.mgr.base
            if nbr_pair_count(base) <= nbr_max_pairs():
                neighbor_csr_device(base, self.device)
                built += 1
                if self.config.join_factorized:
                    factorized_relations_device(base, self.device)
                    built += 1
        for dim in tuple(self.config.prewarm_range_dims or ()):
            value_index_column(self.mgr.base, int(dim), self.device)
            built += 1
        if self.config.use_pallas_bfs:
            hops = (int(max_hops) if max_hops is not None
                    else (tuple(self.config.prewarm_hops or ())
                          or (self.config.default_max_hops,))[0])
            view = self.mgr.pinned_view(self.config.max_lag_edges,
                                        sync_delta=True)
            n = view.base.num_atoms
            top_r = min(self.config.top_r + 1, n + 1)
            for b in buckets:
                width = self._fused_width(b)
                fresh = getattr(view.base, "_fused_plan", None) is None
                if (self.aot is not None and view.base is self._aot_base
                        and plan_supported(view.base, width) is None):
                    hits, misses = self.aot.stats.hits, self.aot.stats.misses
                    fused_plans_for(view.base, aot=self.aot)
                    warm += self.aot.stats.hits - hits
                    built += int(fresh and self.aot.stats.misses > misses)
                    fresh = False
                kw = self._fused_bfs_kwargs(view, width, count=False)
                if kw is None:
                    continue
                built += int(fresh)
                seeds = torch.full((width,), n, dtype=torch.int32,
                                   device=self.device)
                counts, _ = self._serve_bfs_fused(kw, seeds, hops, top_r)
                counts.cpu()
        self.prewarm_counts["built"] += built
        self.prewarm_counts["from_cache"] += warm
        return warm

    def _fused_bfs_kwargs(self, view, width: int, count: bool = True):
        """Route this batch through the fused hop? None keeps the dense
        sweep. Gates, in order: config, pending tombstones (the overlay
        cannot neutralize a dead link — bounded by the next compaction),
        and the fused plan's own verdict on this width (a reason string,
        counted in ``declined``). Anything else that fails raises."""
        from hypergraphdb_tpu_torch.ops.fused_bfs import serve_fused_kwargs

        if not self.config.use_pallas_bfs or view.dead:
            return None
        kw = serve_fused_kwargs(view.base, view.delta, width, self.device)
        if isinstance(kw, str):
            if count:
                self.declined[kw] = self.declined.get(kw, 0) + 1
            return None
        return kw

    def _dispatch_cm(self, kind: str, bucket: int, statics: int):
        """The per-dispatch profiler annotation, active only when device
        timing is on or an ``obs.profile`` session is running."""
        if self.config.device_timing or profiling():
            slot = self._dispatch_seq % 2
            return annotate(
                f"hg.serve.{kind}[K={bucket},s={statics},slot={slot}]"
            )
        return _NULL_CM

    def _stage(self, outs) -> StagedOut:
        """Queue the compact outputs' copies to page-locked host memory and
        record an event after them: collect waits on this batch alone."""
        if self.device.type != "cuda":
            return StagedOut(tuple(outs))
        import torch

        host = tuple(
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
                t, non_blocking=True)
            for t in outs)
        ev = torch.cuda.Event()
        ev.record()
        return StagedOut(host, ev)

    # -- launch (async: never waits for the device's work) -------------------
    def launch(self, batch: MicroBatch) -> LaunchedBatch:
        t0 = time.perf_counter()
        kind = batch.key[0]
        out = self._launch(batch, kind)
        self._time(kind, batches=1, launch_s=time.perf_counter() - t0)
        return out

    def _launch(self, batch: MicroBatch, kind: str) -> LaunchedBatch:
        import torch

        if getattr(batch, "force_host", False):
            # breaker-degraded mode: the WHOLE batch takes the exact host
            # path under the pinned epoch — no device work, no delta sync
            view = self._pin_view(kind, host_only=True)
            out = LaunchedBatch(batch=batch, view=view)
            out.host_tickets = list(batch.tickets)
            return out
        if self.faults.enabled:  # the ONE gate read on the disabled path
            # models the DEVICE dispatch failing — deliberately after the
            # force_host branch, so breaker-degraded batches stay immune
            self.faults.check("serve.launch", kind=kind)
        # pattern and range batches read base + HOST corrections only —
        # they don't pay a device-delta upload on their hot path
        t0 = time.perf_counter()
        view = self._pin_view(kind)
        t1 = time.perf_counter()
        out = LaunchedBatch(batch=batch, view=view)
        if kind == "bfs":
            max_hops = batch.key[1]
            n = view.base.num_atoms
            width = self._fused_width(batch.bucket)
            seeds = np.full(width, n, dtype=np.int32)  # pad → dummy
            lane = 0
            for t in batch.tickets:
                if t.request.seed >= n or t.request.seed < 0:
                    out.host_tickets.append(t)
                    continue
                seeds[lane] = t.request.seed
                out.lane_tickets.append((lane, t))
                lane += 1
            if out.lane_tickets:
                # one slot beyond top_r: an include_seed=False request
                # drops its seed from the window, and the spare slot keeps
                # the remaining prefix full-width (see _bfs_result)
                top_r = min(self.config.top_r + 1, n + 1)
                fused_kw = self._fused_bfs_kwargs(view, width)
                out.route = "fused" if fused_kw is not None else "dense"
                self.routes[out.route] += 1
                if fused_kw is not None and fused_kw["overlay"] is not None:
                    self.overlay_batches += 1
                with self._dispatch_cm("bfs", batch.bucket, max_hops):
                    if fused_kw is not None:
                        counts, first_r = self._serve_bfs_fused(
                            fused_kw,
                            torch.from_numpy(seeds).to(self.device),
                            max_hops, top_r)
                    else:
                        counts, first_r = self._serve_bfs(
                            view,
                            torch.from_numpy(seeds[: batch.bucket]).to(
                                self.device),
                            max_hops, top_r)
                    k = batch.bucket
                    out.dev_out = self._stage((counts[:k], first_r[:k]))
        elif kind == "pattern":
            from hypergraphdb_tpu_torch.ops.serving import NO_TYPE

            P = batch.key[1]
            n = view.base.num_atoms
            ell = self._pattern_gate(view)
            off = view.base.inc_offsets
            anchors = np.full((batch.bucket, P), n, dtype=np.int32)
            type_vec = np.full(batch.bucket, NO_TYPE, dtype=np.int32)
            lane = 0
            for t in batch.tickets:
                req = t.request
                a = np.asarray(req.anchors, dtype=np.int64)
                if ell is None or a.min() < 0 or a.max() >= n:
                    out.host_tickets.append(t)
                    continue
                lens = off[a + 1].astype(np.int64) - off[a]
                order = np.argsort(lens, kind="stable")
                if lens[order[0]] > self.config.pattern_pad:
                    out.host_tickets.append(t)  # base row over budget
                    continue
                anchors[lane] = a[order]
                if req.type_handle is not None:
                    type_vec[lane] = int(req.type_handle)
                out.lane_tickets.append((lane, t))
                lane += 1
            if out.lane_tickets:
                out.cand_records = self._capture_candidates(view)
                with self._dispatch_cm("pattern", batch.bucket, P):
                    out.dev_out = self._stage(self._serve_pattern(
                        view, ell, anchors, type_vec))
        elif kind == "range":
            self._launch_range(batch, view, out)
        elif kind == "join":
            self._launch_join(batch, view, out)
        else:  # pragma: no cover - batch keys come from our own requests
            raise Unservable(f"unknown batch kind {kind!r}")
        self._time(kind, pin_s=t1 - t0, dispatch_s=time.perf_counter() - t1)
        if out.dev_out is not None:
            out.slot = self._dispatch_seq % 2
            self._dispatch_seq += 1
            self.stats.record_device_dispatch()
            if self.config.device_timing and self.tracer.enabled:
                out._t_launch = self.tracer.clock()
        return out

    def _launch_range(self, batch: MicroBatch, view,
                      out: LaunchedBatch) -> None:
        from hypergraphdb_tpu_torch.ops.value_index import lane_bounds
        from hypergraphdb_tpu_torch.storage.value_index import (
            FIXED_WIDTH_KINDS,
            value_index_column,
        )

        dim = batch.key[1]
        n = view.base.num_atoms
        top = (1 << 64) - 1
        lanes = {k: [] for k in ("lo", "lo2", "lo_right", "hi", "hi2",
                                 "hi_right", "type_vec", "anchor", "desc")}
        # columns build lazily: a variable-width batch must consult their
        # device_exact verdicts BEFORE routing lanes, but an all-host batch
        # (every bound ambiguous) must not pay the build/upload at all
        cols = []

        def _cols():
            if not cols:
                cols.append(value_index_column(view.base, dim, self.device))
                cols.append(self.mgr.value_delta(
                    view, dim, self.config.max_lag_edges))
            return cols

        lane = 0
        for t in batch.tickets:
            req = t.request
            if (not req.exact
                    or (req.limit is not None
                        and req.limit > self.config.top_r)
                    or (req.anchor is not None
                        and (req.anchor < 0 or req.anchor >= n))
                    or (dim not in FIXED_WIDTH_KINDS
                        and not all(c.device_exact for c in _cols()))):
                # ambiguous variable-width bounds, columns holding any
                # ambiguous key, over-window limits, and anchors outside
                # the base (a memtable anchor has no base incidence row to
                # probe) all serve exactly on host. Anchored lanes under
                # fresh ingest stay on device: the base-row probe can only
                # mask fresh links OUT, and the collect re-offers the full
                # memtable candidate set through the live-graph predicate.
                out.host_tickets.append(t)
                continue
            # an open lower bound: rank 0, gte; an open upper bound: the
            # largest rank pair, lte
            open_lo, open_hi = req.lo_rank is None, req.hi_rank is None
            lanes["lo"].append(0 if open_lo else req.lo_rank)
            lanes["lo2"].append(0 if open_lo else req.lo_rank2)
            lanes["lo_right"].append(not open_lo and req.lo_op == "gt")
            lanes["hi"].append(top if open_hi else req.hi_rank)
            lanes["hi2"].append(top if open_hi else req.hi_rank2)
            lanes["hi_right"].append(open_hi or req.hi_op == "lte")
            lanes["type_vec"].append(-1 if req.type_handle is None
                                     else int(req.type_handle))
            lanes["anchor"].append(-1 if req.anchor is None
                                   else int(req.anchor))
            lanes["desc"].append(bool(req.desc))
            out.lane_tickets.append((lane, t))
            lane += 1
        if out.lane_tickets:
            bounds = lane_bounds(
                batch.bucket, np.asarray(lanes["lo"], dtype=np.uint64),
                lanes["lo_right"], np.asarray(lanes["hi"], dtype=np.uint64),
                lanes["hi_right"],
                lo2=np.asarray(lanes["lo2"], dtype=np.uint64),
                hi2=np.asarray(lanes["hi2"], dtype=np.uint64),
                type_vec=lanes["type_vec"], anchor=lanes["anchor"],
                desc=lanes["desc"])
            bcol, dcol = _cols()
            out.range_covered = dcol.covered
            self.stats.record_range_dispatch()
            with self._dispatch_cm("range", batch.bucket, dim):
                out.dev_out = self._stage(self._serve_range(
                    view, bcol, dcol, bounds))

    def _launch_join(self, batch: MicroBatch, view,
                     out: LaunchedBatch) -> None:
        """A join batch: a memtable LINK can mint bindings anywhere in the
        tuple space, which a compact device prefix cannot absorb. While the
        dirty set stays SMALL and pure-add the batch still dispatches on
        the device and collect merges the per-lane correction (tuples
        touching the dirty atoms); tombstones, revalues, a dirty set past
        ``join_dirty_max`` or a declined plan take the whole batch to the
        exact host path (bounded by the next compaction). Anchors outside
        the base's ids go to the host before the executor sees them."""
        sig = batch.key[1]
        n = view.base.num_atoms
        dirty = self._join_dirty_info(view)
        t0 = time.perf_counter()
        plan = (None if dirty == "full"
                else self._join_plan(sig, batch.tickets[0].request,
                                     view.base))
        self._time("join", plan_s=time.perf_counter() - t0)
        if plan is None:
            out.host_tickets = list(batch.tickets)
            route = "dirty" if dirty == "full" else "declined"
            self.join_routes[route] += len(batch.tickets)
            return
        consts = np.zeros((batch.bucket, sig.n_consts), dtype=np.int32)
        lane = 0
        for t in batch.tickets:
            cv = np.asarray(t.request.consts, dtype=np.int64)
            if len(cv) and (cv.min() < 0 or cv.max() >= n):
                out.host_tickets.append(t)  # beyond the base
                self.join_routes["beyond_base"] += 1
                continue
            consts[lane] = cv
            out.lane_tickets.append((lane, t))
            lane += 1
        if not out.lane_tickets:
            return
        out.join_plan = plan
        out.join_dirty = dirty
        with self._dispatch_cm("join", batch.bucket, len(plan.steps)):
            with self.tracer.span("join.execute", sig=str(sig.atoms)):
                ex = self._execute_join(view, plan, consts, n_real=lane)
            out.dev_out = self._stage((ex.counts, ex.trunc, ex.tuples))
        if ex.hub_lanes:
            self.stats.record_join_hub_dispatch(ex.hub_lanes)
        out.join_hub_lanes = int(ex.hub_lanes)
        self._time("join", host_syncs=ex.host_syncs)

    def _capture_candidates(self, view) -> dict:
        """Memtable candidates' (targets, type), read ONCE per batch right
        after the view is pinned: collect-time corrections then evaluate
        pin-time state, not whatever the live graph mutated into while the
        device ran. A candidate whose record vanished inside the pin →
        capture window is treated as dead; node candidates (no targets)
        can never match a pattern and drop out here too."""
        g = self.graph
        recs = {}
        for h in (set(view.new_atoms) | view.revalued) - view.dead:
            try:
                ts = {int(t) for t in g.get_targets(h)}
                th = int(g.get_type_handle_of(h))
            except Exception:
                continue
            recs[h] = (ts, th)
        return recs

    # -- collect (waits for its batch, corrects, resolves) -------------------
    def _host_arrays(self, launched: LaunchedBatch) -> tuple:
        """The batch's staged outputs as numpy, after waiting for its
        event (the wait is counted in ``timing``)."""
        st = launched.dev_out
        if st.event is not None:
            t0 = time.perf_counter()
            st.event.synchronize()
            self._time(launched.batch.key[0],
                       wait_s=time.perf_counter() - t0)
        return tuple(t.numpy() for t in st.arrays)

    def collect(self, launched: LaunchedBatch) -> list:
        t0 = time.perf_counter()
        try:
            return self._collect(launched)
        finally:
            self._time(launched.batch.key[0],
                       collect_s=time.perf_counter() - t0)

    def _collect(self, launched: LaunchedBatch) -> list:
        from hypergraphdb_tpu_torch.ops.setops import SENTINEL

        out = []
        view = launched.view
        if launched.dev_out is not None:
            if self.faults.enabled:
                # models the device RESULT download failing — host-only
                # batches (breaker-degraded / all-fallback) stay immune
                self.faults.check("serve.collect",
                                  kind=launched.batch.key[0])
            if launched._t_launch is not None:
                # opt-in device attribution: wait for the batch and record
                # the launch→ready wall delta for the batch's span
                from hypergraphdb_tpu_torch.obs.device import block_timed

                _, t_ready = block_timed(launched.dev_out,
                                         self.tracer.clock)
                launched.t_device = (launched._t_launch, t_ready)
            kind = launched.batch.key[0]
            if kind == "join":
                return self._collect_join(launched)
            if kind == "range":
                return self._collect_range(launched)
            counts, first_r = self._host_arrays(launched)
            if kind == "pattern":
                # batch-invariant memtable views, hoisted off the per-lane
                # path
                drop = view.dead | view.revalued
                drop_arr = (np.fromiter(drop, dtype=np.int64)
                            if drop else np.empty(0, dtype=np.int64))
                by_target = _by_target(launched.cand_records)
            for lane, ticket in launched.lane_tickets:
                row = first_r[lane]
                matches = row[row != SENTINEL].astype(np.int64)
                count = int(counts[lane])
                if kind == "bfs":
                    res = self._bfs_result(ticket.request, count, matches,
                                           view)
                else:
                    res = self._pattern_result(ticket.request, count,
                                               matches, view, drop_arr,
                                               launched.cand_records,
                                               by_target)
                out.append((ticket, res))
        out.extend(self._serve_host(launched.host_tickets, view.epoch))
        return out

    def _collect_join(self, launched: LaunchedBatch) -> list:
        """Join-batch result assembly: the compact per-lane windows,
        permuted from the plan's elimination order back to the request's
        variable order; a truncation-flagged lane (its count a LOWER
        bound) is re-served exactly on the host.

        Batches dispatched under a small pure-add dirty memtable
        (``launched.join_dirty``) merge the per-lane correction here: the
        host enumerates exactly the tuples touching the dirty atoms
        (``join/host.host_join_touching`` — sound because a new link only
        ever mints tuples containing itself or its targets) and unions
        them into the device answer. Lanes whose device window is a PREFIX
        (count beyond top_r) re-serve on the host instead — a prefix
        cannot absorb corrections, the pattern lane's rule. A pattern the
        correction's reduced form does not serve (``JoinUnsupported``)
        re-serves on the host too; any other failure surfaces on the
        request."""
        from hypergraphdb_tpu_torch.join.host import host_join_touching
        from hypergraphdb_tpu_torch.join.ir import JoinUnsupported

        view = launched.view
        sig = launched.batch.key[1]
        plan = launched.join_plan
        dirty = launched.join_dirty
        counts, trunc, tuples = self._host_arrays(launched)
        perm = [plan.order.index(v) for v in sig.vars]
        top_r = self.config.top_r

        def host(ticket, route: str):
            self.join_routes[route] += 1
            self.stats.record_host_fallback()
            return ticket, self._host_join(ticket.request, view.epoch)

        out = []
        for lane, ticket in launched.lane_tickets:
            try:
                rows = tuples[lane]
                rows = rows[rows[:, 0] >= 0][:, perm].astype(np.int64)
                count = int(counts[lane])
                if trunc[lane] or (dirty and count > len(rows)):
                    out.append(host(ticket, "truncated" if trunc[lane]
                                    else "prefix"))
                    continue
                if dirty:
                    try:
                        extra = host_join_touching(
                            self.graph, sig.bind(ticket.request.consts),
                            dirty,
                        )
                    except JoinUnsupported:
                        out.append(host(ticket, "correction"))
                        continue
                    if extra:
                        merged = sorted(
                            {tuple(int(x) for x in r) for r in rows}
                            | set(extra)
                        )
                        rows = np.asarray(merged, dtype=np.int64)
                        rows = rows.reshape(-1, len(sig.vars))[:top_r]
                        count = len(merged)
                    self.stats.record_join_partial_correction()
                    launched.join_partials += 1
                self.join_routes["device"] += 1
                out.append((ticket, JoinResult(
                    "join", count, rows, sig.vars,
                    count > len(rows), view.epoch,
                )))
            except Exception as e:  # surface, don't kill the batch
                out.append((ticket, e))
        out.extend(self._serve_host(launched.host_tickets, view.epoch))
        return out

    def _collect_range(self, launched: LaunchedBatch) -> list:
        """Range-batch result assembly: the compact per-lane windows plus
        the LSM memtable correction — drop dead/revalued gids,
        host-evaluate the residual memtable candidates (atoms past the
        delta column's coverage, plus every revalued atom), merge in VALUE
        order. Prefix lanes (count beyond the compact window) with a
        non-empty correction set re-serve exactly on host."""
        from hypergraphdb_tpu_torch.ops.setops import SENTINEL

        view = launched.view
        counts_f, first_r, covered, total = self._host_arrays(launched)
        residual = view.new_atoms[launched.range_covered:]
        drop = view.dead | view.revalued
        drop_arr = (np.fromiter(drop, dtype=np.int64)
                    if drop else np.empty(0, dtype=np.int64))
        cands = (set(residual) | view.revalued) - view.dead
        # filtered lanes need the FULL memtable candidate set: the type
        # filter reads the BASE type_of column and the anchor filter probes
        # the BASE incidence row, so fresh atoms are masked out on device
        # (never falsely in) and the host merge must re-offer every one
        cands_full = (
            (set(view.new_atoms) | view.revalued) - view.dead
            if any(t.request.type_handle is not None
                   or t.request.anchor is not None
                   for _, t in launched.lane_tickets)
            else cands
        )
        out = []
        for lane, ticket in launched.lane_tickets:
            try:
                req = ticket.request
                out.append((ticket, self._range_result(
                    req, int(counts_f[lane]),
                    first_r[lane][first_r[lane] != SENTINEL],
                    bool(covered[lane]), int(total[lane]), view,
                    drop_arr,
                    cands_full
                    if (req.type_handle is not None
                        or req.anchor is not None) else cands,
                )))
            except Exception as e:  # surface, don't kill the batch
                out.append((ticket, e))
        out.extend(self._serve_host(launched.host_tickets, view.epoch))
        return out

    def _range_result(self, req: RangeRequest, count_f: int,
                      matches: np.ndarray, covered: bool, total: int,
                      view, drop_arr: np.ndarray, cands: set):
        filtered = req.type_handle is not None or req.anchor is not None
        if filtered and not covered:
            # the window outran the gather pad under a filter: neither
            # count nor prefix is reconstructible on device
            self.stats.record_host_fallback()
            return self._host_range(req, view.epoch)
        count = count_f if filtered else total
        top_r = self.config.top_r
        upto = min(req.limit if req.limit is not None else top_r, top_r)
        if count <= len(matches):
            # the complete filtered set is in hand: corrections merge
            # exactly (the LSM read-merge, value edition)
            matches = matches.astype(np.int64)
            if len(drop_arr) and len(matches):
                matches = matches[~np.isin(matches, drop_arr)]
            keys = self._range_keys(req) if cands else None
            fresh = [h for h in cands
                     if self._range_matches_host(req, h, keys)]
            if fresh:
                matches = self._range_order(
                    req, np.union1d(matches,
                                    np.asarray(fresh, dtype=np.int64))
                )
            count = len(matches)
            matches = matches[:upto]
            return ServeResult("range", count, matches,
                               count > len(matches), view.epoch)
        # prefix shape: count exact, matches an honest value-ordered
        # prefix — but only while the memtable is quiet for this view
        if len(drop_arr) or cands:
            self.stats.record_host_fallback()
            return self._host_range(req, view.epoch)
        return ServeResult("range", count,
                           matches[:upto].astype(np.int64),
                           count > upto, view.epoch)

    # -- range lane helpers ---------------------------------------------------
    def _range_keys(self, req: RangeRequest) -> tuple:
        """(lo_key, hi_key) order-preserving byte bounds of one request —
        the host comparison unit (exact for every kind, unlike the 64-bit
        ranks). None = open."""
        ts = self.graph.typesystem

        def key_of(v):
            if v is None:
                return None
            vt = ts.infer(v)
            if vt is None:
                raise Unservable(f"value {v!r} has no registered type")
            return vt.to_key(v)

        return key_of(req.values[0]), key_of(req.values[1])

    def _range_matches_host(self, req: RangeRequest, h: int,
                            keys: Optional[tuple] = None) -> bool:
        """Does live atom ``h`` satisfy the FULL request predicate — kind,
        bounds, type, anchor? The memtable-correction evaluator."""
        from hypergraphdb_tpu_torch.storage.value_index import value_key_of

        g = self.graph
        if not g.contains(h):
            return False
        key = value_key_of(g, h)
        if key is None or key[0] != req.dim:
            return False
        lo_key, hi_key = keys if keys is not None else self._range_keys(req)
        payload = key[1:]
        if lo_key is not None:
            lo = lo_key[1:]
            if payload < lo or (payload == lo and req.lo_op == "gt"):
                return False
        if hi_key is not None:
            hi = hi_key[1:]
            if payload > hi or (payload == hi and req.hi_op == "lt"):
                return False
        if req.type_handle is not None and int(
            g.get_type_handle_of(h)
        ) != int(req.type_handle):
            return False
        if req.anchor is not None:
            try:
                if int(req.anchor) not in {
                    int(t) for t in g.get_targets(h)
                }:
                    return False
            except Exception:  # noqa: BLE001 - node candidate: no targets
                return False
        return True

    def _range_order(self, req: RangeRequest, gids: np.ndarray
                     ) -> np.ndarray:
        """Sort gids into the request's value order via their live keys
        (bounded work: only complete—≤ top_r—windows are ever merged)."""
        from hypergraphdb_tpu_torch.storage.value_index import value_key_of

        g = self.graph
        keyed = []
        for h in gids.tolist():
            key = value_key_of(g, int(h))
            if key is not None:
                keyed.append((key[1:], int(h)))
        keyed.sort(key=lambda kv: (kv[0], kv[1]))
        if req.desc:
            # descending by value, gid-ascending within ties (the lane's
            # complemented-rank order)
            keyed.sort(key=lambda kv: kv[1])
            keyed.sort(key=lambda kv: kv[0], reverse=True)
        return np.asarray([h for _, h in keyed], dtype=np.int64)

    def _host_range(self, req: RangeRequest, epoch: int) -> ServeResult:
        """Exact host oracle: walk the by-value system index in key order
        (the scan the device lane replaces), filter, and shape the result
        under the same order/limit/truncation contract."""
        from hypergraphdb_tpu_torch.core.graph import IDX_BY_VALUE

        g = self.graph
        idx = g.store.get_index(IDX_BY_VALUE)
        kb = bytes([req.dim])
        lo_key, hi_key = self._range_keys(req)
        start = lo_key if lo_key is not None else kb
        matched: list[int] = []
        for key, handles in idx.bulk_items(lo=start):
            if key[:1] != kb:
                break  # past the dimension's key family
            if lo_key is not None and key == lo_key and req.lo_op == "gt":
                continue
            if hi_key is not None:
                if key > hi_key or (key == hi_key and req.hi_op == "lt"):
                    break
            for h in np.asarray(handles).tolist():
                h = int(h)
                if req.type_handle is not None and (
                    not g.contains(h)
                    or int(g.get_type_handle_of(h)) != int(req.type_handle)
                ):
                    continue
                if req.anchor is not None:
                    try:
                        if int(req.anchor) not in {
                            int(t) for t in g.get_targets(h)
                        }:
                            continue
                    except Exception:  # noqa: BLE001 - node candidate
                        continue
                matched.append(h)
        arr = self._range_order(req, np.asarray(matched, dtype=np.int64))
        top_r = self.config.top_r
        upto = min(req.limit if req.limit is not None else top_r, top_r)
        return ServeResult("range", len(arr), arr[:upto],
                           len(arr) > upto, epoch, served_by="host")

    def collect_host(self, launched: LaunchedBatch) -> list:
        """Exact host re-serve of the WHOLE batch — the collect-failure
        recovery path: the device results are lost but the pinned epoch is
        still the right consistency label."""
        view = launched.view
        return self._serve_host(launched.batch.tickets,
                                0 if view is None else view.epoch)

    def _serve_host(self, tickets, epoch: int) -> list:
        """The ONE exact host-serving loop (fallback lanes, degraded
        batches, collect recovery): per-ticket dispatch with per-ticket
        exception capture — one failing request surfaces, never kills its
        batch."""
        out = []
        for ticket in tickets:
            self.stats.record_host_fallback()
            try:
                kind = ticket.request.kind
                if kind == "bfs":
                    out.append((ticket, self._host_bfs(ticket.request,
                                                       epoch)))
                elif kind == "range":
                    out.append((ticket, self._host_range(ticket.request,
                                                         epoch)))
                elif kind == "join":
                    out.append((ticket, self._host_join(ticket.request,
                                                        epoch)))
                else:
                    out.append((ticket, self._host_pattern(ticket.request,
                                                           epoch)))
            except Exception as e:  # surface, don't kill the batch
                out.append((ticket, e))
        return out

    # -- per-request result assembly -----------------------------------------
    def _bfs_result(self, req: BFSRequest, count: int,
                    matches: np.ndarray, view) -> ServeResult:
        if not req.include_seed and count > 0:
            # a live seed is always in its own visited set
            count -= 1
            matches = matches[matches != req.seed]
        matches = matches[: self.config.top_r]  # trim the spare slot
        truncated = count > len(matches)
        return ServeResult("bfs", count, matches, truncated, view.epoch)

    def _pattern_result(self, req: PatternRequest, count: int,
                        matches: np.ndarray, view, drop_arr: np.ndarray,
                        cand_records: dict,
                        by_target: Optional[dict] = None) -> ServeResult:
        truncated = count > len(matches)
        if truncated and (len(drop_arr) or cand_records):
            # corrections against a prefix we cannot see past are not
            # reconstructible: serve this rare shape exactly on host
            self.stats.record_host_fallback()
            return self._host_pattern(req, view.epoch)
        if truncated:
            # memtable quiet (checked above): device numbers are exact
            return ServeResult("pattern", count, matches, True, view.epoch)
        # LSM read-merge over the COMPLETE result set: drop links
        # tombstoned/revalued since the pack, evaluate the pattern over
        # the captured memtable records (pin-time state — never the live
        # graph) — exact at any delta lag. Only the records targeting the
        # first anchor can match (the batch's index of them by target)
        if len(drop_arr) and len(matches):
            matches = matches[~np.isin(matches, drop_arr)]
        if by_target is None:
            by_target = _by_target(cand_records)
        fresh = [
            h for h in by_target.get(req.anchors[0], ())
            if all(a in cand_records[h][0] for a in req.anchors[1:])
            and (req.type_handle is None
                 or cand_records[h][1] == int(req.type_handle))
        ]
        if fresh:
            matches = np.union1d(matches,
                                 np.asarray(fresh, dtype=np.int64))
        count = len(matches)
        top_r = self.config.top_r
        if count > top_r:
            # the merge pushed the full set past the compact window
            return ServeResult("pattern", count, matches[:top_r], True,
                               view.epoch)
        return ServeResult("pattern", count, matches, False, view.epoch)

    # -- join lane helpers ----------------------------------------------------
    def _join_dirty_info(self, view):
        """What the memtable holds that a join answer could see. Returns
        ``None`` — clean, device lane open with no correction; a sorted
        touched-atom list — small pure-ADD dirty set (every new link plus
        its targets, ≤ ``join_dirty_max`` atoms): the batch still
        dispatches on the device and collect merges the per-lane
        correction; ``"full"`` — tombstones/revalues (a vanished witness is
        not correctable against a compact window) or a dirty set past the
        bound: the whole batch takes the exact host path. Fresh NODES
        alone never dirty anything (nothing in the base points at them).

        Memoized per epoch with incremental suffix scans — ``new_atoms``
        only grows within an epoch and the touched set only accumulates
        (the ``"full"`` verdict is sticky), so a bulk ingest costs each
        batch only the atoms that arrived since the last one."""
        if view.dead or view.revalued:
            return "full"
        epoch, n_seen, dirty = self._join_dirty_memo
        if epoch != view.epoch:
            n_seen, dirty = 0, frozenset()
        limit = self.config.join_dirty_max
        if dirty != "full" and len(view.new_atoms) > n_seen:
            g = self.graph
            acc = set(dirty)
            for h in view.new_atoms[n_seen:]:
                try:
                    ts = g.get_targets(h)
                except Exception:  # noqa: BLE001 - removed since: no link
                    continue
                if ts:
                    acc.add(int(h))
                    acc.update(int(t) for t in ts)
                    if len(acc) > limit:
                        acc = "full"
                        break
            dirty = acc if acc == "full" else frozenset(acc)
        self._join_dirty_memo = (view.epoch, len(view.new_atoms), dirty)
        if dirty == "full":
            return "full"
        return sorted(dirty) if dirty else None

    def _join_plan(self, sig, req0: JoinRequest, base):
        """The signature's decomposition, planned once per (signature,
        base snapshot). The first request's constants seed the cardinality
        estimates; the structure stays valid for every constant vector of
        the signature. None → the planner declined (host path): a pattern
        it does not serve, or a co-incidence relation over the pair budget
        (declined BEFORE launch would ask the executor to build it on the
        dispatch thread). With ``join_factorized`` the trie encoding is
        built here, once per base epoch; a build that fails its pair
        budget leaves the plan serving from the flat CSRs, its reason
        counted in ``declined``."""
        cache = getattr(base, "_join_plan_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(base, "_join_plan_cache", cache)
        if sig not in cache:
            from hypergraphdb_tpu_torch.join.ir import JoinUnsupported
            from hypergraphdb_tpu_torch.join.planner import plan_join
            from hypergraphdb_tpu_torch.ops.join import (
                factorized_relations,
                nbr_max_pairs,
                nbr_pair_count,
            )

            try:
                if any(a[0] == "co" for a in sig.atoms) and \
                        nbr_pair_count(base) > nbr_max_pairs():
                    cache[sig] = None
                else:
                    with self.tracer.span("join.plan",
                                          sig=str(sig.atoms)):
                        cache[sig] = plan_join(
                            base, sig.bind(req0.consts), sig,
                            req0.consts,
                        )
            except JoinUnsupported:
                cache[sig] = None
            if cache[sig] is not None and self.config.join_factorized:
                try:
                    with self.tracer.span("join.factorize"):
                        factorized_relations(base, self.device)
                except JoinUnsupported as e:
                    reason = f"join factorize: {e}"
                    self.declined[reason] = self.declined.get(reason, 0) + 1
        return cache[sig]

    def _host_join(self, req: JoinRequest, epoch: int) -> JoinResult:
        from hypergraphdb_tpu_torch.join.host import host_join

        rows = host_join(self.graph, req.sig.bind(req.consts))
        V = len(req.sig.vars)
        arr = (np.asarray(rows, dtype=np.int64) if rows
               else np.empty((0, V), dtype=np.int64))
        top_r = self.config.top_r
        return JoinResult("join", len(arr), arr[:top_r], req.sig.vars,
                          len(arr) > top_r, epoch, served_by="host")

    # -- exact host fallbacks -------------------------------------------------
    def _host_bfs(self, req: BFSRequest, epoch: int) -> ServeResult:
        from hypergraphdb_tpu_torch.algorithms.traversals import (
            HGBreadthFirstTraversal,
        )

        reached = {
            int(atom) for _, atom in HGBreadthFirstTraversal(
                self.graph, req.seed, max_distance=req.max_hops
            )
        }
        if req.include_seed:
            reached.add(int(req.seed))
        else:
            reached.discard(int(req.seed))
        arr = np.asarray(sorted(reached), dtype=np.int64)
        top_r = self.config.top_r
        return ServeResult("bfs", len(arr), arr[:top_r],
                           len(arr) > top_r, epoch, served_by="host")

    def _host_pattern(self, req: PatternRequest, epoch: int) -> ServeResult:
        from hypergraphdb_tpu_torch.query import conditions as c

        clauses = [c.Incident(a) for a in req.anchors]
        if req.type_handle is not None:
            clauses.append(c.AtomType(int(req.type_handle)))
        cond = clauses[0] if len(clauses) == 1 else c.And(*clauses)
        arr = np.asarray(sorted(int(h) for h in self.graph.find_all(cond)),
                         dtype=np.int64)
        top_r = self.config.top_r
        return ServeResult("pattern", len(arr), arr[:top_r],
                           len(arr) > top_r, epoch, served_by="host")


def _by_target(cand_records: dict) -> dict:
    """The captured memtable records indexed by target: ``{target:
    [handle, ...]}`` — a lane then tests only the records that target its
    first anchor, not every record of the batch."""
    by_target: dict = {}
    for h, (ts, _) in cand_records.items():
        for t in ts:
            by_target.setdefault(t, []).append(h)
    return by_target


def _make_executor(graph, config: ServeConfig, stats):
    """The executor of one runtime: the single-card
    :class:`DeviceExecutor`. The reference's mesh-sharded executor
    (``sharded=True``, or AUTO with ``hbm_budget_bytes``) waits for
    ROADMAP item 8."""
    if config.sharded is True or config.hbm_budget_bytes is not None:
        raise _later(8, "sharded serving (sharded / hbm_budget_bytes)")
    return DeviceExecutor(graph, config, stats)


class ServeRuntime:
    """The serving front door. Threaded by default; ``manual=True`` for
    deterministic stepping (tests). Context manager: ``close(drain=True)``
    on exit."""

    def __init__(self, graph=None, config: Optional[ServeConfig] = None,
                 executor=None):
        self.config = config or ServeConfig()
        self.clock: Clock = self.config.clock or time.monotonic
        self.tracer = self.config.tracer or global_tracer()
        self.stats = ServeStats(self.config.latency_window)
        self.perf = self.config.perf
        self.faults = self.config.faults or global_faults()
        # per-batch-key breaker: a flaky device bucket trips to the exact
        # host-fallback path and recovers via half-open probes
        self.breaker = CircuitBreaker(
            threshold=self.config.breaker_threshold,
            cooldown_s=self.config.breaker_cooldown_s,
            clock=self.clock,
            on_state=self.stats.set_breaker_state,
            on_trip=self.stats.record_breaker_trip,
            on_key_state=self.stats.set_breaker_key_state,
            on_key_trip=self.stats.record_breaker_key_trip,
        )
        self._sleep: Callable = self.config.sleep or time.sleep
        # seeded jitter: retries are reproducible under a fixed seed
        self._retry_rng = random.Random(self.config.retry_seed)
        self.queue = AdmissionQueue(
            self.config.max_queue, self.config.policy, self.clock,
            self.stats,
        )
        self.batcher = Batcher(self.queue, self.config.buckets,
                               self.config.max_linger_s)
        self.executor = (
            executor if executor is not None
            else _make_executor(graph, self.config, self.stats)
        )
        self.graph = graph
        # deploy-time set-up: the plans and kernels of every bucket are
        # built before the dispatch thread takes traffic; a failure raises
        # from here (injected executors without a prewarm hook skip it)
        if (self.config.prewarm_aot and graph is not None
                and callable(getattr(self.executor, "prewarm", None))):
            self.executor.prewarm(self.config.buckets)
        #: in-flight batch: (tickets, executor token, batch key,
        #: device_attempted) — what _finalize needs
        self._pending: Optional[tuple] = None
        #: attached ``sub.SubscriptionManager`` (``attach_subscriptions``):
        #: the dispatch cycle drives its evaluator rounds, so standing
        #: queries re-fire on the thread that forms batches and coalesce
        #: with ad-hoc traffic by bucket key. None = one comparison a cycle
        self.subscriptions = None
        self._closed = False
        self._close_started = False
        self._draining = False
        self._close_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        if not self.config.manual:
            self._thread = threading.Thread(
                target=self._loop, name="hgdb-serve", daemon=True
            )
            self._thread.start()

    # -- submit --------------------------------------------------------------
    def submit(self, request, deadline_s: Optional[float] = None,
               priority: int = 0, explain: bool = False) -> Future:
        """Admit one request; returns its future. Raises
        :class:`~.types.QueueFull` under fail-fast backpressure,
        :class:`~.types.RuntimeClosed` after close; a deadline that expires
        while blocked lands ON the future as DeadlineExceeded. A higher
        ``priority`` class pops first at batch formation (FIFO within a
        class). An ``admission_gate`` refusal raises
        :class:`~.types.AdmissionGated` BEFORE any queue state is touched.
        ``explain=True`` (the reference's cost-attribution record) raises
        :class:`~.types.Unservable` until its ROADMAP item."""
        gate = self.config.admission_gate
        if gate is not None:
            reason = gate()
            if reason:
                self.stats.record_gated()
                from hypergraphdb_tpu_torch.serve.types import AdmissionGated

                raise AdmissionGated(str(reason))
        if explain:
            raise _later(10, "explain=True (obs/fleet.explain_record)")
        now = self.clock()
        dl = (deadline_s if deadline_s is not None
              else self.config.default_deadline_s)
        ticket = Ticket(
            request=request, submit_t=now,
            deadline_t=None if dl is None else now + dl,
            priority=int(priority),
        )
        if self.tracer.enabled:  # the ONE gate read on the disabled path
            self._trace_submit(ticket)
        try:
            self.queue.submit(ticket)
        except Exception as e:
            ticket._close_trace("error", error=type(e).__name__)
            raise
        tr = ticket.trace
        if tr is not None:
            # ending is race-safe: if the dispatch thread already finished
            # the trace, the first end (finish's) won
            tr.marks["submit"].end()
        return ticket.future

    def _trace_submit(self, ticket: Ticket) -> None:
        """Open the request's trace: ``request`` root + ``submit`` and
        ``queue_wait`` spans, both before the ticket becomes visible to
        the dispatch thread."""
        tr = self.tracer.start_trace(
            "serve.request", kind=ticket.request.kind,
            priority=ticket.priority,
        )
        if tr is None:
            return
        root = tr.start_span("request")
        tr.marks["root"] = root
        tr.marks["submit"] = tr.start_span("submit", parent=root)
        tr.marks["queue_wait"] = tr.start_span("queue_wait", parent=root)
        ticket.trace = tr

    def submit_bfs(self, seed: int, max_hops: Optional[int] = None,
                   deadline_s: Optional[float] = None,
                   include_seed: bool = True, priority: int = 0,
                   explain: bool = False) -> Future:
        return self.submit(
            BFSRequest(int(seed),
                       max_hops if max_hops is not None
                       else self.config.default_max_hops,
                       include_seed),
            deadline_s, priority, explain,
        )

    def submit_pattern(self, anchors: Sequence[int],
                       type_handle: Optional[int] = None,
                       deadline_s: Optional[float] = None,
                       priority: int = 0, explain: bool = False) -> Future:
        return self.submit(
            PatternRequest(tuple(int(a) for a in anchors),
                           None if type_handle is None
                           else int(type_handle)),
            deadline_s, priority, explain,
        )

    def submit_join(self, spec, distinct: bool = True,
                    deadline_s: Optional[float] = None,
                    priority: int = 0, explain: bool = False) -> Future:
        """Admit a conjunctive-pattern JOIN: ``spec`` is either a prebuilt
        :class:`~.types.JoinRequest` or a ``{var: condition}`` mapping with
        ``query.variables.Var`` cross-references
        (``query/bridge.to_join_request`` does the extraction). Raises
        :class:`~.types.Unservable` for specs outside the pattern
        vocabulary. Resolves to a :class:`~.types.JoinResult`."""
        if not isinstance(spec, JoinRequest):
            from hypergraphdb_tpu_torch.query.bridge import to_join_request

            spec = to_join_request(self.graph, spec, distinct=distinct)
        return self.submit(spec, deadline_s, priority, explain)

    def submit_range(self, lo=None, hi=None, *, lo_op: str = "gte",
                     hi_op: str = "lte", type_handle: Optional[int] = None,
                     anchor: Optional[int] = None, desc: bool = False,
                     limit: Optional[int] = None,
                     deadline_s: Optional[float] = None,
                     priority: int = 0, explain: bool = False) -> Future:
        """Admit a value RANGE / ordered / top-k request: atoms whose value
        lies in the ``[lo, hi]`` window of the bounds' kind, in value order
        (``desc=True`` flips it), optionally type-filtered /
        ``anchor``-incident / ``limit``-ed. Resolves to a
        :class:`~.types.ServeResult` with kind ``"range"``. Raises
        :class:`~.types.Unservable` for unbounded or mixed-kind windows."""
        from hypergraphdb_tpu_torch.query.bridge import to_range_request

        return self.submit(
            to_range_request(self.graph, lo, hi, lo_op=lo_op, hi_op=hi_op,
                             type_handle=type_handle, anchor=anchor,
                             desc=desc, limit=limit),
            deadline_s, priority, explain,
        )

    def submit_query(self, condition,
                     deadline_s: Optional[float] = None,
                     priority: int = 0) -> Future:
        """Admit a query CONDITION (the batchable subset — see
        ``query/bridge``). Raises :class:`~.types.Unservable` for
        conditions outside it."""
        from hypergraphdb_tpu_torch.query.bridge import to_request

        return self.submit(
            to_request(self.graph, condition,
                       default_max_hops=self.config.default_max_hops),
            deadline_s, priority,
        )

    # -- the host tiers that ride the runtime ---------------------------------
    def attach_planner(self, planner) -> None:
        raise _later(7, "attach_planner (plan/)")

    def submit_planned(self, condition, deadline_s: Optional[float] = None,
                       priority: int = 0, explain: bool = False,
                       force_shape: Optional[str] = None) -> Future:
        raise _later(7, "submit_planned (plan/)")

    def attach_subscriptions(self, manager) -> None:
        """Wire a ``sub.SubscriptionManager`` into the dispatch cycle:
        every ``step``/``pump`` runs one evaluator round before batch
        formation (dirty standing queries re-enter the admission queue
        and coalesce with ad-hoc lanes) and one after a finalize
        (completed evals notify within the same wake)."""
        with self._close_lock:
            self.subscriptions = manager

    def _pump_subs(self) -> None:
        """One evaluator round. A round that raises must not stop the
        dispatch thread: it is counted (``sub.pump_errors``) and logged,
        and the next cycle runs the next round."""
        m = self.subscriptions
        if m is None:
            return
        try:
            m.pump()
        except Exception:
            import logging

            m.stats.record_pump_error()
            logging.getLogger("hypergraphdb_tpu_torch.serve").exception(
                "subscription pump error (counted in sub.pump_errors)")

    # -- dispatch ------------------------------------------------------------
    def step(self, drain: bool = False) -> bool:
        """ONE synchronous collect→launch→finalize cycle (manual mode /
        tests). Returns whether a batch was dispatched."""
        self._pump_subs()
        t_form = self.tracer.clock() if self.tracer.enabled else None
        batch = self.batcher.next_batch(self.clock(), drain=drain)
        if batch is None:
            return False
        inflight = self._launch_guarded(batch, t_form)
        if inflight is not None:
            self.stats.record_batch(len(inflight[0]), batch.bucket)
            self._finalize(*inflight)
            self._pump_subs()
        return True

    def pump(self, drain: bool = False) -> bool:
        """One PIPELINED cycle: launch the next batch (if any), THEN
        finalize the previously launched one — host assembly of batch N+1
        overlaps device execution of batch N. Returns whether a new batch
        was consumed."""
        self._pump_subs()
        t_form = self.tracer.clock() if self.tracer.enabled else None
        batch = self.batcher.next_batch(self.clock(), drain=drain)
        inflight = None
        if batch is not None:
            inflight = self._launch_guarded(batch, t_form)
            if inflight is not None:
                self.stats.record_batch(len(inflight[0]), batch.bucket)
        prev = self._take_pending()
        if prev is not None:
            self._finalize(*prev)
            self._pump_subs()
        with self._close_lock:
            self._pending = inflight
        return batch is not None

    def _launch_guarded(self, batch, t_form=None):
        """Launch with the self-healing ladder, converting executor errors
        into per-ticket outcomes instead of a dead dispatch thread:
        transient failures get bounded exponential backoff + seeded jitter
        that respects each ticket's remaining deadline; permanent failures
        surface typed to every caller; K consecutive device failures trip
        the batch key's circuit breaker, and a tripped/OPEN key re-routes
        the batch — including the one that tripped it — to the exact
        host-fallback path. Returns ``(tickets, token, key,
        device_attempted)`` for ``_finalize``, or None when every ticket
        was already completed."""
        tracer = self.tracer
        traced = tracer.enabled
        if traced:
            if t_form is None:
                t_form = tracer.clock()
            n_real = len(batch.tickets)
            pending = []
            for t in batch.tickets:
                tr = t.trace
                if tr is not None and not tr.finished:
                    qw = tr.marks.pop("queue_wait", None)
                    # clamp per ticket: a request submitted AFTER the
                    # caller's t_form capture must not get a negative
                    # queue_wait
                    t0_i = t_form
                    if qw is not None:
                        t0_i = max(t_form, qw.t0)
                        qw.end(t0_i)
                    pending.append((tr, t0_i))
            t_l0 = tracer.clock()
            for tr, t0_i in pending:
                if not tr.finished:
                    tr.add_span(
                        "batch_form", t0_i, max(t_l0, t0_i),
                        parent=tr.marks.get("root"), bucket=batch.bucket,
                        n_real=n_real, n_pad=batch.bucket - n_real,
                    )
        key = batch.key
        cfg = self.config
        attempt = 0
        while True:
            device = not batch.force_host and self.breaker.allow(key)
            batch.force_host = not device
            try:
                launched = self.executor.launch(batch)
            except Exception as e:
                if not device:
                    # the DEGRADED path itself failed: no ladder left
                    self._fail_batch(batch.tickets, e)
                    return None
                self.breaker.record_failure(key)
                if not is_transient(e, cfg.transient_errors):
                    self._fail_batch(batch.tickets, e)
                    return None
                attempt += 1
                if self.breaker.state_of(key) == OPEN:
                    # this failure tripped the breaker: serve THIS batch
                    # on host immediately (no backoff: host is local)
                    for t in batch.tickets:
                        if t.trace is not None:
                            t.trace.force_sample()
                    continue
                if attempt > cfg.max_retries:
                    self._fail_batch(batch.tickets, e)
                    return None
                self.stats.record_retry()
                if _FLIGHT.enabled:
                    _FLIGHT.record("serve.retry", key=str(key),
                                   attempt=attempt,
                                   error=type(e).__name__)
                if not self._backoff(batch, attempt):
                    return None  # every ticket's deadline < next attempt
                continue
            break
        if traced:
            t_l1 = tracer.clock()
            for t in batch.tickets:
                tr = t.trace
                if tr is not None and not tr.finished:
                    tr.add_span("launch", t_l0, t_l1,
                                parent=tr.marks.get("root"),
                                retries=attempt)
        return batch.tickets, launched, key, device

    def _backoff(self, batch, attempt: int) -> bool:
        """Sleep the capped exponential backoff (seeded jitter) before
        re-attempting a transient launch failure — deadline-aware: tickets
        whose deadline falls inside the sleep are shed NOW, and with none
        left the batch is abandoned. Returns whether anything is left to
        retry."""
        cfg = self.config
        dt = min(cfg.retry_base_s * (2.0 ** (attempt - 1)), cfg.retry_max_s)
        dt *= 1.0 + cfg.retry_jitter * self._retry_rng.random()
        now = self.clock()
        wake = now + dt
        live = []
        for t in batch.tickets:
            if t.expired(wake):
                t.shed(now)
                self.stats.record_shed()
            else:
                live.append(t)
        batch.tickets = live
        if not live:
            return False
        self._sleep(dt)
        return True

    def _fail_batch(self, tickets, exc: BaseException) -> None:
        if tickets and _FLIGHT.enabled:
            # a typed serve error is an incident: the recorder dumps the
            # window that led here (rate-limited; counting is always on)
            _FLIGHT.incident("serve_error", error=type(exc).__name__,
                             tickets=len(tickets))
        for t in tickets:
            if t.fail(exc):
                self.stats.record_error()

    def _take_pending(self):
        """Swap the in-flight (tickets, token) pair out under the state
        lock (the lock covers only the pointer — finalize's wait runs
        outside it)."""
        with self._close_lock:
            prev, self._pending = self._pending, None
            return prev

    def _pending_empty(self) -> bool:
        with self._close_lock:
            return self._pending is None

    def _finalize(self, tickets, token, key=None, device=False) -> None:
        tracer = self.tracer
        traced = tracer.enabled
        t_c0 = tracer.clock() if traced else 0.0
        try:
            results = self.executor.collect(token)
        except Exception as e:
            results = self._recover_collect(tickets, token, key, device, e)
            if results is None:
                return
        else:
            if device and key is not None:
                self.breaker.record_success(key)
        if traced:
            t_c1 = tracer.clock()
            t_dev = getattr(token, "t_device", None)
            slot = getattr(token, "slot", -1)
            if t_dev is not None:
                self.stats.record_device_time(t_dev[1] - t_dev[0])
                if self.perf is not None and key is not None:
                    # a sentinel bug must degrade observability, never
                    # the batch
                    try:
                        self.perf.observe_batch(
                            key[0], t_dev[1] - t_dev[0],
                            n_real=len(getattr(token, "lane_tickets",
                                               ()) or ()),
                            n_total=getattr(getattr(token, "batch", None),
                                            "bucket", 0) or 0,
                            t=self.clock(),
                        )
                    except Exception:  # noqa: BLE001
                        self.stats.record_perf_error()
            for ticket, res in results:
                tr = ticket.trace
                if tr is None or tr.finished:
                    continue
                root = tr.marks.get("root")
                served_by = getattr(res, "served_by", None)
                if t_dev is not None and served_by == "device":
                    tr.add_span("device", t_dev[0], t_dev[1], parent=root,
                                slot=slot)
                tr.add_span("collect", t_c0, t_c1, parent=root)
                if served_by == "host":
                    tr.add_span("host_fallback", t_c0, t_c1, parent=root)
        now = self.clock()
        device_lane = getattr(self.executor, "device_lane", "device")
        for ticket, res in results:
            if isinstance(res, BaseException):
                if ticket.fail(res):
                    self.stats.record_error()
            else:
                path = ("host"
                        if getattr(res, "served_by", None) == "host"
                        else device_lane)
                if ticket.resolve(res):
                    # a cancel()ed future neither raises out of the
                    # dispatch thread nor counts as a completion
                    self.stats.record_complete(now - ticket.submit_t)
                    self.stats.record_lane(res.kind, path)
                    if self.perf is not None:
                        try:
                            self.perf.observe(res.kind,
                                              now - ticket.submit_t,
                                              path=path, t=now)
                        except Exception:  # noqa: BLE001
                            self.stats.record_perf_error()
        if self.perf is not None:
            # rate-limited drift evaluation rides the completion path;
            # guarded so an evaluation bug cannot strand the next batch
            try:
                self.perf.maybe_tick()
            except Exception:  # noqa: BLE001
                import logging

                logging.getLogger("hypergraphdb_tpu_torch.serve").warning(
                    "perf sentinel tick failed (continuing)",
                    exc_info=True,
                )

    def _recover_collect(self, tickets, token, key, device,
                         exc: BaseException):
        """A collect failure loses the whole batch's device results; the
        recovery is an exact host re-serve under the same pinned epoch
        (the executor's ``collect_host`` hook), not a device retry. Feeds
        the breaker like any other device failure. Returns replacement
        results, or None after failing every ticket typed."""
        if device and key is not None:
            self.breaker.record_failure(key)
        host = getattr(self.executor, "collect_host", None)
        if host is not None and is_transient(exc,
                                             self.config.transient_errors):
            self.stats.record_retry()
            try:
                return host(token)
            except Exception as e2:
                exc = e2
        self._fail_batch(tickets, exc)
        return None

    def _loop(self) -> None:
        import logging

        log = logging.getLogger("hypergraphdb_tpu_torch.serve")
        while True:
            try:
                if self._closed and not self._draining:
                    prev = self._take_pending()
                    if prev is not None:
                        self._finalize(*prev)
                    self.queue.cancel_all()
                    return
                worked = self.pump(drain=self._draining)
                if worked:
                    continue  # keep forming batches while the device runs
                # exit only once _closed is set (which happens AFTER
                # admission closed): no submit can land behind our back
                if (self._closed and self._draining
                        and self.queue.depth() == 0
                        and self._pending_empty()):
                    return
                ttf = self.batcher.time_to_flush(self.clock())
                if ttf is None:
                    # empty queue: wait_for_work's non-empty pre-check
                    # makes the submit-before-wait race safe
                    self.queue.wait_for_work(None)
                else:
                    # items queued but linger remaining: sleep the
                    # remainder (a submit filling the bucket wakes us)
                    self.queue.park(ttf)
            except Exception:
                # the per-batch paths already route errors onto tickets;
                # anything landing here is a runtime bug — log it and keep
                # serving rather than stranding every future caller
                log.exception("serve dispatch loop error (continuing)")
                time.sleep(0.01)  # no hot-spin on a persistent fault

    # -- lifecycle -----------------------------------------------------------
    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop admitting and shut down. ``drain=True`` flushes and
        completes everything queued and in flight; ``drain=False``
        completes only the in-flight batch and fails queued tickets with
        RuntimeClosed."""
        with self._close_lock:
            already = self._close_started
            self._close_started = True
            if not already:
                self._draining = drain
        if not already:
            # admission closes BEFORE the thread sees _closed: a submit
            # racing close() either lands while the thread still serves or
            # raises RuntimeClosed — never a silently stranded ticket
            self.queue.close()
            with self._close_lock:
                self._closed = True
        if self._thread is not None:
            self._thread.join(timeout)
            return
        if already:
            return
        # manual mode: run the shutdown inline, deterministically
        prev = self._take_pending()
        if prev is not None:
            self._finalize(*prev)
        if drain:
            while self.step(drain=True):
                pass
        else:
            self.queue.cancel_all()

    def __enter__(self) -> "ServeRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=True)

    def stats_snapshot(self) -> dict:
        out = self.stats.snapshot(queue_depth=self.queue.depth())
        # an injected executor has no plan cache
        aot = getattr(self.executor, "aot", None)
        if aot is not None:
            out["aot"] = aot.stats.as_dict()
        return out
