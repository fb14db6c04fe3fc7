"""Join planning: variable elimination orders from cardinality estimates.

The port of the planning half of ``hypergraphdb_tpu/join/planner.py``, on
host numpy as there. A conjunctive pattern becomes a **generalized
hypertree decomposition** — one bag per variable, processed in an
elimination order chosen greedily to minimize the expected binding-table
growth at every step. Acyclic patterns (paths, stars) get the classic
width-1 GHD; cyclic ones (triangles, loops) keep every extra atom as a
membership filter on the step that closes the cycle, the worst-case-optimal
leapfrog discipline: never materialize a binary join larger than the
intersection the full conjunction allows.

Two plan shapes come out:

* **Left-deep** (:class:`JoinPlan`) — one chain binding every variable,
  the default for single-component patterns.
* **Bushy** (:class:`BushyJoinPlan`) — when the pattern's variable-
  variable atom graph falls into ≥2 connected components, each component
  plans as its own chain; the cheapest becomes the SPINE and the rest
  become materialized **bags** joined onto the spine by
  ``ops/join.join_bag_join`` with cross-component distinctness.

The degree split is policy here too: :func:`hub_lane_mask` decides which
request lanes anchor on rows wider than the hub threshold; those run the
chunked dense-frontier chain (``ops/join.join_hub_expand``).

Cardinalities come from snapshot CSR offsets (exact row widths for
constant-anchored atoms) and whole-relation averages and tails for
variable-keyed expansions. The planner decides SEMANTICS only: the order,
each step's expansion source and membership filters. Shapes (expansion
pads, row buckets) are the executor's call at launch time
(``ops/join.execute_join``).

The graph half: the cost model that weighs a device join against the
classic host plan in bytes (:func:`device_cost_bytes`,
:func:`host_cost_bytes`), and :class:`DeviceJoinPlan`, the query
compiler's plan for ``And(CoIncident+, Incident*, [AtomType],
[AtomValue{1,2}])`` built by :func:`try_single_var_join`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from hypergraphdb_tpu_torch.device import DEFAULT_DEVICE
from hypergraphdb_tpu_torch.join.ir import (
    ConjunctivePattern,
    JoinAtom,
    JoinUnsupported,
    PatternSignature,
    extract_pattern,
    pattern_to_conditions,
    split_constants,
)


@dataclass(frozen=True)
class KeyRef:
    """Where a step's key comes from at run time: a bound binding-table
    column (``col``) or a per-request constant slot (``const``)."""

    kind: str   # "col" | "const"
    index: int


@dataclass(frozen=True)
class FilterSpec:
    """One membership filter on a step's candidates. ``rev=False``:
    candidate ∈ row(key) of ``rel``'s CSR; ``rev=True``: key ∈
    row(candidate) (the dual direction — used where the forward row is
    unsorted, e.g. target tuples)."""

    rel: str    # "co" | "inc"
    rev: bool
    key: KeyRef


@dataclass(frozen=True)
class JoinStep:
    """Bind one variable: gather candidate rows from ``source_rel`` keyed
    by ``source_key``, then intersect against every filter (the
    per-variable multiway intersection of the WCO loop)."""

    var: str
    source_rel: str          # "co" | "inc" | "tgt"
    source_key: KeyRef
    filters: tuple = ()
    type_handle: Optional[int] = None
    dedupe: bool = False     # tgt expansions may repeat values
    width_est: float = 1.0   # expected expansion row width (planning)


@dataclass(frozen=True)
class JoinPlan:
    """The compiled decomposition: elimination order + per-variable
    steps. ``order[i]`` binds to binding-table column ``i``."""

    sig: PatternSignature
    order: tuple[str, ...]
    steps: tuple[JoinStep, ...]
    distinct: bool
    n_consts: int
    est_rows: float          # expected bindings per request (planning)

    def describe(self) -> str:
        parts = []
        for s in self.steps:
            key = (f"${s.source_key.index}" if s.source_key.kind == "const"
                   else self.order[s.source_key.index])
            extra = f"+{len(s.filters)}f" if s.filters else ""
            parts.append(f"{s.var}←{s.source_rel}({key}){extra}")
        return "join[" + " ⋈ ".join(parts) + "]"


def _describe_chain(order: tuple, steps) -> str:
    parts = []
    for s in steps:
        key = (f"${s.source_key.index}" if s.source_key.kind == "const"
               else order[s.source_key.index])
        extra = f"+{len(s.filters)}f" if s.filters else ""
        parts.append(f"{s.var}←{s.source_rel}({key}){extra}")
    return " ⋈ ".join(parts)


@dataclass(frozen=True)
class BagJoin:
    """One materialized GHD bag of a bushy plan: a variable-connected
    component planned as its own chain. ``vars`` is the bag's local
    elimination order (its steps' ``col`` KeyRefs index the BAG's own
    binding table); the executor materializes the bag once per batch and
    joins its output onto the spine (``ops/join.join_bag_join``)."""

    vars: tuple[str, ...]
    steps: tuple[JoinStep, ...]
    est_rows: float


@dataclass(frozen=True)
class BushyJoinPlan:
    """A bushy decomposition: the SPINE chain (cheapest component) plus
    one materialized bag per remaining component, folded on in ``bags``
    order. ``order`` concatenates the spine's and each bag's local
    orders — binding-table column ``i`` holds ``order[i]`` after the
    last fold, so downstream consumers (finalize permutations, result
    assembly) read it exactly like a left-deep plan's."""

    sig: PatternSignature
    order: tuple[str, ...]
    spine: tuple[JoinStep, ...]
    bags: tuple[BagJoin, ...]
    distinct: bool
    n_consts: int
    est_rows: float

    @property
    def steps(self) -> tuple:
        """Every step across spine and bags — the flat view cost models
        and dispatch annotations read; executors MUST dispatch on
        ``bags`` instead (the chains have disjoint column spaces)."""
        return self.spine + tuple(
            s for b in self.bags for s in b.steps
        )

    def describe(self) -> str:
        spine = _describe_chain(self.order, self.spine)
        bags = " ⊗ ".join(
            "[" + _describe_chain(b.vars, b.steps) + "]"
            for b in self.bags
        )
        return f"bushy[{spine} ⊗ {bags}]"


# ---------------------------------------------------------------- statistics


class _Stats:
    """Planning cardinalities over one CSRSnapshot's host arrays."""

    def __init__(self, snap):
        self.snap = snap
        n = snap.num_atoms
        live = max(int((snap.type_of[:n] >= 0).sum()), 1)
        ar = snap.arity[:n].astype(np.int64)
        links = max(int((ar > 0).sum()), 1)
        self.avg = {
            # expected row widths per relation for variable-keyed
            # expansions (whole-relation averages)
            "co": float((ar * np.maximum(ar - 1, 0)).sum()) / live,
            "inc": float(snap.n_edges_inc) / live,
            "tgt": float(snap.n_edges_tgt) / links,
        }
        # skew guard: on zipf-shaped graphs the MEAN row width wildly
        # undersells what a variable-keyed expansion will actually
        # gather (one hub neighbour pays the hub's whole row), which
        # made the greedy prefer an "average-cheap" var expansion over
        # an exactly-bounded constant row and truncate on every hub.
        # Cost var-keyed candidates at a high quantile of the POSITIVE
        # widths instead — planning estimate only, shapes still come
        # from the executor.
        inc_w = np.diff(snap.inc_offsets[: n + 1].astype(np.int64))
        inc_p99 = self._q99(inc_w[inc_w > 0])
        avg_arity = float(snap.n_edges_tgt) / links
        self.p99 = {
            # a co row is roughly Σ (arity-1) over the atom's incident
            # links — approximated from the incidence tail × mean arity
            # (building the real neighbour CSR here would cost more
            # than the plan it prices)
            "co": inc_p99 * max(avg_arity - 1.0, 1.0),
            "inc": inc_p99,
            "tgt": self._q99(ar[ar > 0]),
        }

    @staticmethod
    def _q99(widths: np.ndarray) -> float:
        return float(np.percentile(widths, 99)) if len(widths) else 0.0

    def const_width(self, rel: str, handle: int) -> float:
        """EXACT expansion width of a constant-keyed atom (CSR offsets
        diff — the count-first half of the ``_capped_range_estimate``
        policy)."""
        s = self.snap
        if handle < 0 or handle >= s.num_atoms:
            return 0.0
        if rel == "inc":
            return float(s.inc_offsets[handle + 1] - s.inc_offsets[handle])
        if rel == "tgt":
            return float(s.arity[handle])
        # co: each incident link contributes (arity - 1) co-targets —
        # an upper bound (shared neighbours dedupe), cheap and exact
        # enough to order anchors
        row = s.inc_links[s.inc_offsets[handle]: s.inc_offsets[handle + 1]]
        return float(np.maximum(s.arity[row].astype(np.int64) - 1, 0).sum())

    def var_width(self, rel: str) -> float:
        return max(self.avg[rel], self.p99[rel])


# ------------------------------------------------------- direction resolution


def _expansion_of(atom: JoinAtom, new_var: str) -> str:
    """The CSR an expansion of ``new_var`` through ``atom`` gathers
    from. ``inc(x, y)`` (x is a link containing y) expands x from y's
    incidence row and y from x's target tuple; ``tgt`` is its mirror."""
    if atom.rel == "co":
        return "co"
    if atom.rel == "inc":
        return "inc" if atom.var == new_var else "tgt"
    # tgt(x, y): x ∈ targets(y) — expanding x reads y's target tuple,
    # expanding y (a link containing x) reads x's incidence row
    return "tgt" if atom.var == new_var else "inc"


def _filter_of(atom: JoinAtom, new_var: str, key: KeyRef) -> FilterSpec:
    """The membership test of ``atom`` when ``new_var`` is the candidate
    and the other side is bound. Target tuples are NOT sorted, so tests
    that would probe them run through the incidence dual instead
    (``cand ∈ targets(o)`` ≡ ``o ∈ incidence(cand)`` — rev inc)."""
    if atom.rel == "co":
        return FilterSpec("co", False, key)
    if atom.rel == "inc":
        if atom.var == new_var:        # cand is the link: cand ∈ inc(o)
            return FilterSpec("inc", False, key)
        return FilterSpec("inc", True, key)   # cand ∈ tgt(o) ≡ o ∈ inc(cand)
    # tgt(x, y)
    if atom.var == new_var:            # cand ∈ tgt(o) → dual
        return FilterSpec("inc", True, key)
    return FilterSpec("inc", False, key)      # cand is the link


# ---------------------------------------------------------------- planning


def _greedy_chain(stats: "_Stats", pattern: ConjunctivePattern,
                  slot_of: dict, chain_vars, chain_atoms,
                  seed_var: Optional[str] = None) -> tuple:
    """The greedy elimination core over ONE variable-connected subset:
    seed at the narrowest constant-anchored row, then repeatedly bind
    the connected variable whose cheapest expansion grows the binding
    table least; every other atom touching bound variables becomes a
    membership filter (the WCO intersection). ``col`` KeyRefs index the
    CHAIN's own binding table. Returns ``(order, steps, est_rows)``."""

    def key_ref(atom: JoinAtom, bound_idx: dict) -> KeyRef:
        if atom.key_is_var:
            return KeyRef("col", bound_idx[atom.key])
        return KeyRef("const", slot_of[id(atom)])

    bound: list[str] = []
    bound_idx: dict[str, int] = {}
    steps: list[JoinStep] = []
    remaining = list(chain_vars)
    used: set[int] = set()
    est_rows = 1.0
    if seed_var is not None:
        if seed_var not in remaining:
            raise JoinUnsupported(f"seed variable {seed_var!r} is not a "
                                  "pattern variable")
        # placeholder step: execute_join(seeds=...) replaces it with the
        # caller's candidate column and starts from steps[1:]
        steps.append(JoinStep(var=seed_var, source_rel="co",
                              source_key=KeyRef("const", 0)))
        bound_idx[seed_var] = 0
        bound.append(seed_var)
        remaining.remove(seed_var)
    while remaining:
        best = None  # (width, var, atom, source KeyRef)
        for v in remaining:
            for a in chain_atoms:
                if a.var == v and (not a.key_is_var or a.key in bound_idx):
                    ref = key_ref(a, bound_idx)
                    is_const = not a.key_is_var
                    other = a.key
                elif a.key == v and a.var in bound_idx:
                    ref = KeyRef("col", bound_idx[a.var])
                    is_const = False
                    other = a.var
                else:
                    continue
                if not bound and not is_const:
                    continue  # first variable must seed from a constant
                rel = _expansion_of(a, v)
                w = (stats.const_width(rel, int(other)) if is_const
                     else stats.var_width(rel))
                if best is None or w < best[0]:
                    best = (w, v, a, ref)
        if best is None:
            missing = ", ".join(remaining)
            raise JoinUnsupported(
                "pattern variables unreachable from any constant anchor: "
                f"{missing} (every pattern needs at least one constant-"
                "anchored variable, and every variable a path to one)"
            )
        w, v, src, src_ref = best
        used.add(id(src))
        filters = []
        for a in chain_atoms:
            if id(a) in used:
                continue
            if a.var == v and (not a.key_is_var or a.key in bound_idx):
                filters.append(_filter_of(a, v, key_ref(a, bound_idx)))
                used.add(id(a))
            elif a.key == v and a.var in bound_idx:
                # the atom's var side is bound; candidate is the key side
                filters.append(_filter_of(a, v, KeyRef(
                    "col", bound_idx[a.var]
                )))
                used.add(id(a))
        steps.append(JoinStep(
            var=v,
            source_rel=_expansion_of(src, v),
            source_key=src_ref,
            filters=tuple(filters),
            type_handle=pattern.type_of(v),
            dedupe=_expansion_of(src, v) == "tgt",
            width_est=max(w, 1.0),
        ))
        bound_idx[v] = len(bound)
        bound.append(v)
        remaining.remove(v)
        # filters are selective; the width bound alone keeps est_rows an
        # upper bound, which is what bucket sizing wants
        est_rows *= max(w, 1.0)
    unused = [a for a in chain_atoms if id(a) not in used]
    if unused:
        # only reachable in seed mode: an atom whose endpoints are the
        # seed variable and a constant has no step to ride (the caller's
        # seeds must already satisfy it) — refuse rather than drop it
        raise JoinUnsupported(
            f"atoms {[(a.rel, a.var, a.key) for a in unused]} bind only "
            "pre-seeded variables and constants; no executor step can "
            "apply them"
        )
    return tuple(bound), tuple(steps), est_rows


def _var_components(pattern: ConjunctivePattern) -> list:
    """Connected components of the variable-variable atom graph, in
    ``pattern.vars`` order (a variable with no var-var atoms is its own
    singleton) — the bushy decomposition's bag boundaries: components
    share no variables, only constants."""
    parent = {v: v for v in pattern.vars}

    def find(v):
        while parent[v] != v:
            parent[v] = parent[parent[v]]
            v = parent[v]
        return v

    for a in pattern.atoms:
        if a.key_is_var:
            parent[find(a.var)] = find(a.key)
    comps: dict = {}
    for v in pattern.vars:
        comps.setdefault(find(v), []).append(v)
    return list(comps.values())


def plan_join(snap, pattern: ConjunctivePattern,
              sig: Optional[PatternSignature] = None,
              consts: Optional[Sequence[int]] = None,
              seed_var: Optional[str] = None,
              bushy="auto"):
    """Plan ``pattern`` over ``snap``: a left-deep :class:`JoinPlan`
    (one greedy chain — see :func:`_greedy_chain`) or, for patterns
    whose variable-variable graph splits into ≥2 components, a
    :class:`BushyJoinPlan` with the cheapest component as spine and the
    rest as materialized bags. ``bushy="auto"`` (default) goes bushy
    exactly when a non-trivial bag exists (some component has ≥2
    variables — singleton-only splits like a plain star gain nothing
    over the left-deep chain); ``True``/``False`` force the shape.
    Raises :class:`JoinUnsupported` for patterns no step can seed (no
    constant anchor) or reach (disconnected variables).

    ``seed_var`` pre-binds one variable externally (the caller provides
    its candidates — ``ops/join.execute_join``'s ``seeds`` mode, how an
    UNANCHORED pattern like global triangle counting becomes runnable:
    chunk the id space into seeds, sum the counts). Its step is a
    placeholder the executor skips; seed mode is always left-deep."""
    if sig is None or consts is None:
        sig, consts = split_constants(pattern)
    stats = _Stats(snap)
    slot_of: dict[int, int] = {}
    # atom order == slot order (split_constants contract)
    slot = 0
    for a in pattern.atoms:
        if not a.key_is_var:
            slot_of[id(a)] = slot
            slot += 1
    comps = _var_components(pattern)
    use_bushy = (
        seed_var is None and len(comps) >= 2
        and (bushy is True
             or (bushy == "auto" and any(len(c) >= 2 for c in comps)))
    )
    if not use_bushy:
        order, steps, est_rows = _greedy_chain(
            stats, pattern, slot_of, list(pattern.vars),
            list(pattern.atoms), seed_var,
        )
        return JoinPlan(
            sig=sig, order=order, steps=steps,
            distinct=pattern.distinct, n_consts=sig.n_consts,
            est_rows=est_rows,
        )
    planned = []
    for comp in comps:
        comp_set = set(comp)
        atoms_c = [a for a in pattern.atoms
                   if a.var in comp_set
                   or (a.key_is_var and a.key in comp_set)]
        planned.append(_greedy_chain(stats, pattern, slot_of,
                                     list(comp), atoms_c))
    # fold the cheapest chains first: every bag join's output is the
    # running product, so ascending size keeps intermediates minimal
    planned.sort(key=lambda t: t[2])
    spine_order, spine_steps, spine_est = planned[0]
    bags = tuple(
        BagJoin(vars=o, steps=s, est_rows=e) for o, s, e in planned[1:]
    )
    order = spine_order + tuple(v for b in bags for v in b.vars)
    est_rows = spine_est
    for b in bags:
        est_rows *= max(b.est_rows, 1.0)
    return BushyJoinPlan(
        sig=sig, order=order, spine=spine_steps, bags=bags,
        distinct=pattern.distinct, n_consts=sig.n_consts,
        est_rows=est_rows,
    )


# ---------------------------------------------------------- degree split


def hub_lane_mask(snap, steps, consts: np.ndarray, threshold: int,
                  device=DEFAULT_DEVICE) -> np.ndarray:
    """The degree-split policy (plan-level, applied to one batch's
    constant vectors): a lane is a HUB lane when any const-keyed step
    would expand a row wider than ``threshold`` — exactly the lanes the
    tail path's pads cannot hold, which the flat padded executor
    truncates. Hub lanes run the chunked dense-frontier chain instead
    (``ops/join.join_hub_expand``); dedupe (tgt) steps stay on the tail
    kernel and don't qualify a lane. O(steps × K) host arithmetic over
    CSR offsets already resident (``device`` builds the co-incidence CSR
    if a step reads it and no build is cached yet)."""
    from hypergraphdb_tpu_torch.ops.join import _rel_host_offsets

    consts = np.asarray(consts)
    mask = np.zeros(len(consts), dtype=bool)
    if not len(consts):
        return mask
    for s in steps:
        if s.source_key.kind != "const" or s.dedupe:
            continue
        off = _rel_host_offsets(snap, s.source_rel, device)
        keys = np.clip(consts[:, s.source_key.index].astype(np.int64),
                       0, snap.num_atoms)
        mask |= (off[keys + 1].astype(np.int64) - off[keys]) > threshold
    return mask


# ---------------------------------------------------------------- cost model


#: bytes one candidate costs through one expand+filter round. The
#: reference reads it from its committed static budgets
#: (``tools/hgverify/costs.json``): the ``ops.join.join_expand_step``
#: entry's 15,392 bytes accessed over its exemplar's 64 candidate slots
#: (8 rows x 8 pad, ``EXEMPLAR_SLOTS``) = 240.5. Those are byte counts of
#: the reference's compiled program, kept here as a constant so the
#: port's route choices equal the reference's; not a measurement of the
#: card.
PROBE_BYTES = 15_392 / 64


def probe_bytes() -> float:
    """Bytes one candidate costs through one expand+filter round:
    :data:`PROBE_BYTES`, so the port routes as the reference does. The
    port's own cost record (``verify_costs.json``) does not feed it: that
    record counts the aten ops of the CPU route's plain PyTorch, not the
    compiled program the constant was read from, and a CUDA kernel's
    launch is opaque to it."""
    return PROBE_BYTES


def device_cost_bytes(plan) -> float:
    """Expected device bytes for ONE request through ``plan`` — binding
    rows × expansion width × per-probe bytes × (1 + filters), summed
    over steps. Bushy plans charge each chain independently plus the
    product fold (one probe per joined row) — the bushy-vs-left-deep
    saving the shape choice banks on."""
    per_probe = probe_bytes()

    def chain(steps):
        rows = 1.0
        total = 0.0
        for s in steps:
            total += rows * s.width_est * per_probe * (1 + len(s.filters))
            rows *= s.width_est
        return total, rows

    bags = getattr(plan, "bags", None)
    if bags is None:
        return chain(plan.steps)[0]
    total, rows = chain(plan.spine)
    for b in bags:
        bag_total, bag_rows = chain(b.steps)
        total += bag_total + rows * bag_rows * per_probe
        rows *= bag_rows
    return total


#: host bytes one intersection element costs (sorted-merge over int64
#: arrays: read both sides + write; the IntersectPlan unit)
_HOST_BYTES_PER_ELEM = 24.0

#: host bytes one co-incidence PAIR costs to materialize (repeat + sort +
#: dedupe temps in ``ops/join.neighbor_csr``) — charged to the device arm
#: when the snapshot has no co-incidence CSR on the query device yet, so a
#: one-shot query never pays a multi-GB build the host answer would have
#: skipped
_NBR_BUILD_BYTES_PER_PAIR = 32.0


def host_cost_bytes(graph, fallback_plan) -> float:
    """The classic host translation's byte estimate, from the same
    ``estimate()`` chain ``IntersectPlan.run`` orders children with."""
    est = float(fallback_plan.estimate(graph))
    if est == float("inf"):
        return est
    return max(est, 1.0) * _HOST_BYTES_PER_ELEM


# ------------------------------------------------------------- compiler hook


class DeviceJoinPlan:
    """``query/compiler`` plan for a single-variable conjunctive pattern
    (``And(CoIncident+, Incident*, [AtomType], [AtomValue{1,2}])``)
    answered by the multiway-intersection executor on
    ``QueryConfig.device``. Cost-based at run time, the
    ``DeviceValueConjPlan`` discipline: small inputs and device-hostile
    states (stale anchors, pending deletes) take the classic host
    ``fallback``; fresh link ingest is corrected host-side over the
    memtable, exact at any lag. ``value_conds`` push down as rank-window
    filters on the executor's intersection candidates
    (``ops/join.execute_join`` ``value_windows``); shapes the rank
    compare cannot serve exactly decline to the host plan.

    Only :class:`JoinUnsupported` (a pattern or relation the executor does
    not serve) sends a run to the host plan after the cost decision; any
    other failure of the device arm raises."""

    def __init__(self, pattern: ConjunctivePattern, fallback,
                 value_conds=()):
        self.pattern = pattern
        self.fallback = fallback
        self.value_conds = tuple(value_conds)
        sig, consts = split_constants(pattern)
        self.sig = sig
        self.consts = consts

    def _value_window(self, graph):
        """The executor window for ``value_conds`` —
        ``(kind, lo_rank, lo_op, hi_rank, hi_op)`` — or None for no
        conditions; raises ``JoinUnsupported`` for shapes the rank
        compare cannot serve exactly. The kind/rank/exactness rules are
        NOT re-implemented here: the conds fold into bounds and
        ``query/bridge.to_range_request`` (the one owner of those rules)
        derives the window; the executor's compare is exact only for the
        fixed-width kinds."""
        if not self.value_conds:
            return None
        from hypergraphdb_tpu_torch.query.bridge import to_range_request
        from hypergraphdb_tpu_torch.serve.types import Unservable
        from hypergraphdb_tpu_torch.storage.value_index import (
            FIXED_WIDTH_KINDS,
        )

        lo = hi = None
        lo_op, hi_op = "gte", "lte"
        for vc in self.value_conds:
            if vc.op == "eq":
                if lo is not None or hi is not None:
                    raise JoinUnsupported("eq beside another bound")
                lo = hi = vc.value
            elif vc.op in ("gt", "gte"):
                if lo is not None:
                    raise JoinUnsupported("two lower bounds")
                lo, lo_op = vc.value, vc.op
            elif vc.op in ("lt", "lte"):
                if hi is not None:
                    raise JoinUnsupported("two upper bounds")
                hi, hi_op = vc.value, vc.op
            else:
                raise JoinUnsupported(f"value op {vc.op!r}")
        try:
            req = to_range_request(graph, lo, hi, lo_op=lo_op, hi_op=hi_op)
        except Unservable as e:
            raise JoinUnsupported(str(e)) from e
        if req.dim not in FIXED_WIDTH_KINDS:
            # the executor compares one 64-bit rank a value: values of a
            # variable-width kind that share their first 8 bytes tie there
            # (the reference checks only ``req.exact`` and answers such
            # windows wrongly)
            raise JoinUnsupported(
                "variable-width value kind: rank windows tie"
            )
        return (
            req.dim,
            req.lo_rank,
            req.lo_op if lo is not None else None,
            req.hi_rank,
            req.hi_op if hi is not None else None,
        )

    def costs(self, graph, snap, plan, dev) -> tuple[float, float]:
        """(device bytes, host bytes) of one run of ``plan`` over ``snap``
        against the fallback: the device arm also pays the co-incidence
        build when ``snap`` has none on ``dev`` yet."""
        from hypergraphdb_tpu_torch.ops.join import (
            nbr_pair_count,
            neighbor_csr_on,
        )

        dev_cost = device_cost_bytes(plan)
        if not neighbor_csr_on(snap, dev) and any(
            a.rel == "co" for a in self.pattern.atoms
        ):
            # first co-query on this snapshot pays the relation build —
            # a real cost the probe-byte model cannot see
            dev_cost += nbr_pair_count(snap) * _NBR_BUILD_BYTES_PER_PAIR
        return dev_cost, host_cost_bytes(graph, self.fallback)

    def run(self, graph):
        import numpy as np

        from hypergraphdb_tpu_torch.obs import global_tracer
        from hypergraphdb_tpu_torch.ops.join import execute_join
        from hypergraphdb_tpu_torch.query.compiler import query_device

        cfg = graph.config.query
        # planner duality in the cost model's own unit: if the host can
        # answer for less than one ad-hoc dispatch amortizes
        # (device_min_batch rows' worth of host bytes), stay host. Gating
        # on the raw ROW estimate here would demand anchors so wide the
        # executor's default pads could never hold them.
        host_cost = host_cost_bytes(graph, self.fallback)
        if host_cost < cfg.device_min_batch * _HOST_BYTES_PER_ELEM:
            return self.fallback.run(graph)
        mgr = graph.incremental
        if mgr is not None:
            snap, dead, new_atoms, revalued = mgr.read_view()
        else:
            snap = graph.snapshot()
            dead = revalued = frozenset()
            new_atoms = ()
        if any(a >= snap.num_atoms or a < 0 for a in self.consts):
            return self.fallback.run(graph)  # anchors beyond the base
        if dead or revalued:
            # a vanished link may have been a result's only witness; the
            # device result is not correctable without per-result
            # re-verification — the host plan is exact and fresh
            graph.metrics.incr("query.join.host")
            return self.fallback.run(graph)
        dev = query_device(graph)
        tracer = global_tracer()
        try:
            vwin = self._value_window(graph)
            with tracer.span("join.plan"):
                plan = plan_join(snap, self.pattern, self.sig, self.consts)
            dev_cost, _ = self.costs(graph, snap, plan, dev)
            if dev_cost > host_cost:
                graph.metrics.incr("query.join.host")
                return self.fallback.run(graph)
            with tracer.span("join.execute", plan=plan.describe()):
                out = execute_join(
                    snap, plan,
                    np.asarray([self.consts], dtype=np.int32),
                    top_r=0, count_only=False, full=True,
                    # one-shot find_all wants the full set, not an
                    # honest prefix: exact pads and roomy caps (one
                    # lane — the slot budget still bounds peak memory)
                    var_pad_max=True, pad_cap=1 << 18, row_cap=1 << 20,
                    value_windows=(None if vwin is None
                                   else {plan.order[0]: vwin}),
                    device=dev,
                )
                if bool(out.trunc[0].cpu()):
                    # a capped device run is a PREFIX; one-shot find_all
                    # promises the full set — the host plan delivers it
                    graph.metrics.incr("query.join.host")
                    return self.fallback.run(graph)
                rows = out.full_bindings(0)
        except JoinUnsupported:
            graph.metrics.incr("query.join.host")
            return self.fallback.run(graph)
        graph.metrics.incr("query.join.device")
        arr = np.unique(rows[:, 0]).astype(np.int64) if len(rows) \
            else np.empty(0, dtype=np.int64)
        fresh = _memtable_candidates(graph, new_atoms, revalued, dead)
        if fresh:
            cond = _single_var_condition(self.pattern)
            extra = [
                h for h in fresh
                if cond.satisfies(graph, h)
                and all(vc.satisfies(graph, h) for vc in self.value_conds)
            ]
            if extra:
                arr = np.union1d(arr, np.asarray(extra, dtype=np.int64))
        return arr

    def estimate(self, graph):
        ests = []
        for a in self.pattern.atoms:
            if a.key_is_var:
                continue
            n = float(graph.store.incidence_count(int(a.key)))
            ests.append(2.0 * n if a.rel == "co" else n)
        return min(ests) if ests else float("inf")

    def describe(self):
        return f"device-join({self.sig.atoms})"


def _memtable_candidates(graph, new_atoms, revalued, dead) -> list:
    """Atoms a memtable LINK could have pulled into a co-incidence
    result: the new links themselves plus every target of one. New
    nodes alone cannot create adjacency (nothing points at them from
    the base)."""
    out: set[int] = set()
    for h in set(new_atoms) - set(dead):
        try:
            ts = graph.get_targets(h)
        except Exception:  # noqa: BLE001 - removed since the view: no link
            continue
        if ts:
            out.add(int(h))
            out.update(int(t) for t in ts)
    return sorted(out)


def _single_var_condition(pattern: ConjunctivePattern):
    (cond,) = pattern_to_conditions(pattern).values()
    return cond


def try_single_var_join(graph, clauses, fallback, value_conds=()):
    """Build the single-variable pattern for ``translate()``'s
    ``And(CoIncident+, ...)`` hook — None when extraction declines.
    ``value_conds`` (AtomValue clauses the caller split off) ride the
    plan as executor rank-window filters; shapes the window cannot
    serve exactly decline to the fallback at run time."""
    from hypergraphdb_tpu_torch.query import conditions as c

    try:
        # distinct=False: with one variable there are no var-var pairs,
        # and var-vs-const exclusion is already inherent where it is
        # semantically true (CoIncident is irreflexive by construction;
        # Incident(a) legitimately admits a self-targeting a)
        pattern = extract_pattern(
            graph, {"x": c.And(*clauses)}, distinct=False
        )
    except JoinUnsupported:
        return None
    if not any(not a.key_is_var for a in pattern.atoms):
        return None  # no constant anchor: nothing to seed from
    return DeviceJoinPlan(pattern, fallback, value_conds=value_conds)
