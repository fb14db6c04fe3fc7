"""One run of one cell: find it, check the card, drive it, report.

The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit. The same numbers are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback
from types import SimpleNamespace

from hgbench import spec, trace
from hgbench.run_state import Run

#: top-level module names that no run may load (the JAX package's name is
#: a prefix of the port's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "hypergraphdb_tpu")


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    tops = {m.split(".")[0] for m in names}
    return sorted(t for t in tops if t in FORBIDDEN)


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="hgbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card(chips: int):
    """The first card, or None (and why on standard error) when there are
    fewer cards than the cell asks for."""
    import torch

    if not torch.cuda.is_available():
        print("hgbench: no CUDA device", file=sys.stderr)
        return None
    if torch.cuda.device_count() < chips:
        print(f"hgbench: the cell asks for {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return None
    return torch.device("cuda:0")


def metrics_of(run: Run, cell: spec.Cell, traced: bool) -> dict:
    """The cell's end-to-end metrics, or with tracing its per-layer
    metrics (those whose reader finds something to read)."""
    out = {}
    if not traced:
        for m in cell.end_to_end:
            value = (run.setup_s if m["name"] == "setup_s"
                     else run.e2e.get(m["name"]))
            if value is None:
                raise RuntimeError(f"the runner gave no {m['name']}")
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out
    ctx = SimpleNamespace(cell=cell.name, trace=run.tracer.trace,
                          counters=run.counters, spans=run.spans)
    for m in cell.per_layer:
        value = spec.load_reader(m["name"], cell.here)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result(run: Run, cell: spec.Cell, traced: bool) -> dict:
    import torch

    dev = run.dev
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": run.correct,
           "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics_of(run, cell, traced), "device": device}
    if traced:
        tr = run.tracer.trace
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        out["breakdown"] = trace.breakdown(tr)
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in run.checks}
    return out


def drive(cell: spec.Cell, args, dev, t_start: float) -> dict:
    """One run of ``cell`` on ``dev`` by its mix's runner: the result."""
    run = Run(cell=cell, seed=args.seed, seconds=args.seconds,
              tracer=trace.Tracer() if args.trace else trace.NoTrace(),
              dev=dev, t_start=t_start)
    cell.runner().run(run)
    return result(run, cell, bool(args.trace))


def main(argv, t_start: float) -> int:
    args = parse(argv)
    try:
        cell = spec.load_cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"hgbench: {e}", file=sys.stderr)
        return 2
    dev = card(cell.chips)
    if dev is None:
        return 3
    try:
        out = drive(cell, args, dev, t_start)
    except Exception:
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print(f"hgbench: the run loaded {found}", file=sys.stderr)
        return 4
    for name, v in out["checks"].items():
        print(f"check {name} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
