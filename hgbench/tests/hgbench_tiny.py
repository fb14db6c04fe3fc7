"""Cells of ``BENCHMARK.json`` cut to a size a CPU test holds, and runs of
them on the CPU (the harness's look for a card skipped)."""

import copy
import time

import torch

from hgbench import spec, trace
from hgbench.run_state import Run


def cell(name: str, **mix):
    c = spec.load_cell(name)
    cfg = copy.deepcopy(c.config)
    if cfg["system"] == "snapshot":
        cfg.update(n_entities=3000, n_links=12000)
    else:
        cfg.update(n_entities=2000, n_links=4000, load_chunk=1500)
        cfg["manager"] = {}
        cfg["serve"]["buckets"] = [64, 256]
    c.config = cfg
    small = {"batch": 64, "k_block": 64, "clients": 128,
             "control_requests": 40000}
    c.mix = dict(c.mix, **{k: v for k, v in small.items() if k in c.mix},
                 **mix)
    return c


def run(c, seed: int = 2**31 + 11, seconds: float = 1.0) -> Run:
    """One run on the CPU; a tiny window's few answers are all kept for
    the check."""
    r = Run(cell=c, seed=seed, seconds=seconds, tracer=trace.NoTrace(),
            dev=torch.device("cpu"), t_start=time.perf_counter())
    runner = c.runner()
    share = getattr(runner, "KEEP_SHARE", None)
    if share is not None:
        runner.KEEP_SHARE = 1.0
    try:
        runner.run(r)
    finally:
        if share is not None:
            runner.KEEP_SHARE = share
    return r
