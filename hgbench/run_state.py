"""One run of one cell, as its runner fills it: set-up time, end-to-end
numbers, counters and spans for the readers, the numbers compared with
their limits, and the card's memory peak."""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field


@dataclass
class Run:
    """One run of one cell, filled by its runner."""

    cell: object
    seed: int
    seconds: float
    tracer: object
    dev: object
    t_start: float
    setup_s: float = 0.0
    e2e: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    spans: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    #: (name, number compared, limit): correct while every number is at
    #: most its limit
    checks: list = field(default_factory=list)
    memory_peak_bytes: int = 0

    def span(self, name: str):
        """Host seconds of a set-up step (``spans[name]``), also a named
        range in the trace."""
        return _Span(self, name)

    def note(self, msg: str) -> None:
        print(f"[hgbench {self.cell.name}] {msg}", file=sys.stderr,
              flush=True)

    def sync(self) -> None:
        import torch

        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def setup_done(self) -> None:
        """The end of set-up: the card idle and the garbage set-up left
        collected, so a full pass of the cyclic collector in the window
        is the window's own work, not the load's."""
        self.sync()
        gc.collect()
        self.setup_s = time.perf_counter() - self.t_start

    def read_peak(self) -> None:
        import torch

        self.sync()
        if self.dev.type == "cuda":
            self.memory_peak_bytes = int(
                torch.cuda.max_memory_allocated(self.dev))

    @property
    def correct(self) -> bool:
        return all(v <= lim for _, v, lim in self.checks)


class _Span:
    def __init__(self, run: Run, name: str):
        self.run, self.name = run, name

    def __enter__(self):
        self.inner = self.run.tracer.span(self.name)
        self.inner.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.run.sync()
        self.run.spans[self.name] = (self.run.spans.get(self.name, 0.0)
                                     + time.perf_counter() - self.t0)
        return self.inner.__exit__(*exc)


def free_device() -> None:
    """Collect the program's freed state and give its card memory back,
    before the reference runs."""
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
