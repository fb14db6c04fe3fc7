"""The traced window: ``torch.profiler`` over the card, reduced to device
operations, the device's busy time, the top operations and the idle gaps
by what the host was doing. The benchmark's own spans are
``record_function`` ranges named ``hgbench.<step>`` around its calls into
each layer of the program."""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Trace:
    """Device operations ``(name, start_us, end_us)`` in start order, host
    ranges ``(name, start_us, end_us)``, the window's length and the
    device's busy seconds in it (the union of the operations' intervals)."""

    ops: list = field(default_factory=list)
    host: list = field(default_factory=list)
    window_s: float = 0.0
    busy_s: float = 0.0

    def device_ms(self, match) -> float:
        """Device milliseconds of the operations whose name ``match``
        accepts."""
        return sum(e - s for n, s, e in self.ops if match(n)) / 1e3

    def gaps(self) -> list:
        """(start_us, end_us) of the idle stretches between operations."""
        out, end = [], None
        for _, s, e in self.ops:
            if end is not None and s > end:
                out.append((end, s))
            end = e if end is None else max(end, e)
        return out


def union_s(ops) -> float:
    total, end = 0.0, float("-inf")
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e6


class NoTrace:
    """What the runners get with ``--trace 0``: spans cost one call."""

    enabled = False

    def span(self, name: str):
        return _NULL

    @contextmanager
    def window(self, sync):
        yield None


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class Tracer:
    """``torch.profiler`` over the window the runner marks."""

    enabled = True

    def __init__(self):
        self.trace = None

    def span(self, name: str):
        from torch.profiler import record_function

        return record_function(f"hgbench.{name}")

    @contextmanager
    def window(self, sync):
        """Profile the body; ``sync`` waits for the card at both ends."""
        from torch.profiler import ProfilerActivity, profile

        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            yield prof
            sync()
            window_s = time.perf_counter() - t0
        self.trace = reduce_profile(prof, window_s)


def reduce_profile(prof, window_s: float) -> Trace:
    from torch.autograd import DeviceType

    ops, host = [], []
    for e in prof.events():
        rng = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith("hgbench."):  # a range, not an op
                ops.append(rng)
        elif e.device_type == DeviceType.CPU:
            host.append(rng)
    ops.sort(key=lambda o: o[1])
    host.sort(key=lambda o: o[1])
    return Trace(ops=ops, host=host, window_s=window_s, busy_s=union_s(ops))


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the idle
    gaps summed by what the host was doing in each: the innermost
    benchmark span and the innermost host call (of any thread) over the
    gap's middle."""
    by_op: dict = {}
    for n, s, e in tr.ops:
        by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e6
    by_gap: dict = {}
    gaps = sorted(tr.gaps(), key=lambda g: g[0] - g[1])[: 5 * top]
    names = [n for n, _, _ in tr.host]
    hs = np.asarray([s for _, s, _ in tr.host], dtype=np.float64)
    he = np.asarray([e for _, _, e in tr.host], dtype=np.float64)
    ours = np.asarray([n.startswith("hgbench.") for n in names], dtype=bool)
    for s, e in gaps:
        mid = (s + e) / 2
        over = (hs <= mid) & (he >= mid)
        label = []
        # no benchmark span: outside the window's own calls (another
        # thread's work); no host call: the interpreter between calls
        for pick, none in ((over & ours, "-"), (over & ~ours, "python")):
            idx = np.flatnonzero(pick)
            if not len(idx):
                label.append(none)
                continue
            n = names[int(idx[np.argmin(he[idx] - hs[idx])])]
            label.append(n[len("hgbench."):] if n.startswith("hgbench.")
                         else n)
        key = " / ".join(label)
        by_gap[key] = by_gap.get(key, 0.0) + (e - s) / 1e6
    return {
        "device_ops": sorted(([n[:120], v] for n, v in by_op.items()),
                             key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(([n[:120], v] for n, v in by_gap.items()),
                            key=lambda x: -x[1])[:top],
    }
