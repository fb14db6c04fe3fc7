"""Device-timing hooks: dispatch wall-clock + profiler trace sessions.

The port of ``hypergraphdb_tpu/obs/device.py``. CUDA launches are
asynchronous: ``launch`` returns tensors whose kernels are still queued,
and the host only learns how long the card actually ran when something
waits on them. The serving runtime exploits that for pipelining — which
means naive timestamps around ``launch`` measure host assembly, not device
execution. :func:`block_timed` is the one honest measurement available
without a profiler: wait until the batch's work is done and report the
launch→ready wall delta, attributed to the batch's ``device`` span by the
caller. It is OPT-IN (``ServeConfig.device_timing``) because the wait
itself serializes the pipeline's collect side a little earlier than a
plain download would.

**Per-batch attribution via the profiler**: :func:`profile` opens a
``torch.profiler`` session; while one is active (``profiling()``), the
serving executor wraps every kernel dispatch in :func:`annotate` — a
``torch.profiler.record_function`` range carrying the batch kind, bucket
and double-buffer slot — so the profile's device timeline is attributable
per batch. Each ``device`` span likewise carries its ``slot`` (dispatch
sequence mod 2).

Both hooks are clean no-ops off the card: :func:`block_timed` waits on a
CUDA event only when the handles carry one, and a CPU tensor is ready on
return.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Optional

#: True while a profile() session is open — the serving executor gates
#: its per-dispatch annotations on (device_timing or this), so a plain run
#: pays nothing for annotation support
_PROFILING = False


def profiling() -> bool:
    """Whether an ``obs.profile`` session is currently active."""
    return _PROFILING


@contextmanager
def annotate(name: str):
    """A named ``torch.profiler.record_function`` range around a host-side
    dispatch; its kernels show under ``name`` in a profile."""
    import torch

    with torch.profiler.record_function(name):
        yield True


def _events(handles):
    """The CUDA events among ``handles`` (nested tuples, lists and dicts,
    or objects with an ``event`` attribute)."""
    import torch

    if isinstance(handles, torch.cuda.Event):
        return [handles]
    if isinstance(handles, dict):
        handles = list(handles.values())
    if isinstance(handles, (tuple, list)):
        return [e for h in handles for e in _events(h)]
    ev = getattr(handles, "event", None)
    return [] if ev is None else _events(ev)


def block_timed(handles, clock: Callable[[], float]) -> tuple:
    """Wait until ``handles`` are ready; returns ``(handles, t_ready)``.
    ``handles`` carry the CUDA event recorded after their last kernel
    (the serving executor's staged results do); CUDA tensors without one
    wait for the whole current stream, CPU tensors are ready already.
    Against a launch timestamp taken on the same clock, ``t_ready`` gives
    the launch→ready wall delta — the per-dispatch device attribution
    (see ``serve/runtime.py``)."""
    import torch

    events = _events(handles)
    if events:
        for ev in events:
            ev.synchronize()
    elif torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()
    return handles, clock()


@contextmanager
def profile(logdir: Optional[str]):
    """A ``torch.profiler`` session (CPU and, where present, CUDA
    activity) writing a Chrome trace into ``logdir``; a no-op context when
    ``logdir`` is falsy. Sets the :func:`profiling` flag so dispatch sites
    turn their per-batch :func:`annotate` ranges on for the session's
    duration. Yields the profiler (``key_averages()`` reads it after)."""
    global _PROFILING

    if not logdir:
        yield None
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _PROFILING = True
    try:
        yield prof
    finally:
        _PROFILING = False
        prof.stop()
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
