"""hgfault — deterministic fault injection and the self-healing vocabulary.

The port's copy of ``hypergraphdb_tpu/fault``, in three parts:

- **errors** (:mod:`~hypergraphdb_tpu_torch.fault.errors`): the typed
  fault vocabulary — :class:`TransientFault` (retry may help),
  :class:`PermanentFault` (it will not), :class:`InjectedCrash` (a
  simulated kill, deliberately a ``BaseException``), and the
  :func:`is_transient` classifier every retry ladder keys off;
- **registry** (:mod:`~hypergraphdb_tpu_torch.fault.registry`): seeded,
  deterministic fault injection at named points with per-point
  probability/count/index schedules. Zero-cost when disabled: one
  attribute read per site, nothing allocated;
- **breaker** (:mod:`~hypergraphdb_tpu_torch.fault.breaker`): a per-key
  circuit breaker (closed → open → half-open probe → closed) the serving
  runtime uses to trip flaky device buckets onto the exact host-fallback
  path and recover automatically.

Wired consumers: ``serve/runtime.py`` (bounded deadline-aware retries +
breaker degradation), ``tx/manager.py`` (the commit crash points) and
``ops/checkpoint.py`` (the crash-atomic saves). The reference's peer
points come with those modules.
"""

from hypergraphdb_tpu_torch.fault.breaker import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    STATE_CODES,
    CircuitBreaker,
)
from hypergraphdb_tpu_torch.fault.errors import (
    DEFAULT_TRANSIENT,
    FaultError,
    InjectedCrash,
    PermanentFault,
    TransientFault,
    is_transient,
)
from hypergraphdb_tpu_torch.fault.registry import FaultRegistry, global_faults

#: every fault point wired into the port (name → where it fires)
WIRED_POINTS = {
    "serve.launch": "DeviceExecutor.launch, before any device work",
    "serve.collect": "DeviceExecutor.collect, before the result download",
    "ckpt.save_npz": "save_snapshot, after the tmp npz is written, "
                     "before os.replace publishes it",
    "ckpt.save_plans": "save_snapshot, after the tmp plans sidecar is "
                       "written, before os.replace publishes it",
    "tx.commit.pre": "HGTransactionManager.commit, top-level write "
                     "commit, before the commit lock",
    "tx.commit.apply": "HGTransactionManager.commit, inside the commit "
                       "lock, after conflict checks, before apply",
}

__all__ = [
    "CLOSED",
    "CircuitBreaker",
    "DEFAULT_TRANSIENT",
    "FaultError",
    "FaultRegistry",
    "HALF_OPEN",
    "InjectedCrash",
    "OPEN",
    "PermanentFault",
    "STATE_CODES",
    "TransientFault",
    "WIRED_POINTS",
    "global_faults",
    "is_transient",
]
