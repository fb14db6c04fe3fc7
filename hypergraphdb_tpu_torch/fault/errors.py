"""Typed fault vocabulary: what can go wrong, and how callers classify it.

The reference survives faults by TYPING them — activities carry explicit
failure FSM states (``peer/workflow/WorkflowState.java``), storage errors
are transactional aborts, and everything else is a crash the BDB log
replays through. This module is the rebuild's equivalent vocabulary: every
self-healing layer (serve retries, peer redelivery, checkpoint recovery)
keys its decision — retry / degrade / surface / die — off these types
instead of string-matching exception messages.
"""

from __future__ import annotations


class FaultError(Exception):
    """Base of every injected fault (and the natural base for real fault
    types a deployment wants routed through the same classification)."""


class TransientFault(FaultError):
    """Retry-worthy: the operation may succeed if re-attempted (flaky
    device dispatch, dropped packet, momentarily busy resource)."""

    transient = True


class PermanentFault(FaultError):
    """Not retry-worthy: re-attempting burns the caller's deadline for
    nothing (malformed input, missing capability, poisoned state)."""

    transient = False


class InjectedCrash(BaseException):
    """Simulated process death at a registered crash point.

    Deliberately NOT an ``Exception``: the self-healing layers' generic
    ``except Exception`` recovery code must never swallow a *kill* — a
    crash drill's harness catches it at the very top and ``os._exit``\\ s,
    exactly like the reference's AbruptExit test."""


#: exception types classified transient by default (beyond the explicit
#: ``transient`` attribute): timeouts and connection drops are the
#: canonical retry-worthy failures of both the device and the peer planes
DEFAULT_TRANSIENT = (TransientFault, TimeoutError, ConnectionError)


def is_transient(exc: BaseException, extra: tuple = ()) -> bool:
    """Classify an error as transient (retry may help) vs permanent.

    Order matters: an explicit ``transient`` attribute on the exception
    wins (``PermanentFault.transient = False`` beats any isinstance
    check), then the default transient families plus the caller's
    ``extra`` types (``ServeConfig.transient_errors``)."""
    t = getattr(exc, "transient", None)
    if t is not None:
        return bool(t)
    return isinstance(exc, DEFAULT_TRANSIENT + tuple(extra))
