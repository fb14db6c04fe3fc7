"""FIPA-ACL-style message envelopes.

Re-expression of the reference's performative vocabulary and Json envelopes
(``peer/Performative.java``, ``peer/Messages.java:22``): every message
carries a performative, an activity type + id (conversation correlation),
and content. ``reply_to`` builds the response envelope with the same
conversation id (the ``Messages.getReply`` analogue).

**Distributed tracing rides the envelope**: :func:`attach_trace` stamps a
message with the compact hgobs trace context
(``{"tid": trace id, "sid": parent span id, "s": sampled}`` under the
``"trace"`` key — three JSON scalars, transport-agnostic) and
:func:`trace_context` reads it back on the receiving side, tolerant of
messages from peers that predate tracing (absent key → None). The
context's semantics live in ``obs.trace`` (``Trace.context`` /
``Tracer.start_remote_trace``); this module only owns the wire placement.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Optional

#: envelope key carrying the propagated hgobs trace context
TRACE_KEY = "trace"

#: conversation ids: version-4 UUIDs cut from a buffer of OS randomness
#: (hex) refilled every ``_ID_POOL_BYTES // 16`` ids, not one
#: ``os.urandom`` call and one ``uuid.UUID`` a message (``uuid.uuid4``),
#: which was the push worker's largest cost (one message a mutation). A
#: forked child drops the buffer it inherited, so it never repeats its
#: parent's ids
_ID_POOL_BYTES = 8 * 1024
_ids = {"lock": threading.Lock(), "pool": "", "at": 0}
#: the variant nibble (RFC 4122: binary 10xx) from a random hex digit
_VARIANT = "89ab" * 4


def _reset_ids() -> None:
    _ids.update(lock=threading.Lock(), pool="", at=0)


os.register_at_fork(after_in_child=_reset_ids)


def new_id() -> str:
    """A fresh random (version 4) UUID string."""
    with _ids["lock"]:
        at = _ids["at"]
        if at >= len(_ids["pool"]):
            _ids["pool"], at = os.urandom(_ID_POOL_BYTES).hex(), 0
        h = _ids["pool"][at:at + 32]
        _ids["at"] = at + 32
    return (f"{h[:8]}-{h[8:12]}-4{h[13:16]}-{_VARIANT[int(h[16], 16)]}"
            f"{h[17:20]}-{h[20:]}")

# the performative constant pool (Performative.java)
REQUEST = "request"
INFORM = "inform"
QUERY_REF = "query-ref"
PROPOSE = "propose"
ACCEPT_PROPOSAL = "accept-proposal"
REJECT_PROPOSAL = "reject-proposal"
AGREE = "agree"
REFUSE = "refuse"
FAILURE = "failure"
CONFIRM = "confirm"
DISCONFIRM = "disconfirm"
CANCEL = "cancel"
SUBSCRIBE = "subscribe"
NOT_UNDERSTOOD = "not-understood"


def make_message(
    performative: str,
    activity_type: str,
    content: Any = None,
    activity_id: Optional[str] = None,
) -> dict:
    return {
        "performative": performative,
        "activity_type": activity_type,
        "activity_id": activity_id or new_id(),
        "content": content,
    }


def reply_to(msg: dict, performative: str, content: Any = None) -> dict:
    """Response envelope correlated to the same activity/conversation."""
    return {
        "performative": performative,
        "activity_type": msg["activity_type"],
        "activity_id": msg["activity_id"],
        "content": content,
    }


def attach_trace(msg: dict, ctx: Optional[dict]) -> dict:
    """Stamp ``msg`` with a propagated trace context (no-op when ctx is
    falsy — untraced sends carry no extra bytes). Returns ``msg``."""
    if ctx:
        msg[TRACE_KEY] = ctx
    return msg


def trace_context(msg: dict) -> Optional[dict]:
    """The propagated trace context of a received message, or None."""
    ctx = msg.get(TRACE_KEY)
    return ctx if isinstance(ctx, dict) else None
