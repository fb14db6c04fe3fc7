"""Wire surface of the subscription tier: payload -> manager calls.

The port of ``hypergraphdb_tpu/sub/wire.py``. The JSON envelopes (all
``"what"``-discriminated):

Requests (``POST /subscribe`` body; ``GET /notifications`` query)::

    {"what": "subscribe", "kind": "pattern", "anchors": [..],
     "type_handle": T?, "window": W?, "deadline_s": D?}
    {"what": "subscribe", "kind": "range", "lo": .., "hi": ..,
     "lo_op": "gte", "hi_op": "lte", "type_handle": T?, "anchor": A?,
     "window": W?, "deadline_s": D?}
    {"what": "subscribe", "kind": "bfs", "seed": S, "max_hops": H?,
     "include_seed": false, "window": W?, "deadline_s": D?}
    {"what": "unsubscribe", "id": "sub-1"}
    {"id": "sub-1", "timeout_s": 5, "max": 32}          # notifications

Responses::

    {"what": "subscribed", "id", "kind", "seq", "window",
     "matches": [..], "digest"}                          # resume base
    {"what": "unsubscribed", "id"}
    {"what": "notifications", "id", "notes": [..], "more": bool}
    {"what": "notification", "id", "seq_from", "seq_to",
     "added": [..], "removed": [..], "digest"}           # one note
    {"what": "resync", "id", "seq", "matches": [..], "digest"}

Contract: a notification's ``added``/``removed`` is EXACTLY the diff of
full evaluations at ``seq_from`` and ``seq_to``; consecutive notes
chain (``seq_from`` equals the previous ``seq_to``); after a ``resync``
the consumer replaces its set wholesale and drops any delta whose
``seq_to`` is <= the resync's ``seq``.

Errors are typed: an unknown or closed subscription and malformed shapes
are :class:`~hypergraphdb_tpu_torch.serve.types.Unservable` (an HTTP front
door's 400), capacity is
:class:`~hypergraphdb_tpu_torch.serve.types.QueueFull` (503).
"""

from __future__ import annotations

from hypergraphdb_tpu_torch.serve.types import Unservable


def subscribe_payload(manager, payload: dict) -> dict:
    """Decode one ``POST /subscribe`` body and run it against the
    manager: ``subscribe`` (the default when ``what`` is omitted) or
    ``unsubscribe``."""
    what = payload.get("what", "subscribe")
    if what == "unsubscribe":
        sid = payload.get("id")
        if not isinstance(sid, str):
            raise Unservable("unsubscribe needs a string 'id'")
        return manager.unsubscribe(sid)
    if what == "subscribe":
        kind = payload.get("kind")
        if not isinstance(kind, str):
            raise Unservable("subscribe needs a string 'kind' "
                             "(pattern | range | bfs)")
        params = {
            "anchors": payload.get("anchors"),
            "type_handle": payload.get("type_handle"),
            "lo": payload.get("lo"), "hi": payload.get("hi"),
            "lo_op": payload.get("lo_op", "gte"),
            "hi_op": payload.get("hi_op", "lte"),
            "anchor": payload.get("anchor"),
            "limit": payload.get("limit"),
            "desc": payload.get("desc"),
            "seed": payload.get("seed"),
            "max_hops": payload.get("max_hops"),
            "include_seed": payload.get("include_seed", False),
        }
        if kind == "pattern" and params["anchors"] is None:
            raise Unservable("pattern subscription needs 'anchors'")
        if kind == "bfs" and params["seed"] is None:
            raise Unservable("bfs subscription needs 'seed'")
        return manager.subscribe(
            kind, params, window=payload.get("window"),
            deadline_s=payload.get("deadline_s"),
        )
    raise Unservable(f"unknown subscribe action {what!r}")


def poll_payload(manager, payload: dict,
                 max_timeout_s: float = 25.0) -> dict:
    """Decode one ``GET /notifications`` request (query parameters as a
    dict) into a long-poll. ``timeout_s`` is clamped below the HTTP
    handler's own socket timeout so a parked poll always answers."""
    sid = payload.get("id")
    if not isinstance(sid, str) or not sid:
        raise Unservable("notifications poll needs a subscription 'id'")
    try:
        timeout = float(payload.get("timeout_s", 0.0) or 0.0)
        max_notes = int(payload.get("max", 32) or 32)
    except (TypeError, ValueError) as e:
        raise Unservable(f"bad poll parameter: {e}") from None
    return manager.poll(sid, max_notes=max_notes,
                        timeout_s=min(max(0.0, timeout), max_timeout_s))
