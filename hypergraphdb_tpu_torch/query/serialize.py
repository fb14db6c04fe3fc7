"""Condition ↔ JSON round-trip for remote queries and interest predicates.

The analogue of the reference's query/atom JSON serialization used by the
p2p layer (``peer/serializer/HGPeerJsonFactory.java``, exercised by
``p2p/test/java/hgtest/p2p/QueryToJsonTests``): a peer ships a query
condition to another peer, which compiles and executes it locally
(``peer/cact/RemoteQueryExecution.java:34``).

Conditions are frozen dataclasses, so the codec is generic: class name +
field dict, recursing into nested conditions and condition tuples. ``bytes``
fields travel base64. ``Predicate`` (an arbitrary Python callable) is
explicitly NOT serializable — remote peers must never execute foreign code.
"""

from __future__ import annotations

import base64
import dataclasses
from typing import Any

from hypergraphdb_tpu_torch.core.errors import QueryError
from hypergraphdb_tpu_torch.query import conditions as c

#: serializable condition classes, by name (the remote-queryable vocabulary)
VOCABULARY: dict[str, type] = {
    cls.__name__: cls
    for cls in vars(c).values()
    if isinstance(cls, type)
    and issubclass(cls, c.HGQueryCondition)
    and cls is not c.HGQueryCondition
    and dataclasses.is_dataclass(cls)
    and cls.__name__ != "Predicate"
}


def to_json(cond: c.HGQueryCondition) -> dict:
    cls = type(cond)
    if cls.__name__ not in VOCABULARY:
        raise QueryError(
            f"condition {cls.__name__} is not remotely serializable"
        )
    out: dict[str, Any] = {"c": cls.__name__}
    for f in dataclasses.fields(cond):
        out[f.name] = _enc(getattr(cond, f.name))
    return out


def from_json(obj: dict) -> c.HGQueryCondition:
    name = obj.get("c")
    cls = VOCABULARY.get(name)
    if cls is None:
        raise QueryError(f"unknown condition class {name!r}")
    kwargs = {k: _dec(v) for k, v in obj.items() if k != "c"}
    # variadic constructors (the JAX package's codec omits Link and
    # OrderedLink here, so it cannot read back what it writes for them)
    if name in ("And", "Or"):
        return cls(*kwargs["clauses"])
    if name in ("Link", "OrderedLink"):
        return cls(*kwargs["targets"])
    return cls(**kwargs)


def _enc(v: Any) -> Any:
    if isinstance(v, c.HGQueryCondition):
        return to_json(v)
    if isinstance(v, tuple):
        return {"t": [_enc(x) for x in v]}
    if isinstance(v, bytes):
        return {"b64": base64.b64encode(v).decode("ascii")}
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise QueryError(f"value {v!r} is not remotely serializable")


def _dec(v: Any) -> Any:
    if isinstance(v, dict):
        if "c" in v:
            return from_json(v)
        if "t" in v:
            return tuple(_dec(x) for x in v["t"])
        if "b64" in v:
            return base64.b64decode(v["b64"])
    return v
