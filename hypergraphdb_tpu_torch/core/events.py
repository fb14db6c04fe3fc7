"""Events: synchronous listener dispatch per event class.

A listener registered for a class also sees events of its subclasses, and
a listener returning ``HGListener.CANCEL`` vetoes the operation (the
propose / refuse protocol).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from hypergraphdb_tpu_torch.core.handles import HGHandle


class HGEvent:
    pass


@dataclass
class HGAtomEvent(HGEvent):
    handle: HGHandle
    atom: Any = None


class HGAtomProposeEvent(HGAtomEvent):
    """Fired before an add; a CANCEL veto aborts the add."""


class HGAtomAddedEvent(HGAtomEvent):
    pass


class HGAtomRemoveRequestEvent(HGAtomEvent):
    """Fired before a remove; a CANCEL veto aborts it."""


class HGAtomRemovedEvent(HGAtomEvent):
    pass


class HGAtomReplaceRequestEvent(HGAtomEvent):
    pass


class HGAtomReplacedEvent(HGAtomEvent):
    pass


class HGAtomLoadedEvent(HGAtomEvent):
    pass


@dataclass
class HGOpenedEvent(HGEvent):
    graph: Any = None


@dataclass
class HGClosingEvent(HGEvent):
    graph: Any = None


class HGListener:
    CONTINUE = 0
    CANCEL = 1


Listener = Callable[[Any, HGEvent], int]


class HGEventManager:
    """Listeners keyed by event class; dispatch walks the event's MRO."""

    def __init__(self) -> None:
        self._listeners: dict[type, list[Listener]] = {}

    def add_listener(self, event_class: type, listener: Listener) -> None:
        self._listeners.setdefault(event_class, []).append(listener)

    def remove_listener(self, event_class: type, listener: Listener) -> None:
        ls = self._listeners.get(event_class)
        if ls and listener in ls:
            ls.remove(listener)

    def dispatch(self, graph: Any, event: HGEvent) -> int:
        if not self._listeners:  # the bulk ingest fast path
            return HGListener.CONTINUE
        for cls in type(event).__mro__:
            if not (isinstance(cls, type) and issubclass(cls, HGEvent)):
                continue
            for listener in list(self._listeners.get(cls, ())):
                if listener(graph, event) == HGListener.CANCEL:
                    return HGListener.CANCEL
        return HGListener.CONTINUE

    def has_listeners_for(self, event_class: type) -> bool:
        """Would any listener see an event of this class? Lets hot paths
        skip building per-atom events."""
        if not self._listeners:
            return False
        return any(issubclass(event_class, cls) and self._listeners[cls]
                   for cls in self._listeners)
