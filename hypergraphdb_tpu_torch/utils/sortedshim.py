"""Pure-Python stand-ins for the ``sortedcontainers`` API the memory store
uses: ``SortedList.add/remove/__contains__/__iter__/__len__`` and
``SortedDict.get/__getitem__/__setitem__/__delitem__/pop/irange/__iter__``.

The memory store takes these unless ``sortedcontainers`` imports, so it
runs where that package is missing. Inserts are O(n) (``list.insert``)
against O(sqrt n); the hot reads come from cached numpy arrays.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right, insort
from typing import Any, Iterator, Optional


class SortedList:
    """Sorted sequence: O(log n) membership, O(n) insert and remove."""

    __slots__ = ("_items",)

    def __init__(self, iterable=()):
        self._items = sorted(iterable)

    def add(self, value) -> None:
        insort(self._items, value)

    def remove(self, value) -> None:
        i = bisect_left(self._items, value)
        if i == len(self._items) or self._items[i] != value:
            raise ValueError(f"{value!r} not in list")
        del self._items[i]

    def discard(self, value) -> None:
        """:meth:`remove` without the error for an absent value."""
        i = bisect_left(self._items, value)
        if i < len(self._items) and self._items[i] == value:
            del self._items[i]

    def __contains__(self, value) -> bool:
        i = bisect_left(self._items, value)
        return i < len(self._items) and self._items[i] == value

    def __iter__(self) -> Iterator:
        return iter(self._items)

    def __len__(self) -> int:
        return len(self._items)


class SortedDict:
    """A dict iterated in key order, with ``irange`` scans from a key. The
    key list grows by insertion and is re-sorted lazily after deletions."""

    __slots__ = ("_data", "_keys", "_dirty")

    def __init__(self, *args, **kwargs):
        self._data = dict(*args, **kwargs)
        self._keys = sorted(self._data)
        self._dirty = False

    def _klist(self) -> list:
        if self._dirty:
            self._keys = sorted(self._data)
            self._dirty = False
        return self._keys

    def __getitem__(self, key):
        return self._data[key]

    def __setitem__(self, key, value) -> None:
        if key not in self._data and not self._dirty:
            insort(self._keys, key)
        self._data[key] = value

    def __delitem__(self, key) -> None:
        del self._data[key]
        self._dirty = True

    def __contains__(self, key) -> bool:
        return key in self._data

    def __len__(self) -> int:
        return len(self._data)

    def __iter__(self) -> Iterator:
        return iter(self._klist())

    def get(self, key, default=None):
        return self._data.get(key, default)

    def pop(self, key, *default):
        if key in self._data:
            self._dirty = True
        return self._data.pop(key, *default)

    def setdefault(self, key, default=None):
        if key not in self._data:
            self[key] = default
        return self._data[key]

    def keys(self) -> list:
        return list(self._klist())

    def values(self) -> list:
        return [self._data[k] for k in self._klist()]

    def items(self) -> list:
        return [(k, self._data[k]) for k in self._klist()]

    def irange(self, minimum: Optional[Any] = None,
               maximum: Optional[Any] = None,
               inclusive: tuple[bool, bool] = (True, True),
               reverse: bool = False) -> Iterator:
        """Keys between ``minimum`` and ``maximum`` (None: unbounded), in
        order, descending with ``reverse``; ``inclusive`` says whether each
        bound is in the range."""
        keys = self._klist()
        if minimum is None:
            start = 0
        elif inclusive[0]:
            start = bisect_left(keys, minimum)
        else:
            start = bisect_right(keys, minimum)
        if maximum is None:
            end = len(keys)
        elif inclusive[1]:
            end = bisect_right(keys, maximum)
        else:
            end = bisect_left(keys, maximum)
        sel = keys[start:end]
        return reversed(sel) if reverse else iter(sel)
