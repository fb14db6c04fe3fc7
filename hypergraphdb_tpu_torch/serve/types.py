"""Serving errors: the port's copy of the error base classes of
``hypergraphdb_tpu/serve/types.py``. The requests, results, tickets and
the other errors of that module come with the port of the runtime."""

from __future__ import annotations


class ServeError(Exception):
    """Base class of every serving-runtime error."""


class Unservable(ServeError):
    """The condition/request is outside the batchable subset — run it
    through ``graph.find_all`` instead."""
