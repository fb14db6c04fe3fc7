"""Named subgraphs with a membership index.

Re-expression of the reference's ``HGSubgraph`` (``atom/HGSubgraph.java:36``):
a subgraph is itself an atom; membership is tracked in a dedicated storage
index (subgraph handle → member handles) so ``SubgraphMember`` queries are
index lookups, and a subgraph scopes add/remove operations on its graph.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator, Optional

import numpy as np

from hypergraphdb_tpu_torch.core.handles import HGHandle
from hypergraphdb_tpu_torch.utils.ordered_bytes import encode_int

#: storage index: key = encoded subgraph handle, values = member handles
IDX_SUBGRAPH = "hg.subgraph"


def member_key(handle: HGHandle) -> bytes:
    """Index key of a subgraph's member list — the ONE key encoding shared
    by membership ops here and the purge in ``HyperGraph.remove``."""
    return encode_int(int(handle))


@dataclass
class SubgraphValue:
    """The stored value of a subgraph atom."""

    name: str = ""


class HGSubgraph:
    """A view over a graph restricted to an indexed member set."""

    def __init__(self, graph, handle: HGHandle):
        self.graph = graph
        self.handle = int(handle)

    # -- lifecycle -----------------------------------------------------------
    @staticmethod
    def create(graph, name: str = "") -> "HGSubgraph":
        h = graph.add(SubgraphValue(name=name))
        return HGSubgraph(graph, h)

    @staticmethod
    def of(graph, handle: HGHandle) -> "HGSubgraph":
        return HGSubgraph(graph, handle)

    @staticmethod
    def find_by_name(graph, name: str) -> Optional["HGSubgraph"]:
        from hypergraphdb_tpu_torch.query import dsl as hg

        t = graph.typesystem.infer(SubgraphValue())
        h = graph.find_one(hg.and_(hg.type_(t.name), hg.part("name", name)))
        return None if h is None else HGSubgraph(graph, h)

    # -- membership ----------------------------------------------------------
    def _key(self) -> bytes:
        return member_key(self.handle)

    def _index(self):
        return self.graph.store.get_index(IDX_SUBGRAPH)

    def add_member(self, atom: HGHandle) -> None:
        self._index().add_entry(self._key(), int(atom))

    def remove_member(self, atom: HGHandle) -> None:
        self._index().remove_entry(self._key(), int(atom))

    def is_member(self, atom: HGHandle) -> bool:
        return int(atom) in self._index().find(self._key())

    def members(self) -> np.ndarray:
        return self._index().find(self._key()).array()

    def __iter__(self) -> Iterator[int]:
        return iter(self.members().tolist())

    def __len__(self) -> int:
        return len(self.members())

    # -- scoped operations (HGSubgraph.add/remove delegate + auto-member) -----
    def add(self, value: Any = None, **kw) -> HGHandle:
        h = self.graph.add(value, **kw)
        self.add_member(h)
        return h

    def remove(self, atom: HGHandle) -> bool:
        self.remove_member(atom)
        return self.graph.remove(atom)


def member_index_plan(graph, subgraph_handle: HGHandle):
    """Physical plan for ``SubgraphMember``: a direct index lookup."""
    from hypergraphdb_tpu_torch.query.compiler import Plan

    class _MembersPlan(Plan):
        def __init__(self, h: int):
            self.h = int(h)

        def run(self, g):
            return g.store.get_index(IDX_SUBGRAPH).find(member_key(self.h)).array()

        def estimate(self, g):
            return float(g.store.get_index(IDX_SUBGRAPH).count(member_key(self.h)))

        def describe(self):
            return f"subgraph({self.h})"

    return _MembersPlan(subgraph_handle)
