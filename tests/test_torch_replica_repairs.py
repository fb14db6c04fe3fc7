"""Two faults of the reference that the replicated tier exposed, repaired
in the port (``ROADMAP.md`` queue 3).

1. The snapshot manager lost a link whose transaction took its handle
   before a compaction's extraction and committed after it: its added
   event fell under the new high-water mark and was dropped as an echo
   (``ops/incremental.py``), so no served view held the link until the
   next compaction. A resumed replica packs its base while its catch-up
   applies, which is that race. The port drops an event as an echo only
   when the base holds the atom, and keeps such atoms in the memtable at
   a swap.
2. The native engine takes no lock, and ctypes releases the interpreter
   lock for each call: a replica's op-log writer asking the atom map for
   a gid while a transfer page commits could read the engine's tables
   mid-update, miss the gid and mint a second one (a replica whose digest
   never equals its primary's). The port runs one engine call at a time
   on a store.

Tolerance: exact.
"""

from __future__ import annotations

import threading

import pytest

from hypergraphdb_tpu_torch.core.config import HGConfiguration, QueryConfig
from hypergraphdb_tpu_torch.core.graph import HyperGraph
from hypergraphdb_tpu_torch.serve import ServeConfig, ServeRuntime


def cpu_graph(**kw) -> HyperGraph:
    return HyperGraph(HGConfiguration(query=QueryConfig(device="cpu"), **kw))


def late_link(g, a, b):
    """A link added in a transaction held open on a thread: returns the
    thread's state and two events, ``taken`` (its handle exists) and
    ``commit`` (set it to commit)."""
    st = {"taken": threading.Event(), "commit": threading.Event(),
          "done": threading.Event()}

    def writer():
        tx = g.txman.begin()
        st["h"] = int(g.add_link((a, b), value="late"))
        st["taken"].set()
        st["commit"].wait(10)
        g.txman.commit(tx)
        st["done"].set()

    st["thread"] = threading.Thread(target=writer, daemon=True)
    st["thread"].start()
    assert st["taken"].wait(10)
    return st


def served_pair(g, a) -> tuple:
    rt = ServeRuntime(g, ServeConfig(device="cpu", prewarm_aot=False,
                                     max_linger_s=0.001))
    try:
        res = rt.submit_bfs(int(a), max_hops=1).result(timeout=30)
    finally:
        rt.close()
    return int(res.count), sorted(int(m) for m in res.matches)


def test_link_committed_after_the_first_pack_reaches_the_view():
    g = cpu_graph()
    a, b = int(g.add("a")), int(g.add("b"))
    st = late_link(g, a, b)
    mgr = g.enable_incremental(device="cpu", background=False)
    st["commit"].set()
    st["thread"].join(10)
    view = mgr.pinned_view()
    assert st["h"] < mgr._pack_highwater          # under the mark...
    assert int(view.base.type_of[st["h"]]) < 0     # ...and not packed
    assert st["h"] in set(view.new_atoms)
    assert served_pair(g, a) == (2, sorted((a, b)))
    g.close()


def test_link_committed_during_a_compaction_survives_the_swap():
    g = cpu_graph()
    a, b = int(g.add("a")), int(g.add("b"))
    mgr = g.enable_incremental(device="cpu", background=False)
    st = late_link(g, a, b)
    real = mgr._assemble_and_swap

    def assemble(ext):
        # the writer commits between the extraction and the swap
        st["commit"].set()
        assert st["done"].wait(10)
        real(ext)

    mgr._assemble_and_swap = assemble
    mgr._request_compact()
    st["thread"].join(10)
    view = mgr.pinned_view()
    assert st["h"] < mgr._pack_highwater
    assert st["h"] in set(view.new_atoms)
    assert served_pair(g, a) == (2, sorted((a, b)))
    g.close()


@pytest.mark.parametrize("round_", range(3))
def test_native_index_lookups_beside_a_writer_miss_nothing(tmp_path, round_):
    """A reader asking an index by value while a writer commits to it
    finds every entry committed before its lookup began."""
    g = cpu_graph(store_backend="native", location=str(tmp_path / "db"))
    idx = g.store.get_index("test.by_value")
    n = 4000
    committed = []
    stop = threading.Event()
    misses = []

    def writer():
        for h in range(1, n + 1):
            g.txman.transact(
                lambda h=h: idx.add_entry(f"k{h}".encode(), h))
            committed.append(h)
        stop.set()

    def reader():
        i = 0
        while not stop.is_set():
            if committed:
                h = committed[i % len(committed)]
                if f"k{h}".encode() not in idx.find_by_value(h):
                    misses.append(h)
                i += 7
    threads = [threading.Thread(target=writer)] + [
        threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    g.close()
    assert not misses


def test_atoms_removed_before_a_compaction_leave_the_memtable():
    """The swap keeps an unpacked atom under the mark only while the store
    holds it: one added after a pack and removed before the next
    extraction is gone from the new memtable, as in the reference."""
    g = cpu_graph()
    a, b = int(g.add("a")), int(g.add("b"))
    mgr = g.enable_incremental(device="cpu", background=False)
    links = [int(g.add_link((a, b), value=i)) for i in range(6)]
    for h in links[:4]:
        g.remove(h)
    mgr._request_compact()
    view = mgr.pinned_view()
    assert view.new_atoms == [] and not view.dead
    assert served_pair(g, a) == (2, sorted((a, b)))
    g.close()
