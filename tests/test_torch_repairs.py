"""Two faults of the port held against the reference.

1. ``DictType`` projects: ``part`` and ``part_regex`` conditions over dict
   values, and a ``ByPartIndexer`` over the dict type, find and index what
   the reference finds and indexes (handles, counts and store tables
   compared exactly).
2. A compaction leaves its trace and its flight record: the port's twins
   of ``tests/test_obs_serving.py::test_compaction_trace_and_metrics`` and
   ``::test_compact_trace_exported_when_swap_raises``, plus the
   ``compact.swap`` record with ``highwater`` and ``total_s``."""

import re

import pytest

from test_torch_query import PKGS, mod, new_graph
from test_torch_subgraph_indexing import tables

DICTS = ({"k": 1, "name": "xa"}, {"k": 2, "name": "yb"},
         {"k": 1, "name": "xc", "extra": [1, 2]}, {"name": "z"}, {"k": 1})


def on_both(build):
    out = []
    for pkg in PKGS:
        g = new_graph(pkg)
        out.append(build(pkg, g, mod(pkg, "query.dsl")))
        g.close()
    assert out[1] == out[0]
    return out[1]


@pytest.mark.parametrize("cond", [
    ("part", "k", 1), ("part", "k", 2), ("part", "name", "z"),
    ("part", "missing", 1), ("regex", "name", "^x"),
    ("regex", "name", "b$")])
def test_dict_parts_are_found_as_in_the_reference(cond):
    form, path, v = cond

    def build(pkg, g, hg):
        hs = [g.add(d) for d in DICTS]
        g.add({"k": "1"})
        g.add(7)
        c = hg.part(path, v) if form == "part" else hg.part_regex(path, v)
        return sorted(g.find_all(c)), g.count(c), hs

    got, n, hs = on_both(build)
    want = [h for h, d in zip(hs, DICTS)
            if (d.get(path) == v if form == "part"
                else isinstance(d.get(path), str)
                and re.search(v, d[path]))]
    assert got == want and n == len(want) and want or path == "missing"


def test_dict_type_projects_any_key():
    for pkg in PKGS:
        dt = mod(pkg, "types.primitive").DictType()
        assert dt.dimensions() == []
        assert dt.project({"k": 3}, "k") == 3
        assert dt.project({"k": 3}, "other") is None


def test_by_part_indexer_over_dicts_indexes_what_the_reference_does():
    def build(pkg, g, hg):
        im = mod(pkg, "indexing.manager")
        hs = [g.add(d) for d in DICTS]
        th = g.get_type_handle_of(hs[0])
        im.register(g, im.ByPartIndexer("bypart_k", th, "k"))
        late = g.add({"k": 2, "name": "late"})
        g.replace(hs[1], {"k": 1})
        g.remove(hs[2])
        idx = im.get_index(g, "bypart_k")
        it = g.typesystem.get_type("int")
        return (idx.find(it.to_key(1)).array().tolist(),
                idx.find(it.to_key(2)).array().tolist(),
                sorted(g.find_all(hg.part("k", 1))), tables(g), hs, late)

    ones, twos, found, _, hs, late = on_both(build)
    assert ones == sorted([hs[0], hs[1], hs[4]]) == found
    assert twos == [late]


# ------------------------------------------------------------ compaction


@pytest.fixture
def global_tracing():
    """The port's process tracer, on for one test."""
    from hypergraphdb_tpu_torch import obs

    tracer = obs.tracer()
    tracer.enable()
    tracer.drain()
    try:
        yield tracer
    finally:
        tracer.disable()
        tracer.drain()


@pytest.fixture
def graph():
    from hypergraphdb_tpu_torch.core.graph import HyperGraph

    g = HyperGraph()
    yield g
    g.close()


def test_compaction_trace_and_metrics(graph, global_tracing):
    for i in range(4):
        graph.add(f"c{i}")
    mgr = graph.enable_incremental(device="cpu")
    global_tracing.drain()  # drop the first pack's trace
    a, b = graph.add("x"), graph.add("y")
    graph.add_link([a, b], value="e")
    mgr._compact_sync()
    traces = [t for t in global_tracing.drain() if t.name == "compact"]
    assert traces
    tr = traces[-1]
    names = [s.name for s in tr.spans()]
    assert names == ["compact", "buffer_drain", "device_swap"]
    root = tr.find("compact")
    for s in tr.spans()[1:]:
        assert s.parent_id == root.span_id
        assert root.t0 <= s.t0 <= s.t1 <= root.t1
    assert tr.find("device_swap").attrs["highwater"] == mgr._pack_highwater
    m = graph.metrics
    assert m.counters["compact.passes"] >= 1
    assert m.timings["compact.extract_seconds"][0] >= 1


def test_compact_trace_exported_when_swap_raises(graph, global_tracing,
                                                 monkeypatch):
    mgr = graph.enable_incremental(device="cpu")
    global_tracing.drain()
    monkeypatch.setattr(
        mgr, "_assemble_and_swap",
        lambda ext: (_ for _ in ()).throw(RuntimeError("swap OOM")),
    )
    with pytest.raises(RuntimeError, match="swap OOM"):
        mgr._compact_sync()
    (tr,) = [t for t in global_tracing.drain() if t.name == "compact"]
    assert tr.find("error").attrs == {"error": "RuntimeError"}
    assert tr.find("buffer_drain") is not None
    assert graph.metrics.counters["compact.failures"] == 1


def test_compaction_records_its_swap_in_the_flight_ring():
    """Both packages append one ``compact.swap`` record a pass, with the
    high-water mark the pass packed to."""
    got = []
    for pkg in PKGS:
        fl = mod(pkg, "obs.flight").global_flight()
        g = new_graph(pkg)
        kw = {"device": "cpu"} if pkg.endswith("_torch") else {}
        mgr = g.enable_incremental(**kw)
        a, b = g.add("x"), g.add("y")
        g.add_link([a, b], value="e")
        fl.reset()
        mgr._compact_sync()
        recs = [r for r in fl.records() if r[1] == "compact.swap"]
        g.close()
        assert len(recs) == 1
        fields = recs[-1][2]
        assert fields["total_s"] >= 0
        got.append(fields["highwater"])
    assert got[1] == got[0]
