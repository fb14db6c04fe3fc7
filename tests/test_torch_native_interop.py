"""Each package reads the other's durable stores.

A store written by one package's native engine, first as a write-ahead
log alone and then after a checkpoint, opens in the other with every
record, payload, index and incidence set equal, at the backend and
through a graph; a partitioned grid's ``partitions.json`` stamped by one
package decides the partition count the other opens it with. Both
directions. Tolerance: exact equality.
"""

import json

import numpy as np
import pytest

from test_torch_storage import PKGS, mod

DIRECTIONS = [PKGS, PKGS[::-1]]


def dump_backend(b) -> dict:
    """Every table a backend holds, as plain Python."""
    ids, offs, flat = b.bulk_links()
    return {
        "links": [ids.tolist(), offs.tolist(), flat.tolist()],
        "records": {h: b.get_link(h) for h in ids.tolist()},
        "data": {h: b.get_data(h) for h in range(b.max_handle())
                 if b.get_data(h) is not None},
        "inc": {h: b.get_incidence_set(h).array().tolist()
                for h in range(b.max_handle())
                if len(b.get_incidence_set(h))},
        "idx": {n: [(k, v.tolist()) for k, v in b.get_index(n).bulk_items()]
                for n in b.index_names()},
        "by_value": {n: {h: b.get_index(n).find_by_value(h)
                         for h in range(0, b.max_handle(), 7)}
                     for n in b.index_names()},
        "max": b.max_handle(),
    }


def write_graph(pkg, loc, checkpoint: bool):
    """A small graph of every primitive kind, links to links, a removal
    and a replace, written through ``pkg``'s graph on the native engine."""
    cfg = mod(pkg, "core.config").HGConfiguration(store_backend="native",
                                                  location=str(loc))
    g = mod(pkg, "core.graph").HyperGraph(cfg)
    r = np.random.default_rng(5)
    hs = [int(g.add(v)) for v in [7, -3, 2**40, 1.5, "alpha", b"raw", True,
                                  None, [1, "two"], {"k": 1}]]
    hs += [int(g.add(f"n{i}")) for i in range(30)]
    for _ in range(40):
        a, b = (int(x) for x in r.choice(hs, size=2, replace=False))
        hs.append(int(g.add_link((a, b), value=int(r.integers(0, 5)))))
    hs.append(int(g.add_link(hs[-3:], value="link of links")))
    g.remove(hs[12])
    g.replace(hs[13], "replaced")
    if checkpoint:
        g.backend.checkpoint()
        g.add("after the checkpoint")
    views = [(h, g.contains(h) and repr(g.get(h))) for h in hs]
    g.close()
    return views


@pytest.mark.parametrize("checkpoint", [False, True],
                         ids=["wal-only", "after-checkpoint"])
@pytest.mark.parametrize("writer,reader", DIRECTIONS,
                         ids=["reference-to-port", "port-to-reference"])
def test_store_written_by_one_opens_in_the_other(tmp_path, writer, reader,
                                                 checkpoint):
    loc = tmp_path / "db"
    views = write_graph(writer, loc, checkpoint)
    dumps = []
    for pkg in (writer, reader):
        b = mod(pkg, "storage.native").NativeStorage(str(loc))
        b.startup()
        dumps.append(dump_backend(b))
        b.shutdown()
    assert dumps[1] == dumps[0]
    assert dumps[0]["records"] and dumps[0]["inc"]
    # and through the reader's graph: the same atoms, the stamp current
    cfg = mod(reader, "core.config").HGConfiguration(store_backend="native",
                                                     location=str(loc))
    g = mod(reader, "core.graph").HyperGraph(cfg)
    assert [(h, g.contains(h) and repr(g.get(h))) for h, _ in views] == views
    assert mod(reader, "maintenance.migration").stored_format_version(g) == 1
    g.close()


@pytest.mark.parametrize("writer,reader", DIRECTIONS,
                         ids=["reference-to-port", "port-to-reference"])
def test_partition_marker_read_by_the_other(tmp_path, writer, reader):
    loc = tmp_path / "grid"

    def grid(pkg, n):
        cfg = mod(pkg, "core.config").HGConfiguration(
            store_backend="partitioned", location=str(loc), n_partitions=n)
        return mod(pkg, "core.graph").HyperGraph(cfg)

    g = grid(writer, 3)
    hs = [int(g.add(f"v{i}")) for i in range(20)]
    links = [int(g.add_link((hs[i], hs[i + 1]))) for i in range(19)]
    g.close()
    assert json.loads((loc / "partitions.json").read_text()) == {
        "schema_version": 1, "n_partitions": 3}
    g2 = grid(reader, 6)
    assert len(g2.backend._parts) == 3
    assert [g2.get(h) for h in hs] == [f"v{i}" for i in range(20)]
    assert [g2.get(h).targets for h in links] == [
        (hs[i], hs[i + 1]) for i in range(19)]
    g2.close()
