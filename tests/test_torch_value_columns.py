"""Port value columns vs the reference: a valued reference graph packed by
the reference and carried over by ``from_reference_arrays``, the device
rank words mapped back to the reference's ``(hi, lo)`` uint32 pair,
``setops.value_columns``, ``from_tables``'s ambiguity rule and the
generator's ``value_rank``. Tolerance: exact equality (integer words)."""

import dataclasses

import numpy as np
import pytest
import torch

from hypergraphdb_tpu import HyperGraph
from hypergraphdb_tpu.models.generators import dbpedia_snapshot as jax_dbpedia
from hypergraphdb_tpu.ops import setops as rs
from hypergraphdb_tpu.ops.snapshot import CSRSnapshot as JaxSnapshot
from hypergraphdb_tpu.ops.snapshot import DeviceSnapshot as JaxDevice
from hypergraphdb_tpu_torch.models import dbpedia_snapshot
from hypergraphdb_tpu_torch.ops import setops as ps
from hypergraphdb_tpu_torch.ops.snapshot import (
    CSRSnapshot,
    DeviceSnapshot,
    rank_word,
    rank_words,
    reference_words,
)
from tests.test_torch_snapshot import FIELDS, assert_same_topology, to_port

#: node values of the valued graph: ints, floats, bools, strings sharing an
#: 8-byte prefix (rank ties), a string over 16 bytes and one with a NUL
#: (ambiguous keys), and None
VALUES = (5, -3, 0, 2**40, 2.5, -0.75, True, False, "prefix__a",
          "prefix__b", "prefix__", "apple", "a" * 20, "x\x00y", None)


def valued_graph():
    """A reference graph over :data:`VALUES`, int-valued links among the
    nodes, a link without a value and a removed atom."""
    g = HyperGraph()
    nodes = [int(g.add(v)) for v in VALUES]
    rng = np.random.default_rng(17)
    for i in range(30):
        a, b = rng.choice(len(nodes), size=2, replace=False)
        g.add_link((nodes[a], nodes[b]), value=int(rng.integers(-20, 20)))
    g.add_link((nodes[0], nodes[8]))
    g.remove(nodes[4])
    return g


def assert_words(port_words, ref_hi, ref_lo):
    hi, lo = reference_words(port_words)
    assert np.array_equal(hi, np.asarray(ref_hi))
    assert np.array_equal(lo, np.asarray(ref_lo))


@pytest.fixture
def valued():
    g = valued_graph()
    snap = g.snapshot()
    yield snap, to_port(snap)
    g.close()


def test_valued_graph_carries_over(valued):
    ref, port = valued
    assert_same_topology(ref, port)
    kinds = set(port.value_kind[: port.num_atoms].tolist())
    assert {ord(k) for k in "ifbs"} <= kinds
    assert port.value_ambig.any() and (port.type_of == -1).any()


def test_device_words_map_back_to_reference(valued):
    ref, port = valued
    dev = port.device("cpu")
    assert dev.value_rank.dtype == torch.int64
    assert dev.value_kind.dtype == torch.uint8
    assert_words(dev.value_rank.numpy(), ref.device.value_rank_hi,
                 ref.device.value_rank_lo)
    assert np.array_equal(dev.value_kind.numpy(),
                          np.asarray(ref.device.value_kind))


def test_device_kind_zeros_when_host_column_is_short(valued):
    ref, port = valued
    ref_short = dataclasses.replace(ref, value_kind=np.empty(0, np.uint8))
    port_short = dataclasses.replace(port, value_kind=np.empty(0, np.uint8))
    want = np.asarray(JaxDevice.from_host(ref_short).value_kind)
    got = DeviceSnapshot.from_host(port_short, "cpu").value_kind.numpy()
    assert not want.any() and np.array_equal(got, want)


def test_value_columns_match_reference(valued):
    ref, port = valued
    want = np.asarray(rs.value_columns(ref))
    got = ps.value_columns(port, "cpu")
    assert got.shape == (port.num_atoms + 1, 2) and got.dtype == torch.int64
    assert ps.value_columns(port, "cpu") is got
    assert_words(got[:, 0].numpy(), want[:, 0], want[:, 1])
    assert np.array_equal(got[:, 1].numpy(), want[:, 2].astype(np.int64))
    assert not want[:, 3].any()


@pytest.mark.parametrize("given", [
    ("value_rank",), ("value_rank", "value_kind"),
    ("value_rank", "value_kind", "value_rank2"),
    ("value_rank", "value_kind", "value_rank2", "value_ambig"),
    ("value_rank", "value_kind", "value_ambig"),
])
def test_from_tables_value_columns_and_ambiguity_rule(given):
    r = np.random.default_rng(8)
    n_nodes, n_links = 60, 40
    N = n_nodes + n_links
    type_of = r.integers(0, 3, size=N).astype(np.int32)
    is_link = np.zeros(N, dtype=bool)
    is_link[n_nodes:] = True
    offsets = np.zeros(N + 1, dtype=np.int64)
    offsets[n_nodes + 1:] = np.cumsum(r.integers(1, 4, size=n_links))
    flat = r.integers(0, N, size=int(offsets[-1]))
    cols = {
        "value_rank": r.integers(0, 2**63, size=N, dtype=np.uint64) * 2 + 1,
        "value_kind": r.choice(np.frombuffer(b"\x00ifbs", np.uint8), size=N),
        "value_rank2": r.integers(0, 2**63, size=N, dtype=np.uint64),
        "value_ambig": r.random(N) < 0.3,
    }
    kw = {k: cols[k] for k in given}
    ref = JaxSnapshot.from_tables(type_of, is_link, offsets, flat, **kw)
    port = CSRSnapshot.from_tables(type_of, is_link, offsets, flat, **kw)
    assert_same_topology(ref, port)
    if given == ("value_rank", "value_kind"):
        s = port.value_kind[:N] == ord("s")
        assert np.array_equal(port.value_ambig[:N], s)


def test_from_reference_arrays_checks_value_columns(valued):
    ref, _ = valued
    d = {k: getattr(ref, k) for k in FIELDS}
    empty = dict(d, value_rank2=np.empty(0, np.uint64),
                 value_ambig=np.empty(0, bool))
    assert len(CSRSnapshot.from_reference_arrays(empty).value_rank2) == 0
    with pytest.raises(ValueError, match="value_rank"):
        CSRSnapshot.from_reference_arrays(
            dict(d, value_rank=d["value_rank"][1:]))
    with pytest.raises(ValueError, match="value_kind"):
        CSRSnapshot.from_reference_arrays(
            dict(d, value_kind=d["value_kind"][1:]))


def test_generator_value_rank_matches_reference():
    ref, ref_info = jax_dbpedia(n_entities=400, n_links=1500, seed=9)
    port, info = dbpedia_snapshot(n_entities=400, n_links=1500, seed=9)
    assert info == ref_info
    assert port.value_rank.dtype == np.uint64
    assert np.array_equal(port.value_rank, ref.value_rank)
    e0, l0 = info["entities"]
    assert np.array_equal(port.value_rank[e0:l0], np.arange(l0 - e0))
    assert_same_topology(ref, port)
    assert_words(port.device("cpu").value_rank.numpy(),
                 ref.device.value_rank_hi, ref.device.value_rank_lo)


def test_rank_words_keep_the_unsigned_order():
    r = np.random.default_rng(3)
    ranks = np.concatenate([
        r.integers(0, 2**64 - 1, size=500, dtype=np.uint64, endpoint=True),
        np.asarray([0, 1, 2**63 - 1, 2**63, 2**64 - 1], np.uint64)])
    words = rank_words(ranks)
    assert words.dtype == np.int64
    assert np.array_equal(np.argsort(words, kind="stable"),
                          np.argsort(ranks, kind="stable"))
    hi, lo = reference_words(words)
    back = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    assert np.array_equal(back, ranks)
    assert [rank_word(int(x)) for x in ranks[-5:]] == words[-5:].tolist()
    for bad in (-1, 2**64):
        with pytest.raises(ValueError):
            rank_word(bad)
