"""The port's bit-packed push BFS (``ops/bitfrontier.py``) against the
reference's, after ``tests/test_bitfrontier.py``: the bit operations on
the same random bits; ``bfs_packed`` on the same graphs (built the same
way in both packages) and seeds, visited words, edge counts and levels
equal to the reference's, to the port's dense frontier BFS and to its
pull BFS, with an odd K (block padding) and small edge chunks (many
chunks a relation); the isolated seed; ``bfs_memory_bytes`` equal to the
reference's across scales and device counts. The port's words are int32
and compare through ``.numpy().view(np.uint32)``; everything runs on
``device="cpu"`` (plain PyTorch). The reference's sharded case
(``bfs_packed_sharded``) waits for the sharded slice.

Tolerance: exact equality."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypergraphdb_tpu.ops import bitfrontier as ref
from hypergraphdb_tpu_torch.ops import bitfrontier as prt

from conftest import make_random_hypergraph


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def snapshots(build):
    """The same graph built in both packages, packed."""
    import hypergraphdb_tpu as hg
    from hypergraphdb_tpu.ops.snapshot import CSRSnapshot as RefSnap
    from hypergraphdb_tpu_torch.core.graph import HyperGraph
    from hypergraphdb_tpu_torch.ops.snapshot import CSRSnapshot as PortSnap

    rg, pg = hg.HyperGraph(), HyperGraph()
    try:
        out = build(rg), build(pg)
        assert out[0] == out[1]
        rs, ps = RefSnap.pack(rg), PortSnap.pack(pg)
    finally:
        rg.close()
        pg.close()
    np.testing.assert_array_equal(rs.tgt_flat, ps.tgt_flat)
    return rs, ps, out[0]


@pytest.mark.parametrize("shape", [(5, 256), (1, 32), (3, 4, 96)])
def test_pack_unpack_roundtrip(shape):
    bits = np.random.default_rng(0).random(shape) < 0.3
    bits[..., 31] = True                     # bit 31 of the first word
    packed = prt.pack_bits(torch.from_numpy(bits))
    assert packed.dtype == torch.int32
    assert packed.shape == (*shape[:-1], shape[-1] // 32)
    np.testing.assert_array_equal(
        u32(packed), np.asarray(ref.pack_bits(jnp.asarray(bits))))
    np.testing.assert_array_equal(prt.unpack_bits(packed).numpy(), bits)


def test_test_bits_gather():
    r = np.random.default_rng(1)
    bits = r.random(320) < 0.5
    packed = prt.pack_bits(torch.from_numpy(bits[None, :]))
    idx = r.integers(0, 320, size=64).astype(np.int32)
    got = prt.test_bits(packed, torch.from_numpy(idx)).numpy()[0]
    want = np.asarray(ref.test_bits(ref.pack_bits(jnp.asarray(bits[None])),
                                    jnp.asarray(idx)))[0]
    np.testing.assert_array_equal(got, bits[idx])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_valid,w,offset", [(70, 3, 0), (64, 2, 0),
                                              (1000, 4, 900), (5, 1, 32)])
def test_valid_word_mask_clears_tail(n_valid, w, offset):
    m = prt.valid_word_mask(n_valid, w, offset)
    assert m.dtype == np.int32
    np.testing.assert_array_equal(m.view(np.uint32),
                                  ref.valid_word_mask(n_valid, w, offset))
    bits = prt.unpack_bits(torch.from_numpy(m[None, :])).numpy()[0]
    want = offset + np.arange(w * 32) < n_valid
    np.testing.assert_array_equal(bits, want)


def test_popcount_with_bit_31_set():
    """SWAR popcount on int32 words: all ones, bit 31 alone, bit 31 with
    others, random words; against ``np.unpackbits`` and the reference."""
    r = np.random.default_rng(2)
    words = np.concatenate([
        np.array([0xFFFFFFFF, 0x80000000, 0x80000001, 0x7FFFFFFF, 0],
                 dtype=np.uint32),
        r.integers(0, 2**32, size=59, dtype=np.uint64).astype(np.uint32),
    ]).reshape(8, 8)
    got = prt.popcount(torch.from_numpy(words.view(np.int32)))
    want = np.unpackbits(words.view(np.uint8), axis=-1).reshape(
        8, -1).sum(axis=1)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref.popcount(jnp.asarray(words))))
    np.testing.assert_array_equal(
        prt.popcount(torch.from_numpy(words.view(np.int32)), axis=0).numpy(),
        np.asarray(ref.popcount(jnp.asarray(words), axis=0)))


@pytest.mark.parametrize("k,k_block,edge_chunk,hops", [
    (33, 8, 256, 3),        # odd K: block padding; many chunks
    (64, 64, 1 << 19, 2),   # one block, one chunk a relation
    (7, 32, 100, 4),        # a chunk that does not divide the relation
])
def test_packed_bfs_matches_reference_dense_and_pull(k, k_block, edge_chunk,
                                                     hops):
    from hypergraphdb_tpu_torch.ops.ellbfs import bfs_pull
    from hypergraphdb_tpu_torch.ops.frontier import (
        bfs_levels,
        frontier_edge_counts,
    )

    rs, ps, (nodes, _) = snapshots(
        lambda g: make_random_hypergraph(g, n_nodes=200, n_links=600,
                                         seed=7))
    r = np.random.default_rng(7)
    seeds = np.asarray([int(nodes[i]) for i in r.integers(0, 200, size=k)],
                       dtype=np.int32)
    vis, cnt, lev = prt.bfs_packed(ps, seeds, hops, k_block=k_block,
                                   edge_chunk=edge_chunk, with_levels=True,
                                   device="cpu")
    rv, rc, rl = ref.bfs_packed(rs, seeds, hops, k_block=k_block,
                                edge_chunk=edge_chunk, with_levels=True)
    np.testing.assert_array_equal(u32(vis), rv)
    np.testing.assert_array_equal(cnt.numpy(), rc)
    np.testing.assert_array_equal(lev.numpy(), rl)
    assert cnt.dtype == torch.int64 and lev.dtype == torch.int8

    dev = ps.device("cpu")
    lv_d, vis_d = bfs_levels(dev, torch.from_numpy(seeds), hops)
    np.testing.assert_array_equal(
        prt.unpack_visited(vis, ps.num_atoms + 1).numpy(), vis_d.numpy())
    np.testing.assert_array_equal(lev.numpy().astype(np.int32),
                                  lv_d.numpy())
    np.testing.assert_array_equal(
        cnt.numpy(),
        frontier_edge_counts(dev, torch.from_numpy(seeds), hops).numpy())

    pull = bfs_pull(ps, seeds, hops, device="cpu")
    vt = pull.visited_t[: ps.num_atoms + 1]
    lanes = ((vt[:, :, None] >> torch.arange(32, dtype=torch.int32)) & 1)
    lanes = lanes.reshape(vt.shape[0], -1)[:, :k].T.to(torch.bool)
    np.testing.assert_array_equal(
        prt.unpack_visited(vis, ps.num_atoms + 1).numpy(), lanes.numpy())
    np.testing.assert_array_equal(cnt.numpy(), pull.edges_touched)


def test_packed_bfs_on_a_zipf_graph_matches_the_reference():
    """The lexical graph family of bench c2, cut to 800 nodes: 64 seeds,
    2 hops, both packages' generators and BFS."""
    from hypergraphdb_tpu.models import zipf_hypergraph as ref_zipf
    from hypergraphdb_tpu_torch.models import zipf_hypergraph as port_zipf

    def build(g):
        nodes, links = (ref_zipf if type(g).__module__.startswith(
            "hypergraphdb_tpu.") else port_zipf)(g, 800, 400, seed=7)
        return [int(x) for x in nodes], [int(x) for x in links]

    rs, ps, (nodes, _) = snapshots(build)
    seeds = np.random.default_rng(123).choice(
        np.asarray(nodes, np.int32), size=64)
    vis, cnt, _ = prt.bfs_packed(ps, seeds, 2, edge_chunk=1 << 10,
                                 device="cpu")
    rv, rc, _ = ref.bfs_packed(rs, seeds, 2, edge_chunk=1 << 10)
    np.testing.assert_array_equal(u32(vis), rv)
    np.testing.assert_array_equal(cnt.numpy(), rc)


def test_packed_bfs_isolated_seed():
    def build(g):
        h = g.add("loner")
        g.add("other")
        return int(h)

    rs, ps, h = snapshots(build)
    vis, cnt, lev = prt.bfs_packed(ps, np.asarray([h]), 4, device="cpu")
    dense = prt.unpack_visited(vis, ps.num_atoms + 1).numpy()[0]
    assert dense.sum() == 1 and dense[h]
    assert int(cnt[0]) == 0 and lev is None
    rv, rc, _ = ref.bfs_packed(rs, np.asarray([h]), 4)
    np.testing.assert_array_equal(u32(vis), rv)


def test_max_hops_over_127_raises():
    rs, ps, h = snapshots(lambda g: int(g.add("x")))
    with pytest.raises(ValueError, match="127"):
        prt.bfs_packed(ps, np.asarray([h]), 128, device="cpu")


def test_packed_bfs_asks_for_the_card():
    """Without CUDA the default device raises instead of running on the
    CPU."""
    rs, ps, h = snapshots(lambda g: int(g.add("x")))
    if torch.cuda.is_available():
        assert prt.bfs_packed(ps, np.asarray([h]), 1)[0].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            prt.bfs_packed(ps, np.asarray([h]), 1)


@pytest.mark.parametrize("n_atoms,e_inc,e_tgt", [
    (10_000_000, 50_000_000, 50_000_000),   # BASELINE config 4
    (10_000_072, 43_560_565, 48_057_034),
    (120_000, 177_000, 160_000),            # bench c2's scale
    (1, 0, 0),
])
@pytest.mark.parametrize("k_block,n_dev,edge_chunk,with_levels", [
    (256, 1, 1 << 19, False), (256, 4, 1 << 19, False),
    (128, 1, 1 << 17, True), (1024, 8, 1 << 16, True),
])
def test_memory_plan_matches_reference(n_atoms, e_inc, e_tgt, k_block,
                                       n_dev, edge_chunk, with_levels):
    kw = dict(k_block=k_block, n_dev=n_dev, edge_chunk=edge_chunk,
              with_levels=with_levels)
    assert (prt.bfs_memory_bytes(n_atoms, e_inc, e_tgt, **kw)
            == ref.bfs_memory_bytes(n_atoms, e_inc, e_tgt, **kw))


def test_config4_memory_plan():
    """BASELINE config 4's plan (K = 1024 in 256-seed blocks, 10M atoms,
    50M edges a relation) under the same bounds the reference pins."""
    plan = prt.bfs_memory_bytes(n_atoms=10_000_000, e_inc=50_000_000,
                                e_tgt=50_000_000, k_block=256, n_dev=4)
    assert plan["total"] < 6 * 2**30, plan
    plan1 = prt.bfs_memory_bytes(n_atoms=10_000_000, e_inc=50_000_000,
                                 e_tgt=50_000_000, k_block=128, n_dev=1)
    assert plan1["total"] < 8 * 2**30, plan1


def test_exports_match_the_reference_ops_package():
    import hypergraphdb_tpu_torch.ops as ops

    for name in ("bfs_packed", "bfs_memory_bytes", "unpack_visited"):
        assert getattr(ops, name) is getattr(prt, name)
