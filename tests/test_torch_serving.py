"""Served BFS: the port's ``bfs_serve_batch_fused`` / ``serve_bfs`` against
the reference ``bfs_serve_batch_fused(..., interpret=True)`` across the serve
buckets, pad lanes included. Tolerance: exact equality of counts and
``first_r`` windows."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from hypergraphdb_tpu.ops import pallas_bfs as ref_fused
from hypergraphdb_tpu.ops.serving import bfs_serve_batch_fused as ref_serve
from hypergraphdb_tpu_torch.ops import fused_bfs
from hypergraphdb_tpu_torch.ops.serving import (
    BUCKETS,
    bfs_serve_batch_fused,
    serve_bfs,
)
from tests.test_ellbfs import random_snapshot
from tests.test_torch_snapshot import to_port


def _reference(snap, seeds, hops, top_r):
    kw = ref_fused.serve_fused_kwargs(snap, None, len(seeds))
    counts, first_r = ref_serve(
        kw["fused"], jnp.asarray(seeds), kw["n_atoms"], geom=kw["geom"],
        kwp=kw["kwp"], max_hops=hops, top_r=top_r, interpret=True)
    return np.asarray(counts), np.asarray(first_r)


@pytest.fixture(scope="module")
def snaps():
    ref = random_snapshot(90, 180, 4, seed=8, zipf=True)
    return ref, to_port(ref)


@pytest.mark.parametrize("bucket", [64, 256])
def test_serve_batch_matches_reference_with_pad_lanes(snaps, bucket):
    ref_snap, port = snaps
    n = port.num_atoms
    seeds = np.full(bucket, n, np.int32)
    live = min(bucket - 3, 50)
    seeds[:live] = np.random.default_rng(5).integers(0, 90, size=live)
    top_r = 9
    c_ref, f_ref = _reference(ref_snap, seeds, 2, top_r)
    plan, geom = fused_bfs.device_fused_plan(port, "cpu")
    counts, first_r = bfs_serve_batch_fused(plan, torch.from_numpy(seeds),
                                            geom, 2, top_r)
    assert np.array_equal(counts.numpy(), c_ref)
    assert np.array_equal(first_r.numpy(), f_ref)
    assert (c_ref[:live] > top_r).any()  # truncated prefixes exercised
    assert (counts.numpy()[live:] == 1).all()  # pad lanes keep the dummy bit


@pytest.mark.parametrize("n_req", [5, 64, 65, 300])
def test_serve_bfs_pads_to_bucket(snaps, n_req):
    ref_snap, port = snaps
    seeds = np.random.default_rng(n_req).integers(0, 90, size=n_req).astype(
        np.int32)
    bucket = next(b for b in BUCKETS if b >= n_req)
    padded = np.full(bucket, port.num_atoms, np.int32)
    padded[:n_req] = seeds
    c_ref, f_ref = _reference(ref_snap, padded, 3, 16)
    counts, first_r = serve_bfs(port, seeds, 3, 16, device="cpu")
    assert counts.shape == (n_req,) and first_r.shape == (n_req, 16)
    assert np.array_equal(counts, c_ref[:n_req])
    assert np.array_equal(first_r, f_ref[:n_req])


def test_serve_bfs_rejects_oversized_batch(snaps):
    _, port = snaps
    with pytest.raises(ValueError, match="bucket"):
        serve_bfs(port, np.zeros(BUCKETS[-1] + 1, np.int32), 1, 4, device="cpu")


def test_first_r_top_r_beyond_row_block():
    """``top_r`` wider than one streamed row block still yields the global
    prefix, and rows at or past ``n1`` are masked."""
    R, K, top_r, n1 = 8200, 32, 4100, 8000
    r = np.random.default_rng(2)
    vis = np.zeros((R, 1), np.int32)
    rows0 = np.unique(r.integers(0, n1, size=7000))
    vis[rows0, 0] |= 1
    vis[[5, 4097, 8100], 0] |= 2
    want = np.asarray(ref_fused.first_r_from_bitmap(
        jnp.asarray(vis.view(np.uint32)), jnp.int32(n1), top_r, K))
    got = fused_bfs.first_r_from_bitmap(torch.from_numpy(vis), n1, top_r, K)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy()[0], rows0[:top_r])
