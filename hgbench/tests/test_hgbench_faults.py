"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell can have (a hop that returns its state
unchanged, half of a batch left out and filled from the other half, an
answer altered where it is produced; one card, so no exchange between
cards), and for the control of each configuration. The harness's look for
a card is skipped: the runners run on the CPU at a tiny size."""

import numpy as np
import pytest
import torch

import hgbench_tiny as tiny
from hgbench import control

BFS = "dbpedia-10m.bfs3-k4096"
SERVED = "serve-600k.bfs2-closed2048"


def hop_unchanged(monkeypatch):
    from hypergraphdb_tpu_torch.ops import fused_bfs, linemask

    def same(old, plan, out=None, mask=None, out_mask=None):
        out = torch.zeros_like(old) if out is None else out
        out.copy_(old)
        if out_mask is not None:
            out_mask.copy_(linemask.line_mask(old))
        return out

    monkeypatch.setattr(fused_bfs, "fused_hop", same)


def bfs_half(monkeypatch):
    from hypergraphdb_tpu_torch.ops import ellbfs

    real = ellbfs.bfs_pull

    def half(snap, seeds, max_hops, **kw):
        h = len(seeds) // 2
        r = real(snap, seeds[:h], max_hops, **dict(kw, k_block=h))
        return ellbfs.PullBFSResult(
            torch.cat([r.visited_t, r.visited_t], dim=1),
            np.concatenate([r.edges_touched, r.edges_touched]),
            torch.cat([r.reach_counts, r.reach_counts]))

    monkeypatch.setattr(ellbfs, "bfs_pull", half)


def bfs_altered(monkeypatch):
    from hypergraphdb_tpu_torch.ops import ellbfs

    real = ellbfs.bfs_pull

    def off_by_one(*a, **kw):
        r = real(*a, **kw)
        return r._replace(edges_touched=r.edges_touched + 1)

    monkeypatch.setattr(ellbfs, "bfs_pull", off_by_one)


def bfs_one_warp(monkeypatch):
    """A fault confined to one warp's 32 lanes: their reach sets gain an
    atom that none of them reached, their counts follow."""
    from hypergraphdb_tpu_torch.ops import ellbfs

    real = ellbfs.bfs_pull

    def warp(snap, *a, **kw):
        r = real(snap, *a, **kw)
        vt = r.visited_t.clone()
        n = snap.num_atoms
        row = int(torch.nonzero(vt[:n, 1] == 0).flatten()[-1])
        vt[row, 1] = -1
        counts = r.reach_counts.clone()
        counts[32:64] = torch.from_numpy(np.asarray(
            [len(x) for x in ellbfs.visited_rows(
                r._replace(visited_t=vt), n, list(range(32, 64)))],
            dtype=np.int32))
        return r._replace(visited_t=vt, reach_counts=counts)

    monkeypatch.setattr(ellbfs, "bfs_pull", warp)


def served_half(monkeypatch):
    from hypergraphdb_tpu_torch.ops import serving

    real = serving.bfs_serve_batch_fused

    def half(plan, seeds, geom, max_hops, top_r, overlay=None):
        # every other lane computed, its answer handed to the next one:
        # half of the batch's requests left out however full it is
        counts, first_r = real(plan, seeds, geom, max_hops, top_r, overlay)
        counts[1::2] = counts[0::2]
        first_r[1::2] = first_r[0::2]
        return counts, first_r

    monkeypatch.setattr(serving, "bfs_serve_batch_fused", half)


def served_altered(monkeypatch):
    from hypergraphdb_tpu_torch.ops import serving

    real = serving.bfs_serve_batch_fused

    def off_by_one(*a, **kw):
        counts, first_r = real(*a, **kw)
        return counts + 1, first_r

    monkeypatch.setattr(serving, "bfs_serve_batch_fused", off_by_one)


@pytest.mark.parametrize("fault", [hop_unchanged, bfs_half, bfs_altered,
                                   bfs_one_warp])
def test_bfs_fault_is_not_correct(monkeypatch, fault):
    c = tiny.cell(BFS)
    assert tiny.run(c).correct
    fault(monkeypatch)
    r = tiny.run(c)
    assert not r.correct, r.checks


@pytest.mark.parametrize("fault", [hop_unchanged, served_half,
                                   served_altered])
def test_served_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r = tiny.run(tiny.cell(SERVED))
    assert not r.correct, r.checks


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 3])
@pytest.mark.parametrize("name", [BFS, SERVED])
def test_control_is_not_correct(name, seed):
    """The control through the runner's own comparison, at a size a test
    holds; edge totals have to pass 2^24 for float32 to round them, so the
    snapshot cell's control runs a graph of 3,500,000 links."""
    c = tiny.cell(name)
    if c.config["system"] == "snapshot":
        c.config.update(n_entities=700_000, n_links=3_500_000)
        c.mix.update(check_sets=4, control_batches=2)
    checks = control.control(c, seed)
    assert any(v > lim for _, v, lim in checks), checks


@pytest.mark.parametrize("name", [BFS, SERVED])
def test_reference_in_the_programs_place_is_correct(name):
    """The comparison a control goes through passes the plain reference
    itself: what fails a control is the guarantee it breaks."""
    from hgbench.reference import bfs as ref_bfs

    c = tiny.cell(name)
    checks = c.runner().control(c, 5, ref_bfs.answer)
    assert checks and all(v <= lim for _, v, lim in checks), checks
