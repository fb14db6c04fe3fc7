"""Incremental snapshots: the port's dense base ∪ delta BFS
(``expand_frontier_delta``, ``bfs_levels_delta``) against the reference's on
the same base and delta, carried across with ``delta_from_reference``; and
``DeltaMemtable`` against a reference ``SnapshotManager`` fed the same link
records and removals: padded arrays, dead bits, bucket, upload counters,
drift rule, out-of-capacity records. Tolerance: exact equality."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from hypergraphdb_tpu import HyperGraph
from hypergraphdb_tpu.core import events as ev
from hypergraphdb_tpu.ops import incremental as ref_inc
from chip_smoke import split_snapshot
from hypergraphdb_tpu_torch.ops import incremental as inc
from tests.conftest import make_random_hypergraph
from tests.test_torch_snapshot import to_port

FIELDS = inc.COLUMNS + ("dead",)


class Recorder:
    """A reference graph under incremental mode with every link record
    (handle, targets) and removal captured in commit order, so the port's
    memtable can be fed exactly what the manager saw."""

    def __init__(self, n_nodes=60, n_links=90, seed=3, build=None,
                 **mgr_kw):
        self.g = HyperGraph()
        if build is None:
            self.nodes, self.links = make_random_hypergraph(
                self.g, n_nodes=n_nodes, n_links=n_links, seed=seed)
        else:
            self.nodes, self.links = build(self.g)
        mgr_kw.setdefault("background", False)
        mgr_kw.setdefault("compact_ratio", 50.0)
        self.mgr = self.g.enable_incremental(**mgr_kw)
        self.events = []
        self.g.events.add_listener(ev.HGAtomRemovedEvent, self._removed)

    def _removed(self, g, event):
        self.events.append(("remove", int(event.handle)))

    def add_link(self, targets, value):
        h = int(self.g.add_link([int(t) for t in targets], value=value))
        self.events.append(("add", h, self.g.store.get_link(h)[3:]))
        return h

    def remove(self, h):
        self.g.remove(int(h))

    def feed(self, mt, start=0):
        """Replay events[start:] into the port memtable; returns the end."""
        for e in self.events[start:]:
            if e[0] == "add":
                mt.add_link(e[1], e[2])
            else:
                mt.remove(e[1])
        return len(self.events)

    def memtable(self, **kw):
        return inc.DeltaMemtable(self.mgr.base.num_atoms,
                                 bucket_min=self.mgr.delta_bucket_min,
                                 device="cpu", **kw)

    def close(self):
        self.mgr.close()
        self.g.close()


def ref_arrays(delta) -> dict:
    return {k: np.asarray(getattr(delta, k)) for k in FIELDS}


def assert_same_delta(port_delta, ref_delta):
    for k in FIELDS:
        assert np.array_equal(getattr(port_delta, k).numpy(),
                              np.asarray(getattr(ref_delta, k))), k


def grown(seed=3, n_delta=25, dead=True):
    """A recorder whose memtable holds ``n_delta`` new links bridging the
    node halves and, with ``dead``, tombstones on a base link, a node (the
    graph cascades its links) and a delta link."""
    rec = Recorder(seed=seed)
    r = np.random.default_rng(seed)
    half = len(rec.nodes) // 2
    new = [rec.add_link([rec.nodes[int(r.integers(0, half))],
                         rec.nodes[int(r.integers(half, 2 * half))]], f"d{i}")
           for i in range(n_delta)]
    if dead:
        rec.remove(rec.links[3])
        rec.remove(rec.nodes[5])
        rec.remove(new[2])
    return rec, new


@pytest.fixture(scope="module")
def pair():
    rec, new = grown()
    dev, delta = rec.mgr.device()
    port = to_port(rec.mgr.base)
    yield rec, dev, delta, port, inc.delta_from_reference(ref_arrays(delta),
                                                          "cpu")
    rec.close()


def _seeds(rec, n_atoms):
    """40 live node seeds, the tombstoned node among them, and 24 pad lanes
    at the dummy row."""
    seeds = np.full(64, n_atoms, np.int32)
    seeds[:40] = [int(rec.nodes[i]) for i in range(40)]
    seeds[1] = int(rec.nodes[5])  # dead seed
    return seeds


# ------------------------------------------------------------- dense sweep


@pytest.mark.parametrize("lane_block", [8, 256])
@pytest.mark.parametrize("hops", [1, 3])
def test_bfs_levels_delta_matches_reference(pair, hops, lane_block,
                                            monkeypatch):
    rec, dev, delta, port, pd = pair
    monkeypatch.setattr(inc, "DENSE_LANE_BLOCK", lane_block)
    seeds = _seeds(rec, port.num_atoms)
    lv, vis = ref_inc.bfs_levels_delta(dev, delta, jnp.asarray(seeds), hops)
    plv, pvis = inc.bfs_levels_delta(port.device("cpu"), pd,
                                     torch.from_numpy(seeds), hops)
    assert np.array_equal(pvis.numpy(), np.asarray(vis))
    assert np.array_equal(plv.numpy(), np.asarray(lv))
    vis = pvis.numpy()
    assert not vis[1].any()  # the dead seed reaches nothing
    assert (vis[40:].sum(1) == 1).all() and vis[40:, -1].all()  # pad lanes
    dead = pd.dead.numpy()
    assert not (vis[:, dead]).any()  # dead atoms are never reached


def test_bfs_levels_delta_without_levels(pair):
    rec, dev, delta, port, pd = pair
    seeds = _seeds(rec, port.num_atoms)
    _, vis = ref_inc.bfs_levels_delta(dev, delta, jnp.asarray(seeds), 2,
                                      with_levels=False)
    lv, pvis = inc.bfs_levels_delta(port.device("cpu"), pd,
                                    torch.from_numpy(seeds), 2,
                                    with_levels=False)
    assert lv is None
    assert np.array_equal(pvis.numpy(), np.asarray(vis))


def test_delta_edges_and_tombstones_change_the_reach(pair):
    """The case is not vacuous: the delta's links add reach over the base
    alone, and the tombstones take reach away."""
    rec, dev, delta, port, pd = pair
    seeds = torch.from_numpy(_seeds(rec, port.num_atoms))
    n1 = port.num_atoms + 1
    empty = inc.DeviceDelta(dead=torch.zeros(n1, dtype=torch.bool),
                            **{c: torch.full((4,), port.num_atoms,
                                             dtype=torch.int32)
                               for c in inc.COLUMNS})
    no_dead = inc.DeviceDelta(dead=torch.zeros(n1, dtype=torch.bool),
                              **{c: getattr(pd, c) for c in inc.COLUMNS})
    d = port.device("cpu")
    base = inc.bfs_levels_delta(d, empty, seeds, 3)[1].sum()
    grown_ = inc.bfs_levels_delta(d, no_dead, seeds, 3)[1].sum()
    dead = inc.bfs_levels_delta(d, pd, seeds, 3)[1].sum()
    assert grown_ > base and dead < grown_


@pytest.mark.parametrize("batched", [False, True])
def test_expand_frontier_delta_matches_reference(pair, batched):
    rec, dev, delta, port, pd = pair
    n1 = port.num_atoms + 1
    r = np.random.default_rng(4)
    f = r.random((5, n1) if batched else n1) < 0.1
    want = ref_inc.expand_frontier_delta(dev, delta, jnp.asarray(f))
    got = inc.expand_frontier_delta(port.device("cpu"), pd,
                                    torch.from_numpy(f))
    assert got.shape == f.shape
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_dense_sweep_rejects_a_delta_of_another_id_space(pair):
    rec, dev, delta, port, pd = pair
    other = inc.DeviceDelta(dead=pd.dead[:-1],
                            **{c: getattr(pd, c) for c in inc.COLUMNS})
    with pytest.raises(ValueError, match="does not fit"):
        inc.bfs_levels_delta(port.device("cpu"), other,
                             torch.zeros(1, dtype=torch.int32), 1)


def test_unpack_dead_and_splice_match_reference():
    r = np.random.default_rng(0)
    words = r.integers(0, 2**32, size=7, dtype=np.uint64).astype(np.uint32)
    want = ref_inc._unpack_dead(jnp.asarray(words), 200)
    got = inc._unpack_dead(torch.from_numpy(words.view(np.int32)), 200)
    assert np.array_equal(got.numpy(), np.asarray(want))
    buf = r.integers(0, 99, size=32).astype(np.int32)
    tail = r.integers(0, 99, size=8).astype(np.int32)
    want = ref_inc._splice(jnp.asarray(buf), jnp.asarray(tail), jnp.int32(20))
    t_buf = torch.from_numpy(buf)
    got = inc._splice(t_buf, torch.from_numpy(tail), 20)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(t_buf.numpy(), buf)  # the old buffer is untouched
    with pytest.raises(ValueError, match="overrun"):
        inc._splice(t_buf, torch.from_numpy(tail), 30)


# --------------------------------------------------------------- memtable


def test_memtable_matches_reference_manager_through_growth():
    """The same adds and removals, refreshed after each batch: equal padded
    arrays, dead bits and bucket, and equal upload counters, across a
    bucket growth (full re-upload) and append-only tails."""
    rec = Recorder(seed=5, delta_bucket_min=1024)
    mt = rec.memtable()
    r = np.random.default_rng(5)
    done = 0
    buckets = set()
    for step in range(8):
        for i in range(20):
            ts = r.choice(rec.nodes, size=int(r.integers(6, 10)),
                          replace=False)
            rec.add_link(ts, f"s{step}.{i}")
        if step == 3:
            rec.remove(rec.links[step])
            rec.remove(rec.nodes[step])
        _, d_ref = rec.mgr.device()
        done = rec.feed(mt, done)
        d = mt.device()
        assert_same_delta(d, d_ref)
        assert (mt.full_uploads, mt.tail_uploads) == (
            rec.mgr.full_uploads, rec.mgr.tail_uploads), step
        buckets.add(d.inc_links.shape[0])
    assert rec.mgr.compactions == 1  # one epoch: the memtable's
    assert len(buckets) > 1 and mt.tail_uploads > 0  # both routes ran
    assert mt.delta_edges == rec.mgr.delta_edges
    rec.close()


def test_memtable_tail_upload_counts_match_reference():
    """The append-only tail splice: one full upload, then one tail upload,
    and the spliced delta equals a fresh full upload and the reference's
    (the reference's ``test_incremental_delta_upload_appends_tail``)."""
    rec = Recorder(n_nodes=20, n_links=0, headroom=3.0,
                   delta_bucket_min=1 << 12)
    nodes = rec.nodes
    for i in range(30):
        rec.add_link((nodes[i % 20], nodes[(i + 1) % 20]), i)
    mt = rec.memtable()
    done = rec.feed(mt)
    _, d_ref = rec.mgr.device()
    mt.device()
    assert (mt.full_uploads, mt.tail_uploads) == (1, 0)
    assert (rec.mgr.full_uploads, rec.mgr.tail_uploads) == (1, 0)
    rec.add_link((nodes[0], nodes[7]), "tail-link")
    rec.feed(mt, done)
    _, d_ref = rec.mgr.device()
    d2 = mt.device()
    assert (mt.full_uploads, mt.tail_uploads) == (1, 1)
    assert rec.mgr.tail_uploads == 1
    assert_same_delta(d2, d_ref)
    fresh = rec.memtable()
    rec.feed(fresh)
    assert_same_delta(fresh.device(), d_ref)
    rec.close()


def test_memtable_dead_only_refresh_reuses_edge_buffers():
    """A removal with no new edges refreshes only the tombstones; the edge
    buffers are the same tensors (the reference's
    ``test_incremental_dead_only_refresh_reuses_edge_buffers``)."""
    def build(g):
        nodes = [g.add(x) for x in "abc"]
        return nodes, [g.add_link(nodes[:2], value=1)]

    rec = Recorder(build=build, headroom=3.0, delta_bucket_min=1 << 12)
    a, b, c = rec.nodes
    l2 = rec.add_link((b, c), 2)
    mt = rec.memtable()
    done = rec.feed(mt)
    _, r1 = rec.mgr.device()
    d1 = mt.device()
    rec.remove(l2)
    rec.feed(mt, done)
    _, r2 = rec.mgr.device()
    d2 = mt.device()
    assert r2.inc_links is r1.inc_links
    assert d2.inc_links is d1.inc_links and d2.tgt_src is d1.tgt_src
    assert (mt.full_uploads, mt.tail_uploads) == (1, 0)
    assert bool(d2.dead[l2])
    assert_same_delta(d2, r2)
    port = to_port(rec.mgr.base)
    _, vis = inc.bfs_levels_delta(port.device("cpu"), d2,
                                  torch.tensor([int(a)], dtype=torch.int32), 4)
    assert bool(vis[0, int(b)]) and not bool(vis[0, int(c)])
    rec.close()


class _Store:
    def __init__(self, recs):
        self.recs = recs

    def get_link(self, h):
        return self.recs.get(h)


@pytest.mark.parametrize("case", ["inside", "link_out", "target_out",
                                  "no_targets"])
def test_memtable_buffers_like_reference(case):
    """``add_link`` against the reference's ``_buffer_edges_locked`` on the
    same record: an id or a target at or past the capacity buffers nothing
    and sets ``needs_recompact``."""
    cap = 50
    h, targets = {"inside": (40, (3, 7, 3)), "link_out": (50, (3, 7)),
                  "target_out": (41, (3, 60)), "no_targets": (42, ())}[case]
    mgr = ref_inc.SnapshotManager.__new__(ref_inc.SnapshotManager)
    mgr._capacity = cap
    mgr._needs_recompact = False
    mgr._inc_links, mgr._inc_src, mgr._tgt_flat, mgr._tgt_src = [], [], [], []
    graph = type("G", (), {"store": _Store({h: (0, 0, 0) + targets})})()
    want = mgr._buffer_edges_locked(graph, h)
    mt = inc.DeltaMemtable(cap, device="cpu")
    mt.remove(h)
    assert mt.add_link(h, targets) == want
    assert mt.needs_recompact == mgr._needs_recompact == (case.endswith("out"))
    hd = mt.host_delta()
    for c in inc.COLUMNS:
        assert hd[c].tolist() == getattr(mgr, "_" + c)
    # a buffered link lifts its tombstone; a refused one keeps it
    assert hd["dead"].tolist() == ([] if want or h >= cap else [h])


def test_memtable_remove_outside_capacity_is_ignored():
    mt = inc.DeltaMemtable(10, device="cpu")
    mt.remove(10)
    mt.remove(3)
    assert mt.host_delta()["dead"].tolist() == [3]


@pytest.mark.parametrize("lag", [0, 5, 1000])
def test_memtable_drift_rule_matches_reference(lag):
    """``device(max_lag_edges)``: a refresh happens exactly when the
    reference's manager refreshes, over a run of single-link adds and a
    removal."""
    rec = Recorder(seed=7)
    mt = rec.memtable()
    done = rec.feed(mt)
    _, r_prev = rec.mgr.device(max_lag_edges=lag)
    d_prev = mt.device(max_lag_edges=lag)
    r = np.random.default_rng(7)
    pattern = []
    for i in range(12):
        if i == 6:
            rec.remove(rec.links[0])
        else:
            rec.add_link(r.choice(rec.nodes, size=2, replace=False), i)
        done = rec.feed(mt, done)
        _, r_cur = rec.mgr.device(max_lag_edges=lag)
        d_cur = mt.device(max_lag_edges=lag)
        assert (d_cur is d_prev) == (r_cur is r_prev), i
        assert_same_delta(d_cur, r_cur)
        pattern.append(d_cur is d_prev)
        r_prev, d_prev = r_cur, d_cur
    assert any(pattern) == (lag > 0)
    assert all(pattern) == (lag == 1000)
    rec.close()


def test_host_delta_matches_reference():
    rec, _ = grown(seed=9)
    mt = rec.memtable()
    rec.feed(mt)
    want, got = rec.mgr.host_delta(), mt.host_delta()
    assert got["capacity"] == want["capacity"]
    for c in inc.COLUMNS:
        assert got[c].dtype == np.int32
        assert np.array_equal(got[c], want[c]), c
    assert sorted(got["dead"].tolist()) == sorted(want["dead"].tolist())
    rec.close()


# ------------------------------------------------------ carrying deltas


def test_delta_from_reference_host_form_equals_device_form(pair):
    rec, dev, delta, port, pd = pair
    hd = rec.mgr.host_delta()
    assert rec.mgr.delta_bucket_min == inc.BUCKET_MIN
    from_host = inc.delta_from_reference(hd, "cpu")
    assert_same_delta(from_host, delta)
    assert_same_delta(pd, delta)
    assert from_host.has_tombstones() and pd.n_atoms == port.num_atoms


@pytest.mark.parametrize("bad", ["range", "negative", "lengths"])
def test_delta_from_reference_rejects_bad_arrays(bad):
    n = 10
    d = {c: np.full(4, n, np.int32) for c in inc.COLUMNS}
    d["dead"] = np.zeros(n + 1, bool)
    if bad == "range":
        d["tgt_flat"][0] = n + 1
    elif bad == "negative":
        d["inc_src"][1] = -1
    else:
        d["inc_src"] = d["inc_src"][:3]
    with pytest.raises(ValueError):
        inc.delta_from_reference(d, "cpu")


# ------------------------------------------------------- held-back links


def memtable_of(base, records):
    """A CPU memtable of the base fed ``records`` in order."""
    mt = inc.DeltaMemtable(base.num_atoms, device="cpu")
    for h, targets in records:
        assert mt.add_link(h, targets)
    return mt


def test_split_snapshot_plus_delta_is_the_whole_graph():
    """Base ∪ delta of a split snapshot is the snapshot: the dense sweep
    over the pair equals the plain dense BFS over the whole graph."""
    from hypergraphdb_tpu_torch.ops.frontier import bfs_levels
    from tests.test_ellbfs import random_snapshot

    full = to_port(random_snapshot(80, 120, 4, seed=2, zipf=True))
    base, records = split_snapshot(full, 30)
    assert base.n_edges_tgt == full.n_edges_tgt - sum(len(t) for _, t in
                                                     records)
    assert (base.type_of[[h for h, _ in records]] == -1).all()
    delta = memtable_of(base, records).device()
    seeds = torch.arange(0, 64, dtype=torch.int32)
    want_lv, want = bfs_levels(full.device("cpu"), seeds, 3)
    lv, got = inc.bfs_levels_delta(base.device("cpu"), delta, seeds, 3)
    assert torch.equal(got, want) and torch.equal(lv, want_lv)
