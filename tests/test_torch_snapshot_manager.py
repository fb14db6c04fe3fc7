"""The port's ``SnapshotManager`` against the reference's: the scenarios of
``tests/test_incremental.py`` (:30, :53, :70, :90, :103, :138, :189,
:226, :250, :286, :310, :342, :369, :390) run on both managers, each over
a graph built by the same operations. After every step the two must hold
the same base (every ``REFERENCE_FIELDS`` field and the by-type index),
the same ``host_delta`` (epoch, capacity, COO columns; dead ids as a set),
the same compaction count, the same device delta arrays and upload
counters, and the dense ``bfs_levels_delta`` over their pairs must give the
same levels and visited sets. Background scenarios compare after
``wait_compacted``. Every wait and join is bounded. Tolerance: exact
equality."""

import threading

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hypergraphdb_tpu_torch.ops.snapshot import CSRSnapshot
from tests.conftest import make_random_hypergraph
from tests.test_torch_graph import PKGS, mod, new_graph

DELTA_FIELDS = ("inc_links", "inc_src", "tgt_flat", "tgt_src", "dead")
WAIT_S = 60


def plain(x):
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.tolist())
    return x


class Side:
    """One package's graph and manager, driven by a scenario."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.port = pkg == PKGS[1]
        self.g = new_graph(pkg)
        self.inc = mod(pkg, "ops.incremental")
        self.mgr = None

    def _kw(self, kw):
        return dict(kw, device="cpu") if self.port else kw

    def manager(self, **kw):
        self.mgr = self.inc.SnapshotManager(self.g, **self._kw(kw))
        return self.mgr

    def enable(self, **kw):
        self.mgr = self.g.enable_incremental(**self._kw(kw))
        return self.mgr

    def arrays(self, delta) -> dict:
        return {k: np.asarray(getattr(delta, k).numpy() if self.port
                              else getattr(delta, k)) for k in DELTA_FIELDS}

    def bfs(self, dev, delta, seeds, hops):
        seeds = np.asarray(seeds, dtype=np.int32)
        if self.port:
            lv, vis = self.inc.bfs_levels_delta(
                dev, delta, torch.from_numpy(seeds), hops)
            return lv.numpy(), vis.numpy()
        lv, vis = self.inc.bfs_levels_delta(dev, delta, jnp.asarray(seeds),
                                            hops)
        return np.asarray(lv), np.asarray(vis)

    def state(self) -> dict:
        """What the manager holds, as plain Python."""
        m = self.mgr
        base = {k: plain(getattr(m.base, k))
                for k in CSRSnapshot.REFERENCE_FIELDS}
        base["by_type"] = {t: v.tolist() for t, v in m.base.by_type.items()}
        hd = m.host_delta()
        hd = {k: sorted(v.tolist()) if k == "dead" else plain(v)
              for k, v in hd.items()}
        return {"base": base, "host_delta": hd, "epoch": m.compactions,
                "delta_edges": m.delta_edges,
                "correction": (sorted(m.correction()[0]), m.correction()[1],
                               sorted(m.correction()[2]))}

    def read(self, seeds, hops, max_lag_edges=0) -> dict:
        """The device pair's arrays, upload counters and a BFS over it."""
        dev, delta = self.mgr.device(max_lag_edges)
        lv, vis = self.bfs(dev, delta, seeds, hops)
        return {"delta": {k: plain(v) for k, v in self.arrays(delta).items()},
                "uploads": (self.mgr.full_uploads, self.mgr.tail_uploads),
                "n": dev.num_atoms, "levels": plain(lv),
                "visited": plain(vis)}

    def close(self):
        if self.mgr is not None:
            assert self.mgr.wait_compacted(WAIT_S)
        self.g.close()


def run_both(scenario):
    """``scenario(side, log)`` on both packages; the logs must agree.
    Returns the port's log."""
    logs = {}
    for pkg in PKGS:
        side, log = Side(pkg), []
        try:
            scenario(side, log)
        finally:
            side.close()
        logs[pkg] = log
    ref, port = logs[PKGS[0]], logs[PKGS[1]]
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert b == a, f"step {i} differs"
    return port


def node_seeds(nodes, k=8):
    return [int(h) for h in nodes[:k]]


def delta_matches_full_repack_on_ingest(s, log):
    nodes, _ = make_random_hypergraph(s.g, n_nodes=80, n_links=120, seed=9)
    s.manager(headroom=3.0)
    log.append(s.state())
    new_nodes = list(s.g.add_nodes_bulk([f"x{i}" for i in range(30)]))
    r = np.random.default_rng(1)
    for i in range(60):
        s.g.add_link([int(r.choice(nodes)), int(r.choice(new_nodes))],
                     value=1000 + i)
    log.append(s.read([nodes[0], new_nodes[0]] + node_seeds(nodes), 3))
    log.append(s.state())


def delta_handles_removals(s, log):
    a, b, c = s.g.add("a"), s.g.add("b"), s.g.add("c")
    s.g.add_link((a, b))
    l2 = s.g.add_link((b, c))
    s.manager(headroom=3.0)
    s.g.remove(int(l2))
    log.append(s.read([a, b, c], 4))
    log.append(s.state())


def cascade_removal_tombstones_links(s, log):
    a, b, c = s.g.add("a"), s.g.add("b"), s.g.add("c")
    s.g.add_link((a, b))
    s.g.add_link((b, c))
    s.manager(headroom=3.0)
    s.g.remove(int(b))
    log.append(s.read([a, c], 4))
    log.append(s.state())


def compaction_on_headroom_exhaustion(s, log):
    s.g.add("seed")
    s.manager(headroom=1.05)
    log.append(s.state())
    s.g.add_nodes_bulk([f"n{i}" for i in range(5000)])
    log.append(s.read([20, 5000], 1))
    log.append(s.state())


def compaction_on_delta_ratio(s, log):
    nodes, _ = make_random_hypergraph(s.g, n_nodes=50, n_links=20, seed=2)
    s.manager(headroom=50.0, compact_ratio=0.0)
    s.mgr._maybe_compact()
    log.append(s.state())
    r = np.random.default_rng(3)
    for i in range(5000):
        s.g.add_link([int(t) for t in r.choice(nodes, size=2, replace=False)],
                     value=i)
    log.append(s.read(node_seeds(nodes), 2))
    log.append(s.state())


def no_repack_on_mutation(s, log):
    nodes, _ = make_random_hypergraph(s.g, n_nodes=60, n_links=40, seed=4)
    s.enable(headroom=10.0, background=False)
    base0 = s.g.snapshot()
    s.g.add_link((nodes[0], nodes[1]), value=12345)
    log.append((s.g.snapshot() is base0, s.mgr.compactions))
    log.append(s.read(node_seeds(nodes), 2))
    log.append(s.state())


def background_compaction(s, log):
    nodes = [s.g.add(f"n{i}") for i in range(8)]
    s.enable(headroom=50.0, compact_ratio=0.0, background=True)
    base0 = s.mgr.base
    r = np.random.default_rng(9)
    for i in range(2000):
        a, b = r.choice(8, size=2, replace=False)
        s.g.add_link((nodes[a], nodes[b]), value=int(i))
    s.mgr._maybe_compact()
    assert s.mgr.wait_compacted(WAIT_S)
    log.append((s.mgr.compactions, s.mgr.base is not base0))
    log.append(s.state())
    s.mgr._compact_sync()
    log.append(s.state())
    log.append(s.read(node_seeds(nodes), 2))


def overflow_add_defers_compaction(s, log):
    [s.g.add(f"n{i}") for i in range(6)]
    s.enable(headroom=1.01, background=False)
    packs = s.mgr.compactions
    extra = list(s.g.add_nodes_bulk([f"x{i}" for i in range(2000)]))
    s.g.add_link((extra[-1], extra[0]), value="late")
    log.append((bool(s.mgr._needs_recompact), s.mgr.compactions == packs))
    got = s.read([extra[-1]], 1)
    log.append((s.mgr.compactions > packs,
                bool(got["visited"][1][0][int(extra[0])])))
    log.append(got)
    log.append(s.state())


def concurrent_writers_and_readers(s, log):
    nodes = [s.g.add(f"n{i}") for i in range(8)]
    s.enable(headroom=1.05, compact_ratio=0.0, background=False)
    errors = []

    def writer():
        try:
            for i in range(300):
                s.g.add_link((nodes[i % 8], nodes[(i + 1) % 8]), value=int(i))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    def reader():
        try:
            for _ in range(30):
                s.mgr.device()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    ts = [threading.Thread(target=writer), threading.Thread(target=reader)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in ts), "deadlock: threads alive"
    assert not errors, errors
    # the compaction count depends on the interleaving; the drained state
    # does not
    s.mgr._compact_sync()
    st = s.state()
    st.pop("epoch")
    log.append(st)


def shape_stable_packing(s, log):
    nodes = [s.g.add(f"n{i}") for i in range(10)]
    s.enable(headroom=1.5, compact_ratio=50.0, background=False,
             pack_pad_multiple=4096)
    n0, e0 = s.mgr.base.num_atoms, len(s.mgr.base.inc_links)
    log.append((len(s.mgr.compaction_stats), n0 % 4096, e0 % 4096))
    for i in range(50):
        s.g.add_link((nodes[i % 10], nodes[(i + 3) % 10]), value=i)
    s.mgr._compact_sync()
    log.append((s.mgr.base.num_atoms == n0, len(s.mgr.base.inc_links) == e0,
                sorted(s.mgr.compaction_stats[-1])))
    log.append(s.state())


def delta_upload_appends_tail(s, log):
    nodes = [s.g.add(f"n{i}") for i in range(20)]
    s.enable(headroom=3.0, compact_ratio=50.0, background=False,
             delta_bucket_min=1 << 12)
    for i in range(30):
        s.g.add_link((nodes[i % 20], nodes[(i + 1) % 20]), value=i)
    log.append(s.read([nodes[0]], 3))
    s.g.add_link((nodes[0], nodes[7]), value="tail-link")
    tail = s.read([nodes[0]], 3)
    log.append(tail)
    # a clean full upload answers as the spliced one
    holder = s.mgr._mt if s.port else s.mgr  # the port's memtable
    holder._device_delta = None
    holder._uploaded_marker = (-1, -1, -1)
    full = s.read([nodes[0]], 3)
    log.append((full["visited"] == tail["visited"],
                full["levels"] == tail["levels"], full["uploads"]))


def dead_only_refresh(s, log):
    a, b, c = s.g.add("a"), s.g.add("b"), s.g.add("c")
    s.g.add_link((a, b), value=1)
    s.enable(headroom=3.0, compact_ratio=50.0, background=False,
             delta_bucket_min=1 << 12)
    l2 = s.g.add_link((b, c), value=2)
    _, d1 = s.mgr.device()
    s.g.remove(int(l2))
    _, d2 = s.mgr.device()
    log.append(d2.inc_links is d1.inc_links)
    log.append(s.read([a], 4))
    log.append(s.state())


def wait_compacted_bounds_compaction(s, log):
    nodes = [s.g.add(f"n{i}") for i in range(8)]
    s.enable(headroom=50.0, compact_ratio=0.0, background=True)
    log.append(s.mgr.wait_compacted(1.0))
    for i in range(1500):
        s.g.add_link((nodes[i % 8], nodes[(i + 1) % 8]), value=i)
    s.mgr._maybe_compact()
    log.append(s.mgr.wait_compacted(WAIT_S))
    log.append((s.mgr._compacting, s.mgr.compactions))
    dev, _ = s.mgr.device()
    log.append(dev.num_atoms == s.mgr.base.num_atoms)
    log.append(s.state())


def pinned_view_is_one_epoch(s, log):
    nodes = [s.g.add(f"n{i}") for i in range(6)]
    s.enable(background=False, compact_ratio=100.0)
    lk = s.g.add_link((nodes[0], nodes[1]), value="after-pack")
    s.g.remove(int(nodes[5]))
    pv = s.mgr.pinned_view()
    twin = pv.base.device("cpu") if s.port else pv.base.device
    log.append((pv.epoch == s.mgr.compactions, twin is pv.device,
                int(lk) in pv.new_atoms, int(nodes[5]) in pv.dead,
                pv.delta is (s.mgr._device_delta), sorted(pv.dead),
                pv.new_atoms, sorted(pv.revalued)))
    log.append({k: plain(v) for k, v in s.arrays(pv.delta).items()})


SCENARIOS = [
    delta_matches_full_repack_on_ingest, delta_handles_removals,
    cascade_removal_tombstones_links, compaction_on_headroom_exhaustion,
    compaction_on_delta_ratio, no_repack_on_mutation, background_compaction,
    overflow_add_defers_compaction, concurrent_writers_and_readers,
    shape_stable_packing, delta_upload_appends_tail, dead_only_refresh,
    wait_compacted_bounds_compaction, pinned_view_is_one_epoch,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_manager_scenario_matches_reference(scenario):
    run_both(scenario)


def test_what_the_reference_scenarios_assert():
    """The reference tests' own assertions, on the port's logs."""
    log = run_both(delta_handles_removals)
    a, c = 20, 24  # the first atoms after the 10 type atoms (and values)
    assert log[0]["visited"][1][0][a] and not log[0]["visited"][1][0][c]
    log = run_both(compaction_on_headroom_exhaustion)
    assert log[2]["epoch"] > log[0]["epoch"] and log[2]["delta_edges"] == 0
    log = run_both(no_repack_on_mutation)
    assert log[0] == (True, 1)
    log = run_both(background_compaction)
    assert log[0] == (2, True) and log[2]["delta_edges"] == 0
    log = run_both(overflow_add_defers_compaction)
    assert log[0] == (True, True) and log[1] == (True, True)
    log = run_both(delta_upload_appends_tail)
    assert log[0]["uploads"] == (1, 0) and log[1]["uploads"] == (1, 1)
    assert log[2][:2] == (True, True)
    log = run_both(dead_only_refresh)
    assert log[0] is True
    log = run_both(wait_compacted_bounds_compaction)
    assert log[:3] == [True, True, (False, 2)]
    log = run_both(pinned_view_is_one_epoch)
    assert all(log[0][:5])


def test_device_views_default_to_cuda():
    """Without ``device="cpu"`` the manager asks for the card and raises
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g = new_graph(PKGS[1])
    g.add("x")
    with pytest.raises(RuntimeError, match="CUDA"):
        g.enable_incremental()
    g.close()


def test_host_delta_of_a_view_and_value_delta():
    """``pinned_view(host_delta=True)`` captures the memtable with the view;
    ``value_delta`` covers the view's new atoms of one kind, as the
    reference's ``value_delta`` does."""
    out = {}
    for pkg in PKGS:
        s = Side(pkg)
        nodes = [s.g.add(i) for i in range(10)]
        s.enable(background=False, compact_ratio=100.0)
        new = [s.g.add_link((nodes[i], nodes[i + 1]), value=100 + i)
               for i in range(5)]
        s.g.add("not an int")
        pv = s.mgr.pinned_view()
        col = s.mgr.value_delta(pv, ord("i"))
        again = s.mgr.value_delta(pv, ord("i")) is col
        if s.port:
            hd = s.mgr.pinned_view(host_delta=True).host_delta
            assert {k: plain(v) for k, v in hd.items()} == {
                k: plain(v) for k, v in s.mgr.host_delta().items()}
            gids = col.gids[: col.n].numpy()
        else:
            gids = np.asarray(col.gids)[: col.n]
        out[pkg] = (col.n, col.covered, col.epoch, col.device_exact, again,
                    gids.tolist(), [int(h) for h in new])
        s.close()
    assert out[PKGS[1]] == out[PKGS[0]]
    n, covered, _, exact, again, gids, new = out[PKGS[1]]
    assert (n, covered, exact, again) == (5, 6, True, True) and gids == new
