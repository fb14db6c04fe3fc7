"""The port's checkpoints (``ops/checkpoint.py``) and plan sidecar
(``ellbfs.save_plans`` / ``load_plans`` / ``HG_PLAN_CACHE``) against the
reference's: the checkpoint cases of ``tests/test_checkpoint_variables.py``
as scenarios on both packages over graphs built the same way, records
equal (arrays, plan pyramids, the files' fields, BFS answers over the
reloaded snapshot on ``device="cpu"``, crash outcomes, the
``fault.sidecar_corrupt`` count); then both directions across the
packages: a port checkpoint loads and serves in the reference, and a
reference checkpoint in the port.

Tolerance: exact equality."""

from __future__ import annotations

import importlib
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

from conftest import make_random_hypergraph

PKGS = ("hypergraphdb_tpu", "hypergraphdb_tpu_torch")
#: the snapshot fields of the reference's checkpoint file
FIELDS = ("inc_offsets", "inc_links", "inc_src", "tgt_offsets", "tgt_flat",
          "tgt_src", "type_of", "is_link", "arity", "value_rank",
          "value_kind")


def package(pkg) -> SimpleNamespace:
    imp = importlib.import_module
    return SimpleNamespace(
        name=pkg, port=pkg == PKGS[1], graph=imp(f"{pkg}.core.graph"),
        cp=imp(f"{pkg}.ops.checkpoint"), ellbfs=imp(f"{pkg}.ops.ellbfs"),
        fault=imp(f"{pkg}.fault"), q=imp(f"{pkg}.query.dsl"),
        metrics=imp(f"{pkg}.utils.metrics"))


def corrupt_count(P) -> int:
    m = P.metrics.global_metrics
    if P.port:
        return m.counters.get("fault.sidecar_corrupt", 0)
    return m.registry.counter("fault.sidecar_corrupt").value


def snap_record(snap) -> dict:
    """A snapshot as plain data: its scalars, its file fields and its
    type rows."""
    out = {"version": snap.version, "num_atoms": snap.num_atoms,
           "n_edges": (snap.n_edges_inc, snap.n_edges_tgt),
           "by_type": {int(k): np.asarray(v).tolist()
                       for k, v in sorted(snap.by_type.items())}}
    for f in FIELDS:
        a = np.asarray(getattr(snap, f))
        out[f] = (str(a.dtype), a.tolist())
    return out


def plans_record(plans) -> dict:
    return {
        "n": (plans.n_atoms, plans.n_pad),
        "s1": ([l.tolist() for l in plans.stage1.levels],
               plans.stage1.widths, plans.stage1.out_map.tolist(),
               plans.stage1.n_rows, plans.stage1.concat_size),
        "s2": ([l.tolist() for l in plans.stage2_levels],
               plans.stage2_widths),
        "out_map": plans.out_map.tolist(), "inc_deg": plans.inc_deg.tolist(),
    }


def bfs_record(P, snap, seeds, hops=3) -> tuple:
    """The pull BFS over ``snap``: visited bitmap words and edge counts."""
    if P.port:
        res = P.ellbfs.bfs_pull(snap, seeds, hops, device="cpu")
        vt = res.visited_t.numpy().view(np.uint32)
    else:
        res = P.ellbfs.bfs_pull(snap, seeds, hops)
        vt = np.asarray(res.visited_t)
    return vt.tolist(), np.asarray(res.edges_touched).tolist()


def npz_record(path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: (str(z[k].dtype), z[k].tolist()) for k in sorted(z.files)}


def on_both(scenario, tmp_path) -> dict:
    out = {}
    for pkg in PKGS:
        P = package(pkg)
        g = P.graph.HyperGraph()
        d = tmp_path / pkg
        d.mkdir()
        try:
            out[pkg] = scenario(P, g, d)
        finally:
            g.close()
    assert out[PKGS[1]] == out[PKGS[0]]
    return out


@pytest.fixture
def faults():
    regs = [package(p).fault.global_faults() for p in PKGS]
    for f in regs:
        f.reset()
    yield
    for f in regs:
        f.reset()
        f.disable()


def two_snapshots(g):
    make_random_hypergraph(g, n_nodes=40, n_links=60, seed=3)
    snap_a = g.snapshot()
    for i in range(25):
        g.add(f"extra-{i}")
    snap_b = g.snapshot()
    assert snap_b.num_atoms > snap_a.num_atoms
    return snap_a, snap_b


# ---------------------------------------------------------------- snapshot ckpt


def test_snapshot_save_load_roundtrip(tmp_path):
    def scenario(P, g, d):
        make_random_hypergraph(g, n_nodes=60, n_links=90, seed=5)
        snap = g.snapshot()
        p = str(d / "snap.npz")
        P.cp.save_snapshot(snap, p)
        back = P.cp.load_snapshot(p)
        assert snap_record(back) == snap_record(snap)
        if P.port:
            for f in ("value_rank2", "value_ambig"):
                np.testing.assert_array_equal(getattr(back, f),
                                              getattr(snap, f))
        seeds = np.arange(32, dtype=np.int32)
        assert bfs_record(P, back, seeds) == bfs_record(P, snap, seeds)
        return snap_record(back), bfs_record(P, back, seeds)

    on_both(scenario, tmp_path)


def test_snapshot_path_without_extension(tmp_path):
    def scenario(P, g, d):
        g.add("p")
        snap = g.snapshot()
        p = str(d / "noext")
        P.cp.save_snapshot(snap, p)
        back = P.cp.load_snapshot(p)       # both sides normalize to .npz
        assert back.num_atoms == snap.num_atoms
        return sorted(os.listdir(d)), snap_record(back)

    on_both(scenario, tmp_path)


def test_plans_persist_with_snapshot(tmp_path):
    """``with_plans=True`` writes a sidecar the loader attaches, in the
    same fields in both packages; the restored plans drive equal BFS."""
    def scenario(P, g, d):
        make_random_hypergraph(g, n_nodes=150, n_links=300, seed=11)
        snap = g.snapshot()
        path = str(d / "snap.npz")
        P.cp.save_snapshot(snap, path, with_plans=True)
        loaded = P.cp.load_snapshot(path)
        assert getattr(loaded, "_pull_plans", None) is not None
        seeds = np.arange(24, dtype=np.int32)
        assert bfs_record(P, snap, seeds) == bfs_record(P, loaded, seeds)
        assert (plans_record(P.ellbfs.plans_for(snap))
                == plans_record(loaded._pull_plans))
        return (plans_record(loaded._pull_plans),
                npz_record(P.cp._plans_path(path)),
                bfs_record(P, loaded, seeds))

    on_both(scenario, tmp_path)


# ------------------------------------------------- crash-atomic saves (hgfault)


def test_crash_mid_npz_save_previous_checkpoint_survives(tmp_path, faults):
    def scenario(P, g, d):
        snap_a, snap_b = two_snapshots(g)
        p = str(d / "snap.npz")
        P.cp.save_snapshot(snap_a, p)
        f = P.fault.global_faults()
        f.enable(seed=0)
        f.arm("ckpt.save_npz", at={1}, error=P.fault.InjectedCrash)
        with pytest.raises(P.fault.InjectedCrash):
            P.cp.save_snapshot(snap_b, p)
        back = P.cp.load_snapshot(p)
        assert snap_record(back) == snap_record(snap_a)
        P.cp.save_snapshot(snap_b, p)
        assert P.cp.load_snapshot(p).num_atoms == snap_b.num_atoms
        f.reset()
        f.disable()
        return snap_record(back), f.hits("ckpt.save_npz")

    on_both(scenario, tmp_path)


def test_crash_mid_plans_save_leaves_loadable_state(tmp_path, faults):
    def scenario(P, g, d):
        snap_a, snap_b = two_snapshots(g)
        p = str(d / "snap.npz")
        P.cp.save_snapshot(snap_a, p, with_plans=True)
        f = P.fault.global_faults()
        f.enable(seed=0)
        f.arm("ckpt.save_plans", at={1}, error=P.fault.InjectedCrash)
        with pytest.raises(P.fault.InjectedCrash):
            P.cp.save_snapshot(snap_b, p, with_plans=True)
        # npz published (B), sidecar still A's: the designed stale shape
        back = P.cp.load_snapshot(p)
        assert back.num_atoms == snap_b.num_atoms
        rec = [getattr(back, "_pull_plans", None) is None,
               os.path.exists(P.cp._plans_path(p))]
        f.disarm("ckpt.save_plans")
        P.cp.save_snapshot(snap_b, p, with_plans=True)
        rec.append(getattr(P.cp.load_snapshot(p), "_pull_plans", None)
                   is not None)
        assert rec == [True, True, True]
        return rec, snap_record(back)

    on_both(scenario, tmp_path)


def test_ordinary_save_failure_cleans_tmp(tmp_path, faults):
    """A simulated crash leaves its tmp behind, as a kill would; the next
    save publishes over it; an ordinary failure removes its tmp."""
    def scenario(P, g, d):
        snap_a, snap_b = two_snapshots(g)
        p = str(d / "snap.npz")
        P.cp.save_snapshot(snap_a, p)
        f = P.fault.global_faults()
        f.enable(seed=0)
        f.arm("ckpt.save_npz", at={1}, error=P.fault.InjectedCrash)
        with pytest.raises(P.fault.InjectedCrash):
            P.cp.save_snapshot(snap_b, p)
        rec = [os.path.exists(p + ".tmp")]
        f.disarm("ckpt.save_npz")
        P.cp.save_snapshot(snap_b, p)
        rec += [os.path.exists(p + ".tmp"),
                P.cp.load_snapshot(p).num_atoms == snap_b.num_atoms]
        f.arm("ckpt.save_npz", at={1}, error=P.fault.PermanentFault)
        with pytest.raises(P.fault.PermanentFault):
            P.cp.save_snapshot(snap_a, p)
        rec += [os.path.exists(p + ".tmp"),
                P.cp.load_snapshot(p).num_atoms == snap_b.num_atoms]
        assert rec == [True, False, True, False, True]
        return rec

    on_both(scenario, tmp_path)


def test_stale_sidecar_rebuilds_quietly_corrupt_sidecar_counts(tmp_path):
    """Triage: another snapshot's sidecar rebuilds quietly; an unreadable
    one is counted in ``fault.sidecar_corrupt``; the load succeeds."""
    def scenario(P, g, d):
        snap_a, snap_b = two_snapshots(g)
        pa, pb = str(d / "a.npz"), str(d / "b.npz")
        P.cp.save_snapshot(snap_a, pa, with_plans=True)
        P.cp.save_snapshot(snap_b, pb, with_plans=True)
        before = corrupt_count(P)
        shutil.copyfile(P.cp._plans_path(pa), P.cp._plans_path(pb))
        back = P.cp.load_snapshot(pb)
        rec = [back.num_atoms == snap_b.num_atoms,
               getattr(back, "_pull_plans", None) is None,
               corrupt_count(P) - before]
        with open(P.cp._plans_path(pb), "wb") as f:
            f.write(b"this is not an npz file at all")
        back = P.cp.load_snapshot(pb)
        rec += [back.num_atoms == snap_b.num_atoms,
                getattr(back, "_pull_plans", None) is None,
                corrupt_count(P) - before]
        assert rec == [True, True, 0, True, True, 1]
        return rec

    on_both(scenario, tmp_path)


def test_plan_cache_env_roundtrip(tmp_path, monkeypatch):
    """``HG_PLAN_CACHE``: a content-identical snapshot reads its plans from
    the cache instead of building them; the cache files are equal across
    the packages."""
    def scenario(P, g, d):
        make_random_hypergraph(g, n_nodes=100, n_links=200, seed=5)
        snap = g.snapshot()
        monkeypatch.setenv("HG_PLAN_CACHE", str(d / "plancache"))
        p0 = P.ellbfs.plans_for(snap)
        snap2 = g.snapshot()
        calls = []
        real = P.ellbfs.build_pull_plans
        monkeypatch.setattr(P.ellbfs, "build_pull_plans",
                            lambda *a, **k: calls.append(1))
        p1 = P.ellbfs.plans_for(snap2)
        monkeypatch.setattr(P.ellbfs, "build_pull_plans", real)
        assert not calls
        assert plans_record(p0) == plans_record(p1)
        (name,) = os.listdir(d / "plancache")
        return name, npz_record(d / "plancache" / name), plans_record(p1)

    on_both(scenario, tmp_path)


def test_corrupt_plan_cache_entry_rebuilds_counted(tmp_path, monkeypatch):
    """The port does not swallow a broken ``HG_PLAN_CACHE`` entry: a
    corrupt one is rebuilt and counted (``fault.sidecar_corrupt``), a
    stale one rebuilt quietly, and the rebuilt plans replace it."""
    P = package(PKGS[1])
    g = P.graph.HyperGraph()
    try:
        make_random_hypergraph(g, n_nodes=60, n_links=100, seed=8)
        snap = g.snapshot()

        def fresh():
            """A copy of the snapshot without its memoized plans."""
            return type(snap)(**{k: v for k, v in vars(snap).items()
                                 if not k.startswith("_")})

        monkeypatch.setenv("HG_PLAN_CACHE", str(tmp_path))
        want = plans_record(P.ellbfs.plans_for(fresh()))
        (name,) = os.listdir(tmp_path)
        before = corrupt_count(P)
        with open(tmp_path / name, "wb") as f:
            f.write(b"garbage")
        assert plans_record(P.ellbfs.plans_for(fresh())) == want
        assert corrupt_count(P) == before + 1
        P.ellbfs.save_plans(P.ellbfs.plans_for(fresh()),
                            str(tmp_path / name),
                            fingerprint="another snapshot")
        assert plans_record(P.ellbfs.plans_for(fresh())) == want
        assert corrupt_count(P) == before + 1
        with np.load(tmp_path / name, allow_pickle=False) as z:
            assert bytes(z["fingerprint"]).decode() == \
                P.ellbfs.snapshot_fingerprint(snap)
    finally:
        g.close()


# ---------------------------------------------------------------- logical dump


def test_export_import_roundtrip(tmp_path):
    def scenario(P, g, d):
        a = g.add("alpha")
        b = g.add(42)
        lnk = g.add_link((a, b), value="edge")
        meta = g.add_link((lnk,), value="meta")
        p = str(d / "dump.jsonl")
        n = P.cp.export_graph(g, p)
        assert n >= 4
        g2 = P.graph.HyperGraph()
        try:
            mapping = P.cp.import_graph(g2, p)
            na, nb, nl = (mapping[int(a)], mapping[int(b)],
                          mapping[int(lnk)])
            assert g2.get(na) == "alpha" and g2.get(nb) == 42
            assert g2.get(nl).targets == (na, nb)
            assert g2.get(mapping[int(meta)]).targets == (nl,)
            found = list(g2.find_all(P.q.value("edge")))
            assert found == [nl]
        finally:
            g2.close()
        with open(p, encoding="utf-8") as f:
            dump = f.read()
        return n, dump, sorted(mapping.items()), found

    on_both(scenario, tmp_path)


def test_copy_subgraph_closure(tmp_path):
    def scenario(P, g, d):
        a = g.add("root")
        b = g.add("reach")
        c = g.add("unreached")
        lab = g.add_link((a, b), value="ab")
        g.add_link((c,), value="lonely")
        g2 = P.graph.HyperGraph()
        try:
            mapping = P.cp.copy_subgraph(g, g2, [int(a)])
            assert g2.get(mapping[int(b)]) == "reach"
            assert g2.get(mapping[int(lab)]).targets == (
                mapping[int(a)], mapping[int(b)])
            assert int(c) not in mapping
        finally:
            g2.close()
        return sorted(mapping.items())

    on_both(scenario, tmp_path)


# ------------------------------------------------------------ across packages


def same_graph_snapshots():
    out = []
    for pkg in PKGS:
        g = package(pkg).graph.HyperGraph()
        make_random_hypergraph(g, n_nodes=120, n_links=240, seed=13)
        out.append(g.snapshot())
        g.close()
    assert snap_record(out[0]) == snap_record(out[1])
    return out


@pytest.mark.parametrize("writer,reader", [(1, 0), (0, 1)],
                         ids=["port-to-reference", "reference-to-port"])
def test_checkpoint_crosses_the_packages(tmp_path, writer, reader):
    """A checkpoint with its plan sidecar written by one package loads in
    the other: every array equal to the writer's snapshot, the plans
    attached (no rebuild), and the reader's pull BFS over it equal to the
    writer's over its own snapshot."""
    snaps = same_graph_snapshots()
    W, R = package(PKGS[writer]), package(PKGS[reader])
    path = str(tmp_path / "ckpt.npz")
    W.cp.save_snapshot(snaps[writer], path, with_plans=True)
    back = R.cp.load_snapshot(path)
    assert snap_record(back) == snap_record(snaps[writer])
    assert getattr(back, "_pull_plans", None) is not None
    assert (plans_record(back._pull_plans)
            == plans_record(W.ellbfs.plans_for(snaps[writer])))
    seeds = np.arange(20, 84, dtype=np.int32)
    assert bfs_record(R, back, seeds) == bfs_record(W, snaps[writer], seeds)
