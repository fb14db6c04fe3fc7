"""The port's plan cache (``ops/aot_cache.py``) against the reference's
AOT cache: the AOT cases of ``tests/test_pallas_bfs.py`` as scenarios.

The reference caches compiled executables (``jax.jit`` of ``x * n + 1``);
the port caches host plans (a build function returning the same
arithmetic as numpy arrays). The same sequence of calls (cold miss and
store, memory and disk hits, a planted stale entry, a format bump, a
corrupt file, the open-time sweep by generation and by size, tmp
leftovers, the disabled sweep) must move both caches' ``AOTStats``
through equal states, ``compile_s`` aside, and sweep the same files.

Then the runtime: ``ServeConfig(aot_cache_dir=...)`` on the port (CPU)
reads each bucket's fused plan from the cache on a warm start, with zero
plans built, and answers exactly as without a cache and as the
reference's runtime; an unwritable cache directory raises from the
constructor; the pull and fused plans round-trip the cache array for
array. Tolerance: exact equality."""

from __future__ import annotations

import importlib
import json
import logging
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

PKGS = ("hypergraphdb_tpu", "hypergraphdb_tpu_torch")


def package(pkg) -> SimpleNamespace:
    """The cache module of ``pkg`` with a function to cache and arguments
    of the same signature: a jitted function for the reference, a numpy
    plan-building function for the port."""
    ac = importlib.import_module(f"{pkg}.ops.aot_cache")
    if pkg == PKGS[0]:
        import jax
        import jax.numpy as jnp

        fn = jax.jit(lambda x, n: x * n + 1, static_argnames=("n",))

        def args(n=16):
            return (jnp.zeros((n,), jnp.float32),)

        def value(out):
            return float(out(jnp.ones((16,), jnp.float32))[0])

        def cache(root, **kw):
            return ac.AOTCache(root=root, **kw)
    else:
        def fn(x, n):
            return {"y": x * n + 1}

        def args(n=16):
            return (np.ones((n,), np.float32),)

        def value(out):
            return float(out["y"][0])

        def cache(root, **kw):
            return ac.AOTCache(root=root, device="cpu", **kw)
    return SimpleNamespace(ac=ac, fn=fn, args=args, value=value,
                           cache=cache)


def stats(c) -> dict:
    d = c.stats.as_dict()
    d.pop("compile_s")
    return d


def on_both(scenario, tmp_path) -> dict:
    out = {}
    for pkg in PKGS:
        root = tmp_path / pkg
        root.mkdir()
        out[pkg] = scenario(package(pkg), str(root))
    assert out[PKGS[1]] == out[PKGS[0]]
    return out


def rewrite_header(ac, path, **change) -> None:
    with open(path, "rb") as f:
        magic = f.read(len(ac._MAGIC))
        header = json.loads(f.readline())
        rest = f.read()
    header.update(change)
    with open(path, "wb") as f:
        f.write(magic + (json.dumps(header) + "\n").encode() + rest)


def test_aot_cache_lifecycle(tmp_path):
    """cold miss → store → warm hit → content-key mismatch → quiet
    rebuild → format mismatch → quiet rebuild → corrupt → warn and
    rebuild."""
    def scenario(P, root):
        ac, rec = P.ac, []
        args, statics = P.args(), {"n": 2}
        c1 = P.cache(root, content_key="fp-a")
        out = c1.get_or_compile("t.mul", P.fn, args, statics)
        rec.append(("c1", stats(c1), P.value(out)))
        c1.get_or_compile("t.mul", P.fn, args, statics)
        rec.append(("c1 again", stats(c1)))
        c2 = P.cache(root, content_key="fp-a")
        out2 = c2.get_or_compile("t.mul", P.fn, args, statics)
        rec.append(("c2", stats(c2)))
        if P.ac.__name__.startswith(PKGS[1]):
            # the plan read from disk is the one built (running the
            # reference's deserialized executable is not this check: on
            # the forced 8-device CPU mesh it rejects its inputs)
            assert P.value(out2) == P.value(out)
        # fp-b's entry planted at fp-a's key: stale, a quiet rebuild
        cb = P.cache(root, content_key="fp-b")
        cb.get_or_compile("t.mul", P.fn, args, statics)
        key_a = c2.key_for("t.mul", args, statics)
        key_b = cb.key_for("t.mul", args, statics)
        os.replace(cb._path(key_b), c2._path(key_a))
        c3 = P.cache(root, content_key="fp-a")
        c3.get_or_compile("t.mul", P.fn, args, statics)
        rec.append(("c3", stats(c3)))
        # a format bump is stale too
        path = c3._path(key_a)
        rewrite_header(ac, path, format=ac.FORMAT + 1)
        c4 = P.cache(root, content_key="fp-a")
        c4.get_or_compile("t.mul", P.fn, args, statics)
        rec.append(("c4", stats(c4)))
        # a corrupt file: warning, rebuild; the next instance hits again
        with open(path, "wb") as f:
            f.write(b"\x00 not an aot entry")
        c5 = P.cache(root, content_key="fp-a")
        c5.get_or_compile("t.mul", P.fn, args, statics)
        rec.append(("c5", stats(c5)))
        c6 = P.cache(root, content_key="fp-a")
        c6.get_or_compile("t.mul", P.fn, args, statics)
        rec.append(("c6", stats(c6)))
        return rec

    rec = on_both(scenario, tmp_path)[PKGS[1]]
    assert rec[0][1]["misses"] == 1 and rec[0][1]["puts"] == 1
    assert rec[2][1]["disk_hits"] == 1 and rec[2][1]["misses"] == 0
    assert rec[3][1]["stale"] == 1 and rec[4][1]["stale"] == 1
    assert rec[5][1]["corrupt"] == 1 and rec[6][1]["hits"] == 1


def test_aot_cache_corrupt_logs_warning(tmp_path, caplog):
    def scenario(P, root):
        args = P.args(4)
        c = P.cache(root)
        c.get_or_compile("t.x", P.fn, args, {"n": 1})
        with open(c._path(c.key_for("t.x", args, {"n": 1})), "wb") as f:
            f.write(b"junk")
        caplog.clear()
        with caplog.at_level(logging.WARNING, P.ac.log.name):
            c2 = P.cache(root)
            c2.get_or_compile("t.x", P.fn, args, {"n": 1})
        warned = any("rebuilding" in r.message for r in caplog.records)
        assert warned
        return stats(c2), warned

    on_both(scenario, tmp_path)


def test_aot_gc_sweeps_superseded_generations(tmp_path):
    """The open-time sweep deletes entries of a SUPERSEDED content
    generation once past the age bound; the current generation stays."""
    def scenario(P, root):
        args = P.args()
        old = P.cache(root, content_key="gen-old")
        old.get_or_compile("t.mul", P.fn, args, {"n": 2})
        old.get_or_compile("t.mul", P.fn, args, {"n": 3})
        cur = P.cache(root, content_key="gen-new", gc_max_age_s=None)
        cur.get_or_compile("t.mul", P.fn, args, {"n": 2})

        def n_files():
            return len([f for f in os.listdir(cur.dir)
                        if f.endswith(".aot")])

        rec = [n_files()]
        cur.gc_max_age_s = 3600.0
        rec.append(cur.gc(now=time.time() + 1.0))
        rec.append(cur.gc(now=time.time() + 2 * 3600.0))
        rec += [stats(cur), n_files()]
        c2 = P.cache(root, content_key="gen-new")
        c2.get_or_compile("t.mul", P.fn, args, {"n": 2})
        rec.append(stats(c2))
        return rec

    rec = on_both(scenario, tmp_path)[PKGS[1]]
    assert rec[:3] == [3, 0, 2] and rec[4] == 1
    assert rec[5]["disk_hits"] == 1 and rec[5]["misses"] == 0


def test_aot_gc_size_bound_and_tmp_leftovers(tmp_path):
    def scenario(P, root):
        args = P.args()
        old = P.cache(root, content_key="gen-old")
        for n in (2, 3, 4):
            old.get_or_compile("t.mul", P.fn, args, {"n": n})
        cur = P.cache(root, content_key="gen-new", gc_max_age_s=None)
        cur.get_or_compile("t.mul", P.fn, args, {"n": 2})
        leftover = os.path.join(cur.dir, "deadbeef.aot.tmp.123")
        with open(leftover, "wb") as f:
            f.write(b"crashed writer leftover")
        cur.gc_max_age_s = 3600.0
        cur.gc_max_bytes = 1                 # force over-budget
        rec = [cur.gc(now=time.time() + 1.0)]
        survivors = [f for f in os.listdir(cur.dir) if f.endswith(".aot")]
        rec.append(len(survivors))
        assert survivors and all(
            cur._entry_content_key(os.path.join(cur.dir, f)) == "gen-new"
            for f in survivors)
        rec.append(os.path.exists(leftover))
        rec.append(cur.gc(now=time.time() + 2 * 3600.0))
        rec += [os.path.exists(leftover), stats(cur)]
        return rec

    rec = on_both(scenario, tmp_path)[PKGS[1]]
    assert rec[:5] == [3, 1, True, 1, False]


def test_aot_key_separates_shapes_and_statics(tmp_path):
    def scenario(P, root):
        c = P.cache(root)
        keys = [c.key_for("e", P.args(4), {"n": 2}),
                c.key_for("e", P.args(8), {"n": 2}),
                c.key_for("e", P.args(4), {"n": 3})]
        return len(set(keys)), [k.split("__")[0] for k in keys]

    assert on_both(scenario, tmp_path)[PKGS[1]][0] == 3


def test_aot_gc_disabled_by_none_is_inert(tmp_path):
    """``gc_max_age_s=None`` is the off switch, for a manual ``gc()``
    too."""
    def scenario(P, root):
        old = P.cache(root, content_key="gen-old")
        old.get_or_compile("t.mul", P.fn, P.args(), {"n": 2})
        cur = P.cache(root, content_key="gen-new", gc_max_age_s=None)
        with open(os.path.join(cur.dir, "w.tmp.123"), "wb") as f:
            f.write(b"half-written")
        removed = cur.gc()
        names = set(os.listdir(cur.dir))
        return (removed, "w.tmp.123" in names,
                any(n.endswith(".aot") for n in names))

    assert on_both(scenario, tmp_path)[PKGS[1]] == (0, True, True)


# ------------------------------------------------------------ the runtime


def runtime_graph(P, n_nodes, n_links, seed):
    from tests.conftest import make_random_hypergraph

    imp = importlib.import_module
    kw = {}
    if P == PKGS[1]:
        kw["query"] = imp(f"{P}.core.config").QueryConfig(device="cpu")
    g = imp(f"{P}.core.graph").HyperGraph(
        imp(f"{P}.core.config").HGConfiguration(**kw))
    make_random_hypergraph(g, n_nodes=n_nodes, n_links=n_links, seed=seed)
    return g


def serve(P, g, **cfg):
    """A manual runtime over ``g``; returns it after construction."""
    serve_mod = importlib.import_module(f"{P}.serve")
    if P == PKGS[1]:
        cfg["device"] = "cpu"
    return serve_mod.ServeRuntime(g, serve_mod.ServeConfig(manual=True,
                                                           **cfg))


def run(rt, submit):
    fut = submit(rt)
    while rt.step(drain=True):
        pass
    return fut.result(timeout=0)


def test_serve_runtime_warm_start_skips_compiles(tmp_path):
    """A fresh port runtime over a populated cache reaches its first
    dispatch without building a plan: the first bucket's fused plan is a
    disk hit, the other buckets' memory hits, and ``prewarm_counts``
    shows zero plans built. Each runtime is over a fresh graph built the
    same way (so no plan is memoized on its snapshot), and the answers
    equal the cold runtime's and the reference's."""
    cfg = dict(buckets=(4, 8), max_linger_s=0.001, top_r=8,
               aot_cache_dir=str(tmp_path), prewarm_hops=(2, 3))
    P = PKGS[1]
    got = []
    for _ in range(2):
        g = runtime_graph(P, 60, 120, 5)
        rt = serve(P, g, **cfg)
        res = (run(rt, lambda r: r.submit_bfs(3, max_hops=2)),
               run(rt, lambda r: r.submit_bfs(3, max_hops=3)),
               run(rt, lambda r: r.submit_pattern([3])))
        got.append((rt.stats_snapshot()["aot"], dict(rt.executor.prewarm_counts),
                    [(x.count, x.matches.tolist()) for x in res]))
        rt.close()
        g.close()
    (cold, cold_counts, cold_res), (warm, warm_counts, warm_res) = got
    assert cold["misses"] == 1 and cold["puts"] == 1
    assert cold["mem_hits"] == 1 and cold_counts == {"built": 1,
                                                      "from_cache": 1}
    assert warm["misses"] == 0, warm
    assert warm["disk_hits"] == 1 and warm["hits"] == 2, warm
    assert warm_counts == {"built": 0, "from_cache": 2}
    assert warm_res == cold_res
    g = runtime_graph(PKGS[0], 60, 120, 5)
    rt = serve(PKGS[0], g, buckets=(4, 8), max_linger_s=0.001, top_r=8,
               prewarm_aot=False)
    ref = [run(rt, lambda r: r.submit_bfs(3, max_hops=2)),
           run(rt, lambda r: r.submit_bfs(3, max_hops=3)),
           run(rt, lambda r: r.submit_pattern([3]))]
    rt.close()
    g.close()
    assert warm_res == [(x.count, np.asarray(x.matches).tolist())
                        for x in ref]


def test_aot_dispatch_results_match_plain_jit(tmp_path):
    """Answers with the cache equal answers without it, on the port, and
    equal the reference's runtime on the same graph."""
    res = {}
    for pkg, dir_ in ((PKGS[1], str(tmp_path)), (PKGS[1], None),
                      (PKGS[0], None)):
        g = runtime_graph(pkg, 70, 140, 6)
        rt = serve(pkg, g, buckets=(4,), max_linger_s=0.001, top_r=8,
                   aot_cache_dir=dir_,
                   prewarm_aot=dir_ is not None or pkg == PKGS[1])
        r = run(rt, lambda r: r.submit_bfs(7, max_hops=2))
        res[(pkg, dir_)] = (r.count, tuple(np.asarray(r.matches).tolist()))
        assert ("aot" in rt.stats_snapshot()) == (dir_ is not None)
        rt.close()
        g.close()
    assert len(set(res.values())) == 1, res


def test_unwritable_cache_directory_raises_from_the_constructor(tmp_path):
    """A cache root that cannot be made raises from ``ServeRuntime``;
    nothing serves without the cache the caller asked for."""
    blocker = tmp_path / "a-file"
    blocker.write_bytes(b"not a directory")
    g = runtime_graph(PKGS[1], 20, 30, 1)
    try:
        with pytest.raises(OSError):
            serve(PKGS[1], g, buckets=(4,),
                  aot_cache_dir=str(blocker / "cache"))
    finally:
        g.close()


def test_default_cache_follows_the_environment(tmp_path, monkeypatch):
    """``$HG_AOT_CACHE`` opens the cache when the config names none, as
    on the reference; unset, there is no cache."""
    from hypergraphdb_tpu_torch.ops import aot_cache as ac

    monkeypatch.delenv(ac.CACHE_ENV, raising=False)
    assert ac.default_cache(device="cpu") is None
    g = runtime_graph(PKGS[1], 20, 30, 1)
    try:
        assert serve(PKGS[1], g, buckets=(4,)).executor.aot is None
        monkeypatch.setenv(ac.CACHE_ENV, str(tmp_path))
        rt = serve(PKGS[1], g, buckets=(4,))
        assert rt.executor.aot is not None
        assert rt.executor.aot.dir.startswith(str(tmp_path))
        assert rt.stats_snapshot()["aot"]["puts"] == 1
        rt.close()
    finally:
        g.close()


def test_env_fingerprint_names_torch_cuda_device_and_sources():
    import torch

    from hypergraphdb_tpu_torch.ops import aot_cache as ac

    fp = ac.env_fingerprint("cpu")
    assert fp.startswith(f"torch{torch.__version__}".replace("+", "_"))
    assert "_cpu_" in fp and fp.endswith(ac.csrc_hash()[:12])
    assert all(ch.isalnum() or ch in "._-" for ch in fp)


@pytest.mark.parametrize("which", ["pull", "fused"])
def test_plans_round_trip_the_cache(tmp_path, which):
    """The pull plans and the fused plan go through the cache array for
    array: a fresh cache over a fresh copy of the snapshot reads them
    from disk (zero misses) and they equal a build."""
    from dataclasses import asdict

    from hypergraphdb_tpu_torch.ops import aot_cache as ac
    from hypergraphdb_tpu_torch.ops import ellbfs, fused_bfs
    from hypergraphdb_tpu_torch.ops.snapshot import CSRSnapshot

    g = runtime_graph(PKGS[1], 80, 160, 4)
    snap = CSRSnapshot.pack(g)
    g.close()
    fp = ellbfs.snapshot_fingerprint(snap)
    get, build = {
        "pull": (ellbfs.plans_for, ellbfs.build_pull_plans),
        "fused": (fused_bfs.fused_plans_for, fused_bfs.build_fused_plan),
    }[which]

    def copy():
        return CSRSnapshot(**{k: v for k, v in vars(snap).items()
                              if not k.startswith("_")})

    c1 = ac.AOTCache(str(tmp_path), content_key=fp, device="cpu")
    get(copy(), aot=c1)
    c2 = ac.AOTCache(str(tmp_path), content_key=fp, device="cpu")
    fresh = copy()
    got = get(fresh, aot=c2)
    assert c2.stats.misses == 0 and c2.stats.disk_hits == 1
    assert get(fresh) is got               # memoized on the snapshot
    want = build(snap)

    def flat(p):
        return {k: (v if not isinstance(v, (tuple, list)) else list(v))
                for k, v in asdict(p).items()}

    a, b = flat(got), flat(want)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_equal(a[k], b[k])
