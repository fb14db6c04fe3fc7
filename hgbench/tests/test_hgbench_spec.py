"""A configuration, a mix and a per-layer metric added as new files, with
new entries in ``BENCHMARK.json``, are picked up with no edit of the
harness, generator, runner and control included; the committed file keeps
the contract's shape."""

import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from hgbench import harness, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


RING = """\"\"\"A ring of entities, each link joining two neighbours.\"\"\"
import numpy as np
from hgbench import traffic


def draw(cfg, seed):
    n = cfg["n_entities"]
    order = traffic.stream(seed, traffic.GRAPH).permutation(n)
    N = 1 + 2 * n
    tgt_offsets = np.zeros(N + 1, dtype=np.int64)
    tgt_offsets[1 + n + 1:] = 2 * np.arange(1, n + 1)
    flat = 1 + np.stack([order, np.roll(order, 1)], 1).reshape(-1)
    is_link = np.zeros(N, dtype=bool)
    is_link[1 + n:] = True
    return {"type_of": np.zeros(N, np.int32), "is_link": is_link,
            "tgt_offsets": tgt_offsets, "tgt_flat": flat.astype(np.int32),
            "value_rank": np.zeros(N, np.uint64), "n_atoms": N,
            "entities": (1, 1 + n), "links": (1 + n, N)}
"""

ONCE = """\"\"\"One BFS batch, judged lane by lane.\"\"\"
from hgbench import judge, traffic
from hgbench.reference import bfs as ref_bfs


def run(r):
    from hypergraphdb_tpu_torch.ops import ellbfs

    cfg, mix = r.cell.config, r.cell.mix
    t = r.cell.generator().draw(cfg, r.seed)
    snap = r.cell.system().build(cfg, t)
    r.setup_done()
    seeds = traffic.batch_seeds(r.seed, 0, mix["batch"], *t["entities"])
    with r.tracer.window(r.sync):
        res = ellbfs.bfs_pull(snap, seeds, mix["hops"],
                              k_block=mix["batch"], device=r.dev)
    r.e2e["traversals_per_s"] = float(mix["batch"])
    r.counters["reached"] = int(res.reach_counts.sum())
    r.attempted = mix["batch"]
    want = ref_bfs.answer(t, seeds, mix["hops"])
    r.checks += judge.lanes(res.reach_counts.numpy(), res.edges_touched,
                            want.counts, want.edges)


def control(cell, seed, answer):
    t = cell.generator().draw(cell.config, seed)
    seeds = traffic.batch_seeds(seed, 0, cell.mix["batch"], *t["entities"])
    got = answer(t, seeds, cell.mix["hops"])
    want = ref_bfs.answer(t, seeds, cell.mix["hops"])
    return judge.lanes(got.counts, got.edges, want.counts, want.edges)
"""

SHORT = """\"\"\"The reference stopping a hop short.\"\"\"
from hgbench.reference import bfs as ref_bfs


def answer(tables, seeds, hops):
    return ref_bfs.answer(tables, seeds, hops - 1)
"""


def _tree(tmp_path):
    root = Path(spec.ROOT)
    shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(root / "hgbench", tmp_path / "hgbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path / "hgbench"


def _digest(here):
    return {p.relative_to(here): p.read_bytes() for p in here.rglob("*")
            if p.is_file()}


def test_new_files_are_found_by_name(tmp_path):
    """A configuration with a generator and a control of its own, a mix
    with a runner of its own, and a per-layer metric, each a new file with
    new entries in BENCHMARK.json: the cell runs through the harness (on
    the CPU, the look for a card skipped) and its control through the
    control's command, and no file that was there changes."""
    here = _tree(tmp_path)
    before = _digest(here)
    (here / "data" / "ring.py").write_text(RING)
    (here / "runners" / "bfs_once.py").write_text(ONCE)
    (here / "controls" / "hop_short.py").write_text(SHORT)
    (here / "configs" / "ring-500.json").write_text(json.dumps({
        "name": "ring-500", "generator": "hgbench/data/ring.py",
        "system": "snapshot", "control": "hop_short",
        "n_entities": 500}))
    (here / "mixes" / "once-k32.json").write_text(json.dumps({
        "runner": "bfs_once", "batch": 32, "hops": 3}))
    (here / "metrics" / "ring.reached.py").write_text(
        "def read(ctx):\n    return ctx.counters.get('reached')\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ring-500", "source": "a test",
                             "file": "hgbench/configs/ring-500.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "ring-500.once-k32",
                               "config": "ring-500", "traffic": "once-k32",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "ring.reached", "unit": "atoms",
                               "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "traversals_per_s",
                               "workloads": ["ring-500.once-k32"]})
    bench["end_to_end"][0]["workloads"].append("ring-500.once-k32")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("ring-500.once-k32", root=tmp_path)
    assert cell.config["n_entities"] == 500 and cell.mix["hops"] == 3
    assert [m["name"] for m in cell.end_to_end] == ["traversals_per_s",
                                                    "setup_s"]
    import torch

    cpu = torch.device("cpu")
    args = SimpleNamespace(seed=2**31 + 7, seconds=1.0, trace=0)
    out = harness.drive(cell, args, cpu, time.perf_counter())
    assert out["correct"] and out["attempted"] == 32, out
    assert set(out["metrics"]) == {"traversals_per_s", "setup_s"}
    # seven atoms reached from each seed in three hops round the ring
    got = harness.drive(cell, SimpleNamespace(seed=3, seconds=1.0, trace=1),
                        cpu, time.perf_counter())
    assert got["metrics"] == {"ring.reached": {"value": 32.0 * 7,
                                               "unit": "atoms"}}
    # the control through the command, as the committed cells' are run
    ctl = subprocess.run(
        [sys.executable, "hgbench/control.py", "--workload",
         "ring-500.once-k32", "--seeds", "1,2"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert ctl.returncode == 0, ctl.stderr[-2000:]
    for line in ctl.stdout.strip().splitlines():
        assert json.loads(line)["correct"] is False
    # the files that were there are as they were, and the committed
    # cells still load
    after = _digest(here)
    assert {p: after[p] for p in before} == before
    assert spec.load_cell("serve-600k.bfs2-closed2048",
                          root=tmp_path).config["n_entities"] == 200000


def test_benchmark_file_shape():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["hgbench"]
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("hgbench/")
        assert (spec.ROOT / c["file"]).exists()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert spec.mix_path(w["traffic"]).exists()
        cell = spec.load_cell(w["name"])
        for kind in ("generator", "system", "control", "runner"):
            assert getattr(cell, kind)() is not None
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert spec.reader_path(m["name"]).exists()
        for w in m.get("workloads", []):
            moved = next(e for e in bench["end_to_end"]
                         if e["name"] == m["moves"])
            assert spec.applies(moved, w)
    for n in (names + [w["name"] for w in bench["workloads"]]
              + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]):
        assert NAME.match(n), n


@pytest.mark.parametrize("name", ["missing.cell"])
def test_unknown_cell_is_refused(name):
    with pytest.raises(KeyError):
        spec.load_cell(name)
