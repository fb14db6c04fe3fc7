"""The command's contract where it cannot run: without a card, and in a
checkout that holds only ``BENCHMARK.json`` and the benchmark's files, it
exits with another code than 0 and prints no result. On the card, each
cell runs a short window and comes out correct."""

import json
import shutil
import subprocess
import sys

import pytest

from hgbench import spec


def _run(cwd, *args, env=None, timeout=600):
    return subprocess.run(
        [sys.executable, "hgbench/run.py", *args], cwd=cwd,
        capture_output=True, text=True, timeout=timeout, env=env)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: this test is for a machine without")
    out = _run(spec.ROOT, "--workload", "dbpedia-10m.bfs3-k4096", "--seed",
               "1", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "hgbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, "--workload", "serve-600k.bfs2-closed2048",
               "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_unknown_workload_gives_no_result():
    out = _run(spec.ROOT, "--workload", "no.such-cell", "--seed", "1",
               "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_cell_runs_correct_on_the_card(card, name):
    out = _run(spec.ROOT, "--workload", name, "--seed", str(2**31 + 17),
               "--seconds", "3", "--trace", "0", timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    cell = spec.load_cell(name)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
