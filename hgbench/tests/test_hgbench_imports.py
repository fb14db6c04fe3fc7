"""The import check: a run loads no module whose top-level name is
``jax``, ``jaxlib``, ``flax`` or the JAX package's, compared whole (the
port's name begins with the JAX package's)."""

import ast
import subprocess
import sys
from pathlib import Path

from hgbench import harness, spec


def test_names_are_compared_whole():
    assert harness.forbidden_modules(["hypergraphdb_tpu_torch.ops.ellbfs",
                                      "numpy", "hgbench.runners"]) == []
    assert harness.forbidden_modules(["jax.numpy", "hypergraphdb_tpu.ops",
                                      "flax", "jaxlib.xla_client"]) == [
        "flax", "hypergraphdb_tpu", "jax", "jaxlib"]


def test_sources_import_no_jax():
    for path in Path(spec.HERE).rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in harness.FORBIDDEN, (path, n)


def test_a_run_loads_none():
    """Everything a run imports, imported in a fresh interpreter."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from hgbench import harness, spec, control, trace\n"
        "from hgbench.roofline import k2\n"
        "for kind in ('runners', 'systems', 'controls', 'metrics'):\n"
        "    for p in (spec.HERE / kind).glob('*.py'):\n"
        "        spec.load_module(p)\n"
        "from hypergraphdb_tpu_torch.ops import ellbfs, fused_bfs\n"
        "from hypergraphdb_tpu_torch.core.graph import HyperGraph\n"
        "from hypergraphdb_tpu_torch.serve import ServeRuntime\n"
        "print(harness.forbidden_modules())\n" % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
