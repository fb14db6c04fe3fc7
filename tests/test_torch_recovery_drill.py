"""The recovery drill on the port: kill ingest at each commit crash point,
reopen, replay, and compare with a run that never crashed.

The reference's ``tests/test_recovery_drill.py``. A child process that
imports only the port ingests a fixed op stream over the native backend
and arms an ``InjectedCrash`` at ``tx.commit.pre`` or ``tx.commit.apply``
for the k-th op; the crash escapes every ``except Exception`` and the
child ``os._exit``s mid-commit, like a kill. The parent reopens the store
with the port, replays exactly the ops whose markers are missing, and
compares the canonical content (values, and link targets by value) with
the reference's uncrashed run of the same stream. Tolerance: exact
equality.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_OPS = 30


def build_ops():
    """Nodes n0..; every third op links the two nodes before it."""
    ops = []
    nodes = 0
    for i in range(N_OPS):
        if i % 3 == 2 and nodes >= 2:
            ops.append(("link", f"l{i}", f"n{i - 2}", f"n{i - 1}"))
        else:
            ops.append(("node", f"n{i}", None, None))
            nodes += 1
    return ops


def apply_op(g, handles, op):
    kind, marker, ta, tb = op
    if kind == "node":
        handles[marker] = int(g.add(marker))
    else:
        handles[marker] = int(g.add_link((handles[ta], handles[tb]),
                                         value=marker))


def open_native(pkg, loc):
    cfg = importlib.import_module(f"{pkg}.core.config").HGConfiguration(
        store_backend="native", location=loc)
    return importlib.import_module(f"{pkg}.core.graph").HyperGraph(cfg)


def lookup(g, q, marker):
    found = q.find_all(g, q.value(marker))
    return int(found[0]) if found else None


def replay_missing(g, q, ops):
    """Apply exactly the ops whose marker is absent; how many ran."""
    handles = {}
    replayed = 0
    for op in ops:
        h = lookup(g, q, op[1])
        if h is not None:
            handles[op[1]] = h
            continue
        apply_op(g, handles, op)
        replayed += 1
    return replayed


def canonical(g, q):
    """The content by value, free of handles."""
    out = set()
    for kind, marker, _, _ in build_ops():
        h = lookup(g, q, marker)
        assert h is not None, f"marker {marker} missing"
        if kind == "node":
            out.add(("node", marker))
        else:
            out.add(("link", marker,
                     tuple(g.get(t) for t in g.get(h).targets)))
    return out


CHILD = """
import os, sys
sys.modules["jax"] = None
sys.modules["hypergraphdb_tpu"] = None
sys.path.insert(0, {root!r})
sys.path.insert(0, {testdir!r})
from hypergraphdb_tpu_torch.fault import InjectedCrash, global_faults
from test_torch_recovery_drill import apply_op, build_ops, open_native

g = open_native("hypergraphdb_tpu_torch", {loc!r})
f = global_faults()
handles = {{}}
try:
    for i, op in enumerate(build_ops()):
        if i == {k}:
            f.enable(seed=0)
            f.arm({point!r}, at={{1}}, error=InjectedCrash)
        apply_op(g, handles, op)
    os._exit(7)
except InjectedCrash:
    os._exit(9)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's uncrashed run: its canonical content."""
    q = importlib.import_module("hypergraphdb_tpu.query.dsl")
    g = open_native("hypergraphdb_tpu",
                    str(tmp_path_factory.mktemp("ref") / "db"))
    handles = {}
    for op in build_ops():
        apply_op(g, handles, op)
    ref = canonical(g, q)
    g.close()
    return ref


@pytest.mark.parametrize("point", ["tx.commit.pre", "tx.commit.apply"])
@pytest.mark.parametrize("k", [3, 17])
def test_kill_reopen_replay_differential_equal(tmp_path, reference, point,
                                               k):
    loc = str(tmp_path / "db")
    code = textwrap.dedent(CHILD).format(
        root=ROOT, testdir=os.path.join(ROOT, "tests"), loc=loc, k=k,
        point=point)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          timeout=240)
    assert proc.returncode == 9, "the child did not die at the crash point"

    q = importlib.import_module("hypergraphdb_tpu_torch.query.dsl")
    g = open_native("hypergraphdb_tpu_torch", loc)
    ops = build_ops()
    assert lookup(g, q, ops[k][1]) is None       # the killed op is gone
    for op in ops[:k]:
        assert lookup(g, q, op[1]) is not None   # every earlier op stayed
    assert replay_missing(g, q, ops) == N_OPS - k
    assert canonical(g, q) == reference
    g.close()
    # the replay is durable too
    g2 = open_native("hypergraphdb_tpu_torch", loc)
    assert canonical(g2, q) == reference
    g2.close()
