"""The replicated serving tier live on the CPU, with the process structure
of ``chip_smoke.py`` phase 24: a primary (a TCP peer and its own serve
runtime) in this process, two replica processes (fresh interpreters that
import only the port, each on a native store, a TCP peer, a
``ReplicaNode`` and its submit server), and a front door over real HTTP
sockets. Open-loop gid-addressed BFS submits run through the door while
the primary streams two c5 batches; one replica is SIGKILLed after the
first batch reached both, and every submit answered inside its deadline
must be a 200; the killed replica restarts on its store by resume (no
new transfer chunk on the primary) and the door re-admits it; both
replicas converge to the primary's content digest; every seed's answer,
pinned to each replica and through the door, equals the primary's host
BFS; the remote paged query from a replica equals the primary's
``find_all``. Every wait is bounded (``wait_s``).

It runs the smoke's own ``phase_replica`` at a small size with
``device="cpu"``, where the wrappers run their plain versions and count no
launch (the smoke holds K1 and K2 to their launches on the card).

Tolerance: exact equality of counts and digests.
"""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[1]


def cpu_smoke():
    import torch

    def expect(ok, what):
        if not ok:
            raise AssertionError(what)

    return SimpleNamespace(torch=torch, dev=torch.device("cpu"),
                           log=lambda msg: print(f"[cpu] {msg}"),
                           expect=expect)


@pytest.fixture
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke

        yield chip_smoke
    finally:
        sys.path.remove(str(ROOT))


def test_door_serves_through_a_replica_kill_and_resume(chip_smoke, tmp_path):
    cell = chip_smoke.replica_cell(
        entities=200, links=400, batch_links=200, tail=16, k=16,
        rate=10.0, store=tmp_path / "stores", wait_s=60.0, kernels=False,
        manager={})
    rec = chip_smoke.phase_replica(cpu_smoke(), cell)
    assert all(r["mode"] == "transfer" for r in rec["b"]["ready"].values())
    served = rec["c"]["served"]
    assert served["sent"] > 0 and served["errors_in_deadline"] == 0
    assert rec["c"]["kill"]["rc"] == -9
    assert rec["c"]["counters"]["router.readmissions"] >= 1
    assert rec["c"]["counters"]["router.submitted"] == served["sent"]
    assert rec["d"]["converge"]["r2"]["wait_s"] is not None
    assert rec["e"]["exit_codes"] == {"r1": 0, "r2": 0, "r2_killed": -9}
    assert rec["e"]["query_rows"] > 0
    assert not (tmp_path / "stores").exists()      # removed at the end
