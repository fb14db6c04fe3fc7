"""Does ``chip_smoke.py``'s phase 23 child move phase 22's figures? Both
phases are host-bound, and the smoke runs the child beside phase 22.

    python3 tools/torch_phase_contention.py

On one CUDA card, from the root of a checkout: the kernels' build and
phase 14 (whose in-memory atoms/s phase 22 prints beside its own), then
C1 phase 22 alone, C2 phase 22 with phase 23's child beside it, C3 phase
22 alone, C4 phase 23's child alone. Each phase prints its own figures
and fails the run as in the smoke; a ``contention`` line sums up the
phase seconds. Compare C2 with C1 and C3 (phase 22) and with C4 (phase
23) within one run: the host's speed drifts from one run to the next.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("torch_phase_contention: CUDA is not available")
s = cs.Smoke(torch, cs._card())
cs.phase_build(s)
s.c5_memory = cs.phase_ingest(s)
seconds = {}


def durable(tag: str) -> None:
    t0 = time.perf_counter()
    cs.phase_durable(s)
    seconds[f"{tag} phase 22"] = round(time.perf_counter() - t0, 1)


durable("C1 alone")
child = cs.start_peer_child(s)
try:
    durable("C2 beside")
except BaseException:
    child.kill()
    child.communicate()
    raise
seconds["C2 beside phase 23"] = round(
    cs.finish_peer_child(s, child)["phase_s"], 1)
durable("C3 alone")
seconds["C4 alone phase 23"] = round(
    cs.finish_peer_child(s, cs.start_peer_child(s))["phase_s"], 1)
s.log("contention " + json.dumps(seconds))
