"""``chip_smoke.py``'s phase 24 (the replicated serving tier) alone, for
iterating on it without the whole smoke.

    python3 tools/torch_replica_tier.py [--child]

On one CUDA card, from the root of a checkout: the kernels' build, then
phase 24 in this process at the smoke's size (P, two replica processes,
the door, the stream, R2 killed and resumed, the answers). ``--child``
then starts phases 23 and 24 in their two children together, as the
smoke does beside phase 22, and checks their reports. Each phase prints
its own figures and fails the run as in the smoke.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("torch_replica_tier: CUDA is not available")
s = cs.Smoke(torch, cs._card())
cs.phase_build(s)
seconds = {}
t0 = time.perf_counter()
rec = cs.phase_replica(s)
seconds["phase 24 alone"] = round(time.perf_counter() - t0, 1)
if "--child" in sys.argv[1:]:
    t0 = time.perf_counter()
    rec = cs.finish_children(s, {w: cs.start_peer_child(s, w)
                                 for w in cs.P_PHASES})
    seconds["children (23, 24)"] = round(time.perf_counter() - t0, 1)
    seconds["child phase 23"] = round(rec["peer"]["phase_s"], 1)
    seconds["child phase 24"] = round(rec["replica"]["phase_s"], 1)
s.log("replica tier " + json.dumps(seconds))
