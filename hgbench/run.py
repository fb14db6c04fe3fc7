"""Run one cell of the benchmark from the root of a checkout:

    python3 hgbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

See ``hgbench/harness.py`` for what it prints.
"""

import os
import sys
import time


def _process_age_s() -> float:
    """Seconds since this process started, from ``/proc`` (0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age_s()

if __name__ == "__main__":
    # a library that would load JAX by itself stays off it
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # the graph is drawn from the seed, so a plan cache would never hit
    # across runs: the program keeps its plans in memory only
    for name in ("HG_PLAN_CACHE", "HG_AOT_CACHE", "HG_PERF_BASELINE"):
        os.environ.pop(name, None)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from hgbench import harness

    sys.exit(harness.main(sys.argv[1:], T_START))
