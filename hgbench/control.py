"""The benchmark's controls: the plain reference put in the program's
place with one guarantee of the configuration broken (the configuration's
``control``, ``controls/<name>.py``), judged by the cell's runner with the
same comparison a run makes (the runner's ``control``), at the cell's own
size. Each must come out not correct.

    python3 hgbench/control.py --workload <cell> --seeds 1,2,3

prints one JSON line a seed: ``correct`` and the numbers compared, each
beside its limit, as a run prints them. It needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from hgbench import spec  # noqa: E402


def control(cell: spec.Cell, seed: int) -> list:
    """(name, number, limit) of each number the control's run compares."""
    return cell.runner().control(cell, seed, cell.control().answer)


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="hgbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    a = p.parse_args(argv)
    cell = spec.load_cell(a.workload)
    for s in (int(x) for x in a.seeds.split(",")):
        checks = control(cell, s)
        print(json.dumps({
            "workload": a.workload, "seed": s,
            "correct": all(v <= lim for _, v, lim in checks),
            "checks": {n: {"value": v, "limit": lim}
                       for n, v, lim in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
