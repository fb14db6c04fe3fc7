"""Find a cell's configuration, traffic mix and code by name.

Everything that belongs to one configuration, one mix or one per-layer
metric sits in a file of its own under this directory; adding one takes
new files and new entries in ``BENCHMARK.json``, never an edit here.

- ``BENCHMARK.json``'s ``configs[].file``: a configuration. Its
  ``generator`` is the path of the module whose ``draw(cfg, seed)`` makes
  its tables, its ``system`` names ``systems/<system>.py`` (how the
  program is built from the tables) and its ``control`` names
  ``controls/<control>.py`` (the reference with one guarantee broken).
- ``mixes/<traffic>.json``: a traffic mix, parameters only. Its
  ``runner`` names ``runners/<runner>.py``, whose ``run(run)`` drives a
  window and whose ``control(cell, seed, answer)`` judges the control.
- ``metrics/<metric>.py``: a per-layer metric's ``read(ctx)``.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    """One ``workloads`` entry with what it names, loaded."""

    name: str
    traffic: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    #: the checkout the cell's files were found in
    root: Path = ROOT

    @property
    def here(self) -> Path:
        return self.root / HERE.name

    def module(self, kind: str, name: str):
        """``<kind>/<name>.py`` of the benchmark."""
        return load_module(self.here / kind / f"{name}.py")

    def generator(self):
        return load_module(self.root / self.config["generator"])

    def system(self):
        return self.module("systems", self.config["system"])

    def control(self):
        return self.module("controls", self.config["control"])

    def runner(self):
        return self.module("runners", self.mix["runner"])


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config_path(bench: dict, name: str, root: Path = ROOT) -> Path:
    for c in bench["configs"]:
        if c["name"] == name:
            return root / c["file"]
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def mix_path(traffic: str, here: Path = HERE) -> Path:
    return here / "mixes" / f"{traffic}.json"


def reader_path(metric: str, here: Path = HERE) -> Path:
    return here / "metrics" / f"{metric}.py"


def applies(metric: dict, cell: str) -> bool:
    """Whether ``metric`` is reported in ``cell``: every cell when it has
    no ``workloads`` list."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None,
              root: Path = ROOT) -> Cell:
    bench = load_benchmark(root) if bench is None else bench
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    return Cell(
        name=name, traffic=w["traffic"],
        chips=int(w["chips"]),
        config=_json(config_path(bench, w["config"], root)),
        mix=_json(mix_path(w["traffic"], root / HERE.name)),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
        root=root,
    )


_LOADED: dict = {}


def load_module(path: Path):
    """The module in the file ``path``, loaded once a process."""
    path = Path(path).resolve()
    if path not in _LOADED:
        if not path.is_file():
            raise KeyError(f"no file {path}")
        name = "hgbench_" + re.sub(r"\W", "_", str(path.relative_to(
            path.parents[1])).removesuffix(".py"))
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def load_reader(metric: str, here: Path = HERE):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    return load_module(reader_path(metric, here)).read
