"""The benchmark of ``hypergraphdb_tpu_torch`` on one NVIDIA H100.

``python3 hgbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` from the root of a
checkout and prints one JSON result line. Everything a cell names is
found by name (``spec.py``): configurations (``configs/<name>.json``, with
the generator, system and control they name: ``data/``, ``systems/``,
``controls/``), traffic mixes (``mixes/<name>.json``, with the runner they
name: ``runners/``) and per-layer metric readers (``metrics/<name>.py``).
The generators, the roofline arithmetic (``roofline/``), the comparisons
(``judge.py``) and the plain reference (``reference/``) are frozen here so
that a change to the program cannot move the yardstick.
"""
