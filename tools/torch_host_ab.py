"""Host-side A/B of two checkouts of the PyTorch port: the open path and
ingest, the work that no kernel does.

    python3 tools/torch_host_ab.py TREE [ENTITIES LINKS OPENS]

imports ``hypergraphdb_tpu_torch`` from the checkout at ``TREE`` and
prints one JSON line: the median and least milliseconds of ``OPENS``
in-memory ``HyperGraph`` opens; the seconds of bench c6's graph (the
``ENTITIES`` int values, then ``LINKS`` random entity pairs in chunks of
100,000, through ``bulk_import``); 20,000 ``add`` and 10,000 ``add_link``
after it; and ``calls``, the Python calls a 150,000-atom ``bulk_import``
makes under ``cProfile`` (the same in two checkouts that do the same
work). Defaults: 200,000 entities, 400,000 links, 200 opens. Run the two
checkouts alternately, several times each, on one machine: the host's
speed drifts between processes.
"""

import cProfile
import gc
import json
import pstats
import statistics
import sys
import time

root = sys.argv[1]
n_ent, n_links, n_open = (int(x) for x in (sys.argv[2:5] or
                                           (200_000, 400_000, 200)))
sys.path.insert(0, root)
import numpy as np  # noqa: E402

from hypergraphdb_tpu_torch.core.graph import HyperGraph  # noqa: E402


def c6_graph(g, n_ent: int, n_links: int, seed: int = 1) -> int:
    r = np.random.default_rng(seed)
    e0 = int(g.bulk_import(values=np.arange(n_ent).tolist())[0])
    chunk = 100_000
    for st in range(0, n_links, chunk):
        m = min(chunk, n_links - st)
        subj = r.integers(0, n_ent, size=m)
        obj = r.integers(0, n_ent, size=m)
        g.bulk_import(values=[int(st + x) for x in range(m)],
                      target_lists=[[e0 + int(a), e0 + int(b)]
                                    for a, b in zip(subj, obj)])
    return e0


out = {"tree": root}
ts = []
for _ in range(n_open):
    t0 = time.perf_counter()
    g = HyperGraph()
    ts.append(time.perf_counter() - t0)
    g.close()
out["open_ms_median"] = statistics.median(ts) * 1e3
out["open_ms_min"] = min(ts) * 1e3
g = HyperGraph()
out["committed_at_open"] = getattr(g.txman, "committed", None)
out["indexes_at_open"] = len(g.store.index_names())
t0 = time.perf_counter()
c6_graph(g, n_ent, n_links)
out["bulk_import_s"] = time.perf_counter() - t0
t0 = time.perf_counter()
hs = [int(g.add(i)) for i in range(20_000)]
out["add_20k_s"] = time.perf_counter() - t0
t0 = time.perf_counter()
for i in range(0, 20_000, 2):
    g.add_link((hs[i], hs[i + 1]), value=i)
out["add_link_10k_s"] = time.perf_counter() - t0
out["gc_objects"] = len(gc.get_objects())
g.close()
g = HyperGraph()
prof = cProfile.Profile()
prof.enable()
c6_graph(g, 50_000, 100_000)
prof.disable()
out["calls"] = pstats.Stats(prof).total_calls
g.close()
print(json.dumps(out))
