"""The query compiler's device plans in the port, on the CPU: with the
gate open (``device_min_batch = 0``, ``QueryConfig.device = "cpu"``)
``IntersectPlan`` takes its device branch (K3's wrapper called once a
run, its plain version answering) and ``DeviceValueConjPlan`` runs on the
value pushdown's CPU twin; both equal the reference's answers with its
gate open, the host plans, and numpy. Under incremental mode the value
plan corrects the base with the memtable. Nothing falls back: without
CUDA the default device raises, a failing K3 call propagates, and a query
device that is not the manager's raises. Tolerance: exact equality."""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_query import PKGS, mod, new_graph

from hypergraphdb_tpu_torch.ops import membership


@dataclasses.dataclass(frozen=True)
class Tag:
    label: str


def build(pkg, **query):
    """Two hubs with many shared links, int and string link values, a
    typed tail; ``(graph, dsl, hubs)``."""
    g = new_graph(pkg, **query)
    r = np.random.default_rng(9)
    ents = g.bulk_import(values=list(range(60)))
    e0 = int(ents[0])
    pairs = r.integers(0, 6, size=(900, 2))
    g.bulk_import(values=[int(v) for v in r.integers(0, 40, 900)],
                  target_lists=[[e0 + int(a), e0 + int(b)] for a, b in pairs])
    g.bulk_import(values=[f"s{int(v):03d}" for v in r.integers(0, 30, 300)],
                  target_lists=[[e0 + int(a), e0 + int(b)]
                                for a, b in r.integers(0, 6, (300, 2))])
    for i in range(20):
        g.add_link((e0, e0 + 1), value=Tag(f"t{i % 3}"))
    return g, mod(pkg, "query.dsl"), (e0, e0 + 1, e0 + 2)


def conditions(hg, hubs):
    a, b, c = hubs
    return [
        hg.and_(hg.incident(a), hg.incident(b)),
        hg.and_(hg.incident(a), hg.incident(b), hg.incident(c)),
        hg.and_(hg.type_("int"), hg.incident(a), hg.incident(b)),
        hg.and_(hg.incident(a), hg.incident(b), hg.eq(7)),
        hg.and_(hg.incident(a), hg.gte(10), hg.lt(20)),
        hg.and_(hg.incident(a), hg.gt(10), hg.lte(20), hg.type_("int")),
        hg.and_(hg.incident(a), hg.incident(c), hg.lt(5)),
        hg.and_(hg.incident(b), hg.gte("s010"), hg.lt("s020")),
        hg.and_(hg.incident(a), hg.eq("s007")),
        hg.and_(hg.incident(a), hg.gte(3), hg.lt("s020")),   # mixed kinds
    ]


@pytest.fixture
def k3_calls(monkeypatch):
    """Calls of K3's ragged entry (the one ``device_intersect_sorted``
    reaches): on the CPU its plain version runs and the launch count stays
    0, so the device branch is seen through the calls."""
    calls = []
    real = membership.membership_mask_ragged

    def spy(*a, **k):
        calls.append(a[0].device.type)
        return real(*a, **k)

    monkeypatch.setattr(membership, "membership_mask_ragged", spy)
    return calls


def answers(g, hg, hubs):
    return [g.find_all(c) for c in conditions(hg, hubs)]


def test_device_plans_on_the_cpu_equal_the_reference_and_the_host(k3_calls):
    ref, ref_hg, hubs = build(PKGS[0], device_min_batch=0)
    port, port_hg, port_hubs = build(PKGS[1], device_min_batch=0)
    assert port_hubs == hubs
    qc = mod(PKGS[1], "query.compiler")
    plans = [qc.compile_query(port, c).plan
             for c in conditions(port_hg, hubs)]
    kinds = [type(p).__name__ for p in plans]
    assert kinds[:3] == ["IntersectPlan"] * 3
    assert kinds[3:9] == ["DeviceValueConjPlan"] * 6
    for c, plan in zip(conditions(port_hg, hubs), plans):
        del k3_calls[:]
        launches = membership.membership_mask.launches
        got = port.find_all(c)
        # the mixed-kind window runs its host plan: an intersection, whose
        # device branch calls K3 too
        inter = plan.fallback if plan is plans[-1] else plan
        want_calls = int(isinstance(inter, qc.IntersectPlan)
                         and all(len(ch.run(port)) for ch in inter.children))
        assert k3_calls == ["cpu"] * want_calls, c
        assert membership.membership_mask.launches == launches
        assert got == ref.find_all(
            mod(PKGS[0], "query.serialize").from_json(
                mod(PKGS[1], "query.serialize").to_json(c)))
    on_device = answers(port, port_hg, hubs)
    port.config.query.device_min_batch = 1 << 60
    del k3_calls[:]
    assert answers(port, port_hg, hubs) == on_device
    assert k3_calls == []
    ref.close()
    port.close()


def test_value_plan_matches_numpy():
    g, hg, (a, b, c) = build(PKGS[1], device_min_batch=0)
    snap = g.snapshot()
    vals = {h: g.get(h).value for h in snap.incidence_row(a).tolist()}
    got = g.find_all(hg.and_(hg.incident(a), hg.gte(10), hg.lt(20)))
    want = sorted(h for h, v in vals.items()
                  if isinstance(v, int) and not isinstance(v, bool)
                  and 10 <= v < 20)
    assert got == want and len(got) > 20
    got = g.find_all(hg.and_(hg.incident(a), hg.gte("s010"),
                             hg.lt("s020")))
    assert got == sorted(h for h, v in vals.items()
                         if isinstance(v, str) and "s010" <= v < "s020")
    g.close()


def test_incremental_mode_corrects_the_base_with_the_memtable(k3_calls):
    out = {}
    for pkg in PKGS:
        g, hg, (a, b, c) = build(pkg, device_min_batch=0)
        kw = {"device": "cpu"} if pkg == PKGS[1] else {}
        g.enable_incremental(background=False, **kw)
        g.bulk_import(values=[15, 16, 40, 7],
                      target_lists=[[a, b], [a, c], [a, b], [a, b]])
        links = g.get_incidence_set(a).array()
        for h in links[::7][:10].tolist():
            g.remove(h)
        g.replace(int(links[1]), 12)
        res = answers(g, hg, (a, b, c))
        g.config.query.device_min_batch = 1 << 60
        host = answers(g, hg, (a, b, c))
        g.close()
        out[pkg] = res, host
    assert out[PKGS[1]] == out[PKGS[0]]
    res, host = out[PKGS[1]]
    assert res == host and any(res)
    assert k3_calls   # the intersections took the device branch


def test_without_cuda_the_default_device_raises():
    """No silent fallback: the default ``QueryConfig.device`` is the card,
    so on a machine without CUDA a device plan raises; host plans and
    building the graph need no card."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device resolves")
    g = mod(PKGS[1], "core.graph").HyperGraph()
    cfg = g.config.query
    assert cfg.device == "cuda"
    hg = mod(PKGS[1], "query.dsl")
    a, b = g.add("a"), g.add("b")
    for i in range(5):
        g.add_link((a, b), value=i)
    small = g.find_all(hg.and_(hg.incident(a), hg.incident(b)))
    assert len(small) == 5                     # under the gate: the host
    cfg.device_min_batch = 0
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        g.find_all(hg.and_(hg.incident(a), hg.incident(b)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        g.find_all(hg.and_(hg.incident(a), hg.gte(1)))
    g.close()


def test_a_failing_k3_call_propagates(monkeypatch):
    """The device branch has no host merge behind it."""
    def broken(*a, **k):
        raise RuntimeError("K3 failed")

    monkeypatch.setattr(membership, "membership_mask_ragged", broken)
    g, hg, (a, b, c) = build(PKGS[1], device_min_batch=0)
    with pytest.raises(RuntimeError, match="K3 failed"):
        g.find_all(hg.and_(hg.incident(a), hg.incident(b)))
    g.config.query.device_min_batch = 1 << 60
    assert g.find_all(hg.and_(hg.incident(a), hg.incident(b)))
    g.close()


def test_a_query_device_other_than_the_managers_raises():
    g, hg, (a, b, c) = build(PKGS[1], device_min_batch=0)
    mgr = g.enable_incremental(background=False, device="cpu")
    assert g.find_all(hg.and_(hg.incident(a), hg.incident(b)))
    mgr.torch_device = torch.device("meta")   # a device of its own
    err = mod(PKGS[1], "core.errors").QueryError
    with pytest.raises(err, match="not the incremental manager's"):
        g.find_all(hg.and_(hg.incident(a), hg.incident(b)))
    with pytest.raises(err, match="not the incremental manager's"):
        g.find_all(hg.and_(hg.incident(a), hg.gte(10)))
    mgr.torch_device = torch.device("cpu")
    g.close()
