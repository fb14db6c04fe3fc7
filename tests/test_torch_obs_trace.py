"""The port's flight recorder and query tracing against the reference's
(``tests/test_flight.py``'s ring, dump, incident and SIGTERM cases, and
the query-trace cases of ``tests/test_obs_serving.py``): the same calls
under a fake clock record the same events and span trees in both
packages. The flight cases that drive the serve runtime and the fault
registry wait for those modules. Tolerance: exact equality."""

import os
import signal
import subprocess
import sys

import pytest

from test_torch_query import PKGS, mod, new_graph


def flight(pkg):
    return mod(pkg, "obs.flight")


def test_ring_is_bounded_ordered_and_gated():
    out = []
    for pkg in PKGS:
        fl = flight(pkg).FlightRecorder(capacity=16,
                                        clock=iter(range(10_000)).__next__)
        for i in range(100):
            fl.record("tick", i=i)
        recs = fl.records()
        fl.enabled = False
        fl.record("off")
        off = len(fl.records())
        fl.enabled = True
        for i in range(1000):
            fl.record("tick", i=i)
        out.append((recs, off, len(fl.records()), fl.capacity))
    assert out[1] == out[0]
    recs, off, n, cap = out[1]
    assert [f["i"] for _, _, f in recs] == list(range(84, 100))
    assert off == 16 and n == 16 == cap


def test_dump_and_parse_roundtrip(tmp_path):
    out = []
    for pkg in PKGS:
        fl = flight(pkg).FlightRecorder(capacity=8,
                                        clock=iter(range(100)).__next__)
        fl.record("a", n=1, ok=True, label="x")
        fl.record("b", obj=object())   # non-scalar: stringified
        path = fl.dump(str(tmp_path / f"{pkg}.jsonl"))
        recs = flight(pkg).parse_flight_jsonl(open(path).read())
        with pytest.raises(ValueError):
            flight(pkg).parse_flight_jsonl('{"kind": "missing-t"}')
        out.append([(r["kind"], r.get("n"), r.get("ok"),
                     isinstance(r.get("obj"), str)) for r in recs])
    assert out[1] == out[0] == [("a", 1, True, False),
                                ("b", None, None, True)]


def test_incidents_count_rate_limit_and_need_a_dir(tmp_path):
    out = []
    for pkg in PKGS:
        clk = [0.0]
        d = tmp_path / pkg
        d.mkdir()
        fl = flight(pkg).FlightRecorder(capacity=8, clock=lambda: clk[0],
                                        incident_dir=str(d),
                                        min_dump_interval_s=10.0)
        p1 = fl.incident("boom")
        limited = fl.incident("boom")
        clk[0] = 11.0
        p2 = fl.incident("boom")
        quiet = flight(pkg).FlightRecorder(capacity=8)
        out.append((os.path.basename(p1), limited, os.path.basename(p2),
                    fl.dumps, fl.incidents, fl.last_dump_path == p2,
                    quiet.incident("quiet"), quiet.incidents,
                    quiet.records()[-1][1]))
    assert out[1] == out[0]
    p1, limited, p2, dumps, incidents, last, quiet, n, kind = out[1]
    assert limited is None and p1 != p2 and (dumps, incidents) == (2, 3)
    assert last and quiet is None and n == 1 and kind == "incident"


def test_sigterm_dump_via_subprocess(tmp_path):
    """The opt-in SIGTERM hook in a real subprocess of the port: the
    window is dumped and the process still dies of the signal."""
    code = f"""
import os, signal
from hypergraphdb_tpu_torch.obs.flight import (FlightRecorder,
                                               install_sigterm_dump)

rec = FlightRecorder(incident_dir={str(tmp_path)!r}, min_dump_interval_s=0.0)
rec.record("query.error", attempt=1)
install_sigterm_dump(rec)
os.kill(os.getpid(), signal.SIGTERM)
raise SystemExit("unreachable")
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == -signal.SIGTERM, proc.stderr
    (dump,) = sorted(tmp_path.glob("flight_*_sigterm.jsonl"))
    recs = flight(PKGS[1]).parse_flight_jsonl(dump.read_text())
    assert [r["kind"] for r in recs] == ["query.error", "incident"]
    assert recs[-1]["reason"] == "sigterm"
    assert recs[-1]["signal"] == int(signal.SIGTERM)


def test_sigterm_hook_chains_and_uninstalls(tmp_path):
    fl = flight(PKGS[1])
    rec = fl.FlightRecorder(incident_dir=str(tmp_path),
                            min_dump_interval_s=0.0)
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda n, f: seen.append(n))
    try:
        uninstall = fl.install_sigterm_dump(rec)
        os.kill(os.getpid(), signal.SIGTERM)
        assert seen == [signal.SIGTERM]
        assert rec.incidents == 1 and rec.last_dump_path is not None
        uninstall()
        os.kill(os.getpid(), signal.SIGTERM)
        assert seen == [signal.SIGTERM, signal.SIGTERM]
        assert rec.incidents == 1
    finally:
        signal.signal(signal.SIGTERM, prev)


# ------------------------------------------------------------ query traces


def tree(tr):
    """A finished trace as (name, parent name, attrs) per span, in
    order."""
    by_id = {s.span_id: s.name for s in tr.spans()}
    return [(s.name, by_id.get(s.parent_id), dict(s.attrs),
             s.t1 is not None and s.t1 >= s.t0) for s in tr.spans()]


def traced(pkg, run):
    """``run(graph, dsl, compiler)`` with the process tracer of ``pkg``
    on (a fake clock); the finished query traces."""
    obs = mod(pkg, "obs")
    tracer = obs.tracer()
    tracer.enable(iter(range(1_000_000)).__next__)
    tracer.drain()
    g = new_graph(pkg)
    try:
        result = run(g, mod(pkg, "query.dsl"), mod(pkg, "query.compiler"))
        return result, [tree(t) for t in tracer.drain()
                        if t.name == "query"]
    finally:
        tracer.disable()
        tracer.drain()
        g.close()


def both_traced(run):
    ref = traced(PKGS[0], run)
    port = traced(PKGS[1], run)
    assert port == ref
    return port


def test_query_trace_compile_plan_execute():
    def run(g, dsl, qc):
        h = g.add("obs-q")
        cq = qc.compile_query(g, dsl.value("obs-q"))
        first = list(cq.execute())
        again = list(cq.execute())     # does not grow the finished trace
        return first, again, int(h)

    (first, again, h), trees = both_traced(run)
    assert first == again == [h] and len(trees) == 1
    (spans,) = trees
    assert [s[0] for s in spans] == ["query", "compile", "plan", "execute"]
    assert all(s[1] == "query" for s in spans[1:]) and all(s[3]
                                                           for s in spans)
    assert spans[3][2] == {"results": 1} and "plan" in spans[2][2]


def test_query_trace_via_results_count_and_the_graph():
    def run(g, dsl, qc):
        g.add("obs-r")
        return (len(qc.compile_query(g, dsl.value("obs-r")).results()),
                qc.compile_query(g, dsl.value("obs-r")).count(),
                g.find_all(dsl.value("obs-r")), g.count(dsl.value("obs-r")))

    res, trees = both_traced(run)
    assert res[:2] == (1, 1) and len(trees) == 4
    assert all(any(s[0] == "execute" for s in t) for t in trees)


def test_query_trace_exported_when_execute_or_compile_raises():
    def run(g, dsl, qc):
        cq = qc.compile_query(g, dsl.value("whatever"))

        class BrokenPlan:
            def run(self, graph):
                raise RuntimeError("plan fell over")

        cq.plan = BrokenPlan()
        with pytest.raises(RuntimeError, match="plan fell over"):
            list(cq.execute())
        err = mod(type(g).__module__.split(".")[0], "core.errors")
        with pytest.raises(err.QueryError):
            qc.compile_query(g, "not a condition at all")
        orig = qc.translate

        def boom(*a, **k):
            raise err.QueryError("translate fell over")

        qc.translate = boom
        try:
            with pytest.raises(err.QueryError, match="translate fell over"):
                qc.compile_query(g, dsl.value("x"))
        finally:
            qc.translate = orig
        return None

    _, trees = both_traced(run)
    assert len(trees) == 2
    failed_execute, failed_compile = trees
    assert ("error", "query", {"error": "RuntimeError"}, True) in [
        (n, p, a, ok) for n, p, a, ok in failed_execute]
    assert any(n == "error" and a == {"error": "QueryError"}
               for n, _, a, _ in failed_compile)


def test_untraced_internal_queries_leave_no_trace():
    """Pipes and result maps compile untraced: no trace is left open."""
    def run(g, dsl, qc):
        n = g.add("root")
        l1 = g.add_link((n,), value="inner")
        g.add_link((l1,), value="outer")
        return (dsl.pipe(g, dsl.incident(n),
                         lambda k: dsl.incident(k)).tolist(),
                [(v.targets, v.value)
                 for v in dsl.deref(g, dsl.incident(n))])

    res, trees = both_traced(run)
    assert trees == [] and len(res[0]) == 1
