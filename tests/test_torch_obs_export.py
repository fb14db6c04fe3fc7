"""The port's telemetry export (``hypergraphdb_tpu_torch.obs.export``)
against the reference's (``hypergraphdb_tpu.obs.export``).

The export cases of ``tests/test_obs.py`` in both packages, and: for the
same registry contents (counters, gauges with NaN and infinities,
histograms, a constant label set) the Prometheus exposition text is
byte-equal; ``relabel_exposition``, ``merge_expositions`` and
``sample_value`` give equal answers on the same pages; a JSONL trace file
written by either package reads back through the other's reader to the
same records. Tolerance: exact equality."""

from __future__ import annotations

import math
import re

import pytest

from tests.test_torch_graph import PKGS, mod
from tests.test_torch_serve_runtime import FakeClock

PORT = PKGS[1]

PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{le=\"[^\"]+\"\})? -?[0-9.eE+-]+$"
    r"|^[a-zA-Z_:][a-zA-Z0-9_:]*(\{le=\"\+Inf\"\})? [0-9]+$"
)


@pytest.fixture(params=PKGS)
def obs(request):
    return mod(request.param, "obs")


def sample_registry(obs, extra: bool = False):
    r = obs.Registry()
    r.counter("serve.submitted").inc(3)
    r.gauge("serve.queue_depth").set(2.5)
    h = r.histogram("serve.latency_seconds", bounds=(0.001, 0.01, 0.1))
    for v in (0.0005, 0.02, 0.5):
        h.observe(v)
    if extra:
        r.gauge("perf.lane.bfs.p99_s").set(float("nan"))
        r.gauge("x.up").set(math.inf)
        r.gauge("x.down").set(-math.inf)
        r.counter("9lives.count").inc(7)
        h2 = r.histogram("plan.est_rows")
        for v in (0.0, 3.0, 1e6, 2.5e9):
            h2.observe(v)
    return r


def make_tracer(obs):
    clock = FakeClock()
    t = obs.Tracer(clock=clock)
    t.enable()
    return t, clock


def test_prometheus_text_parses_line_by_line(obs):
    lines = obs.prometheus_text(sample_registry(obs)).strip().splitlines()
    assert lines
    for ln in lines:
        if ln.startswith("# TYPE "):
            assert re.match(r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* "
                            r"(counter|gauge|histogram)$", ln)
        else:
            assert PROM_LINE.match(ln), ln
    assert "serve_submitted_total 3" in lines
    assert "serve_queue_depth 2.5" in lines
    buckets = [ln for ln in lines
               if ln.startswith("serve_latency_seconds_bucket")]
    counts = [int(ln.rsplit(" ", 1)[1]) for ln in buckets]
    assert counts == sorted(counts)
    assert buckets[-1] == 'serve_latency_seconds_bucket{le="+Inf"} 3'
    assert "serve_latency_seconds_count 3" in lines


def test_prometheus_merged_registries_dedupe(obs):
    a, b = sample_registry(obs), sample_registry(obs)
    b.counter("other.thing").inc()
    text = obs.prometheus_text(a, b)
    assert [ln for ln in text.splitlines()
            if ln.startswith("serve_submitted_total ")] == [
        "serve_submitted_total 3"]
    assert "other_thing_total 1" in text


@pytest.mark.parametrize("labels", [None, {"node": "r1"},
                                    {"node": 'a"b\\c\nd', "zone": 2}])
def test_exposition_is_byte_equal_to_the_reference(labels):
    texts = [mod(pkg, "obs").prometheus_text(
        sample_registry(mod(pkg, "obs"), extra=True),
        sample_registry(mod(pkg, "obs")), labels=labels) for pkg in PKGS]
    assert texts[1] == texts[0]
    assert "NaN" in texts[1] and "+Inf" in texts[1]


def test_relabel_merge_and_sample_value_equal_the_reference():
    out = []
    for pkg in PKGS:
        o = mod(pkg, "obs")
        page = o.prometheus_text(sample_registry(o, extra=True))
        foreign = page + "not a sample line at all\n"
        merged = o.merge_expositions([({"node": "a"}, page),
                                      ({"node": "b"}, foreign),
                                      ({}, page)])
        out.append((
            o.relabel_exposition(foreign, {"node": "r9"}),
            o.relabel_exposition(page, {}),
            merged,
            [o.sample_value(merged, name, labels) for name, labels in (
                ("serve_submitted_total", None),
                ("serve_submitted_total", {"node": "b"}),
                ("serve_latency_seconds_bucket", {"node": "a", "le": "0.01"}),
                ("absent_total", None),
                ("perf_lane_bfs_p99_s", {"node": "a"}))],
        ))
    assert out[1][:3] == out[0][:3]
    # NaN != NaN: compare the sampled values by repr
    assert [repr(v) for v in out[1][3]] == [repr(v) for v in out[0][3]]
    assert out[1][3][:4] == [3.0, 3.0, 1.0, None]
    assert math.isnan(out[1][3][4])


def traced(obs):
    tracer, clock = make_tracer(obs)
    tr = tracer.start_trace("serve.request", kind="bfs")
    root = tr.start_span("request")
    clock.advance(1.0)
    tr.start_span("submit", parent=root, bucket=64).end()
    tr.finish()
    return tracer


def test_traces_jsonl_round_trip(obs):
    recs = obs.parse_traces_jsonl(obs.traces_to_jsonl(traced(obs).drain()))
    assert len(recs) == 1
    rec = recs[0]
    assert rec["schema_version"] == obs.TRACE_SCHEMA_VERSION
    assert rec["name"] == "serve.request" and rec["attrs"] == {"kind": "bfs"}
    assert [s["name"] for s in rec["spans"]] == ["request", "submit"]
    by_name = {s["name"]: s for s in rec["spans"]}
    assert by_name["submit"]["parent_id"] == by_name["request"]["span_id"]
    assert by_name["submit"]["attrs"] == {"bucket": 64}
    assert rec["t1"] >= rec["t0"]


def test_jsonl_reads_across_the_packages():
    """Each package's JSONL reads back through the other's reader to the
    same records, and both write the same schema version."""
    ref, port = mod(PKGS[0], "obs"), mod(PORT, "obs")
    assert port.TRACE_SCHEMA_VERSION == ref.TRACE_SCHEMA_VERSION
    for writer, reader in ((ref, port), (port, ref)):
        text = writer.traces_to_jsonl(traced(writer).drain())
        assert reader.parse_traces_jsonl(text) == \
            writer.parse_traces_jsonl(text)
    a = [{k: v for k, v in r.items() if k != "trace_id"}
         for r in ref.parse_traces_jsonl(
             ref.traces_to_jsonl(traced(ref).drain()))]
    b = [{k: v for k, v in r.items() if k != "trace_id"}
         for r in port.parse_traces_jsonl(
             port.traces_to_jsonl(traced(port).drain()))]
    for recs in (a, b):
        for r in recs:
            r["spans"] = [{k: v for k, v in s.items()
                           if k not in ("span_id", "parent_id")}
                          for s in r["spans"]]
    assert a == b


def test_traces_jsonl_rejects_wrong_schema(obs):
    tracer, _ = make_tracer(obs)
    tracer.finish_trace(tracer.start_trace("t"))
    text = obs.traces_to_jsonl(tracer.drain())
    bumped = text.replace(f'"schema_version": {obs.TRACE_SCHEMA_VERSION}',
                          '"schema_version": 99')
    with pytest.raises(ValueError, match="schema_version"):
        obs.parse_traces_jsonl(bumped)
    with pytest.raises(ValueError, match="missing"):
        obs.parse_traces_jsonl(
            '{"schema_version": %d}\n' % obs.TRACE_SCHEMA_VERSION)
    assert obs.parse_traces_jsonl("") == []
    v1 = ('{"schema_version": 1, "trace_id": 4611686018427387905, '
          '"name": "serve.request", "t0": 0.0, "t1": 1.0, '
          '"dropped_spans": 0, "attrs": {}, "spans": []}\n')
    with pytest.raises(ValueError, match="schema_version 1"):
        obs.parse_traces_jsonl(v1)


def test_write_telemetry_files(obs, tmp_path):
    tracer, _ = make_tracer(obs)
    tracer.finish_trace(tracer.start_trace("t"))
    out = obs.write_telemetry(str(tmp_path / "tele"),
                              registries=[sample_registry(obs)],
                              tracer=tracer)
    assert out["n_traces"] == 1
    assert "serve_submitted_total 3" in open(out["prometheus"]).read()
    recs = obs.parse_traces_jsonl(open(out["traces"]).read())
    assert [r["name"] for r in recs] == ["t"]


def test_profile_noop_without_logdir(obs):
    for logdir in (None, ""):
        with obs.profile(logdir) as active:
            assert not active
