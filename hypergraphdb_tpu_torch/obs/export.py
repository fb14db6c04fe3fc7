"""Exportable telemetry: Prometheus text format + JSONL span traces.

The port of ``hypergraphdb_tpu/obs/export.py``: for the same registry
contents the exposition text is byte-equal to the reference's, and the
JSONL trace records share its schema version. Two committed wire formats:

- :func:`prometheus_text` renders one or more registries in the
  Prometheus exposition format (``# TYPE`` comments; dots in metric
  names become underscores; counters get the conventional ``_total``
  suffix; histograms emit cumulative ``_bucket{le=...}`` series plus
  ``_sum``/``_count``). Line-parseable — covered by a format test.
  ``labels={"node": "r1"}`` stamps every sample line with a constant
  label set, which is what keeps a FLEET-merged scrape's per-node
  series distinct instead of dedupe-colliding on identical names;
  :func:`relabel_exposition` applies the same stamping to exposition
  TEXT scraped from a remote node, and :func:`merge_expositions` joins
  several nodes' pages into one valid page (``# TYPE`` emitted once per
  metric, first node wins — the multi-registry dedupe rule, fleet
  edition). :func:`sample_value` is the matching tiny reader (the SLO
  monitor's counter source pulls totals out of scraped pages with it).
- :func:`traces_to_jsonl` serializes finished traces one-per-line with an
  explicit ``schema_version`` (:data:`TRACE_SCHEMA_VERSION`); span
  attributes are restricted to scalars at record time (``Span.set``), so
  serialization never fails mid-export. :func:`parse_traces_jsonl` is the
  committed reader — round-tripped by tests, version-checked so a future
  v2 cannot be misread silently.

:func:`write_telemetry` is the one-call dump: ``<prefix>.prom`` +
``<prefix>.trace.jsonl`` next to a run's results.
"""

from __future__ import annotations

import json
import math
import re
from typing import Iterable, Optional

from hypergraphdb_tpu_torch.obs.registry import Registry
from hypergraphdb_tpu_torch.obs.trace import Trace, Tracer

#: bump on ANY change to the JSONL trace record shape.
#: v2: trace/span ids grew to full 128 bits (multi-chip pods put many
#: processes behind one collector; the v1 62-bit space could collide on
#: the join key). A v1 file's ids are not comparable with v2 ids, so the
#: reader REJECTS v1 instead of silently mixing the two spaces.
TRACE_SCHEMA_VERSION = 2

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    out = _NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _fmt(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v)) if isinstance(v, float) else str(v)


def _label_value(v) -> str:
    """Escape one label value per the exposition format."""
    return (str(v).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _label_body(labels: Optional[dict]) -> str:
    """The inside of a ``{...}`` label set (no braces), sorted for a
    stable wire format; empty string for no labels."""
    if not labels:
        return ""
    return ",".join(
        f'{_NAME_RE.sub("_", str(k))}="{_label_value(v)}"'
        for k, v in sorted(labels.items())
    )


def prometheus_text(*registries: Registry,
                    labels: Optional[dict] = None) -> str:
    """Render registries as Prometheus exposition text. Duplicate names
    across registries render once (first registry wins) — merged dumps of
    per-graph + per-runtime registries stay valid exposition. ``labels``
    stamps a constant label set onto every sample line (``node="r1"`` is
    the fleet collector's per-node tag), merged before ``le`` on
    histogram buckets."""
    lines: list[str] = []
    seen: set[str] = set()
    lb = _label_body(labels)
    sfx = "{" + lb + "}" if lb else ""
    for reg in registries:
        for m in reg.instruments():
            pname = _prom_name(m.name)
            if pname in seen:
                continue
            seen.add(pname)
            if m.kind == "counter":
                lines.append(f"# TYPE {pname}_total counter")
                lines.append(f"{pname}_total{sfx} {m.value}")
            elif m.kind == "gauge":
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname}{sfx} {_fmt(m.value)}")
            else:  # histogram
                lines.append(f"# TYPE {pname} histogram")
                # one locked read: _bucket/_sum/_count stay mutually
                # consistent within a scrape
                buckets, total, count = m.export_state()
                pre = lb + "," if lb else ""
                for edge, cum in buckets:
                    lines.append(
                        f'{pname}_bucket{{{pre}le="{_fmt(edge)}"}} {cum}'
                    )
                lines.append(f"{pname}_sum{sfx} {_fmt(total)}")
                lines.append(f"{pname}_count{sfx} {count}")
    return "\n".join(lines) + ("\n" if lines else "")


#: one exposition sample line: name, optional {labels}, value
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)\s*$"
)


def relabel_exposition(text: str, labels: dict) -> str:
    """Stamp ``labels`` onto every sample line of exposition TEXT (what a
    remote node's ``/metrics`` scrape returns) — the collector-side twin
    of ``prometheus_text(labels=...)``. Comment/blank lines pass through;
    existing labels (``le``) are preserved after the stamped ones."""
    lb = _label_body(labels)
    if not lb:
        return text
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            out.append(line)
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            out.append(line)  # foreign line: never corrupt it
            continue
        name, existing, value = m.groups()
        inner = existing[1:-1] if existing else ""
        merged = lb + ("," + inner if inner else "")
        out.append(f"{name}{{{merged}}} {value}")
    return "\n".join(out) + ("\n" if out else "")


def merge_expositions(pages: Iterable[tuple]) -> str:
    """Join several nodes' exposition pages into ONE valid page:
    ``pages`` is an iterable of ``(labels, text)``; every sample line is
    stamped with its page's labels and ``# TYPE`` comments are emitted
    once per metric (first page wins — conflicting redeclarations from a
    skewed node are dropped, not duplicated)."""
    lines: list[str] = []
    typed: set[str] = set()
    for labels, text in pages:
        for line in relabel_exposition(text, labels).splitlines():
            if line.startswith("# TYPE "):
                metric = line.split()[2] if len(line.split()) > 2 else ""
                if metric in typed:
                    continue
                typed.add(metric)
            lines.append(line)
    return "\n".join(lines) + ("\n" if lines else "")


def sample_value(text: str, name: str,
                 labels: Optional[dict] = None) -> Optional[float]:
    """The first sample of ``name`` in exposition text whose label set
    CONTAINS ``labels`` (subset match; None matches any) — the tiny
    reader the SLO monitor's counter sources pull scraped totals with.
    None when absent."""
    want = None if labels is None else {
        (str(k), str(v)) for k, v in labels.items()
    }
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None or m.group(1) != name:
            continue
        if want is not None:
            inner = (m.group(2) or "{}")[1:-1]
            have = set()
            for part in inner.split(","):
                if "=" in part:
                    k, _, v = part.partition("=")
                    have.add((k.strip(), v.strip().strip('"')))
            if not want <= have:
                continue
        try:
            return float(m.group(3))
        except ValueError:
            return None
    return None


# ------------------------------------------------------------------ traces


def trace_to_dict(trace: Trace) -> dict:
    """One trace as a plain dict (the JSONL record body)."""
    return {
        "schema_version": TRACE_SCHEMA_VERSION,
        "trace_id": trace.trace_id,
        "name": trace.name,
        "t0": trace.t0,
        "t1": trace.t1,
        "dropped_spans": trace.dropped,
        "attrs": dict(trace.attrs),
        "spans": [
            {
                "span_id": sp.span_id,
                "parent_id": sp.parent_id,
                "name": sp.name,
                "t0": sp.t0,
                "t1": sp.t1,
                "attrs": dict(sp.attrs),
            }
            for sp in trace.spans()
        ],
    }


def traces_to_jsonl(traces: Iterable[Trace]) -> str:
    """Finished traces, one JSON object per line."""
    return "".join(
        json.dumps(trace_to_dict(t), sort_keys=True) + "\n" for t in traces
    )


def parse_traces_jsonl(text: str) -> list[dict]:
    """The committed reader: parses + version-checks every line."""
    out = []
    for i, line in enumerate(text.splitlines()):
        if not line.strip():
            continue
        rec = json.loads(line)
        ver = rec.get("schema_version")
        if ver != TRACE_SCHEMA_VERSION:
            raise ValueError(
                f"trace line {i}: schema_version {ver!r} != "
                f"{TRACE_SCHEMA_VERSION}"
            )
        for key in ("trace_id", "name", "t0", "spans"):
            if key not in rec:
                raise ValueError(f"trace line {i}: missing {key!r}")
        out.append(rec)
    return out


def write_telemetry(prefix: str, registries: Iterable[Registry] = (),
                    tracer: Optional[Tracer] = None) -> dict:
    """Dump ``<prefix>.prom`` and ``<prefix>.trace.jsonl``; returns the
    paths written."""
    prom_path = prefix + ".prom"
    jsonl_path = prefix + ".trace.jsonl"
    with open(prom_path, "w") as f:
        f.write(prometheus_text(*registries))
    traces = tracer.drain() if tracer is not None else []
    with open(jsonl_path, "w") as f:
        f.write(traces_to_jsonl(traces))
    return {"prometheus": prom_path, "traces": jsonl_path,
            "n_traces": len(traces)}
