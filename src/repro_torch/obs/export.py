"""JSONL event export, import and validation.

Port of ``repro/obs/export.py``. One dump is a JSON-Lines file under the
``juno.obs.v1`` schema: a leading ``meta`` event naming the schema, then
one ``metric`` event a registry series (full state: counters carry
``value``, gauges ``value``/``agg``/``updates``, histograms their bucket
layout and counts, so dumps merge and round-trip losslessly) and one
``span`` event a completed span. The schema, the metric names and the
span names are the reference's, so a dump of either package passes the
other's :func:`validate_events` and reads in ``tools/obs_report.py``.
:func:`validate_events` is the fail-closed schema check: it returns a
list of problems (empty = valid) instead of raising.
"""
from __future__ import annotations

import json
import math
import os
from typing import Optional

from .registry import GAUGE_AGGS, MetricsRegistry, _NAME_RE
from .trace import Tracer

SCHEMA = "juno.obs.v1"


def to_events(registry: Optional[MetricsRegistry] = None,
              tracer: Optional[Tracer] = None,
              extra_meta: Optional[dict] = None) -> list[dict]:
    """Flatten a registry and/or tracer into one schema-stamped event list."""
    meta = {"event": "meta", "schema": SCHEMA}
    if extra_meta:
        meta.update(extra_meta)
    events: list[dict] = [meta]
    if registry is not None:
        events.extend(registry.to_events())
    if tracer is not None:
        events.extend(tracer.to_events())
    return events


def write_jsonl(path: str, events: list[dict]) -> None:
    """Write events one-JSON-object-per-line, creating parent directories."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w") as fh:
        for ev in events:
            fh.write(json.dumps(ev, sort_keys=True) + "\n")


def read_jsonl(path: str) -> list[dict]:
    """Parse a JSONL dump back into its event-dict list (blank lines skipped)."""
    events = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


def registry_from_events(events: list[dict]) -> MetricsRegistry:
    """Rebuild a :class:`MetricsRegistry` from a validated event list."""
    return MetricsRegistry.from_events(events)


def _check_metric(i: int, ev: dict, problems: list[str]) -> None:
    name = ev.get("name")
    if not isinstance(name, str) or not _NAME_RE.match(name):
        problems.append(f"line {i}: bad metric name {name!r}")
        return
    labels = ev.get("labels", {})
    if not isinstance(labels, dict):
        problems.append(f"line {i}: metric {name}: labels must be an object")
    kind = ev.get("kind")
    if kind == "counter":
        v = ev.get("value")
        if not isinstance(v, (int, float)) or v < 0:
            problems.append(f"line {i}: counter {name}: bad value {v!r}")
    elif kind == "gauge":
        if ev.get("agg") not in GAUGE_AGGS:
            problems.append(
                f"line {i}: gauge {name}: bad agg {ev.get('agg')!r}")
        if not isinstance(ev.get("value"), (int, float)):
            problems.append(f"line {i}: gauge {name}: non-numeric value")
    elif kind == "histogram":
        counts = ev.get("counts")
        lo, hi = ev.get("lo"), ev.get("hi")
        bpd = ev.get("bins_per_decade")
        if (not isinstance(counts, list)
                or not isinstance(lo, (int, float))
                or not isinstance(hi, (int, float))
                or not isinstance(bpd, int) or lo <= 0 or hi <= lo):
            problems.append(
                f"line {i}: histogram {name}: missing/bad bucketing state")
            return
        # bucket layout implied by (lo, hi, bins_per_decade): n_edges
        # resolved buckets plus one overflow bucket (see Histogram).
        want = int(math.ceil(math.log10(hi / lo) * bpd)) + 2
        if len(counts) != want:
            problems.append(
                f"line {i}: histogram {name}: {len(counts)} counts, "
                f"bucketing implies {want}")
        n = ev.get("n", 0)
        if sum(counts) != n:
            problems.append(
                f"line {i}: histogram {name}: n={n} != sum(counts)="
                f"{sum(counts)}")
        if any((not isinstance(c, int)) or c < 0 for c in counts):
            problems.append(
                f"line {i}: histogram {name}: negative or non-int count")
    else:
        problems.append(f"line {i}: metric {name}: unknown kind {kind!r}")


def validate_events(events: list[dict]) -> list[str]:
    """Fail-closed schema check; returns problems (empty list = valid).

    Checks: a leading ``meta`` event carrying ``schema == "juno.obs.v1"``;
    every metric event has a scheme-conforming name, a known kind, and
    internally consistent state (histogram ``counts`` length and total);
    every span event has ordered timestamps and a resolvable parent.
    """
    problems: list[str] = []
    if not events:
        return ["empty event list"]
    head = events[0]
    if head.get("event") != "meta":
        problems.append("line 0: first event must be 'meta'")
    elif head.get("schema") != SCHEMA:
        problems.append(
            f"line 0: schema {head.get('schema')!r} != {SCHEMA!r}")
    span_ids = set()
    for i, ev in enumerate(events):
        kind = ev.get("event")
        if kind == "span":
            span_ids.add(ev.get("span_id"))
    for i, ev in enumerate(events):
        kind = ev.get("event")
        if kind == "meta":
            if i != 0:
                problems.append(f"line {i}: duplicate meta event")
        elif kind == "metric":
            _check_metric(i, ev, problems)
        elif kind == "span":
            if not isinstance(ev.get("name"), str) or not ev.get("name"):
                problems.append(f"line {i}: span without a name")
            t0, t1 = ev.get("t_start"), ev.get("t_end")
            if not (isinstance(t0, (int, float)) and
                    isinstance(t1, (int, float)) and t0 <= t1):
                problems.append(
                    f"line {i}: span {ev.get('name')!r}: bad interval "
                    f"[{t0!r}, {t1!r}]")
            pid = ev.get("parent_id")
            if pid is not None and pid not in span_ids:
                problems.append(
                    f"line {i}: span {ev.get('name')!r}: parent_id {pid} "
                    "not in dump")
        else:
            problems.append(f"line {i}: unknown event kind {kind!r}")
    return problems
