"""Process-local, mergeable metrics registry.

Port of ``repro/obs/registry.py`` (numpy and the standard library only,
as there). Three primitives — :class:`Counter` (a monotone sum),
:class:`Gauge` (a point-in-time value with a declared merge aggregation)
and :class:`Histogram` (a streaming log-bucketed distribution) — owned by
a :class:`MetricsRegistry` keyed by ``(name, labels)``.

Naming scheme: every metric an instrumented subsystem registers is named
``juno_<subsystem>_<name>``, with Prometheus conventions for units and
suffixes — ``_total`` for counters, ``_seconds`` / ``_bytes`` units,
label keys for the low-cardinality dimensions (``mode``, ``op``, ...).
The registry enforces only the character set (``[a-z0-9_]``). The names
and the event layout are the reference's, so a dump of either package
reads in the other.

Merging folds registries (one per replica) into one view and is
fail-closed: merging two metrics of different kinds, two histograms
with different bucket *edges* (the same bucket count is not enough), or
two gauges with different declared aggregations raises ``ValueError``.
Counter merge is commutative; gauge merge follows the gauge's ``agg``.
"""
from __future__ import annotations

import math
import re
from typing import Iterator

import numpy as np

#: metric / label-key character set (Prometheus-compatible subset)
_NAME_RE = re.compile(r"^[a-z_][a-z0-9_]*$")

#: gauge merge aggregations (see :class:`Gauge`)
GAUGE_AGGS = ("last", "sum", "max", "min")


def _check_name(name: str) -> str:
    """Validate a metric or label-key name against the character set."""
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric/label name {name!r} "
                         f"(want [a-z_][a-z0-9_]*)")
    return name


class Counter:
    """Monotonically increasing sum. Merge (addition) is commutative."""

    kind = "counter"

    def __init__(self):
        """Start at zero."""
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        """Add ``n`` (must be >= 0: counters only go up)."""
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        self.value += n

    def merge(self, other: "Counter") -> None:
        """Fold another counter in (commutative: ``a+b == b+a``)."""
        self.value += other.value


class Gauge:
    """Point-in-time value with a declared cross-registry aggregation.

    ``agg`` decides what :meth:`merge` means when per-replica registries
    fold into one fleet view: ``"sum"`` for capacity-like gauges (total
    queued rows across replicas), ``"max"``/``"min"`` for envelope
    gauges, ``"last"`` (default) for sampled values where the most
    recently written side wins (NOT commutative — documented, and
    fail-closed against merging with a different ``agg``).
    """

    kind = "gauge"

    def __init__(self, agg: str = "last"):
        """Create an unset gauge with merge aggregation ``agg``."""
        if agg not in GAUGE_AGGS:
            raise ValueError(f"unknown gauge agg {agg!r} "
                             f"(want one of {GAUGE_AGGS})")
        self.agg = agg
        self.value = 0.0
        self.updates = 0

    def set(self, v: float) -> None:
        """Write the gauge's current value."""
        self.value = float(v)
        self.updates += 1

    def merge(self, other: "Gauge") -> None:
        """Fold another gauge in per this gauge's ``agg`` (fail-closed).

        Raises ValueError when the aggregations differ — the two sides
        disagree about what the merged number MEANS, so there is no
        correct answer to silently pick.
        """
        if other.agg != self.agg:
            raise ValueError(f"gauge agg mismatch: {self.agg!r} "
                             f"vs {other.agg!r}")
        if other.updates == 0:
            return
        if self.updates == 0 or self.agg == "last":
            self.value = other.value
        elif self.agg == "sum":
            self.value += other.value
        elif self.agg == "max":
            self.value = max(self.value, other.value)
        elif self.agg == "min":
            self.value = min(self.value, other.value)
        self.updates += other.updates


class Histogram:
    """Streaming log-bucketed histogram with percentile queries.

    Fixed memory (one int64 count per bucket), so it can absorb an
    unbounded observation stream: buckets are geometrically spaced
    between ``lo`` and ``hi`` at ``bins_per_decade`` buckets per decade
    (default 24 → ≤ ~10 % relative resolution). ``percentile`` returns
    the **upper edge** of the bucket holding the requested quantile
    (clamped to the exact observed max), i.e. a conservative tail
    estimate — an SLO gate on it can over-reject by at most one bucket
    width, never under-reject. The unit is whatever the caller observes
    (seconds, bytes, ratios).
    """

    kind = "histogram"

    def __init__(self, lo: float = 1e-6, hi: float = 500.0,
                 bins_per_decade: int = 24):
        """Allocate the bucket table spanning [lo, hi].

        Parameters
        ----------
        lo, hi : float
            Smallest / largest value resolved exactly; values outside
            land in the under/overflow buckets.
        bins_per_decade : int
            Geometric bucket density (resolution ≈ ``10^(1/bins)``).
        """
        self.lo, self.hi = float(lo), float(hi)
        self.bins_per_decade = int(bins_per_decade)
        n_edges = int(math.ceil(math.log10(hi / lo) * bins_per_decade)) + 1
        #: upper edge of bucket b is _edges[b]; the final bucket (index
        #: len(_edges)) is the overflow bucket, bounded by the exact max
        self._edges = lo * 10.0 ** (np.arange(n_edges) / bins_per_decade)
        self._counts = np.zeros(n_edges + 1, np.int64)
        self.n = 0
        self.sum = 0.0
        self.max = 0.0

    def add(self, value: float) -> None:
        """Record one observation into its log-spaced bucket."""
        s = float(value)
        b = int(np.searchsorted(self._edges, s, side="left"))
        self._counts[b] += 1
        self.n += 1
        self.sum += s
        self.max = max(self.max, s)

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram (same bucketing) into this one.

        The bucketings must be identical, which means the *edges* must
        match — two histograms with different ``lo``/``bins_per_decade``
        can land on the same bucket count (e.g. ``lo=1e-5, hi=5000`` vs
        the defaults), and folding those counts together would corrupt
        every percentile. Raises ValueError on any mismatch.
        """
        if not np.array_equal(other._edges, self._edges):
            raise ValueError("histogram bucketings differ")
        self._counts += other._counts
        self.n += other.n
        self.sum += other.sum
        self.max = max(self.max, other.max)

    def percentile(self, p: float) -> float:
        """Upper-edge estimate of the ``p`` quantile (0 < p <= 1)."""
        if self.n == 0:
            return 0.0
        target = max(1, int(math.ceil(p * self.n)))
        cum = np.cumsum(self._counts)
        b = int(np.searchsorted(cum, target))
        edge = self._edges[b] if b < len(self._edges) else self.max
        return float(min(edge, self.max))

    def summary(self) -> dict:
        """``{"n", "mean", "p50", "p95", "p99", "max"}`` in the observed unit."""
        if self.n == 0:
            return {"n": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0,
                    "p99": 0.0, "max": 0.0}
        return {"n": self.n, "mean": self.sum / self.n,
                "p50": self.percentile(0.50), "p95": self.percentile(0.95),
                "p99": self.percentile(0.99), "max": self.max}

    # ---- serialization (JSONL export round-trip) -------------------------
    def state(self) -> dict:
        """Serializable constructor params + bucket state."""
        return {"lo": self.lo, "hi": self.hi,
                "bins_per_decade": self.bins_per_decade,
                "counts": [int(c) for c in self._counts],
                "n": int(self.n), "sum": float(self.sum),
                "max": float(self.max)}

    @classmethod
    def from_state(cls, state: dict) -> "Histogram":
        """Rebuild a histogram from :meth:`state` output (fail-closed)."""
        h = cls(lo=state["lo"], hi=state["hi"],
                bins_per_decade=state["bins_per_decade"])
        counts = np.asarray(state["counts"], np.int64)
        if counts.shape != h._counts.shape:
            raise ValueError(
                f"histogram state has {counts.shape[0]} buckets, "
                f"lo/hi/bins imply {h._counts.shape[0]}")
        if int(counts.sum()) != int(state["n"]):
            raise ValueError("histogram state n != sum(counts)")
        h._counts = counts
        h.n = int(state["n"])
        h.sum = float(state["sum"])
        h.max = float(state["max"])
        return h


MetricKey = tuple  # (name, ((label_key, label_value), ...))


class MetricsRegistry:
    """Get-or-create owner of named, labeled metrics.

    One registry per process-local scope (an engine, a replica, a
    store); :meth:`merge` folds registries together fail-closed for the
    fleet view. Accessors are get-or-create and type-checked: asking for
    ``counter(name)`` where ``name`` is already a gauge raises instead
    of shadowing.
    """

    def __init__(self):
        """Create an empty registry."""
        self._metrics: dict[MetricKey, object] = {}

    # ---- keying ----------------------------------------------------------
    @staticmethod
    def _key(name: str, labels: dict) -> MetricKey:
        _check_name(name)
        for k in labels:
            _check_name(k)
        return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))

    def _get_or_create(self, name: str, labels: dict, kind: str, make):
        key = self._key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            m = make()
            self._metrics[key] = m
        elif m.kind != kind:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{m.kind}, not {kind}")
        return m

    # ---- accessors (get-or-create) ---------------------------------------
    def counter(self, name: str, **labels) -> Counter:
        """Get or create the counter ``name{labels}``."""
        return self._get_or_create(name, labels, "counter", Counter)

    def gauge(self, name: str, agg: str = "last", **labels) -> Gauge:
        """Get or create the gauge ``name{labels}`` with merge agg ``agg``."""
        g = self._get_or_create(name, labels, "gauge", lambda: Gauge(agg))
        if g.agg != agg:
            raise ValueError(f"gauge {name!r} already registered with "
                             f"agg={g.agg!r}, not {agg!r}")
        return g

    def histogram(self, name: str, lo: float = 1e-6, hi: float = 500.0,
                  bins_per_decade: int = 24, **labels) -> Histogram:
        """Get or create the histogram ``name{labels}``.

        Bucketing params apply on creation; a later call with different
        params against an existing histogram raises (fail-closed — the
        caller thought it was observing into different buckets).
        """
        h = self._get_or_create(
            name, labels, "histogram",
            lambda: Histogram(lo=lo, hi=hi, bins_per_decade=bins_per_decade))
        if (h.lo, h.hi, h.bins_per_decade) != (float(lo), float(hi),
                                               int(bins_per_decade)):
            raise ValueError(f"histogram {name!r} already registered with "
                             f"different bucketing")
        return h

    def get(self, name: str, **labels):
        """Return the metric ``name{labels}`` or None."""
        return self._metrics.get(self._key(name, labels))

    def metrics(self) -> Iterator[tuple[str, dict, object]]:
        """Iterate ``(name, labels_dict, metric)`` in sorted key order."""
        for (name, labels) in sorted(self._metrics):
            yield name, dict(labels), self._metrics[(name, labels)]

    def __len__(self) -> int:
        """Number of registered (name, labels) series."""
        return len(self._metrics)

    # ---- merge (the cross-replica primitive) -----------------------------
    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold another registry into this one, fail-closed.

        Series present in both are merged per their kind's semantics
        (kind mismatch, histogram edge mismatch and gauge agg mismatch
        all raise); series only in ``other`` are deep-copied in. Counter
        folds are commutative; see :meth:`Gauge.merge` for gauges.
        Returns ``self`` for chaining.
        """
        for key, om in other._metrics.items():
            mine = self._metrics.get(key)
            if mine is None:
                self._metrics[key] = _clone(om)
            elif mine.kind != om.kind:
                raise ValueError(f"merge kind mismatch on {key[0]!r}: "
                                 f"{mine.kind} vs {om.kind}")
            else:
                mine.merge(om)
        return self

    # ---- exposition ------------------------------------------------------
    def snapshot(self) -> dict:
        """Flat ``{"name{label=...}": value-or-summary}`` dict of all series."""
        out = {}
        for name, labels, m in self.metrics():
            lbl = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
            full = f"{name}{{{lbl}}}" if lbl else name
            out[full] = (m.summary() if m.kind == "histogram" else m.value)
        return out

    def render_text(self) -> str:
        """Prometheus-style text exposition of every series.

        Counters/gauges render one sample line; histograms render
        cumulative ``_bucket{le=...}`` lines (upper bucket edges plus
        ``+Inf``) and ``_sum`` / ``_count`` samples, per the Prometheus
        exposition format. ``# TYPE`` comments are emitted once per
        metric name.
        """
        lines: list[str] = []
        last_name = None
        for name, labels, m in self.metrics():
            if name != last_name:
                lines.append(f"# TYPE {name} {m.kind}")
                last_name = name
            base = sorted(labels.items())
            if m.kind == "histogram":
                cum = 0
                for edge, c in zip(m._edges, m._counts[:-1]):
                    cum += int(c)
                    if c:
                        lines.append(_sample(f"{name}_bucket",
                                             base + [("le", f"{edge:g}")],
                                             cum))
                lines.append(_sample(f"{name}_bucket",
                                     base + [("le", "+Inf")], m.n))
                lines.append(_sample(f"{name}_sum", base, m.sum))
                lines.append(_sample(f"{name}_count", base, m.n))
            else:
                lines.append(_sample(name, base, m.value))
        return "\n".join(lines) + ("\n" if lines else "")

    # ---- event (de)serialization -----------------------------------------
    def to_events(self) -> list[dict]:
        """One JSONL-able ``{"event": "metric", ...}`` dict per series."""
        out = []
        for name, labels, m in self.metrics():
            ev = {"event": "metric", "kind": m.kind, "name": name,
                  "labels": labels}
            if m.kind == "histogram":
                ev.update(m.state())
            elif m.kind == "gauge":
                ev.update({"value": m.value, "agg": m.agg,
                           "updates": m.updates})
            else:
                ev.update({"value": m.value})
            out.append(ev)
        return out

    @classmethod
    def from_events(cls, events) -> "MetricsRegistry":
        """Rebuild a registry from ``to_events`` output (round-trip)."""
        reg = cls()
        for ev in events:
            if ev.get("event") != "metric":
                continue
            name, labels, kind = ev["name"], ev.get("labels", {}), ev["kind"]
            if kind == "counter":
                reg.counter(name, **labels).value = float(ev["value"])
            elif kind == "gauge":
                g = reg.gauge(name, agg=ev.get("agg", "last"), **labels)
                g.value = float(ev["value"])
                g.updates = int(ev.get("updates", 1))
            elif kind == "histogram":
                key = cls._key(name, labels)
                reg._metrics[key] = Histogram.from_state(ev)
            else:
                raise ValueError(f"unknown metric kind {kind!r}")
        return reg


def _sample(name: str, labels: list, value) -> str:
    """One Prometheus sample line."""
    lbl = ",".join(f'{k}="{v}"' for k, v in labels)
    return (f"{name}{{{lbl}}} {value:g}" if lbl else f"{name} {value:g}")


def _clone(m):
    """Deep-copy one metric for merge-into-empty."""
    if m.kind == "counter":
        c = Counter()
        c.value = m.value
        return c
    if m.kind == "gauge":
        g = Gauge(m.agg)
        g.value, g.updates = m.value, m.updates
        return g
    return Histogram.from_state(m.state())
