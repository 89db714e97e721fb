"""Span-based request tracing.

Port of ``repro/obs/trace.py`` (the standard library only, as there).
Every engine tick opens an ``engine.tick`` span whose children cover the
pipeline — per-request ``engine.enqueue`` (submit → batch formation,
stamped after the fact), ``engine.rt_probe`` (the rt router's probe
budget), ``engine.dispatch`` (one search call a batch chunk; on the paged
engine its children are ``paged.filter`` / ``paged.gather``, with one
``paged.fault`` span a cluster cache miss, / ``paged.score``) and
``engine.merge`` (results sliced back onto requests).

The tracer is single-writer (the engine's tick loop is single-threaded);
``trace_id`` tells the requests of one tick apart: spans of one request
carry its id, spans shared by the batch carry none. Completed spans land
in a bounded ring buffer (oldest dropped, counted in ``dropped``),
exported as JSONL events beside the metrics registry (``obs/export.py``).
Spans are appended on close, so buffer order is end-time order; nesting
is rebuilt from ``parent_id``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Iterator, Optional


@dataclasses.dataclass
class Span:
    """One timed, named, optionally-nested trace span.

    ``parent_id`` links to the enclosing span (None at the root),
    ``trace_id`` groups spans of one logical request across ticks, and
    ``attrs`` carries low-cardinality context (signature, cluster id,
    bucket size, ...). Timestamps are ``perf_counter`` seconds.
    """

    name: str
    span_id: int
    parent_id: Optional[int]
    trace_id: Optional[str]
    t_start: float
    t_end: float = 0.0
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        """``t_end - t_start`` in seconds."""
        return self.t_end - self.t_start


class Tracer:
    """Bounded collector of nested spans (single-writer).

    Live spans open via the :meth:`span` context manager and nest
    through an explicit stack (:attr:`current`); already-elapsed
    segments (a request's queue wait, a fleet request's lifetime) are
    stamped retroactively via :meth:`record`. The buffer holds the most
    recent ``max_spans`` completed spans; overflow increments
    :attr:`dropped` instead of growing without bound.
    """

    def __init__(self, max_spans: int = 8192):
        """Create an empty tracer keeping at most ``max_spans`` spans."""
        self.max_spans = int(max_spans)
        self._spans: collections.deque[Span] = collections.deque(
            maxlen=self.max_spans)
        self._stack: list[Span] = []
        self._next_id = 0
        self.dropped = 0

    @property
    def current(self) -> Optional[Span]:
        """The innermost open span, or None outside any span."""
        return self._stack[-1] if self._stack else None

    def _new(self, name: str, parent_id: Optional[int],
             trace_id: Optional[str], t_start: float, attrs: dict) -> Span:
        s = Span(name=name, span_id=self._next_id, parent_id=parent_id,
                 trace_id=trace_id, t_start=t_start, attrs=attrs)
        self._next_id += 1
        return s

    def _close(self, span: Span, t_end: float) -> None:
        span.t_end = t_end
        if len(self._spans) == self.max_spans:
            self.dropped += 1
        self._spans.append(span)

    @contextlib.contextmanager
    def span(self, name: str, trace_id: Optional[str] = None,
             **attrs) -> Iterator[Span]:
        """Open a live span nested under :attr:`current`; closes on exit.

        Parameters
        ----------
        name : str
            Span name (dotted taxonomy, e.g. ``"engine.dispatch"``).
        trace_id : str, optional
            Logical request the span belongs to; inherited from the
            enclosing span when omitted (None at the root = batch-shared).
        **attrs
            Attached attributes (stringified on export).
        """
        parent = self.current
        if trace_id is None and parent is not None:
            trace_id = parent.trace_id
        s = self._new(name, parent.span_id if parent else None, trace_id,
                      time.perf_counter(), attrs)
        self._stack.append(s)
        try:
            yield s
        finally:
            self._stack.pop()
            self._close(s, time.perf_counter())

    def record(self, name: str, t_start: float, t_end: float, *,
               trace_id: Optional[str] = None,
               parent: Optional[Span] = None, **attrs) -> Span:
        """Append an already-elapsed span with explicit timestamps.

        Used for segments whose boundaries were stamped before the
        tracer saw them — a request's submit→batch queue wait, a fleet
        request's arrival→done lifetime. ``parent`` defaults to
        :attr:`current` (the open span at call time), so retro-stamped
        spans still nest under the tick that completed them; like
        :meth:`span`, an omitted ``trace_id`` is inherited from the
        parent.
        """
        p = parent if parent is not None else self.current
        if trace_id is None and p is not None:
            trace_id = p.trace_id
        s = self._new(name, p.span_id if p else None, trace_id,
                      float(t_start), attrs)
        self._close(s, float(t_end))
        return s

    def spans(self) -> list[Span]:
        """Completed spans, oldest first (close-time order)."""
        return list(self._spans)

    def clear(self) -> None:
        """Drop all completed spans (open spans and ids are untouched)."""
        self._spans.clear()
        self.dropped = 0

    # ---- event (de)serialization -----------------------------------------
    def to_events(self) -> list[dict]:
        """One JSONL-able ``{"event": "span", ...}`` dict per span."""
        return [{"event": "span", "name": s.name, "span_id": s.span_id,
                 "parent_id": s.parent_id, "trace_id": s.trace_id,
                 "t_start": s.t_start, "t_end": s.t_end,
                 "attrs": {k: str(v) for k, v in s.attrs.items()}}
                for s in self._spans]

    @staticmethod
    def spans_from_events(events) -> list[Span]:
        """Rebuild :class:`Span` objects from ``to_events`` output."""
        out = []
        for ev in events:
            if ev.get("event") != "span":
                continue
            out.append(Span(name=ev["name"], span_id=int(ev["span_id"]),
                            parent_id=(None if ev.get("parent_id") is None
                                       else int(ev["parent_id"])),
                            trace_id=ev.get("trace_id"),
                            t_start=float(ev["t_start"]),
                            t_end=float(ev["t_end"]),
                            attrs=dict(ev.get("attrs", {}))))
        return out
