"""Observability of the serving stack: metrics, spans, online recall.

Port of ``repro/obs``. Three primitives:

* :class:`MetricsRegistry` of :class:`Counter` / :class:`Gauge` /
  :class:`Histogram` series under the ``juno_<subsystem>_<name>``
  scheme, mergeable fail-closed (``registry.py``);
* a span :class:`Tracer` nesting enqueue → tick → rt probe → dispatch
  → paged fault-in → merge per request (``trace.py``);
* JSONL export with a fail-closed schema check (``export.py``; the
  reference's ``juno.obs.v1`` schema, names and spans, so dumps cross
  between the packages), and a sampled exact-rerank
  :class:`RecallProbe` feeding ``recall@k`` gauges per tier
  (``recall.py``, which reranks on the card).

The instrumentation is host-side bookkeeping: it adds no device
synchronisation, no device tensor and no kernel to the serving path, and
served ids and scores are bit-equal with it on and off. The engines,
the paged tier, the artifact store and the merge scheduler take an
:class:`Observability` bundle (or a bare registry) and work without one.
"""
from .export import (SCHEMA, read_jsonl, registry_from_events,  # noqa: F401
                     to_events, validate_events, write_jsonl)
from .recall import RecallProbe, exact_topk_ids  # noqa: F401
from .registry import Counter, Gauge, Histogram, MetricsRegistry  # noqa: F401
from .trace import Span, Tracer  # noqa: F401

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Span", "Tracer", "RecallProbe", "exact_topk_ids",
    "Observability", "SCHEMA", "to_events", "write_jsonl", "read_jsonl",
    "validate_events", "registry_from_events",
]


class Observability:
    """A registry, a tracer and, optionally, a recall probe for one scope.

    ``registry`` and ``tracer`` default to fresh instances; ``recall``
    stays ``None`` unless a probe is wanted. The probe binds its gauges
    to the first registry it meets (:meth:`RecallProbe.bind`).
    """

    def __init__(self, registry: MetricsRegistry = None,
                 tracer: Tracer = None, recall: RecallProbe = None):
        """Assemble a bundle, creating the registry and tracer if absent."""
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer()
        self.recall = recall
        if recall is not None:
            recall.bind(self.registry)

    def child(self, registry: MetricsRegistry = None) -> "Observability":
        """A per-replica bundle: its own registry, the tracer and probe
        shared (span ids must be unique across one dump)."""
        return Observability(
            registry=registry if registry is not None else MetricsRegistry(),
            tracer=self.tracer, recall=self.recall)

    def events(self, extra_meta: dict = None) -> list:
        """Schema-stamped JSONL events of this bundle's registry and spans."""
        return to_events(self.registry, self.tracer, extra_meta=extra_meta)
