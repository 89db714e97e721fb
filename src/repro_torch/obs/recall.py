"""Online recall telemetry from a sampled exact-rerank shadow path.

Port of ``repro/obs/recall.py``. :class:`RecallProbe` shadows one in
``every`` served requests of each tier (round-robin, no RNG): it scores
the request's queries exactly against the vectors it was built with and
reports the share of the engine's returned ids found in the exact top-k,
as a ``juno_recall_online_at_k`` gauge a tier beside a
``juno_recall_samples_total`` counter. The reference reranks in numpy on
the host, a (Q, N) matrix a sampled request; the port reranks on the
vectors' device with ``core.ref.exact_topk`` (chunked over the points,
a stable sort per chunk), so a 200-row request at 1M points costs
milliseconds on the card. It runs after the request's results are
returned, so it never changes them.

Snapshot caveat: ids inserted after the probe was built lie outside its
vectors and count as misses, biasing the estimate down.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.ref import exact_topk
from ..device import resolve_device
from .registry import MetricsRegistry


def exact_topk_ids(queries, vectors, k: int, metric: str = "l2"
                   ) -> np.ndarray:
    """Exact top-``k`` row ids per query: ``(Q, k)`` int64 on the host,
    best first. The rerank runs on ``vectors``' device (a tensor), or on
    the CPU for an array; ``metric`` is ``"l2"`` (squared euclidean) or
    ``"ip"`` (maximum inner product)."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    v = vectors if isinstance(vectors, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(vectors, np.float32))
    q = torch.as_tensor(np.asarray(queries, np.float32)).to(v.device)
    _, ids = exact_topk(q, v, k=min(int(k), v.shape[0]), metric=metric)
    return ids.cpu().numpy()


class RecallProbe:
    """Sampled online recall@k estimator feeding registry gauges.

    Parameters
    ----------
    vectors : array-like or torch.Tensor
        ``(N, D)`` raw rows; id ``i`` is row ``i``. A tensor stays where
        it is; an array is copied to ``device``.
    k : int
        Depth of the estimate (``recall@k``).
    every : int
        Rerank one request out of this many, per tier (round-robin from
        the first).
    metric : str
        ``"l2"`` or ``"ip"``; must match the served index.
    device : str or torch.device, optional
        Where an array's rerank runs (``None`` = ``cuda``).
    """

    def __init__(self, vectors, *, k: int = 10, every: int = 8,
                 metric: str = "l2", device=None):
        """Hold the vectors and the sampling cadence."""
        self.vectors = (vectors.float() if isinstance(vectors, torch.Tensor)
                        else torch.from_numpy(np.ascontiguousarray(
                            vectors, np.float32)).to(resolve_device(device)))
        self.k = int(k)
        self.every = max(1, int(every))
        self.metric = metric
        self._seen: dict[str, int] = {}
        # per-tier running sums: (matched ids, compared ids)
        self._hits: dict[str, int] = {}
        self._total: dict[str, int] = {}
        self._registry = None

    def bind(self, registry: MetricsRegistry) -> None:
        """Attach the registry that receives the gauges (first bind wins)."""
        if self._registry is None:
            self._registry = registry

    def observe(self, req, mode: str) -> None:
        """Maybe rerank one completed request of tier ``mode``: ``req``
        needs ``queries``, ``ids`` and ``k``; every ``every``-th call of a
        tier reranks, starting with the first."""
        n = self._seen.get(mode, 0)
        self._seen[mode] = n + 1
        if n % self.every != 0 or req.ids is None:
            return
        k = min(self.k, int(req.k))
        exact = exact_topk_ids(req.queries, self.vectors, k, self.metric)
        got = np.asarray(req.ids)[:, :k]
        # returned ids are unique within a row but for the -1 padding,
        # masked out, so membership counts the intersection
        hits = int((((got[:, :, None] == exact[:, None, :]).any(-1))
                    & (got >= 0)).sum())
        self._hits[mode] = self._hits.get(mode, 0) + hits
        self._total[mode] = self._total.get(mode, 0) + got.shape[0] * k
        if self._registry is not None:
            self._registry.counter(
                "juno_recall_samples_total", mode=mode).inc(got.shape[0])
            self._registry.gauge(
                "juno_recall_online_at_k", mode=mode,
                k=str(k)).set(self.estimate(mode))

    def estimate(self, mode: str) -> float:
        """The tier's recall@k estimate so far (0.0 before any sample)."""
        total = self._total.get(mode, 0)
        if total == 0:
            return 0.0
        return self._hits.get(mode, 0) / total
