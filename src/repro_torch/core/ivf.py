"""Inverted file index: coarse k-means filtering and padded cluster storage.

Port of ``repro/core/ivf.py``. Clusters are padded to a fixed capacity P,
so the online scan over the probed clusters is a static-shape gather.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import ops
from .kmeans import assign, kmeans_subsampled


class IVFIndex(NamedTuple):
    """Centroids plus the padded (C, P) cluster layout."""

    centroids: torch.Tensor     # (C, D) f32
    centroid_sq: torch.Tensor   # (C,)   f32
    point_ids: torch.Tensor     # (C, P) int32 — point ids; -1 = pad
    valid: torch.Tensor         # (C, P) bool
    labels: torch.Tensor        # (N,)   int32 — cluster of each point

    @property
    def n_clusters(self) -> int:
        """Number of clusters C."""
        return self.centroids.shape[0]

    @property
    def capacity(self) -> int:
        """Padded slots per cluster P."""
        return self.point_ids.shape[1]


def cluster_capacity(n: int, n_clusters: int, capacity_mult: float) -> int:
    """Padded per-cluster slot count: ``capacity_mult * N/C``, min 8, mult of 8."""
    cap = int(max(8, capacity_mult * n / n_clusters))
    return ((cap + 7) // 8) * 8


def padded_layout(labels: np.ndarray, n_clusters: int, cap: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Pack point ids into the padded (C, P) layout, spilling overflow.

    Same placement as the reference's point-by-point loop
    (``repro/core/ivf.py:padded_layout``), vectorized: each cluster takes
    its points in id order up to ``cap``; the overflow, in id order, fills
    the emptiest clusters (visited in ``np.argsort(fill)`` order) and its
    ``labels`` entries are rewritten to the adoptive cluster.

    Parameters
    ----------
    labels : np.ndarray
        (N,) int — owning cluster per point. Modified in place on spill.
    n_clusters : int
        Number of clusters C.
    cap : int
        Padded capacity P per cluster.

    Returns
    -------
    tuple of np.ndarray
        ``(point_ids (C, P) int32 with -1 padding, labels (N,))``.
    """
    n = labels.shape[0]
    point_ids = np.full((n_clusters, cap), -1, dtype=np.int32)
    order = np.argsort(labels, kind="stable")
    srt = labels[order]
    starts = np.searchsorted(srt, np.arange(n_clusters))
    rank = np.arange(n) - starts[srt]
    fits = rank < cap
    point_ids[srt[fits], rank[fits]] = order[fits]
    fill = np.minimum(np.bincount(labels, minlength=n_clusters), cap)
    overflow = np.sort(order[~fits])
    oi = 0
    for c in np.argsort(fill):
        if oi >= overflow.size:
            break
        take = min(cap - int(fill[c]), overflow.size - oi)
        if take > 0:
            pids = overflow[oi:oi + take]
            point_ids[c, fill[c]:fill[c] + take] = pids
            labels[pids] = c
            fill[c] += take
            oi += take
    return point_ids, labels


def build_ivf(points: torch.Tensor, init_idx: torch.Tensor, *,
              n_clusters: int, train_idx: torch.Tensor | None = None,
              n_iters: int = 10, capacity_mult: float = 4.0) -> IVFIndex:
    """Train IVF centroids and build the padded cluster layout.

    Parameters
    ----------
    points : torch.Tensor
        (N, D) f32.
    init_idx : torch.Tensor
        (C,) int — k-means init indices into the training set.
    n_clusters : int
        Number of clusters C.
    train_idx : torch.Tensor, optional
        (T,) int — Lloyd training subsample (``None``: all points).
    n_iters : int
        Lloyd iterations.
    capacity_mult : float
        Padding headroom over the balanced fill N / C.

    Returns
    -------
    IVFIndex
        The trained index on ``points``' device.
    """
    if init_idx.shape[0] != n_clusters:
        raise ValueError(f"init_idx has {init_idx.shape[0]} entries for "
                         f"{n_clusters} clusters")
    st = kmeans_subsampled(points, init_idx, train_idx=train_idx,
                           n_iters=n_iters)
    labels = assign(points, st.centroids).cpu().numpy()
    cap = cluster_capacity(points.shape[0], n_clusters, capacity_mult)
    point_ids, labels = padded_layout(labels, n_clusters, cap)
    point_ids = torch.from_numpy(point_ids).to(points.device)
    return IVFIndex(
        centroids=st.centroids,
        centroid_sq=torch.sum(st.centroids * st.centroids, dim=-1),
        point_ids=point_ids,
        valid=point_ids >= 0,
        labels=torch.from_numpy(labels.astype(np.int32)).to(points.device))


def filter_clusters(queries: torch.Tensor, index: IVFIndex, *, nprobe: int,
                    metric: str = "l2") -> tuple[torch.Tensor, torch.Tensor]:
    """Stage A: the nprobe closest (l2) or most similar (ip) centroids.

    ``ops.filter_topk``: on the card one ``ivf_filter`` launch, whose
    epilogue keeps each row's best nprobe; on the CPU the plain
    ``csq − 2·(q @ cᵀ)`` as the reference computes it at
    ``repro/core/ivf.py:143``, then a stable sort. Both give
    ``lax.top_k``'s order: (score best first, index ascending on ties).

    Returns
    -------
    tuple of torch.Tensor
        ``(scores (Q, nprobe) f32, cluster_ids (Q, nprobe) int64)``;
        scores are lower-is-better for l2 and higher-is-better for ip.
    """
    return ops.route().filter_topk(queries.float(), index.centroids,
                           index.centroid_sq, nprobe=nprobe, metric=metric)
