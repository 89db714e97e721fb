"""Batched Lloyd k-means — the training primitive for IVF and PQ.

Port of ``repro/core/kmeans.py``. Distances use the expansion
``|x-c|^2 = |x|^2 - 2 x.c^T + |c|^2`` so assignment is one matmul per
chunk, and the (N, C) distance matrix never materialises for large N.
Every function works on a batch of G independent problems, so the S
per-subspace PQ codebooks train in one call instead of a ``vmap``.

Randomness is injected: ``kmeans`` takes its init indices, and
``kmeans_subsampled`` its subsample indices, so a build can either draw
them itself or reproduce another implementation's draws.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class KMeansState(NamedTuple):
    """Trained centroids and the cluster sizes of the last iteration."""

    centroids: torch.Tensor  # (G, C, D) f32
    counts: torch.Tensor     # (G, C)    f32


def _reseed_indices(i: int, n: int, n_clusters: int,
                    device: torch.device) -> torch.Tensor:
    """Deterministic, pairwise-distinct reseed targets for dead clusters.

    The map ``j -> (base_i + j) % n`` is injective whenever
    ``n_clusters <= n`` (reference: ``core/kmeans.py:_reseed_indices``).

    Returns
    -------
    torch.Tensor
        (n_clusters,) int64 point indices for Lloyd iteration ``i``.
    """
    base = (7919 * (i + 2) + 7) % n
    return (base + torch.arange(n_clusters, device=device)) % n


def assign(points: torch.Tensor, centroids: torch.Tensor, *,
           chunk: int = 16384) -> torch.Tensor:
    """Nearest-centroid id per point, batched over G problems.

    Parameters
    ----------
    points : torch.Tensor
        (G, N, D) or (N, D) f32.
    centroids : torch.Tensor
        (G, C, D) or (C, D) f32, matching ``points``' batch form.
    chunk : int
        Points per distance block (memory O(G·chunk·C)).

    Returns
    -------
    torch.Tensor
        (G, N) or (N,) int64 labels; ties go to the lowest centroid id.
    """
    squeeze = points.dim() == 2
    if squeeze:
        points, centroids = points[None], centroids[None]
    c_sq = torch.sum(centroids * centroids, dim=-1)              # (G, C)
    out = []
    for lo in range(0, points.shape[1], chunk):
        x = points[:, lo:lo + chunk]
        d = c_sq[:, None, :] - 2.0 * torch.bmm(x, centroids.transpose(1, 2))
        out.append(torch.argmin(d, dim=-1))
    labels = torch.cat(out, dim=1)
    return labels[0] if squeeze else labels


def _update(points: torch.Tensor, labels: torch.Tensor, n_clusters: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster coordinate sums (G, C, D) and sizes (G, C)."""
    g, n, d = points.shape
    flat = (labels + n_clusters * torch.arange(
        g, device=labels.device)[:, None]).reshape(-1)
    sums = torch.zeros((g * n_clusters, d), dtype=points.dtype,
                       device=points.device)
    sums.index_add_(0, flat, points.reshape(-1, d))
    counts = torch.bincount(flat, minlength=g * n_clusters).to(points.dtype)
    return sums.reshape(g, n_clusters, d), counts.reshape(g, n_clusters)


def kmeans(points: torch.Tensor, init_idx: torch.Tensor, *, n_iters: int = 10,
           chunk: int = 16384) -> KMeansState:
    """Lloyd k-means from given init points; dead clusters are reseeded.

    Parameters
    ----------
    points : torch.Tensor
        (G, N, D) f32 — G independent problems of N points each.
    init_idx : torch.Tensor
        (G, C) int — the initial centroids' point indices per problem.
    n_iters : int
        Lloyd iterations.
    chunk : int
        Assignment chunk (see :func:`assign`).

    Returns
    -------
    KMeansState
        Centroids (G, C, D) and the last iteration's counts (G, C).
    """
    g, n, _ = points.shape
    n_clusters = init_idx.shape[1]
    pts = points.float()
    rows = torch.arange(g, device=pts.device)[:, None]
    centroids = pts[rows, init_idx.to(pts.device).long()]
    counts = torch.zeros((g, n_clusters), dtype=torch.float32,
                         device=pts.device)
    for i in range(n_iters):
        labels = assign(pts, centroids, chunk=chunk)
        sums, counts = _update(pts, labels, n_clusters)
        new = sums / torch.clamp(counts, min=1.0)[..., None]
        reseed = pts[:, _reseed_indices(i, n, n_clusters, pts.device)]
        centroids = torch.where((counts > 0)[..., None], new, reseed)
    return KMeansState(centroids=centroids, counts=counts)


def kmeans_subsampled(points: torch.Tensor, init_idx: torch.Tensor, *,
                      train_idx: torch.Tensor | None = None,
                      n_iters: int = 10, chunk: int = 16384) -> KMeansState:
    """FAISS-style: train on a subsample, assign the full set later.

    Parameters
    ----------
    points : torch.Tensor
        (N, D) f32.
    init_idx : torch.Tensor
        (C,) int — init indices into the TRAINING set.
    train_idx : torch.Tensor, optional
        (T,) int — the training subsample; ``None`` trains on all points.
    n_iters, chunk
        See :func:`kmeans`.

    Returns
    -------
    KMeansState
        Centroids (C, D) and counts (C,) for the single problem.
    """
    train = points if train_idx is None else points[
        train_idx.to(points.device).long()]
    st = kmeans(train[None], init_idx[None], n_iters=n_iters, chunk=chunk)
    return KMeansState(centroids=st.centroids[0], counts=st.counts[0])
