"""Exact brute-force nearest neighbours — the ground truth for calibration
and recall. Port of ``repro/core/ref.py``: chunked over the points, so the
(Q, N) score matrix never materialises for large N."""
from __future__ import annotations

import torch

from .metrics import recall_n_at_k  # noqa: F401  (re-exported for its callers)


def exact_topk(queries: torch.Tensor, points: torch.Tensor, *, k: int,
               metric: str = "l2", chunk: int = 65536
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k scores and ids: queries (Q, D), points (N, D) -> (Q, k).

    A running best-k is merged with each chunk by a stable descending
    sort, which keeps ``lax.top_k``'s (score desc, index asc) tie order.
    Scores are squared distances up to the query norm (l2, ascending) or
    inner products (ip, descending).
    """
    q = queries.float()
    nq = q.shape[0]
    best_s = torch.full((nq, 0), float("-inf"), device=q.device)
    best_i = torch.full((nq, 0), -1, dtype=torch.int64, device=q.device)
    for lo in range(0, points.shape[0], chunk):
        pts = points[lo:lo + chunk].float()
        dots = q @ pts.T
        if metric == "l2":
            p_sq = torch.sum(pts * pts, dim=-1)
            scores = -(p_sq[None, :] - 2.0 * dots)
        elif metric == "ip":
            scores = dots
        else:
            raise ValueError(f"unknown metric {metric!r}")
        ids = torch.arange(lo, lo + pts.shape[0], device=q.device)
        cat_s = torch.cat([best_s, scores], dim=1)
        cat_i = torch.cat([best_i, ids[None].expand(nq, -1)], dim=1)
        top_s, sel = torch.sort(cat_s, dim=1, descending=True, stable=True)
        best_s, best_i = top_s[:, :k], torch.gather(cat_i, 1, sel[:, :k])
    sign = -1.0 if metric == "l2" else 1.0
    return sign * best_s, best_i
