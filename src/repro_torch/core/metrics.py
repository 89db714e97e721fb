"""Search-quality metrics exactly as defined in the paper §6.1.

Port of ``repro/core/metrics.py``. Each takes integer id tensors on one
device and returns a Python float.
"""
from __future__ import annotations

import torch


def recall_1_at_k(retrieved: torch.Tensor, gt_top1: torch.Tensor) -> float:
    """R1@K: fraction of queries whose K retrieved ids include the true NN.

    retrieved (Q, K), gt_top1 (Q,) integer ids.
    """
    hit = (retrieved == gt_top1[:, None]).any(dim=1)
    return float(hit.float().mean())


def recall_n_at_k(retrieved: torch.Tensor, gt_topn: torch.Tensor) -> float:
    """R{N}@{K} (the paper's R100@1000): mean fraction of the true top-N
    present among the K retrieved.

    retrieved (Q, K), gt_topn (Q, N) integer ids.
    """
    hits = (retrieved[:, None, :] == gt_topn[:, :, None]).any(dim=2)
    return float(hits.float().mean())
