"""Dense oracles for the ported kernels (the semantics of record).

Port of ``repro/kernels/ref.py:selective_lut_ref`` (l.12), ``pq_scan_ref``
(l.33), ``hit_count_ref`` (l.42) and ``fused_two_stage_ref`` (l.50). The
two scans are batched over leading (Q, np) axes; they are also the
semantics of ``repro/core/scan.py:adc_scan`` and ``hit_count_scan``, which
the port therefore does not copy. Every top-k is a stable descending sort,
which reproduces ``lax.top_k``'s (value desc, index asc) order.
"""
from __future__ import annotations

import torch

NEG = -(2 ** 30)  # invalid-point count sentinel


def selective_lut_ref(q0, q1, e0, e1, esq, tau, *, metric="l2"):
    """(B,S),(B,S),(S,E),(S,E),(S,E),(B,S) -> lut (B,S,E) f32, hit (B,S,E) i8."""
    # imported here: core imports the kernel wrappers, which import this module
    from ..core.lut import ip_pruned_fill
    dot = q0[:, :, None] * e0[None] + q1[:, :, None] * e1[None]
    tau_sq = (tau * tau)[:, :, None]
    if metric == "l2":
        r_sq = (q0 * q0 + q1 * q1)[:, :, None]
        dist = r_sq - 2.0 * dot + esq[None]
        outer = dist <= tau_sq
        inner = dist <= 0.25 * tau_sq
        lut = torch.where(outer, dist, tau_sq)
    elif metric == "ip":
        t = esq[None] - 2.0 * dot
        outer = t <= tau_sq
        inner = t <= 0.25 * tau_sq
        lut = ip_pruned_fill(dot, outer)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    hit = inner.to(torch.int8) - (~outer).to(torch.int8)
    return lut.float(), hit


def gather_tables(tab: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``tab[q, probe, s, codes[q, probe, p, s]]`` -> (Q, np, P, S).

    tab (Q, np, S, E), codes (Q, np, P, S) uint8 (cast to int64 first: a
    uint8 index would be read as a mask).
    """
    q, n_probe, s, e = tab.shape
    flat = tab.reshape(q, n_probe, 1, s * e).expand(-1, -1, codes.shape[2], -1)
    idx = codes.long() + e * torch.arange(s, device=codes.device)
    return torch.gather(flat, 3, idx)


def bad_score(metric: str) -> float:
    """The invalid-slot score of a masked-ADC scan: +inf (l2), -inf (ip)."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    return float("inf") if metric == "l2" else float("-inf")


def pq_scan_ref(lut, codes, valid, *, metric="l2"):
    """Masked ADC: ``sum_s lut[q, probe, s, codes[q, probe, p, s]]``.

    lut (Q, np, S, E) f32, codes (Q, np, P, S) uint8, valid (Q, np, P)
    bool -> (Q, np, P) f32; invalid slots get +inf (l2) or -inf (ip).
    """
    totals = gather_tables(lut, codes).float().sum(-1)
    return torch.where(valid, totals,
                       torch.tensor(bad_score(metric), device=codes.device))


def hit_count_ref(table, codes, valid):
    """Hit count: ``sum_s table[q, probe, s, codes[q, probe, p, s]]``.

    table (Q, np, S, E) int8, codes (Q, np, P, S) uint8, valid (Q, np, P)
    bool -> (Q, np, P) int32; invalid slots get -2^30.
    """
    totals = gather_tables(table, codes).to(torch.int32).sum(
        -1, dtype=torch.int32)
    return torch.where(valid, totals,
                       torch.tensor(NEG, dtype=torch.int32, device=codes.device))


def fused_two_stage_ref(lut, table, codes, valid, *, cap_c, metric="l2"):
    """Dense oracle for the fused two-stage scan.

    lut/table (Q, np, S, E), codes (Q, np, P, S) uint8, valid (Q, np, P).
    counts = per-point hit totals (invalid -> -2^30); θ_q = cap_c-th
    largest count; dist = ADC totals wherever ``valid & count >= θ_q``,
    bad elsewhere; cand = top-cap_c of counts in (count desc, index asc)
    order; cand_dist = dist at cand.
    """
    q, n_probe, p, _ = codes.shape
    w = n_probe * p
    cap_c = max(1, min(cap_c, w))
    bad = bad_score(metric)
    counts = hit_count_ref(table, codes, valid)
    flat = counts.reshape(q, w)
    topv, order = torch.sort(flat, dim=1, descending=True, stable=True)
    cand = order[:, :cap_c]
    theta = topv[:, cap_c - 1]
    totals = gather_tables(lut, codes).float().sum(-1)
    keep = valid & (counts >= theta[:, None, None])
    dist = torch.where(keep, totals, torch.full_like(totals, bad))
    cand_dist = torch.gather(dist.reshape(q, w), 1, cand)
    return counts, dist, cand.to(torch.int32), cand_dist
