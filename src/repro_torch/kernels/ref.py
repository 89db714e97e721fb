"""Dense oracles for the ported kernels (the semantics of record).

Port of ``repro/kernels/ref.py:selective_lut_ref`` (l.12), ``pq_scan_ref``
(l.33), ``hit_count_ref`` (l.42), ``fused_two_stage_ref`` (l.50),
``fused_three_stage_ref`` (l.83) and ``rt_sphere_hits_ref`` (l.104), with
the rt search's radius (``rt_query_radius_ref``, the port's definition of
``repro/rt/grid.py:query_radius``). The
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


def fused_three_stage_ref(lut, table, codes, valid, q0, q1, radius,
                          cell_c0, cell_c1, slot_reach, slot_idx, *,
                          cap_c, metric="l2"):
    """Dense oracle for the three-stage RT → hit-count → ADC scan.

    The two-stage oracle with phase 0 in front: the dense sphere test
    (:func:`rt_sphere_hits_ref`) gathered at ``slot_idx`` (Q, np) — the
    grid slot of each probed cluster — gives ``probe_ok``; probe 0 is
    forced True (the nearest probe is always scanned); ``valid`` is masked
    by it before :func:`fused_two_stage_ref`. Returns that oracle's
    4-tuple + probe_ok (Q, np) bool.
    """
    probe_ok = probe_verdicts(rt_sphere_hits_ref(q0, q1, radius, cell_c0,
                                                 cell_c1, slot_reach), slot_idx)
    counts, dist, cand, cand_dist = fused_two_stage_ref(
        lut, table, codes, valid & probe_ok[:, :, None], cap_c=cap_c,
        metric=metric)
    return counts, dist, cand, cand_dist, probe_ok


def probe_verdicts(hits: torch.Tensor, slot_idx: torch.Tensor) -> torch.Tensor:
    """The sphere test's verdict per probe, probe 0 forced True.

    hits (Q, n_slots) int8 from :func:`rt_sphere_hits_ref`, slot_idx
    (Q, np) int grid slots of the probed clusters -> (Q, np) bool.
    """
    probe_ok = torch.gather(hits, 1, slot_idx.long()) > 0
    probe_ok[:, 0] = True
    return probe_ok


def rt_sphere_hits_ref(q0, q1, radius, c0, c1, slot_reach):
    """Dense oracle for the RT sphere-intersection filter.

    (Q,),(Q,),(Q,) f32 ray-plane queries and radii; (n_cells, cap) f32
    centroid planes and reaches -> (Q, n_cells·cap) int8, cell-major.
    hit = ``‖qp − cp‖ ≤ R + reach`` by the signed squared compare
    (``thr >= 0`` keeps the ``-inf`` pad slots from ever hitting), rounded
    as :func:`sphere_test` says.
    """
    return sphere_test(q0[:, None], q1[:, None], radius[:, None],
                       c0.reshape(1, -1), c1.reshape(1, -1),
                       slot_reach.reshape(1, -1)).to(torch.int8)


def sphere_test(q0, q1, radius, c0, c1, reach):
    """The disc-vs-disc test, elementwise over broadcast f32 operands
    -> bool.

    Rounded as the reference's oracle is on its CPU backend: the squared
    distance is ``fma(dx, dx, dy*dy)`` — evaluated in float64, where
    ``dx*dx`` is exact, and rounded to float32 once — and every other step
    rounds on its own (``csrc/sphere.cuh``).
    """
    dx = q0 - c0
    dy = q1 - c1
    d2 = (dx.double() * dx.double() + (dy * dy).double()).float()
    thr = radius + reach
    return (thr >= 0.0) & (d2 <= thr * thr)


def rt_query_radius_ref(tau, scale, radius_scale, radius_bias):
    """The ray-plane query radius, ``scale · radius_scale · √Σ_s τ_s² +
    radius_bias``, on any device.

    tau (..., S) f32; scale a float; radius_scale, radius_bias () f32 ->
    (...) f32. The squares and their sum are taken in float64 in s order
    and rounded once to float32; every later step rounds in float32 on its
    own, left to right, the square root correctly rounded (taken in f64 and
    rounded once: torch's float32 ``sqrt`` on the CPU is not). The sum of
    exact squares in f64, rounded once, does not depend on a reduction
    order the way a float32 ``torch.sum`` does, so a kernel can reproduce
    it (``csrc/sphere_hits.cu``). ``scale`` enters as a host scalar: no
    copy to the device.
    """
    t = tau.double()
    acc = torch.zeros(t.shape[:-1], dtype=torch.float64, device=t.device)
    for s in range(t.shape[-1]):
        acc = acc + t[..., s] * t[..., s]
    root = torch.sqrt(acc.float().double()).float()
    s32 = torch.tensor(scale, dtype=torch.float32)
    return s32 * radius_scale * root + radius_bias
