"""Selective L2/IP-LUT construction (paper §4) — the plain tensor path.

Port of ``repro/core/lut.py``, the reference's semantics of record for
stage B. For each probed residual it computes the (S, E) table of
sub-distances and the selection mask ``dist <= tau[s]^2``.

Rounding: the reference forms ``<r, e>`` with an einsum, which its CPU
backend evaluates as ``fma(r1, e1, r0*e0)``; :func:`_dot` reproduces
that (the fused step in float64, rounded once), so this module matches
``repro.core.lut`` bit for bit. The serving path builds the same tables
with the ``selective_lut`` kernel instead (``kernels/ops.py``), whose
contract is ``repro/kernels/ref.py``'s plain ``r0*e0 + r1*e1``.
"""
from __future__ import annotations

import torch

from .pq import PQCodebook


def _dot(residual_sub: torch.Tensor, entries: torch.Tensor) -> torch.Tensor:
    """<r_s, e> (..., S, E), each step after the first rounded once."""
    r = residual_sub[..., None, :]                               # (..., S, 1, M)
    acc = r[..., 0] * entries[..., 0]
    for j in range(1, entries.shape[-1]):
        acc = (r[..., j].double() * entries[..., j].double()
               + acc.double()).float()
    return acc


def build_lut(residual_sub: torch.Tensor, codebook: PQCodebook,
              tau: torch.Tensor, *, metric: str = "l2"
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """residual_sub (..., S, M), tau (..., S) -> (lut, mask), each (..., S, E).

    l2: ``lut = |r_s - e|^2``, ``mask = lut <= tau^2``.
    ip: ``lut = <r_s, e>``, ``mask = |e|^2 - 2<r_s, e> <= tau^2`` (the
    transformed-L2 selection geometry).
    """
    r_dot_e = _dot(residual_sub, codebook.entries)
    e_sq = codebook.entry_sq
    tau_sq = (tau * tau)[..., None]
    if metric == "l2":
        r_sq = residual_sub[..., 0] * residual_sub[..., 0]
        for j in range(1, residual_sub.shape[-1]):
            r_sq = r_sq + residual_sub[..., j] * residual_sub[..., j]
        lut = r_sq[..., None] - 2.0 * r_dot_e + e_sq
        return lut, lut <= tau_sq
    if metric == "ip":
        return r_dot_e, (e_sq - 2.0 * r_dot_e) <= tau_sq
    raise ValueError(f"unknown metric {metric!r}")


def masked_lut(lut: torch.Tensor, mask: torch.Tensor, tau: torch.Tensor, *,
               metric: str = "l2") -> torch.Tensor:
    """Substitute pruned entries: τ² (l2) or the row's worst kept
    similarity (ip, :func:`ip_pruned_fill`)."""
    if metric == "l2":
        return torch.where(mask, lut, (tau * tau)[..., None])
    return ip_pruned_fill(lut, mask)


def ip_pruned_fill(lut: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """IP pruned-entry substitution: each pruned entry takes the minimum
    kept similarity of its row, or 0.0 when the row keeps nothing."""
    inf = torch.tensor(float("inf"), dtype=lut.dtype, device=lut.device)
    fill = torch.amin(torch.where(mask, lut, inf), dim=-1, keepdim=True)
    fill = torch.where(torch.isfinite(fill), fill, torch.zeros_like(fill))
    return torch.where(mask, lut, fill)


def hit_tables(lut: torch.Tensor, mask: torch.Tensor, tau: torch.Tensor, *,
               mode: str = "reward_penalty", metric: str = "l2"
               ) -> torch.Tensor:
    """l2 hit-count tables as int8 (..., S, E).

    ``mode="count"``: outer-sphere hit = +1, miss = 0.
    ``mode="reward_penalty"``: inner sphere (τ/2) = +1, ring = 0, miss = -1.
    """
    if metric != "l2":
        raise ValueError("use hit_tables_ip for the IP metric")
    if mode == "count":
        return mask.to(torch.int8)
    if mode == "reward_penalty":
        inner = lut <= ((0.5 * tau)[..., None]) ** 2
        return inner.to(torch.int8) - (~mask).to(torch.int8)
    raise ValueError(f"unknown hit-count mode {mode!r}")


def hit_tables_ip(r_dot_e: torch.Tensor, entry_sq: torch.Tensor,
                  tau: torch.Tensor, *, mode: str = "reward_penalty"
                  ) -> torch.Tensor:
    """IP hit tables from raw dot products (transformed-L2 geometry)."""
    t = entry_sq - 2.0 * r_dot_e
    tau_sq = (tau * tau)[..., None]
    outer = t <= tau_sq
    if mode == "count":
        return outer.to(torch.int8)
    inner = t <= 0.25 * tau_sq
    return inner.to(torch.int8) - (~outer).to(torch.int8)
