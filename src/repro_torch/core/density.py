"""Dynamic-threshold machinery (paper §4.1).

Port of ``repro/core/density.py``. Offline: a G×G density grid per
subspace over the residual projections, plus a polynomial regressor
log-density → the threshold that contains the top-100. Online: grid
lookup, polynomial evaluation, clip and the user's scale factor.

τ must match the reference bit for bit, or the τ² compares of stage B
flip. Two details carry that: the float → int32 cell index truncates
toward zero before the clip, and :func:`polyval` rounds each Horner step
``y*x + c`` once, as the fused multiply-add that ``jnp.polyval`` compiles
to on the reference's CPU backend does (each step is evaluated in
float64, where the product is exact, and rounded to float32 once).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class DensityModel(NamedTuple):
    """Density grid, its box, and the calibrated threshold polynomial."""

    grid: torch.Tensor      # (S, G, G) f32 — log1p point density per cell
    lo: torch.Tensor        # (S, M) f32 — bounding box per subspace
    hi: torch.Tensor        # (S, M) f32
    coeffs: torch.Tensor    # (deg+1,) f32 — highest degree first
    tau_min: torch.Tensor   # () f32 — clamp range for predicted thresholds
    tau_max: torch.Tensor   # () f32

    @property
    def grid_size(self) -> int:
        """Cells per grid side G."""
        return self.grid.shape[-1]


def _cells(sub: torch.Tensor, lo: torch.Tensor, span: torch.Tensor,
           g: int) -> torch.Tensor:
    """Grid cell (i, j) per point: truncate toward zero, then clip."""
    return torch.clamp(((sub - lo) / span * g).to(torch.int32), 0, g - 1).long()


def build_density_grid(sub_points: torch.Tensor, grid_size: int = 100
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """sub_points (S, N, M) -> (grid (S, G, G), lo (S, M), hi (S, M)).

    Density per cell = count / cell_area, stored as log1p.
    """
    s, _, m = sub_points.shape
    if m != 2:
        raise ValueError("density grid assumes 2-D subspaces (M=2)")
    lo = torch.amin(sub_points, dim=1)
    hi = torch.amax(sub_points, dim=1)
    span = torch.clamp(hi - lo, min=1e-6)
    g = grid_size
    ij = _cells(sub_points, lo[:, None], span[:, None], g)      # (S, N, 2)
    flat = (ij[..., 0] * g + ij[..., 1]
            + g * g * torch.arange(s, device=ij.device)[:, None])
    counts = torch.bincount(flat.reshape(-1), minlength=s * g * g)
    counts = counts.to(torch.float32).reshape(s, g, g)
    cell_area = (span[:, 0] / g) * (span[:, 1] / g)
    grid = torch.log1p(counts / torch.clamp(cell_area, min=1e-12)[:, None, None])
    return grid, lo, hi


def accumulate_density_counts(counts: torch.Tensor, sub_points: torch.Tensor,
                              lo: torch.Tensor, hi: torch.Tensor,
                              weights: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Add one chunk's binned counts to a running (S, G, G) histogram.

    The streaming counterpart of :func:`build_density_grid`
    (``repro/core/density.py:accumulate_density_counts``): the box is
    fixed up front, and an out-of-box point clips to an edge cell, its
    cell index computed step by step in f32 as :func:`_cells` does, so
    chunks accumulate independently. Each row adds its weight (0 for a
    pad row, ±1 for the spill patch) with one ``index_add_`` on a flat
    (S·G·G) view. The counts are whole numbers in f32, so the order of
    the adds does not change them while a cell stays below 2²⁴; past
    that an f32 count no longer holds every whole number (the reference
    has the same limit).

    Parameters
    ----------
    counts : torch.Tensor
        (S, G, G) f32 running counts (start from zeros); not modified.
    sub_points : torch.Tensor
        (S, B, M) f32 — one chunk's residual subspace projections.
    lo, hi : torch.Tensor
        (S, M) f32 — the fixed box per subspace.
    weights : torch.Tensor, optional
        (B,) f32 weight of each row (default all ones).

    Returns
    -------
    torch.Tensor
        (S, G, G) f32 updated counts.
    """
    s, b, _ = sub_points.shape
    g = counts.shape[-1]
    span = torch.clamp(hi - lo, min=1e-6)
    ij = _cells(sub_points, lo[:, None], span[:, None], g)       # (S, B, 2)
    flat = (ij[..., 0] * g + ij[..., 1]
            + g * g * torch.arange(s, device=ij.device)[:, None])
    w = (torch.ones((b,), dtype=torch.float32, device=counts.device)
         if weights is None else weights.float())
    out = counts.reshape(-1).clone()
    out.index_add_(0, flat.reshape(-1), w.expand(s, b).reshape(-1))
    return out.reshape(counts.shape)


def density_grid_from_counts(counts: torch.Tensor, lo: torch.Tensor,
                             hi: torch.Tensor) -> torch.Tensor:
    """Streamed raw counts (S, G, G) -> the log1p density grid
    ``log1p(count / cell_area)``, what :func:`build_density_grid` gives in
    one shot (``repro/core/density.py:density_grid_from_counts``)."""
    g = counts.shape[-1]
    span = torch.clamp(hi - lo, min=1e-6)
    cell_area = (span[:, 0] / g) * (span[:, 1] / g)
    return torch.log1p(counts / torch.clamp(cell_area, min=1e-12)[:, None, None])


def lookup_density(model: DensityModel, sub_queries: torch.Tensor
                   ) -> torch.Tensor:
    """sub_queries (..., S, M) -> densities (..., S)."""
    g = model.grid_size
    span = torch.clamp(model.hi - model.lo, min=1e-6)
    ij = _cells(sub_queries, model.lo, span, g)
    s_idx = torch.arange(model.grid.shape[0], device=ij.device)
    return model.grid[s_idx.expand(ij.shape[:-1]), ij[..., 0], ij[..., 1]]


def polyval(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Horner evaluation, coefficients highest degree first (float32).

    Each step ``y = y*x + c`` is rounded once, like a fused multiply-add:
    see the module docstring.
    """
    x64 = x.double()
    y = torch.zeros_like(x)
    for c in coeffs.double():
        y = (y.double() * x64 + c).float()
    return y


def fit_threshold_regressor(densities: torch.Tensor, thresholds: torch.Tensor,
                            degree: int = 2) -> torch.Tensor:
    """Least-squares polynomial fit threshold = poly(log-density).

    Solved in float64 on the CPU (the system is (Qs·S) × (degree+1)).

    Returns
    -------
    torch.Tensor
        (degree+1,) f32 coefficients, highest degree first, on the
        inputs' device.
    """
    x = densities.reshape(-1).double().cpu()
    y = thresholds.reshape(-1).double().cpu()
    powers = torch.stack([x ** d for d in range(degree, -1, -1)], dim=-1)
    coeffs = torch.linalg.lstsq(powers, y[:, None], driver="gelsd").solution
    return coeffs[:, 0].float().to(densities.device)


def predict_threshold(model: DensityModel, sub_queries: torch.Tensor,
                      scale: float = 1.0) -> torch.Tensor:
    """(..., S, M) query projections -> per-subspace thresholds τ (..., S)."""
    tau = polyval(model.coeffs, lookup_density(model, sub_queries))
    tau = torch.minimum(torch.maximum(tau, model.tau_min), model.tau_max)
    return tau * scale


def calibrate(sub_points: torch.Tensor, sample_queries: torch.Tensor,
              topk_entry_dists: torch.Tensor, *, grid_size: int = 100,
              degree: int = 2) -> DensityModel:
    """Build the full :class:`DensityModel`.

    Parameters
    ----------
    sub_points : torch.Tensor
        (S, N, M) residual projections (the grid's source).
    sample_queries : torch.Tensor
        (Qs, S, M) calibration query projections.
    topk_entry_dists : torch.Tensor
        (Qs, S) distance that contains the top-k's entries per subspace.
    grid_size, degree
        Grid side G and polynomial degree.

    Returns
    -------
    DensityModel
        The calibrated model.
    """
    grid, lo, hi = build_density_grid(sub_points, grid_size)
    return calibrate_from_grid(grid, lo, hi, sample_queries,
                               topk_entry_dists, degree=degree)


def calibrate_from_grid(grid: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                        sample_queries: torch.Tensor,
                        topk_entry_dists: torch.Tensor, *,
                        degree: int = 2) -> DensityModel:
    """Fit the covering threshold regressor onto a built density grid.

    The intercept is shifted by mean + 1σ of the fit's residuals, so the
    predicted τ upper-bounds ~84% of calibration pairs; the clamp range is
    the 1% quantile and the 99.9% quantile plus that margin (reference:
    ``repro/core/density.py:calibrate_from_grid``).

    Returns
    -------
    DensityModel
        The complete calibrated model.
    """
    f32 = dict(dtype=torch.float32, device=grid.device)
    stub = DensityModel(grid=grid, lo=lo, hi=hi,
                        coeffs=torch.zeros((degree + 1,), **f32),
                        tau_min=torch.tensor(0.0, **f32),
                        tau_max=torch.tensor(1.0, **f32))
    dens = lookup_density(stub, sample_queries)                   # (Qs, S)
    coeffs = fit_threshold_regressor(dens, topk_entry_dists, degree)
    y = topk_entry_dists.reshape(-1).float()
    resid = y - polyval(coeffs, dens.reshape(-1))
    margin = torch.mean(resid) + torch.std(resid, correction=0)
    coeffs = coeffs.clone()
    coeffs[-1] += margin
    q_lo = torch.quantile(y, 0.01)
    q_hi = torch.quantile(y, 0.999) + margin
    return DensityModel(grid=grid, lo=lo, hi=hi, coeffs=coeffs,
                        tau_min=q_lo.float(), tau_max=q_hi.float())
