"""Uniform cell grid over the IVF centroids: the RT prefilter's index.

Port of ``repro/rt/grid.py``. The paper's stage-1 filter casts the query
as a ray and the cluster centroids as spheres, and lets RT cores report
which spheres the query lands in. The reference re-maps that onto a 2-D
orthonormal projection of the centroids (the "ray plane"): every cluster
``c`` carries a projected reach ``r_c`` (the largest projected distance of
a member from its centroid), and a query with ray-plane radius ``R``
intersects it iff ``‖P q − P c‖ ≤ R + r_c``. The centroids are laid out
in a padded uniform cell grid (``cap`` slots a cell, ``-inf`` reach at pad
slots), which the sphere test reads slot by slot.

The build (:func:`build_grid`) keeps the work over the C centroids in
numpy float32, as the reference does, so the layout (cell ids, slot map,
boxes, coordinates) is bit-equal given the same projection; the work over
the N points (residual projections, per-cluster reach, the calibration's
exact top-k and τ) runs in torch on the index's device. The projection is
the port's own draw unless one is injected (``proj=``): the reference
draws it with ``jax.random``.

The router's helpers (:func:`routing_state`, :func:`probe_budget`) are
host numpy, copied verbatim from the reference, ``np.polyval`` and its
step-by-step rounding of the sphere test included.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import density as density_lib
from ..core.pq import decode
from ..core.ref import exact_topk
from ..device import resolve_device
from ..kernels import ops
from ..kernels.ref import rt_query_radius_ref

#: analytic fallback (``calib_queries=0``): a full-space radius R contracts
#: to ~R·sqrt(2/D) under a (D, 2) orthonormal projection; SIGMA standard
#: deviations of it keep almost every in-sphere point inside the disc
DEFAULT_SIGMA = 3.0

_PREFIX = "rt_grid."


class CentroidGrid(NamedTuple):
    """Static-shape uniform cell grid over projected cluster centroids.

    The reference's twelve fields, as tensors on one device.
    """

    proj: torch.Tensor          # (D, 2) f32 — orthonormal ray-plane projection
    lo: torch.Tensor            # (2,) f32 — grid bounding box
    hi: torch.Tensor            # (2,) f32
    boxes: torch.Tensor         # (n_cells, 4) f32 — cell AABB [lo0, lo1, hi0, hi1]
    cell_ids: torch.Tensor      # (n_cells, cap) int32 — cluster per slot; -1 = pad
    cell_c0: torch.Tensor       # (n_cells, cap) f32 — projected centroid per slot
    cell_c1: torch.Tensor       # (n_cells, cap) f32
    slot_reach: torch.Tensor    # (n_cells, cap) f32 — reach per slot; -inf = pad
    cell_reach: torch.Tensor    # (n_cells,) f32 — max slot reach (-inf: empty)
    slot_of: torch.Tensor       # (C,) int32 — flat slot (cell*cap + s) per cluster
    radius_scale: torch.Tensor  # () f32 — full-space → ray-plane contraction
    radius_bias: torch.Tensor   # () f32 — calibrated additive radius term

    @property
    def n_cells(self) -> int:
        """Number of grid cells (G²)."""
        return self.cell_ids.shape[0]

    @property
    def capacity(self) -> int:
        """Padded slots a cell (``cap``)."""
        return self.cell_ids.shape[1]

    @property
    def grid_size(self) -> int:
        """Cells per axis G (the grid is square)."""
        return int(round(self.n_cells ** 0.5))


def _projection(dim: int, seed: int) -> np.ndarray:
    """The port's (D, 2) orthonormal projection: QR of a numpy
    ``Generator(seed)`` Gaussian (the reference draws with ``jax.random``)."""
    g = np.random.default_rng(seed).standard_normal((dim, 2))
    q, _ = np.linalg.qr(g)
    return q.astype(np.float32)


def _points(data, points) -> torch.Tensor:
    """The database points on the index's device: the given raw points, or
    their reconstruction from the PQ codes (centroid + decoded residual)."""
    dev = data.ivf.centroids.device
    if points is not None:
        if isinstance(points, torch.Tensor):
            return points.float().to(dev)
        return torch.from_numpy(np.require(np.asarray(points, np.float32),
                                           requirements=["C", "W"])).to(dev)
    cent = data.ivf.centroids
    return cent[data.ivf.labels.long()] + decode(data.codes, data.codebook)


def _radius_calibration(data, proj: np.ndarray, reach: np.ndarray, *,
                        metric: str, coverage: float, n_queries: int,
                        k: int = 10, seed: int = 0,
                        points=None) -> float:
    """Measure the τ → ray-plane radius bias on perturbed database points.

    For each calibration query the smallest radius whose survivors cover
    every owner cluster of its exact top-``k`` is
    ``max_owner(‖qp − cp‖ − reach_c)``; minus the query's contracted
    ``sqrt(Σ_s τ_s²)`` this leaves the correction the analytic radius
    misses, and its ``coverage`` quantile is ``radius_bias``. Step for step
    the reference's recipe: the sample and the noise come from
    ``default_rng(seed)``, the per-query geometry is numpy; the exact top-k
    over the N points runs on the index's device.
    """
    cent = data.ivf.centroids.cpu().numpy()
    labels = data.ivf.labels.cpu().numpy()
    pts = _points(data, points)
    n, d = pts.shape
    nq = min(n_queries, n)
    rng = np.random.default_rng(seed)
    qidx = rng.choice(n, size=nq, replace=False)
    std = np.float32(torch.std(pts.double(), correction=0).item())
    noise = 0.01 * rng.standard_normal((nq, d)) * std
    rows = pts[torch.from_numpy(qidx).to(pts.device)].cpu().numpy()
    queries = (rows + noise).astype(np.float32)

    _, gt = exact_topk(torch.from_numpy(queries).to(pts.device), pts, k=k,
                       metric=metric, chunk=min(65536, n))
    owners = labels[gt.cpu().numpy()]                          # (nq, k)
    qp = queries @ proj
    cp = cent @ proj
    dproj = np.linalg.norm(qp[:, None, :] - cp[owners], axis=-1)
    needed = (dproj - reach[owners]).max(axis=1)               # (nq,)

    if metric == "l2":   # probe-0 residual geometry, as at search time
        dd = np.sum(cent * cent, -1)[None, :] - 2.0 * queries @ cent.T
        res = queries - cent[np.argmin(dd, axis=1)]
    else:
        res = queries
    m = data.codebook.sub_dim
    sub = torch.from_numpy(np.ascontiguousarray(res.reshape(nq, -1, m)))
    tau = density_lib.predict_threshold(
        data.density, sub.to(pts.device), 1.0).cpu().numpy()
    tau_norm = np.sqrt(np.sum(tau * tau, axis=-1))
    contract = (2.0 / cent.shape[1]) ** 0.5
    return float(np.quantile(needed - contract * tau_norm, coverage))


def build_grid(data, *, metric: str = "l2", grid_size: int | None = None,
               proj_seed: int = 0, coverage: float = 0.9,
               calib_queries: int = 64, points=None,
               proj: np.ndarray | None = None) -> CentroidGrid:
    """Build the centroid cell grid for a built index, on its device.

    Parameters
    ----------
    data : JunoIndexData
        A built or loaded index; centroids, labels, codes, codebook and
        density model are read from it.
    metric : str
        "l2" | "ip" — the metric the index serves (drives calibration).
    grid_size : int, optional
        Cells per axis. Default ``max(2, round(sqrt(C / 4)))``.
    proj_seed : int
        Seed of the port's projection draw and of the calibration sample.
    coverage : float
        Radius calibration target: at ``rt_scale=1`` about this share of
        calibration queries keep every owner cluster of their top-10.
    calib_queries : int
        Calibration sample size; 0 falls back to the analytic
        ``DEFAULT_SIGMA · sqrt(2/D)`` contraction.
    points : array-like or torch.Tensor, optional
        (N, D) raw database points. Without them positions are
        reconstructed from the PQ codes, as the reference does.
    proj : np.ndarray, optional
        (D, 2) f32 projection to use instead of the port's own draw (e.g.
        the reference's ``repro.rt.grid._projection(D, seed)``).

    Returns
    -------
    CentroidGrid
        The grid, every tensor on the index's device.
    """
    dev = data.ivf.centroids.device
    cent = data.ivf.centroids.cpu().numpy()                    # (C, D)
    c, d = cent.shape
    proj = _projection(d, proj_seed) if proj is None \
        else np.asarray(proj, np.float32)
    cp = cent @ proj                                           # (C, 2)

    # per-cluster reach over the N points, on the device
    labels_t = data.ivf.labels.long()
    if points is not None:
        res = _points(data, points) - data.ivf.centroids[labels_t]
    else:
        res = decode(data.codes, data.codebook)
    rp = res @ torch.from_numpy(proj).to(dev)                  # (N, 2)
    rnorm = torch.sqrt(torch.sum(rp * rp, dim=-1))
    del res, rp
    reach = torch.zeros((c,), dtype=torch.float32, device=dev).scatter_reduce_(
        0, labels_t, rnorm, reduce="amax").cpu().numpy()

    if calib_queries > 0:
        radius_scale = (2.0 / d) ** 0.5
        radius_bias = _radius_calibration(
            data, proj, reach, metric=metric, coverage=coverage,
            n_queries=calib_queries, seed=proj_seed, points=points)
    else:
        radius_scale = DEFAULT_SIGMA * (2.0 / d) ** 0.5
        radius_bias = 0.0

    g = grid_size or max(2, int(round((c / 4.0) ** 0.5)))
    lo = cp.min(axis=0)
    hi = cp.max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    ij = np.clip(((cp - lo) / span * g).astype(np.int64), 0, g - 1)
    flat_cell = ij[:, 0] * g + ij[:, 1]

    counts = np.bincount(flat_cell, minlength=g * g)
    cap = max(8, int(-(-counts.max() // 8) * 8))               # pad to 8
    cell_ids = np.full((g * g, cap), -1, np.int32)
    slot_reach = np.full((g * g, cap), -np.inf, np.float32)
    cell_c0 = np.zeros((g * g, cap), np.float32)
    cell_c1 = np.zeros((g * g, cap), np.float32)
    slot_of = np.zeros((c,), np.int32)
    fill = np.zeros((g * g,), np.int64)
    for cid in range(c):
        cell = flat_cell[cid]
        s = fill[cell]
        cell_ids[cell, s] = cid
        cell_c0[cell, s] = cp[cid, 0]
        cell_c1[cell, s] = cp[cid, 1]
        slot_reach[cell, s] = reach[cid]
        slot_of[cid] = cell * cap + s
        fill[cell] += 1

    cell_lo = lo[None, :] + np.stack(
        np.meshgrid(np.arange(g), np.arange(g), indexing="ij"),
        axis=-1).reshape(-1, 2) * (span / g)[None, :]
    boxes = np.concatenate([cell_lo, cell_lo + (span / g)[None, :]],
                           axis=1).astype(np.float32)
    return grid_from_arrays(dict(
        proj=proj, lo=lo.astype(np.float32), hi=hi.astype(np.float32),
        boxes=boxes, cell_ids=cell_ids, cell_c0=cell_c0, cell_c1=cell_c1,
        slot_reach=slot_reach, cell_reach=slot_reach.max(axis=1),
        slot_of=slot_of, radius_scale=np.float32(radius_scale),
        radius_bias=np.float32(radius_bias)), dev, prefix="")


def grid_from_arrays(arrays: dict, device=None, *,
                     prefix: str = _PREFIX) -> CentroidGrid:
    """A grid on ``device`` from numpy arrays keyed ``prefix + field``.

    The default prefix reads the ``rt_grid.*`` group of an index artifact
    (``build.store.load_index`` builds ``LoadedIndex.rt_grid`` with it);
    every array keeps its bits.

    Raises
    ------
    KeyError
        When a field is missing.
    """
    dev = resolve_device(device)
    return CentroidGrid(**{
        f: torch.from_numpy(np.array(arrays[prefix + f], copy=True)).to(dev)
        for f in CentroidGrid._fields})


def grid_to(grid: CentroidGrid, device) -> CentroidGrid:
    """Copy every tensor of a grid to ``device``."""
    return CentroidGrid(*(t.to(device) for t in grid))


def query_radius(grid: CentroidGrid, tau: torch.Tensor,
                 scale: float = 1.0) -> torch.Tensor:
    """Ray-plane query radius from the calibrated thresholds.

    tau (Q, S) f32 — the probe-0 row of the search's thresholds ->
    (Q,) f32 ``scale · radius_scale · sqrt(Σ_s τ_s²) + radius_bias``, the
    search's own definition (``kernels/ref.py:rt_query_radius_ref``: the
    sum in float64, rounded once). ``scale`` is the rt analogue of
    ``thres_scale``: the radius is monotone in it, and very large values
    cover every cell. The search computes the radius inside
    ``ops.rt_probe_mask``; this and :func:`survivor_mask` serve the dense
    contract and the tests.
    """
    return rt_query_radius_ref(tau, scale, grid.radius_scale,
                               grid.radius_bias)


def survivor_mask(grid: CentroidGrid, queries: torch.Tensor,
                  radius: torch.Tensor) -> torch.Tensor:
    """Per-(query, cluster) sphere hits, in cluster order.

    Projects the queries (Q, D) onto the ray plane, runs the sphere test
    over every grid slot (``ops.rt_sphere_hits``: the dense CUDA kernel on
    the card) and gathers the table at ``slot_of`` -> (Q, C) int8.
    """
    qp = queries.float() @ grid.proj
    hits = ops.rt_sphere_hits(qp[:, 0].contiguous(), qp[:, 1].contiguous(),
                              radius, grid.cell_c0, grid.cell_c1,
                              grid.slot_reach)
    return hits[:, grid.slot_of.long()]


def update_radii(grid: CentroidGrid, clusters, reaches) -> CentroidGrid:
    """Grow the reaches of the clusters that took inserted points.

    Inserts never move centroids, so cell membership is stable: only the
    owning cluster's reach can grow (a new point may project farther from
    its centroid than any member). The touched slots' and cells' reaches
    are recomputed in numpy f32 on the host, as the reference does
    (``repro/rt/grid.py:343``, bit-equal), and written to new tensors on
    the grid's device. Deletes never shrink a reach (a stale larger reach
    only over-covers).

    Parameters
    ----------
    grid : CentroidGrid
        Current grid.
    clusters : array-like
        (B,) int — owning cluster of each inserted point.
    reaches : array-like
        (B,) f32 — projected residual length of each inserted point
        (``‖(p − centroid) @ proj‖``).

    Returns
    -------
    CentroidGrid
        A new grid; every untouched tensor is shared with ``grid``.
    """
    clusters = np.atleast_1d(np.asarray(clusters, np.int64))
    reaches = np.atleast_1d(np.asarray(reaches, np.float32))
    cap = grid.capacity
    slots = grid.slot_of.cpu().numpy()[clusters]
    slot_reach = grid.slot_reach.cpu().numpy().copy()
    np.maximum.at(slot_reach.reshape(-1), slots, reaches)
    cells = np.unique(slots // cap)
    cell_reach = grid.cell_reach.cpu().numpy().copy()
    cell_reach[cells] = slot_reach[cells].max(axis=1)
    dev = grid.slot_reach.device
    return grid._replace(slot_reach=torch.from_numpy(slot_reach).to(dev),
                         cell_reach=torch.from_numpy(cell_reach).to(dev))


def routing_state(grid: CentroidGrid, data) -> dict:
    """Host (numpy) snapshot of everything :func:`probe_budget` reads.

    The engine caches it, so a request's routing does no device → host
    copy. Returns plain numpy arrays and scalars keyed by name.
    """
    dens = data.density
    host = lambda t: t.cpu().numpy()  # noqa: E731
    return {
        "cent": host(data.ivf.centroids).astype(np.float32),
        "dens_grid": host(dens.grid),
        "dens_lo": host(dens.lo), "dens_hi": host(dens.hi),
        "coeffs": host(dens.coeffs),
        "tau_min": float(dens.tau_min), "tau_max": float(dens.tau_max),
        "sub_dim": int(data.codebook.sub_dim),
        "proj": host(grid.proj),
        "slot_of": host(grid.slot_of),
        "c0": host(grid.cell_c0).reshape(-1),
        "c1": host(grid.cell_c1).reshape(-1),
        "reach": host(grid.slot_reach).reshape(-1),
        "radius_scale": float(grid.radius_scale),
        "radius_bias": float(grid.radius_bias),
    }


def probe_budget(grid: CentroidGrid, data, queries, *, metric: str = "l2",
                 scale: float = 1.0, thres_scale: float = 1.0,
                 max_probes: int = 16, state: dict | None = None
                 ) -> np.ndarray:
    """Host (numpy) per-query probe budget — the router's rt input.

    Ranks each query's ``max_probes`` best clusters by the stage-A score
    and returns the rank of the last one that survives the sphere test
    (probe 0 always counts), so probing that many clusters reaches every
    cluster the rt mask keeps at the full budget. Verbatim the reference's
    numpy, which rounds the sphere test step by step (the search's test is
    ``fma(dx, dx, dy*dy)``; ROADMAP.md queue 3).

    Parameters
    ----------
    grid : CentroidGrid
        The built grid.
    data : JunoIndexData
        The served index (centroids and density model).
    queries : np.ndarray
        (Q, D) f32 queries.
    metric : str
        "l2" | "ip".
    scale : float
        Radius knob, as in :func:`query_radius`.
    thres_scale : float
        The routed searches' threshold multiplier.
    max_probes : int
        The unshrunk probe budget to rank within.
    state : dict, optional
        Cached :func:`routing_state` snapshot.

    Returns
    -------
    np.ndarray
        (Q,) int64 in ``[1, max_probes]``.
    """
    st = state if state is not None else routing_state(grid, data)
    q = np.atleast_2d(np.asarray(queries, np.float32))
    cent = st["cent"]
    max_probes = min(max_probes, cent.shape[0])
    qc = q @ cent.T                                            # (Q, C), once
    if metric == "l2":
        score = np.sum(cent * cent, -1)[None, :] - 2.0 * qc
        res = q - cent[np.argmin(score, axis=1)]
    else:
        score = -qc
        res = q
    order = np.argsort(score, axis=1)[:, :max_probes]          # (Q, np)

    qsub = res.reshape(q.shape[0], -1, st["sub_dim"])
    g = st["dens_grid"]
    gsz = g.shape[-1]
    span = np.maximum(st["dens_hi"] - st["dens_lo"], 1e-6)
    ij = np.clip(((qsub - st["dens_lo"]) / span * gsz).astype(np.int64),
                 0, gsz - 1)
    dval = g[np.arange(g.shape[0])[None, :], ij[..., 0], ij[..., 1]]
    tau = np.clip(np.polyval(st["coeffs"], dval),
                  st["tau_min"], st["tau_max"]) * thres_scale
    radius = (scale * st["radius_scale"]
              * np.sqrt(np.sum(tau * tau, axis=-1)) + st["radius_bias"])

    qp = q @ st["proj"]
    flat = st["slot_of"][order]                                # (Q, np)
    dx = qp[:, 0, None] - st["c0"][flat]
    dy = qp[:, 1, None] - st["c1"][flat]
    thr = radius[:, None] + st["reach"][flat]
    hit = (thr >= 0) & (dx * dx + dy * dy <= thr * thr)
    hit[:, 0] = True                                           # backstop
    return max_probes - np.argmax(hit[:, ::-1], axis=1)


def save_grid(path: str, grid: CentroidGrid) -> None:
    """Write a grid to ``path`` (.npz), the reference's format."""
    np.savez(path, **{k: v.cpu().numpy() for k, v in grid._asdict().items()})


def load_grid(path: str, device=None) -> CentroidGrid:
    """Read a grid written by :func:`save_grid` (either package's) onto
    ``device`` (``None`` = ``cuda``)."""
    with np.load(path) as z:
        return grid_from_arrays({k: z[k] for k in z.files}, device, prefix="")
