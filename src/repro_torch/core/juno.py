"""The JUNO index: offline build and the online search of every tier.

Port of ``repro/core/juno.py`` (``JunoConfig``, ``JunoIndexData``,
``build``, ``_calibrate_density``, ``_rt_probe_mask``, ``_score_probed``,
``_search_batch``, ``_score_probed_two_stage``, ``_search_batch_two_stage``
and ``search``), without the side buffer.

Offline (:func:`build`): IVF k-means → residual PQ codebooks → padded
per-cluster codes → density grid and threshold-regressor calibration.
Every random draw of the build is injectable (:class:`BuildDraws`), so a
build can reproduce another implementation's sample and init indices.

Online (:func:`search`): stage A filters the nprobe nearest clusters
(one GEMM), τ comes from the density model, stage B builds the masked LUT
and the int8 hit table (``selective_lut`` kernel), and stage C scores the
probed points by tier (paper's JUNO-H/M/L, plus the two-stage H2):

* "H": masked ADC of every probed point (``pq_scan`` kernel), top-k;
* "M": reward/penalty hit count (``hit_count`` kernel), top-k by count;
* "L": plain hit count, the table clipped to {0, 1}, top-k by count;
* "H2": hit count → top-C → masked ADC of the C → top-k, either in one
  fused kernel (``fused=True``, ``fused_two_stage``) or composed
  (``hit_count`` kernel, then a plain-torch rerank).

With ``prefilter="rt"`` (the paper's RT-core stage-1 filter, ``rt/``) the
probes whose cluster disc the query disc misses in the ray plane are
pruned from stage C: the ``sphere_hits`` kernel gives each probe its
verdict (probe 0 always kept) and the scans treat a pruned probe's points
as invalid slots. Fused H2 then runs all three stages in the
``fused_three_stage`` kernel unless ``fused3=False``.

The side buffer raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from ..rt import grid as rt_lib
from . import density as density_lib
from .ivf import IVFIndex, build_ivf, filter_clusters
from .pq import PQCodebook, encode, split_subspaces, train_codebook
from .ref import exact_topk


@dataclasses.dataclass(frozen=True)
class JunoConfig:
    """Build-time knobs of the JUNO index (the reference's fields)."""

    n_clusters: int = 1024          # C
    n_entries: int = 256            # E
    sub_dim: int = 2                # M
    metric: str = "l2"              # "l2" | "ip"
    kmeans_iters: int = 10
    capacity_mult: float = 4.0
    max_train_points: int = 200_000  # Lloyd subsample (<= 0: all points)
    grid_size: int = 64             # density grid G
    calib_queries: int = 128        # queries used to fit the threshold poly
    calib_topk: int = 100
    poly_degree: int = 2


class JunoIndexData(NamedTuple):
    """A built index: IVF + PQ codebooks + padded codes + density model."""

    ivf: IVFIndex
    codebook: PQCodebook
    codes: torch.Tensor          # (N, S) uint8
    cluster_codes: torch.Tensor  # (C, P, S) uint8 — padded per-cluster codes
    density: density_lib.DensityModel
    points_sq: torch.Tensor      # (N,) f32


class BuildDraws(NamedTuple):
    """Every random draw of :func:`build` (numpy integer / float arrays)."""

    ivf_train_idx: np.ndarray | None  # (T,) IVF Lloyd subsample, or None
    ivf_init_idx: np.ndarray          # (C,) k-means init, into the subsample
    pq_train_idx: np.ndarray | None   # (T,) PQ training subsample, or None
    pq_init_idx: np.ndarray           # (S, E) per-subspace init indices
    calib_idx: np.ndarray             # (nq,) calibration query points
    calib_noise: np.ndarray           # (nq, D) unscaled N(0, 1) noise


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, queue 1: {item})")


def _as_tensor(x) -> torch.Tensor:
    """An f32 tensor from a tensor or any array-like (numpy is copied only
    when it is not already writable, contiguous f32)."""
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.from_numpy(np.require(np.asarray(x, np.float32),
                                       requirements=["C", "W"]))


def index_to(index: JunoIndexData, device) -> JunoIndexData:
    """Copy every tensor of an index to ``device``."""
    def move(obj):
        if isinstance(obj, torch.Tensor):
            return obj.to(device)
        return type(obj)(*(move(f) for f in obj))
    return move(index)


def draw_build(n: int, d: int, config: JunoConfig, seed: int = 0
               ) -> BuildDraws:
    """The port's own build draws, from a numpy ``Generator(seed)``."""
    rng = np.random.default_rng(seed)
    t_max = config.max_train_points if config.max_train_points > 0 else n
    n_train = min(n, t_max)
    sub = (lambda: rng.choice(n, t_max, replace=False)) if n > t_max \
        else (lambda: None)
    ivf_train = sub()
    ivf_init = rng.choice(n_train, config.n_clusters,
                          replace=n_train < config.n_clusters)
    pq_train = sub()
    pq_init = np.stack([
        rng.choice(n_train, config.n_entries, replace=n_train < config.n_entries)
        for _ in range(d // config.sub_dim)])
    nq = min(config.calib_queries, n)
    return BuildDraws(ivf_train_idx=ivf_train, ivf_init_idx=ivf_init,
                      pq_train_idx=pq_train, pq_init_idx=pq_init,
                      calib_idx=rng.choice(n, nq, replace=False),
                      calib_noise=rng.standard_normal((nq, d),
                                                      dtype=np.float32))


def build(points, config: JunoConfig, *, seed: int = 0,
          draws: BuildDraws | None = None, device=None) -> JunoIndexData:
    """Offline phase: build a JUNO index on the device.

    Parameters
    ----------
    points : array-like or torch.Tensor
        (N, D) f32 database vectors.
    config : JunoConfig
        Build knobs.
    seed : int
        Seed of the port's own draws (:func:`draw_build`); ignored when
        ``draws`` is given.
    draws : BuildDraws, optional
        Every random draw of the build, injected (e.g. the reference's).
    device : str or torch.device, optional
        ``None`` = ``cuda`` (raises without a GPU); ``"cpu"`` for the CPU.

    Returns
    -------
    JunoIndexData
        The index, every tensor on ``device``.
    """
    dev = resolve_device(device)
    pts = _as_tensor(points).to(dev)
    n, d = pts.shape
    if draws is None:
        draws = draw_build(n, d, config, seed)

    def idx(a):
        return None if a is None else torch.from_numpy(
            np.array(a, np.int64)).to(dev)

    ivf = build_ivf(pts, idx(draws.ivf_init_idx), n_clusters=config.n_clusters,
                    train_idx=idx(draws.ivf_train_idx),
                    n_iters=config.kmeans_iters,
                    capacity_mult=config.capacity_mult)
    residuals = pts - ivf.centroids[ivf.labels.long()]
    train_res = residuals if draws.pq_train_idx is None \
        else residuals[idx(draws.pq_train_idx)]
    codebook = train_codebook(train_res, idx(draws.pq_init_idx),
                              m=config.sub_dim, n_iters=config.kmeans_iters)
    codes = encode(residuals, codebook)                           # (N, S)
    # pad slots read code 0 and are masked by valid
    cluster_codes = codes[torch.clamp(ivf.point_ids, min=0).long()]
    dens = _calibrate_density(pts, residuals, codebook, codes, ivf, config,
                              draws)
    return JunoIndexData(ivf=ivf, codebook=codebook, codes=codes,
                         cluster_codes=cluster_codes, density=dens,
                         points_sq=torch.sum(pts * pts, dim=-1))


def _calib_query_subspaces(queries, ivf, config):
    """Calibration queries in the mask's geometry: the probe-0 residual for
    l2, the raw query for ip. Returns (Qs, S, M) f32."""
    if config.metric == "l2":
        _, c1 = filter_clusters(queries, ivf, nprobe=1, metric="l2")
        return split_subspaces(queries - ivf.centroids[c1[:, 0]],
                               config.sub_dim)
    return split_subspaces(queries, config.sub_dim)


def _calib_tau_needed(qsub, gt_codes, codebook, metric):
    """Per-subspace threshold covering every ground-truth top-k entry.

    qsub (Qs, S, M), gt_codes (Qs, K, S) int64 -> (Qs, S) f32.
    """
    ent = codebook.entries                                        # (S, E, M)
    s_idx = torch.arange(ent.shape[0], device=ent.device)
    gt_entries = ent[s_idx, gt_codes]                             # (Qs, K, S, M)
    if metric == "l2":
        diff = gt_entries - qsub[:, None]
        return torch.sqrt(torch.amax(torch.sum(diff * diff, -1), dim=1))
    e_sq = torch.sum(gt_entries * gt_entries, -1)
    dot = torch.sum(gt_entries * qsub[:, None], -1)
    t = torch.amax(e_sq - 2.0 * dot, dim=1)
    return torch.sqrt(torch.clamp(t, min=0.0))


def _calibrate_density(pts, residuals, codebook, codes, ivf, config, draws):
    """Fit density → threshold from ground-truth top-k (paper §4.1)."""
    qidx = torch.from_numpy(np.array(draws.calib_idx, np.int64)).to(pts.device)
    noise = _as_tensor(draws.calib_noise).to(pts.device)
    # perturb so calibration queries are not exact database points
    queries = pts[qidx] + 0.01 * noise * torch.std(pts, correction=0)
    _, gt_ids = exact_topk(queries, pts, k=config.calib_topk,
                           metric=config.metric)
    qsub = _calib_query_subspaces(queries, ivf, config)
    tau_needed = _calib_tau_needed(qsub, codes[gt_ids].long(), codebook,
                                   config.metric)
    sub_pts = split_subspaces(residuals, config.sub_dim).transpose(0, 1)
    return density_lib.calibrate(sub_pts, qsub, tau_needed,
                                 grid_size=config.grid_size,
                                 degree=config.poly_degree)


def _stage_b(index: JunoIndexData, q: torch.Tensor, base: torch.Tensor,
             cids: torch.Tensor, *, metric: str, thres_scale: float):
    """τ and stage B over the probed clusters.

    Returns ``(mlut, table, probe_base, tau)``: the masked LUT
    (Q, np, S, E) f32, the int8 reward/penalty hit table of the same
    shape, the per-probe score offset (Q, np) that ip adds to a point's LUT
    total (``<q, c_probe>``; ``None`` for l2), and τ (Q, np, S).
    """
    nq, nprobe = cids.shape
    m = index.codebook.sub_dim
    if metric == "l2":
        res = q[:, None, :] - index.ivf.centroids[cids]
        qsub = res.reshape(nq, nprobe, -1, m)
        probe_base = None
    else:
        qsub = q.reshape(nq, 1, -1, m).expand(nq, nprobe, -1, m)
        probe_base = base
    tau = density_lib.predict_threshold(index.density, qsub, thres_scale)
    mlut, table = ops.build_selective_lut(
        qsub, index.codebook.entries, index.codebook.entry_sq, tau,
        metric=metric)
    return mlut, table, probe_base, tau


def _rt_probe_mask(rt_grid: rt_lib.CentroidGrid, q: torch.Tensor,
                   tau: torch.Tensor, cids: torch.Tensor,
                   rt_scale: float) -> torch.Tensor:
    """Stage-1 spatial pruning: which probed clusters survive the RT test.

    The radius comes from the probe-0 row of the thresholds ``tau``
    (Q, np, S) the search already computed; the sphere test's (Q, C)
    survivor mask is gathered at the probed cluster ids ``cids``. Probe 0
    is always kept, so a query whose disc misses everything degrades to an
    nprobe-1 search. Returns (Q, np) bool.
    """
    radius = rt_lib.query_radius(rt_grid, tau[:, 0, :], rt_scale)
    hits = rt_lib.survivor_mask(rt_grid, q, radius)             # (Q, C)
    probe_ok = torch.gather(hits, 1, cids) > 0
    probe_ok[:, 0] = True
    return probe_ok


def _top_k(scores: torch.Tensor, k: int, higher_better: bool
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` of ``scores`` (or of ``-scores``) along dim 1: the k
    best in (score desc, index asc) order. Returns (scores, positions)."""
    key = scores if higher_better else -scores
    vals, order = torch.sort(key, dim=1, descending=True, stable=True)
    vals = vals[:, :k]
    return (vals if higher_better else -vals), order[:, :k]


def _score_probed(index: JunoIndexData, q: torch.Tensor, base: torch.Tensor,
                  cids: torch.Tensor, *, k: int, mode: str, metric: str,
                  thres_scale: float, prefilter: str = "scan",
                  rt_grid: rt_lib.CentroidGrid | None = None,
                  rt_scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Modes "H", "M" and "L": τ, stage B and a scan of every probed point.

    ``base``/``cids`` (Q, np) come from :func:`filter_clusters`. The scan
    kernels read the probed clusters' codes through ``cids``; ids are
    gathered for the k results only. Under ``prefilter="rt"`` the scans
    score the points of pruned probes as invalid slots
    (:func:`_rt_probe_mask`); their ids still come back beside the
    sentinel score, as in the reference. Returns (scores (Q, k), ids
    (Q, k) int32): l2 H scores are distances (lower better), every other
    score is higher-better (ip similarity, or hit count as f32).
    """
    nq = q.shape[0]
    mlut, table, probe_base, tau = _stage_b(index, q, base, cids,
                                            metric=metric,
                                            thres_scale=thres_scale)
    probe_ok = (_rt_probe_mask(rt_grid, q, tau, cids, rt_scale)
                if prefilter == "rt" else None)
    if mode == "H":
        pt_scores = ops.masked_adc_scan(mlut, index.cluster_codes,
                                        index.ivf.valid, cids, metric=metric,
                                        probe_ok=probe_ok)
        if probe_base is not None:
            pt_scores = pt_scores + probe_base[..., None]
        higher_better = metric == "ip"
    else:
        if mode == "L":  # plain count: clip penalty/inner to {0, 1}
            table = (table >= 0).to(torch.int8)
        pt_scores = ops.hit_count_scan(table, index.cluster_codes,
                                       index.ivf.valid, cids,
                                       probe_ok=probe_ok).float()
        higher_better = True
    out_scores, sel = _top_k(pt_scores.reshape(nq, -1), k, higher_better)
    p = index.cluster_codes.shape[1]
    sel_cid = torch.gather(cids, 1, sel // p)
    return out_scores, index.ivf.point_ids[sel_cid, sel % p]


def _search_batch(index: JunoIndexData, queries: torch.Tensor, *,
                  nprobe: int, k: int, mode: str, metric: str,
                  thres_scale: float, prefilter: str = "scan",
                  rt_grid: rt_lib.CentroidGrid | None = None,
                  rt_scale: float = 1.0):
    """One query batch of mode "H", "M" or "L": stage A, then
    :func:`_score_probed`. Returns (scores (Q, k) f32, ids (Q, k) int32).
    """
    q = queries.float()
    base, cids = filter_clusters(q, index.ivf, nprobe=nprobe, metric=metric)
    return _score_probed(index, q, base, cids, k=k, mode=mode, metric=metric,
                         thres_scale=thres_scale, prefilter=prefilter,
                         rt_grid=rt_grid, rt_scale=rt_scale)


def _score_probed_two_stage(index: JunoIndexData, q: torch.Tensor,
                            base: torch.Tensor, cids: torch.Tensor, *, k: int,
                            metric: str, thres_scale: float, rerank: int = 0,
                            fused: bool = False, fused3: bool | None = None,
                            prefilter: str = "scan",
                            rt_grid: rt_lib.CentroidGrid | None = None,
                            rt_scale: float = 1.0
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mode "H2": τ, stage B, hit-count prefilter → top-C → masked ADC.

    ``base``/``cids`` (Q, np) come from :func:`filter_clusters`. The C
    candidates are the top-C points by hit count; every form selects the
    same set, so they return the same ids up to score ties:

    * ``fused=True``: one ``fused_two_stage`` kernel counts, thresholds,
      compacts the candidates (index-ascending) and sums their LUT entries;
      under ``prefilter="rt"`` the ``fused_three_stage`` kernel also runs
      the sphere test, per probe, in front (unless ``fused3=False``, which
      composes :func:`_rt_probe_mask` with the two-stage kernel);
    * ``fused=False``: the ``hit_count`` kernel counts, a stable sort takes
      the top C in (count desc, index asc) order, and the C candidates'
      LUT entries are gathered and summed in plain torch.

    A candidate of a pruned probe is invalid, as in the reference, whose
    ``valid`` is already masked. Only the candidates' codes, validity and
    ids are gathered. Returns (scores (Q, k), ids (Q, k) int32).
    """
    nq, nprobe = cids.shape
    mlut, table, probe_base, tau = _stage_b(index, q, base, cids,
                                            metric=metric,
                                            thres_scale=thres_scale)
    use_fused3 = fused and prefilter == "rt" and fused3 is not False
    probe_ok = (_rt_probe_mask(rt_grid, q, tau, cids, rt_scale)
                if prefilter == "rt" and not use_fused3 else None)
    p = index.cluster_codes.shape[1]
    cap = min(rerank or 4 * k, nprobe * p)
    if fused:
        if use_fused3:
            radius = rt_lib.query_radius(rt_grid, tau[:, 0, :], rt_scale)
            qp2 = q @ rt_grid.proj                                  # (Q, 2)
            _, _, cand, exact, probe_ok = ops.fused_three_stage_scan(
                mlut, table, index.cluster_codes, index.ivf.valid, cids,
                qp2[:, 0], qp2[:, 1], radius, rt_grid.cell_c0,
                rt_grid.cell_c1, rt_grid.slot_reach, rt_grid.slot_of[cids],
                cap_c=cap, metric=metric)
        else:
            _, _, cand, exact = ops.fused_two_stage_scan(
                mlut, table, index.cluster_codes, index.ivf.valid, cids,
                cap_c=cap, metric=metric, probe_ok=probe_ok)
        cand = cand.long()
        cand_probe = cand // p
        cand_cid = torch.gather(cids, 1, cand_probe)
    else:
        counts = ops.hit_count_scan(table, index.cluster_codes,
                                    index.ivf.valid, cids, probe_ok=probe_ok)
        _, cand = _top_k(counts.reshape(nq, -1), cap, True)
        cand_probe = cand // p
        cand_cid = torch.gather(cids, 1, cand_probe)
        cand_codes = index.cluster_codes[cand_cid, cand % p].long()  # (Q, C, S)
        s = mlut.shape[2]
        vals = mlut[torch.arange(nq, device=q.device)[:, None, None],
                    cand_probe[..., None], torch.arange(s, device=q.device),
                    cand_codes]                                     # (Q, C, S)
        exact = vals.sum(-1)
    cand_valid = index.ivf.valid[cand_cid, cand % p]
    if probe_ok is not None:
        cand_valid = cand_valid & torch.gather(probe_ok, 1, cand_probe)
    cand_ids = index.ivf.point_ids[cand_cid, cand % p]
    higher_better = metric == "ip"
    if probe_base is not None:
        exact = exact + torch.gather(probe_base, 1, cand_probe)
    exact = torch.where(cand_valid, exact,
                        float("-inf") if higher_better else float("inf"))
    out_scores, sel = _top_k(exact, k, higher_better)
    return out_scores, torch.gather(cand_ids, 1, sel)


def _search_batch_two_stage(index: JunoIndexData, queries: torch.Tensor, *,
                            nprobe: int, k: int, metric: str,
                            thres_scale: float, rerank: int = 0,
                            fused: bool = False, fused3: bool | None = None,
                            prefilter: str = "scan",
                            rt_grid: rt_lib.CentroidGrid | None = None,
                            rt_scale: float = 1.0):
    """One query batch of mode "H2": stage A, then the two-stage tail.

    Returns (scores (Q, k) f32, ids (Q, k) int32).
    """
    q = queries.float()
    base, cids = filter_clusters(q, index.ivf, nprobe=nprobe, metric=metric)
    return _score_probed_two_stage(index, q, base, cids, k=k, metric=metric,
                                   thres_scale=thres_scale, rerank=rerank,
                                   fused=fused, fused3=fused3,
                                   prefilter=prefilter, rt_grid=rt_grid,
                                   rt_scale=rt_scale)


def search(index: JunoIndexData, queries, *, nprobe: int = 16, k: int = 100,
           mode: str = "H", metric: str = "l2", thres_scale: float = 1.0,
           batch: int = 64, rerank: int = 0, fused: bool = False,
           fused3: bool | None = None, side=None, prefilter: str = "scan",
           rt_grid: rt_lib.CentroidGrid | None = None, rt_scale: float = 1.0
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Search the index — the online API (paper Alg. 2).

    Queries run in chunks of ``batch``; the last chunk is padded with
    copies of its last row (in-distribution work whose results are sliced
    off), as the reference does.

    Parameters
    ----------
    index : JunoIndexData
        A built or loaded index; the search runs on its device.
    queries : array-like or torch.Tensor
        (Q, D) f32 query vectors.
    nprobe : int
        Clusters probed per query.
    k : int
        Results per query.
    mode : str
        Operating point: "H" (exact selective distances), "M"
        (reward/penalty hit count), "L" (plain hit count) or "H2"
        (hit-count prefilter → exact rerank of the top C).
    metric : str
        "l2" | "ip".
    thres_scale : float
        Multiplier on the calibrated thresholds τ.
    batch : int
        Queries per chunk.
    rerank : int
        Mode "H2": candidate budget C (0 → ``4 * k``).
    fused : bool
        Mode "H2" only: both stages in the ``fused_two_stage`` kernel
        instead of the composed hit count → rerank; the ids are the same
        up to score ties. With ``prefilter="rt"`` this runs the
        three-stage kernel unless ``fused3=False``.
    fused3 : bool, optional
        ``None`` (default) takes the ``fused_three_stage`` kernel whenever
        ``fused=True`` and ``prefilter="rt"``; ``False`` composes the RT
        probe mask with the two-stage kernel (the same ids and scores);
        ``True`` also checks that the combination applies.
    side
        Only ``None`` is ported.
    prefilter : str
        "scan" (every probed cluster is scanned) or "rt" (probes whose
        cluster disc the query disc misses in the ray plane are pruned;
        at full-coverage radii the results equal "scan").
    rt_grid : repro_torch.rt.CentroidGrid, optional
        The centroid grid ``prefilter="rt"`` needs (``rt.build_grid``), on
        the index's device.
    rt_scale : float
        Radius multiplier for "rt" (monotone: larger keeps more probes;
        very large values keep every probe).

    Returns
    -------
    tuple of torch.Tensor
        ``(scores (Q, k) f32, ids (Q, k) int32)``; scores are distances
        (lower better) for l2 H/H2, similarities or counts (higher better)
        otherwise.

    Raises
    ------
    ValueError
        For ``fused=True`` with a mode other than "H2", an unknown mode or
        prefilter, ``prefilter="rt"`` without ``rt_grid``, or
        ``fused3=True`` without ``fused=True`` and ``prefilter="rt"``.
    NotImplementedError
        For a side buffer (not ported yet).
    """
    if mode not in ("H", "M", "L", "H2"):
        raise ValueError(f"unknown mode {mode!r}")
    if fused and mode != "H2":
        raise ValueError(f"fused=True requires mode='H2', got mode={mode!r}")
    if prefilter not in ("scan", "rt"):
        raise ValueError(f"unknown prefilter {prefilter!r}")
    if prefilter == "rt" and rt_grid is None:
        raise ValueError("prefilter='rt' requires rt_grid (rt.build_grid)")
    if fused3 and not (fused and prefilter == "rt"):
        raise ValueError("fused3=True requires fused=True and "
                         "prefilter='rt' (the three-stage kernel folds the "
                         "RT test into the fused scan)")
    if side is not None:
        raise _not_ported("the side buffer", "item 7, mutability and freshness")
    dev = index.ivf.centroids.device
    q_all = _as_tensor(queries).to(dev)
    out_s, out_i = [], []
    for i in range(0, q_all.shape[0], batch):
        qb = q_all[i:i + batch]
        pad = batch - qb.shape[0]
        if pad:
            qb = torch.cat([qb, qb[-1:].expand(pad, -1)])
        kw = dict(nprobe=nprobe, k=k, metric=metric, thres_scale=thres_scale,
                  prefilter=prefilter, rt_grid=rt_grid, rt_scale=rt_scale)
        if mode == "H2":
            s, ids = _search_batch_two_stage(index, qb, rerank=rerank,
                                             fused=fused, fused3=fused3, **kw)
        else:
            s, ids = _search_batch(index, qb, mode=mode, **kw)
        out_s.append(s[:batch - pad])
        out_i.append(ids[:batch - pad])
    return torch.cat(out_s), torch.cat(out_i)
