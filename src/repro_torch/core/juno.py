"""The JUNO index: offline build and the online search of every tier.

Port of ``repro/core/juno.py`` (``JunoConfig``, ``JunoIndexData``,
``build``, ``_calibrate_density``, ``_rt_probe_mask``, ``SideBuffer``,
``_side_gather``, ``_score_probed``, ``_search_batch``,
``_score_probed_two_stage``, ``_search_batch_two_stage``, ``search``,
``_label_encode``, ``MutableIndexBase`` and ``MutableJunoIndex``).

Offline (:func:`build`): IVF k-means → residual PQ codebooks → padded
per-cluster codes → density grid and threshold-regressor calibration.
Every random draw of the build is injectable (:class:`BuildDraws`), so a
build can reproduce another implementation's sample and init indices.

Online (:func:`search`): stage A filters the nprobe nearest clusters
(``ivf_filter`` kernel, then a stable sort), τ comes from the density
model, stage B builds the masked LUT and the int8 hit table
(``selective_lut`` kernel), and stage C scores the probed points by tier
(paper's JUNO-H/M/L, plus the two-stage H2):

* "H": masked ADC of every probed point, top-k (``pq_scan`` kernels with
  their top-k epilogue: no sort);
* "M": reward/penalty hit count, top-k by count (``hit_count`` kernel and
  its top-k epilogue: no sort);
* "L": plain hit count, the table clipped to {0, 1}, top-k by count;
* "H2": hit count → top-C → masked ADC of the C → top-k, either in one
  fused kernel (``fused=True``, ``fused_two_stage``) or composed
  (``hit_count`` kernel's top-C, then a plain-torch rerank).

With ``prefilter="rt"`` (the paper's RT-core stage-1 filter, ``rt/``) the
probes whose cluster disc the query disc misses in the ray plane are
pruned from stage C: the ``sphere_hits`` kernel's probe entry gives each
probe its verdict in one launch (probe 0 always kept) and the scans treat
a pruned probe's points as invalid slots. Fused H2 then runs all three
stages in the ``fused_three_stage`` kernel unless ``fused3=False``.

The scans read the probed clusters' codes and validity through a *scan
view* ``(codes, valid, scan_cids)``: by default the index's
``cluster_codes``, ``ivf.valid`` and the probed cluster ids, and for the
paged tier (``serve/paged.py``) a per-batch page buffer of the distinct
probed clusters' rows with local indices into it. Everything else (the
residuals, the rt probe, the point ids, the side buffer) reads the true
cluster ids, so both views give the same results bit for bit.

Mutation (:class:`MutableIndexBase`, :class:`MutableJunoIndex`): ``insert``
labels new points with the ``ivf_filter`` kernel and encodes them with the
existing codebooks into free padded slots of their owning cluster,
spilling into a fixed-capacity :class:`SideBuffer` when the cluster is
full; ``delete`` tombstones slots;
``compact`` folds spills back into freed slots. Side points are scored
with the same LUT or hit-table gather as their in-cluster siblings (and,
under rt, with their probe's verdict), in every tier. The index's tensors
are updated in place; the freshness tiers are ``core/freshness.py``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from ..kernels.ref import NEG, bad_score
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


class SideBuffer(NamedTuple):
    """Fixed-capacity overflow store for online inserts.

    When an insert's owning cluster has no free padded slot, the point
    spills here. A side point is scored only when its owning cluster is
    probed, with the same LUT or hit-table gather an in-cluster point gets,
    so ``compact()`` (which moves it back into a freed cluster slot) does
    not change the search's results.
    """

    codes: torch.Tensor     # (B, S) uint8 — PQ codes of spilled points
    cluster: torch.Tensor   # (B,) int32 — owning cluster (-1 = empty slot)
    ids: torch.Tensor       # (B,) int32 — global point id
    valid: torch.Tensor     # (B,) bool

    @property
    def capacity(self) -> int:
        """Fixed slot count B of the buffer."""
        return self.ids.shape[0]


def empty_side_buffer(capacity: int, n_subspaces: int,
                      device=None) -> SideBuffer:
    """An all-empty :class:`SideBuffer` of ``capacity`` slots on ``device``
    (``None`` = ``cuda``, see :func:`repro_torch.device.resolve_device`):
    codes 0, cluster and ids -1, valid False."""
    device = resolve_device(device)
    return SideBuffer(
        codes=torch.zeros((capacity, n_subspaces), dtype=torch.uint8,
                          device=device),
        cluster=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        ids=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device))


def _side_set(side: SideBuffer, pos: torch.Tensor, **fields) -> SideBuffer:
    """A copy of ``side`` with ``fields`` written at positions ``pos``
    (the buffer is small; the original is left as it was)."""
    out = {}
    for name, val in fields.items():
        t = getattr(side, name).clone()
        t[pos] = val
        out[name] = t
    return side._replace(**out)


def _side_gather(table: torch.Tensor, cids: torch.Tensor, side: SideBuffer
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score side-buffer points against a per-probe LUT or hit table.

    table (Q, np, S, E) f32 or int8, cids (Q, np). A side point takes
    part only when its owning cluster is among the probed ones, the
    condition under which it would have been scanned in its cluster, and
    its score is the same gather and sum over S: f32 as
    ``kernels/ref.py:pq_scan_ref`` sums (on the CPU bit-equal to the plain
    scan), int32 for a hit table. Plain torch, as in the reference
    (``repro/core/juno.py:110``).

    Returns (totals (Q, B), probe (Q, B) int64 — the first matching
    probe, ok (Q, B) bool).
    """
    nq = cids.shape[0]
    match = cids[:, :, None] == side.cluster.long()[None, None]  # (Q, np, B)
    ok = match.any(dim=1) & side.valid[None, :]
    probe = torch.argmax(match.to(torch.uint8), dim=1)              # (Q, B)
    qi = torch.arange(nq, device=cids.device)[:, None, None]
    si = torch.arange(table.shape[2], device=cids.device)[None, None, :]
    codes = side.codes.long()[None]                                 # (1, B, S)
    vals = table[qi, probe[:, :, None], si, codes]                  # (Q, B, S)
    if table.dtype == torch.int8:
        return vals.to(torch.int32).sum(-1, dtype=torch.int32), probe, ok
    return vals.float().sum(-1), probe, ok


def _side_scores(table: torch.Tensor, cids: torch.Tensor, side: SideBuffer,
                 probe_ok: torch.Tensor | None,
                 probe_base: torch.Tensor | None, bad
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Side points' scores as the scans give in-cluster points: the
    :func:`_side_gather` totals, plus the probe's ip offset, and ``bad``
    (the invalid-slot sentinel) where the owning cluster is not probed,
    the slot is empty or (under rt) the probe was pruned. Returns
    (scores (Q, B), ok (Q, B))."""
    tot, probe, ok = _side_gather(table, cids, side)
    if probe_ok is not None:
        ok = ok & torch.gather(probe_ok, 1, probe)
    if probe_base is not None:
        tot = tot + torch.gather(probe_base, 1, probe)
    return torch.where(ok, tot, torch.tensor(bad, dtype=tot.dtype,
                                             device=tot.device)), ok


def _scan_view(index: JunoIndexData, cids: torch.Tensor, view):
    """``(codes, valid, scan_cids)`` the scans read: ``view`` when given
    (a page buffer (U, P, S), its validity (U, P) and local indices (Q, np)
    into it), else the whole index and the probed cluster ids."""
    return view if view is not None else (index.cluster_codes,
                                          index.ivf.valid, cids)


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


def _calib_queries(pts: torch.Tensor, draws: BuildDraws) -> torch.Tensor:
    """The calibration queries: the drawn points plus noise of 0.01 of the
    points' std, so they are not exact database points."""
    qidx = torch.from_numpy(np.array(draws.calib_idx, np.int64)).to(pts.device)
    noise = _as_tensor(draws.calib_noise).to(pts.device)
    return pts[qidx] + 0.01 * noise * torch.std(pts, correction=0)


def _calibrate_density(pts, residuals, codebook, codes, ivf, config, draws):
    """Fit density → threshold from ground-truth top-k (paper §4.1)."""
    queries = _calib_queries(pts, draws)
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
    mlut, table = ops.route().build_selective_lut(
        qsub, index.codebook.entries, index.codebook.entry_sq, tau,
        metric=metric)
    return mlut, table, probe_base, tau


def _rt_probe(rt_grid: rt_lib.CentroidGrid, q: torch.Tensor,
              tau: torch.Tensor, cids: torch.Tensor, rt_scale: float,
              rt_offset: int | None = None):
    """Stage-1 spatial pruning: the projection GEMM, then one
    ``ops.rt_probe_mask`` call: two kernels on the card.

    The radius comes from the probe-0 row of the thresholds ``tau``
    (Q, np, S) the search already computed; each probed cluster is tested
    at its grid slot. Probe 0 is always kept, so a query whose disc misses
    everything degrades to an nprobe-1 search. On a shard of a
    cluster-sharded index (``dist/``) ``cids`` are the shard's local ids
    and the grid is global: it is looked up at ``cids + rt_offset`` (the
    shard's first global cluster id). Returns ``(qp (Q, 2),
    probe_ok (Q, np) bool, radius (Q,), slot (Q, np) int32)``: the
    three-stage scan reads the projection, the radius and the probed slots.
    """
    # the projection as Q products (1, D) × (D, 2): cuBLAS runs them as one
    # gemv kernel, where it runs the (Q, D) × (D, 2) product as a split-K
    # GEMM and a reduce kernel (on the H100, Q 8 to 4096, D 96 and 200)
    nq = q.shape[0]
    qp = torch.bmm(q[:, None, :], rt_grid.proj.expand(nq, -1, -1))[:, 0]
    gcids = cids if rt_offset is None else cids + rt_offset
    probe_ok, radius, slot = ops.rt_probe_mask(
        qp[:, 0], qp[:, 1], tau[:, 0], gcids, rt_grid.slot_of,
        rt_grid.cell_c0, rt_grid.cell_c1, rt_grid.slot_reach,
        rt_grid.radius_scale, rt_grid.radius_bias, scale=rt_scale)
    return qp, probe_ok, radius, slot


def _rt_probe_mask(rt_grid: rt_lib.CentroidGrid, q: torch.Tensor,
                   tau: torch.Tensor, cids: torch.Tensor,
                   rt_scale: float, rt_offset: int | None = None
                   ) -> torch.Tensor:
    """Which probed clusters survive the RT test (:func:`_rt_probe`):
    (Q, np) bool, probe 0 always True."""
    return _rt_probe(rt_grid, q, tau, cids, rt_scale, rt_offset)[1]


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
                  thres_scale: float, side: SideBuffer | None = None,
                  prefilter: str = "scan",
                  rt_grid: rt_lib.CentroidGrid | None = None,
                  rt_scale: float = 1.0, view=None,
                  rt_offset: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Modes "H", "M" and "L": τ, stage B and a scan of every probed point.

    ``base``/``cids`` (Q, np) come from :func:`filter_clusters`. The scan
    kernels read the probed clusters' codes and validity through the scan
    view (:func:`_scan_view`; ``view`` or the whole index); ids are
    gathered, by the true cluster ids, for the k results only. Under
    ``prefilter="rt"`` the scans score the points of pruned probes as
    invalid slots (:func:`_rt_probe_mask`); their ids still come back
    beside the sentinel score, as in the reference. ``side`` points join the flat
    score vector after the probed slots (:func:`_side_scores`). Returns
    (scores (Q, k), ids (Q, k) int32): l2 H scores are distances (lower
    better), every other score is higher-better (ip similarity, or hit
    count as f32).
    """
    nq = q.shape[0]
    mlut, table, probe_base, tau = _stage_b(index, q, base, cids,
                                            metric=metric,
                                            thres_scale=thres_scale)
    probe_ok = (_rt_probe_mask(rt_grid, q, tau, cids, rt_scale, rt_offset)
                if prefilter == "rt" else None)
    codes, valid, scan_cids = _scan_view(index, cids, view)
    p = codes.shape[1]
    n_in = cids.shape[1] * p
    k_in = min(k, n_in)
    if mode == "H":
        out_scores, sel = ops.route().masked_adc_topk_scan(
            mlut, codes, valid, scan_cids, k_in, metric=metric,
            probe_ok=probe_ok, probe_base=probe_base)
        side_args = (mlut, probe_base, bad_score(metric), metric == "ip")
    else:
        if mode == "L":  # plain count: clip penalty/inner to {0, 1}
            table = (table >= 0).to(torch.int8)
        out_scores, sel = ops.route().hit_count_topk_scan(
            table, codes, valid, scan_cids, k_in, probe_ok=probe_ok)
        side_args = (table, None, NEG, True)
    if side is not None:
        # every in-cluster index is below every side index, so the k best
        # of both are the k best of the k_in in-cluster ones and the side
        # points, in-cluster first among equal scores
        tab, side_base, bad, higher_better = side_args
        side_s, _ = _side_scores(tab, cids, side, probe_ok, side_base, bad)
        out_scores, order = _top_k(
            torch.cat([out_scores, side_s.float()], dim=1), k, higher_better)
        sel = torch.where(order < k_in,
                          torch.gather(sel, 1, order.clamp(max=k_in - 1)),
                          order - k_in + n_in)
    in_cl = sel < n_in
    s_in = torch.where(in_cl, sel, 0)
    ids = index.ivf.point_ids[torch.gather(cids, 1, s_in // p), s_in % p]
    if side is not None:
        ids = torch.where(in_cl, ids, side.ids[(sel - n_in).clamp(min=0)])
    return out_scores, ids


def _search_batch(index: JunoIndexData, queries: torch.Tensor, *,
                  nprobe: int, k: int, mode: str, metric: str,
                  thres_scale: float, side: SideBuffer | None = None,
                  prefilter: str = "scan",
                  rt_grid: rt_lib.CentroidGrid | None = None,
                  rt_scale: float = 1.0, gather=None,
                  rt_offset: int | None = None):
    """One query batch of mode "H", "M" or "L": stage A, then
    :func:`_score_probed` (over ``gather(cids)``'s scan view when
    ``gather`` is given; on a shard, the rt grid looked up at
    ``cids + rt_offset``, :func:`_rt_probe`). Returns (scores (Q, k) f32,
    ids (Q, k) int32).
    """
    q = queries.float()
    base, cids = filter_clusters(q, index.ivf, nprobe=nprobe, metric=metric)
    return _score_probed(index, q, base, cids, k=k, mode=mode, metric=metric,
                         thres_scale=thres_scale, side=side,
                         prefilter=prefilter, rt_grid=rt_grid,
                         rt_scale=rt_scale,
                         view=None if gather is None else gather(cids),
                         rt_offset=rt_offset)


def _score_probed_two_stage(index: JunoIndexData, q: torch.Tensor,
                            base: torch.Tensor, cids: torch.Tensor, *, k: int,
                            metric: str, thres_scale: float, rerank: int = 0,
                            fused: bool = False, fused3: bool | None = None,
                            side: SideBuffer | None = None,
                            prefilter: str = "scan",
                            rt_grid: rt_lib.CentroidGrid | None = None,
                            rt_scale: float = 1.0, view=None,
                            rt_offset: int | None = None
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
    * ``fused=False``: the ``hit_count`` kernel counts and its top-k
      epilogue takes the top C in (count desc, index asc) order, and the C
      candidates' LUT entries are gathered and summed in plain torch.

    A candidate of a pruned probe is invalid, as in the reference, whose
    ``valid`` is already masked. Only the candidates' codes, validity and
    ids are gathered: codes and validity through the scan view
    (:func:`_scan_view`), ids by the true cluster ids. ``side`` points
    bypass the count prefilter and join the rerank pool directly, as in
    the reference (``repro/core/juno.py`` l.522); under rt they take the
    probe verdict the cluster lanes got (for the three-stage kernel, the
    ``probe_ok`` it returns). Returns (scores (Q, k), ids (Q, k) int32).
    """
    nq, nprobe = cids.shape
    mlut, table, probe_base, tau = _stage_b(index, q, base, cids,
                                            metric=metric,
                                            thres_scale=thres_scale)
    use_fused3 = fused and prefilter == "rt" and fused3 is not False
    probe_ok = (_rt_probe_mask(rt_grid, q, tau, cids, rt_scale, rt_offset)
                if prefilter == "rt" and not use_fused3 else None)
    codes, valid, scan_cids = _scan_view(index, cids, view)
    p = codes.shape[1]
    cap = min(rerank or 4 * k, nprobe * p)
    if fused:
        if use_fused3:
            qp2, _, radius, slot = _rt_probe(rt_grid, q, tau, cids,
                                             rt_scale, rt_offset)
            _, _, cand, exact, probe_ok = ops.fused_three_stage_scan(
                mlut, table, codes, valid, scan_cids, qp2[:, 0], qp2[:, 1],
                radius, rt_grid.cell_c0, rt_grid.cell_c1, rt_grid.slot_reach,
                slot, cap_c=cap, metric=metric)
        else:
            _, _, cand, exact = ops.fused_two_stage_scan(
                mlut, table, codes, valid, scan_cids, cap_c=cap,
                metric=metric, probe_ok=probe_ok)
        cand = cand.long()
    else:
        _, cand = ops.route().hit_count_topk_scan(
            table, codes, valid, scan_cids, cap, probe_ok=probe_ok)
    cand_probe = cand // p
    cand_slot = cand % p
    cand_cid = torch.gather(cids, 1, cand_probe)
    # the candidates' rows in the scan view (the true cluster's without one)
    cand_row = (cand_cid if scan_cids is cids
                else torch.gather(scan_cids, 1, cand_probe))
    if not fused:
        cand_codes = codes[cand_row, cand_slot].long()              # (Q, C, S)
        s = mlut.shape[2]
        vals = mlut[torch.arange(nq, device=q.device)[:, None, None],
                    cand_probe[..., None], torch.arange(s, device=q.device),
                    cand_codes]                                     # (Q, C, S)
        exact = vals.sum(-1)
    cand_valid = valid[cand_row, cand_slot]
    if probe_ok is not None:
        cand_valid = cand_valid & torch.gather(probe_ok, 1, cand_probe)
    cand_ids = index.ivf.point_ids[cand_cid, cand_slot]
    higher_better = metric == "ip"
    if probe_base is not None:
        exact = exact + torch.gather(probe_base, 1, cand_probe)
    if side is not None:
        side_s, side_ok = _side_scores(mlut, cids, side, probe_ok, probe_base,
                                       bad_score(metric))
        exact = torch.cat([exact, side_s], dim=1)
        cand_valid = torch.cat([cand_valid, side_ok], dim=1)
        cand_ids = torch.cat([cand_ids, side.ids[None].expand(nq, -1)], dim=1)
    exact = torch.where(cand_valid, exact,
                        float("-inf") if higher_better else float("inf"))
    out_scores, sel = _top_k(exact, k, higher_better)
    return out_scores, torch.gather(cand_ids, 1, sel)


def _search_batch_two_stage(index: JunoIndexData, queries: torch.Tensor, *,
                            nprobe: int, k: int, metric: str,
                            thres_scale: float, rerank: int = 0,
                            fused: bool = False, fused3: bool | None = None,
                            side: SideBuffer | None = None,
                            prefilter: str = "scan",
                            rt_grid: rt_lib.CentroidGrid | None = None,
                            rt_scale: float = 1.0, gather=None,
                            rt_offset: int | None = None):
    """One query batch of mode "H2": stage A, then the two-stage tail (over
    ``gather(cids)``'s scan view when ``gather`` is given; on a shard, the
    rt grid looked up at ``cids + rt_offset``, :func:`_rt_probe`).

    Returns (scores (Q, k) f32, ids (Q, k) int32).
    """
    q = queries.float()
    base, cids = filter_clusters(q, index.ivf, nprobe=nprobe, metric=metric)
    return _score_probed_two_stage(
        index, q, base, cids, k=k, metric=metric, thres_scale=thres_scale,
        rerank=rerank, fused=fused, fused3=fused3, side=side,
        prefilter=prefilter, rt_grid=rt_grid, rt_scale=rt_scale,
        view=None if gather is None else gather(cids), rt_offset=rt_offset)


def search(index: JunoIndexData, queries, *, nprobe: int = 16, k: int = 100,
           mode: str = "H", metric: str = "l2", thres_scale: float = 1.0,
           batch: int = 64, rerank: int = 0, fused: bool = False,
           fused3: bool | None = None, side: SideBuffer | None = None,
           prefilter: str = "scan",
           rt_grid: rt_lib.CentroidGrid | None = None, rt_scale: float = 1.0,
           gather=None) -> tuple[torch.Tensor, torch.Tensor]:
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
    side : SideBuffer, optional
        Overflow buffer of online inserts (``MutableJunoIndex``), on the
        index's device, merged into the final top-k with the scoring its
        points would get in their clusters.
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
    gather : callable, optional
        ``gather(cids)`` -> the scan view ``(codes, valid, scan_cids)``
        each batch's scans read (the paged tier's page buffer); ``None``
        reads the index's own ``cluster_codes`` and ``ivf.valid``.

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
    dev = index.ivf.centroids.device
    q_all = _as_tensor(queries).to(dev)
    out_s, out_i = [], []
    for i in range(0, q_all.shape[0], batch):
        qb = q_all[i:i + batch]
        pad = batch - qb.shape[0]
        if pad:
            qb = torch.cat([qb, qb[-1:].expand(pad, -1)])
        kw = dict(nprobe=nprobe, k=k, metric=metric, thres_scale=thres_scale,
                  side=side, prefilter=prefilter, rt_grid=rt_grid,
                  rt_scale=rt_scale, gather=gather)
        if mode == "H2":
            s, ids = _search_batch_two_stage(index, qb, rerank=rerank,
                                             fused=fused, fused3=fused3, **kw)
        else:
            s, ids = _search_batch(index, qb, mode=mode, **kw)
        out_s.append(s[:batch - pad])
        out_i.append(ids[:batch - pad])
    return torch.cat(out_s), torch.cat(out_i)


def _label_encode(pts: torch.Tensor, ivf: IVFIndex, codebook: PQCodebook
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Insert-time (labels, codes) of a point batch (B, D).

    The owning cluster is the first minimum of ``csq − 2·p·cᵀ``
    (``ops.filter_topk`` at nprobe 1: one ``ivf_filter`` launch on the
    card; equal scores go to the smaller index), as ``jnp.argmin`` takes
    it in the reference (``repro/core/juno.py:687``); the codes are the
    residuals' PQ codes under the existing codebooks.
    Returns (labels (B,) int32, codes (B, S) uint8).
    """
    _, top = ops.filter_topk(pts, ivf.centroids, ivf.centroid_sq, nprobe=1,
                             metric="l2")
    labels = top[:, 0]
    return (labels.to(torch.int32),
            encode(pts - ivf.centroids[labels], codebook))


def _own_copy(data: JunoIndexData) -> JunoIndexData:
    """``data`` with clones of the tensors a mutation writes in place
    (``cluster_codes``, ``ivf.point_ids``, ``ivf.valid``); the rest is
    shared, since no mutation writes it."""
    ivf = data.ivf._replace(point_ids=data.ivf.point_ids.clone(),
                            valid=data.ivf.valid.clone())
    return data._replace(ivf=ivf, cluster_codes=data.cluster_codes.clone())


class MutableIndexBase:
    """Host-side slot bookkeeping of a mutable index.

    Port of ``repro/core/juno.py:MutableIndexBase``: per-cluster free-slot
    lists, an id → (cluster, slot) map (cluster −1 = a side-buffer
    position, ≤ −2 = a minor generation), the LSM delta tiers, and a
    plan-then-commit discipline, so that an ``insert``/``delete``/
    ``compact`` that fails raises before any host or device state is
    touched. A subclass supplies the data plane: ``_labels_codes``
    (insert-time labels and codes), ``_rt_centroids`` (the centroids the rt
    reaches grow from) and ``_apply_insert``/``_apply_delete`` (the device
    writes); :class:`MutableJunoIndex` over a resident index,
    ``serve.paged.PagedJunoIndex`` over a memory-mapped artifact.
    """

    side: SideBuffer
    rt_grid: rt_lib.CentroidGrid | None = None
    #: ``(ArtifactStore, name)`` promoted minors are committed to, or None
    _minor_sink = None

    def _init_bookkeeping(self, ivf_valid: torch.Tensor,
                          point_ids: torch.Tensor, *, side_capacity: int,
                          first_new_id: int, n_subspaces: int) -> None:
        valid = ivf_valid.cpu().numpy()
        pids = point_ids.cpu().numpy()
        self.side = empty_side_buffer(side_capacity, n_subspaces,
                                      ivf_valid.device)
        self._free = [np.flatnonzero(~row)[::-1].tolist() for row in valid]
        cs, ss = np.nonzero(valid)
        #: id -> (cluster, slot); cluster -1 = side-buffer position
        self._loc: dict[int, tuple[int, int]] = dict(zip(
            pids[cs, ss].tolist(), zip(cs.tolist(), ss.tolist())))
        self._side_free = list(range(side_capacity))[::-1]
        self._next_id = first_new_id
        # LSM delta tiers (core/freshness.py). A swap keeps the tier
        # configuration; the epoch and rt counters are monotone across
        # swaps, so a cached view or routing state never aliases a new
        # generation's
        self._minors: list = []
        self._max_minors: int = getattr(self, "_max_minors", 0)
        self._minor_gen: int = getattr(self, "_minor_gen", 0)
        self._delta_epoch: int = getattr(self, "_delta_epoch", 0) + 1
        self._delta_cache: tuple[int, SideBuffer] | None = None
        self._rt_muts: int = getattr(self, "_rt_muts", -1) + 1

    # ---- data-plane hooks (subclass responsibility) ----------------------
    def _labels_codes(self, pts: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """Insert-time (labels (B,) int32, codes (B, S) uint8) on the
        index's device."""
        raise NotImplementedError

    def _rt_centroids(self) -> torch.Tensor:
        """(C, D) centroids the rt reaches of inserts are measured from."""
        raise NotImplementedError

    def _apply_insert(self, cl, sl, ids, codes) -> None:
        raise NotImplementedError

    def _apply_delete(self, cl, sl) -> None:
        raise NotImplementedError

    def _rt_on_insert(self, pts: torch.Tensor, labels: np.ndarray) -> None:
        """After a committed insert batch: grow the touched clusters'
        projected reaches when an rt grid is attached, so the sphere test
        never drops a cluster holding a fresh point (host numpy, as the
        reference computes them). Always bumps :attr:`rt_mutations`, so a
        routing state cached before the insert is never reused after it."""
        self._rt_muts += 1
        grid = self.rt_grid
        if grid is None:
            return
        res = (pts.cpu().numpy().astype(np.float32)
               - self._rt_centroids().cpu().numpy()[labels])
        rp = res @ grid.proj.cpu().numpy()
        self.rt_grid = rt_lib.update_radii(
            grid, labels, np.sqrt(np.sum(rp * rp, axis=-1)))

    # ---- introspection --------------------------------------------------
    @property
    def n_live(self) -> int:
        """Number of live (non-tombstoned) points in the index."""
        return len(self._loc)

    @property
    def side_fill(self) -> int:
        """Number of occupied side-buffer slots."""
        return self.side.capacity - len(self._side_free)

    def free_slots(self, cluster: int) -> int:
        """Free padded slots remaining in ``cluster``."""
        return len(self._free[cluster])

    @property
    def rt_mutations(self) -> int:
        """Monotone count of rt-relevant mutations (insert batches and
        generation swaps); the engine's routing cache keys on it."""
        return self._rt_muts

    # ---- LSM delta tiers (core/freshness.py) ----------------------------
    def enable_tiers(self, max_minors: int, *, minor_store=None,
                     minor_name: str = "minors") -> None:
        """Turn on the LSM freshness tiers (``core/freshness.py``).

        With ``max_minors > 0`` a full L0 side buffer no longer makes
        ``insert`` raise: it is promoted into one of up to ``max_minors``
        sealed minor generations, which a ``MergeScheduler`` folds back
        into the base.

        Parameters
        ----------
        max_minors : int
            Maximum concurrent minor generations (0 disables tiering).
        minor_store : repro_torch.build.ArtifactStore, optional
            When given, a promoted generation is committed to the store
            (before any host state changes) and its codes are faulted back
            in on first search touch, every row verified
            (``build/merge.py``).
        minor_name : str
            Store name the minors are committed under.
        """
        self._max_minors = int(max_minors)
        if minor_store is not None:
            self._minor_sink = (minor_store, minor_name)
        self._delta_cache = None
        self._delta_epoch += 1

    @property
    def n_clusters(self) -> int:
        """Clusters of the served index (``data``'s, unless a subclass
        knows them without building it)."""
        return int(self.data.ivf.centroids.shape[0])

    @property
    def device(self) -> torch.device:
        """Where a search's queries go (``data``'s device, unless a
        subclass says otherwise)."""
        return self.data.ivf.centroids.device

    @property
    def delta_fill(self) -> int:
        """Live points across all delta tiers (L0 + minor generations)."""
        return self.side_fill + sum(m.live for m in self._minors)

    def delta_view(self) -> SideBuffer | None:
        """The delta tiers as one :class:`SideBuffer`, ``None`` when empty.

        Without tiers this is the side buffer itself. With tiers, L0 and
        every minor generation are concatenated and padded to the constant
        capacity ``B · (1 + max_minors)`` (so the search's shapes do not
        change across merge cycles), cached until the next tier mutation.
        """
        if self._max_minors <= 0:
            return None if self.side_fill == 0 else self.side
        if self.side_fill == 0 and not self._minors:
            return None
        if (self._delta_cache is None
                or self._delta_cache[0] != self._delta_epoch):
            from .freshness import combined_delta
            self._delta_cache = (
                self._delta_epoch,
                combined_delta(self.side, self._minors, self._max_minors))
        return self._delta_cache[1]

    def delta_snapshot(self) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                      np.ndarray]:
        """Host ``(valid, cluster, ids, codes)`` over L0 + minors, unpadded
        (what ``build.rebuild.live_points`` folds in)."""
        tiers = [self.side._asdict()] + [
            dict(valid=m.valid, cluster=m.cluster, ids=m.ids,
                 codes=m.materialize()) for m in self._minors]
        host = lambda a: a.cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)  # noqa: E731
        return tuple(np.concatenate([host(t[f]) for t in tiers])
                     for f in ("valid", "cluster", "ids", "codes"))

    # ---- mutation -------------------------------------------------------
    def _placement_fits(self, labels: np.ndarray, side_slots: int) -> bool:
        """Whether a batch with these owning clusters is placeable given
        ``side_slots`` free L0 positions (reads, mutates nothing)."""
        cs, counts = np.unique(labels, return_counts=True)
        spill = sum(max(0, int(n) - len(self._free[int(c)]))
                    for c, n in zip(cs, counts))
        return spill <= side_slots

    def insert(self, points) -> list[int]:
        """Insert a (B, D) batch; returns the assigned global ids.

        Raises ``RuntimeError`` before mutating anything when the batch
        cannot be placed (an owning cluster is full and the delta tier
        cannot take the rest; call ``compact()`` or raise
        ``side_capacity``). With the tiers on, a full L0 is first promoted
        into a minor generation, only when the batch then provably fits.
        The commit writes the device first (the side buffer as a new copy,
        the cluster slots through ``_apply_insert``) and the host
        bookkeeping last, so a device write that raises leaves the host
        bookkeeping and the side buffer unchanged.
        """
        dev = self.side.codes.device
        pts = _as_tensor(points).to(dev)
        if pts.dim() == 1:
            pts = pts[None]
        labels_t, codes = self._labels_codes(pts)              # (B,), (B, S)
        labels = labels_t.cpu().numpy()

        if not self._placement_fits(labels, len(self._side_free)):
            if (self._max_minors > 0 and self.side_fill > 0
                    and len(self._minors) < self._max_minors
                    and self._placement_fits(labels, self.side.capacity)):
                from .freshness import promote_l0
                promote_l0(self)
            else:
                raise RuntimeError(
                    "insert batch does not fit: cluster padding and side "
                    "buffer exhausted — call compact() or raise side_capacity")

        # plan: per-cluster free slots from the free lists' tails, in
        # order, then side-buffer positions
        taken: dict[int, int] = {}
        side_need = 0
        placements: list[tuple[int, int]] = []   # (cluster, slot) | (-1, pos)
        for c in labels.tolist():
            used = taken.get(c, 0)
            if used < len(self._free[c]):
                placements.append((c, self._free[c][-1 - used]))
                taken[c] = used + 1
            else:                 # _placement_fits guarantees a position
                placements.append((-1, self._side_free[-1 - side_need]))
                side_need += 1

        new_ids = list(range(self._next_id, self._next_id + pts.shape[0]))
        ids_np = np.asarray(new_ids, np.int32)
        cl, sl, sel, s_pos, s_sel = [], [], [], [], []
        for i, (c, slot) in enumerate(placements):
            if c >= 0:
                cl.append(c)
                sl.append(slot)
                sel.append(i)
            else:
                s_pos.append(slot)
                s_sel.append(i)

        # commit: device first (the side buffer as a new copy) …
        new_side = None
        if s_pos:
            pos_t = torch.as_tensor(s_pos, device=dev)
            sel_t = torch.as_tensor(s_sel, device=dev)
            new_side = _side_set(
                self.side, pos_t, codes=codes[sel_t],
                cluster=labels_t[sel_t],
                ids=torch.as_tensor(ids_np[s_sel], device=dev), valid=True)
        if cl:
            self._apply_insert(cl, sl, ids_np[sel],
                               codes[torch.as_tensor(sel, device=dev)])
        # … then the host bookkeeping, which cannot fail
        if new_side is not None:
            self.side = new_side
        for c, cnt in taken.items():
            del self._free[c][-cnt:]
        if side_need:
            del self._side_free[-side_need:]
        for i, (c, slot) in enumerate(placements):
            self._loc[new_ids[i]] = (c, slot)
        self._next_id += pts.shape[0]
        if s_pos:
            self._delta_epoch += 1
        self._rt_on_insert(pts, labels)
        return new_ids

    def delete(self, ids) -> int:
        """Tombstone points by global id; returns how many were removed.

        Freed cluster slots become insert targets; nothing moves. An
        unknown, already deleted or duplicated id raises ``KeyError``
        before any state is touched. A point in a minor generation is
        tombstoned in that generation's host mask; a generation left empty
        is dropped.
        """
        pids = [int(p) for p in np.atleast_1d(np.asarray(ids, np.int64))]
        if len(set(pids)) != len(pids):
            raise KeyError(f"duplicate ids in delete batch: {pids}")
        locs = [self._loc[p] for p in pids]      # KeyError = unknown id
        cl, sl, s_pos = [], [], []
        m_pos: dict[int, list[int]] = {}         # minor gen -> positions
        for c, slot in locs:
            if c >= 0:
                cl.append(c)
                sl.append(slot)
            elif c == -1:
                s_pos.append(slot)
            else:
                m_pos.setdefault(-2 - c, []).append(slot)
        # device first …
        if cl:
            self._apply_delete(cl, sl)
        if s_pos:
            pos_t = torch.as_tensor(s_pos, device=self.side.valid.device)
            self.side = _side_set(self.side, pos_t, valid=False)
        # … then the host bookkeeping
        if m_pos:
            by_gen = {m.gen: m for m in self._minors}
            for g, poss in m_pos.items():
                by_gen[g].valid[np.asarray(poss)] = False
            self._minors = [m for m in self._minors if m.live]
        for pid in pids:
            del self._loc[pid]
        for c, slot in locs:
            if c >= 0:
                self._free[c].append(slot)
            elif c == -1:
                self._side_free.append(slot)
        if s_pos or m_pos:
            self._delta_epoch += 1
        return len(pids)

    def compact(self) -> int:
        """Fold side-buffer points into freed slots of their owning cluster.

        Returns how many points moved; points whose cluster is still full
        stay in the buffer. The search's results do not change (same
        scoring). The plan is built (one stable argsort groups side
        positions by cluster; each cluster gives its free-list tail) and
        checked before anything mutates: a free slot listed twice
        (double-free) or a fold from a side position already on the free
        list (reused slot) raises ``RuntimeError`` with all state
        unchanged. Device first, host last, as ``insert``.
        """
        side_valid = self.side.valid.cpu().numpy()
        side_cluster = self.side.cluster.cpu().numpy()
        side_ids = self.side.ids.cpu().numpy()
        pos_all = np.flatnonzero(side_valid)
        if pos_all.size == 0:
            return 0
        pos_sorted = pos_all[np.argsort(side_cluster[pos_all], kind="stable")]
        cs, starts, counts = np.unique(side_cluster[pos_sorted],
                                       return_index=True, return_counts=True)
        cl: list[int] = []
        sl: list[int] = []
        pos_l: list[int] = []
        plan: list[tuple[int, int]] = []         # (cluster, take)
        for c, st, n in zip(cs.tolist(), starts.tolist(), counts.tolist()):
            take = min(n, len(self._free[c]))
            if not take:
                continue
            cl += [c] * take
            sl += [int(s) for s in self._free[c][-take:][::-1]]
            pos_l += pos_sorted[st:st + take].tolist()
            plan.append((c, take))
        if not pos_l:
            return 0
        if len(set(zip(cl, sl))) != len(sl):
            raise RuntimeError(
                "compact plan references a cluster slot twice (corrupted "
                "free list / double-free); refusing to fold")
        if set(pos_l) & set(self._side_free):
            raise RuntimeError(
                "compact plan folds a side position already on the free "
                "list (reused-slot aliasing); refusing to fold")
        pos_t = torch.as_tensor(pos_l, device=self.side.valid.device)
        self._apply_insert(cl, sl, side_ids[pos_l].astype(np.int32),
                           self.side.codes[pos_t])
        self.side = _side_set(self.side, pos_t, valid=False)
        for c, take in plan:
            del self._free[c][-take:]
        for c, slot, pos in zip(cl, sl, pos_l):
            self._loc[int(side_ids[pos])] = (c, slot)
        self._side_free.extend(pos_l)
        self._delta_epoch += 1
        return len(pos_l)


class MutableJunoIndex(MutableIndexBase):
    """Online-mutable wrapper over a built :class:`JunoIndexData`.

    ``insert`` encodes new points with the existing codebooks into free
    padded slots of their owning cluster, spilling into a fixed-capacity
    :class:`SideBuffer` when a cluster is full; ``delete`` tombstones them
    through ``valid``; ``compact()`` folds spills back into freed slots.
    None of them changes the search's shapes.

    The wrapper owns a copy of the index it is given: the constructor and
    :meth:`swap_data` clone the three tensors a mutation writes
    (``cluster_codes``, ``ivf.point_ids``, ``ivf.valid``; 192 / 400 MB at
    1M points, once), so the caller's index still searches as built and
    two wrappers over one index never see each other's writes, as with
    the reference's functional updates. Those copies are then updated
    **in place** (a copy of ``cluster_codes`` a batch is not affordable).
    A batch writes ``cluster_codes``, then ``point_ids``, then ``valid``
    last, so a write that fails part-way leaves only invisible slots.

    An optional :class:`repro_torch.rt.CentroidGrid` rides along for
    ``prefilter="rt"`` (attached, or built by :meth:`ensure_rt_grid`);
    inserts grow the touched clusters' reaches, deletes leave them.
    """

    def __init__(self, data: JunoIndexData, *, side_capacity: int = 256,
                 rt_grid: rt_lib.CentroidGrid | None = None):
        data = _own_copy(data)
        self.data = data
        self.rt_grid = rt_grid
        self._init_bookkeeping(data.ivf.valid, data.ivf.point_ids,
                               side_capacity=side_capacity,
                               first_new_id=int(data.codes.shape[0]),
                               n_subspaces=int(data.codes.shape[1]))

    def _labels_codes(self, pts):
        return _label_encode(pts, self.data.ivf, self.data.codebook)

    def _rt_centroids(self):
        return self.data.ivf.centroids

    # ---- device writes ---------------------------------------------------
    def _apply_insert(self, cl, sl, ids, codes):
        dev = self.data.cluster_codes.device
        cl_t = torch.as_tensor(cl, device=dev)
        sl_t = torch.as_tensor(sl, device=dev)
        ids_t = torch.as_tensor(np.asarray(ids, np.int32), device=dev)
        codes = codes.to(dev)
        # valid last: a write that fails part-way leaves invisible slots
        self.data.cluster_codes[cl_t, sl_t] = codes
        self.data.ivf.point_ids[cl_t, sl_t] = ids_t
        self.data.ivf.valid[cl_t, sl_t] = True

    def _apply_delete(self, cl, sl):
        dev = self.data.ivf.valid.device
        self.data.ivf.valid[torch.as_tensor(cl, device=dev),
                            torch.as_tensor(sl, device=dev)] = False

    def swap_data(self, new_data: JunoIndexData, *,
                  side_capacity: int | None = None) -> None:
        """Install a rebuilt :class:`JunoIndexData` in one assignment.

        The bookkeeping is rederived from its ``point_ids``/``valid``, the
        side buffer is reset to empty (a rebuild drains it, see
        ``build.rebuild``), and the id counter is kept so ids never repeat.
        The rt grid is dropped and rebuilt at the next ``prefilter="rt"``
        search (:meth:`ensure_rt_grid`).

        Parameters
        ----------
        new_data : JunoIndexData
            The replacement index; its point ids are already global.
        side_capacity : int, optional
            Capacity of the fresh side buffer (default: the current one's).
        """
        new_data = _own_copy(new_data)
        pids = new_data.ivf.point_ids
        first_new = max(self._next_id,
                        int(pids.max()) + 1 if pids.numel() else 0)
        self.data = new_data
        self.rt_grid = None
        self._init_bookkeeping(
            new_data.ivf.valid, pids,
            side_capacity=(self.side.capacity if side_capacity is None
                           else side_capacity),
            first_new_id=first_new,
            n_subspaces=int(new_data.codes.shape[1]))

    def ensure_rt_grid(self, *, metric: str = "l2", **kw
                       ) -> rt_lib.CentroidGrid:
        """Build and attach the centroid grid if none is attached
        (``rt.build_grid(self.data, metric=metric, **kw)``); returns it."""
        if self.rt_grid is None:
            self.rt_grid = rt_lib.build_grid(self.data, metric=metric, **kw)
        return self.rt_grid

    def search(self, queries, *, prefilter: str = "scan", **kw):
        """:func:`search` over the current state, side buffer included
        (``None`` when empty); ``prefilter="rt"`` builds the grid at first
        use. Keyword arguments go to :func:`search`."""
        if prefilter == "rt" and kw.get("rt_grid") is None:
            kw["rt_grid"] = self.ensure_rt_grid(metric=kw.get("metric", "l2"))
        return search(self.data, queries, side=self.delta_view(),
                      prefilter=prefilter, **kw)
