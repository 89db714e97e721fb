"""Streaming, memory-bounded index build (out of core).

Port of ``repro/build/pipeline.py``. The in-memory ``core.build`` holds
the whole (N, D) point set at once; this build makes two passes over a
re-iterable chunk source and holds at most one chunk of raw points beside
a bounded training sample:

pass 1  reservoir-sample ``max_train_points`` rows (algorithm R, numpy,
        seeded) and count N. Train the IVF centroids and the residual PQ
        codebook on the sample, fix the density grid's box from the
        sample's residuals and draw the calibration queries from the
        sample (their noise scaled by the sample's std).
pass 2  per 8192-row eval batch, on the build's device: assignment
        (``ops.filter_topk`` at nprobe 1, the ``ivf_filter`` kernel on the
        card, first minimum wins, as the insert path labels points), the
        residuals' PQ codes, the density counts (pad rows weighted 0) and
        ‖p‖², while the calibration queries' exact top-k is merged batch by
        batch. Labels, codes and ‖p‖² go to the host (O(N) bytes) in one
        device→host copy a batch.
finalize  the padded cluster layout (``ivf.padded_layout``); points the
        overflow spill moved to another cluster are fetched again in a
        third pass, re-encoded against their new centroid and their density
        counts moved (−1 at the old cells, +1 at the new, same box); then
        the grid and the threshold regressor's fit.

Randomness is injected as in ``core.build``: :class:`StreamDraws` holds
the reservoir's seed and the in-memory build's draws at ``n = fill`` (the
sample is at most ``max_train_points`` rows, so neither training
subsamples it). Without them the port draws its own from a numpy
``Generator(seed)``. Every chunk that enters the build is counted on a
:class:`BuildProbe`, so the memory bound is checked structurally.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Iterator, NamedTuple

import numpy as np
import torch

from ..core import density as density_lib
from ..core.ivf import IVFIndex, cluster_capacity, padded_layout
from ..core.juno import (BuildDraws, JunoConfig, JunoIndexData,
                         _calib_queries, _calib_query_subspaces,
                         _calib_tau_needed, draw_build)
from ..core.kmeans import kmeans_subsampled
from ..core.pq import encode, split_subspaces, train_codebook
from ..device import resolve_device
from ..kernels import ops

#: rows of one eval batch (bounds the batch's device work whatever the
#: chunk size; the last batch of a pass is padded with copies of its last
#: row)
_EVAL_ROWS = 8192
#: the sample's training assignment chunk (bounds k-means' (chunk, C) and
#: the PQ's (S, chunk, E) distance blocks on the device)
_TRAIN_CHUNK = 4096


@dataclasses.dataclass
class BuildProbe:
    """Structural memory-bound counters of the streaming build.

    Attributes
    ----------
    passes : int
        Completed passes over the source (2, or 3 when the overflow
        spill forced a re-encode pass).
    chunks : int
        Chunks consumed over all passes.
    max_chunk_rows : int
        Largest chunk seen: the raw-point residency bound beside the
        training sample.
    train_rows : int
        Rows in the training sample (<= ``max_train_points``).
    n_points : int
        Rows streamed (N).
    """

    passes: int = 0
    chunks: int = 0
    max_chunk_rows: int = 0
    train_rows: int = 0
    n_points: int = 0

    def note_chunk(self, rows: int) -> None:
        """Record one consumed chunk of ``rows`` points."""
        self.chunks += 1
        self.max_chunk_rows = max(self.max_chunk_rows, rows)


class StreamDraws(NamedTuple):
    """Every random draw of :func:`build_streaming`."""

    reservoir_seed: int   # seed of the reservoir's numpy Generator
    build: BuildDraws     # the in-memory build's draws at n = fill


def array_source(points, chunk_points: int = 65536
                 ) -> Callable[[], Iterator[np.ndarray]]:
    """A chunk source over an (N, D) array or ``np.memmap``: a zero-arg
    callable returning a fresh iterator of ``chunk_points``-row f32
    chunks (the build makes two or three passes)."""
    def it() -> Iterator[np.ndarray]:
        for lo in range(0, points.shape[0], chunk_points):
            yield np.asarray(points[lo:lo + chunk_points], np.float32)
    return it


def _chunks(source) -> Iterator[np.ndarray]:
    """One pass over a chunk source (callable or re-iterable)."""
    it: Iterable = source() if callable(source) else source
    for chunk in it:
        arr = np.asarray(chunk, np.float32)
        if arr.ndim != 2:
            raise ValueError(f"chunk must be (B, D), got {arr.shape}")
        if arr.shape[0]:
            yield arr


def _reservoir_extend(sample: np.ndarray, fill: int, seen: int,
                      chunk: np.ndarray, rng: np.random.Generator
                      ) -> tuple[int, int]:
    """Vectorised reservoir sampling (algorithm R) over one chunk.

    Writes ``sample`` in place; returns the new (fill, seen). Until the
    reservoir is full, rows are appended in stream order, so for
    N <= capacity the sample is the stream.
    """
    cap = sample.shape[0]
    b = chunk.shape[0]
    take = min(cap - fill, b)
    if take:
        sample[fill:fill + take] = chunk[:take]
        fill += take
    if take < b:
        rest = chunk[take:]
        idx = seen + take + np.arange(rest.shape[0])
        accept = rng.integers(0, idx + 1) < cap
        slots = rng.integers(0, cap, size=int(accept.sum()))
        sample[slots] = rest[accept]
    return fill, seen + b


class _EvalBatcher:
    """Regroup chunks of any size into fixed ``_EVAL_ROWS``-row batches."""

    def __init__(self, d: int, rows: int = _EVAL_ROWS):
        self.buf = np.empty((rows, d), np.float32)
        self.fill = 0

    def feed(self, chunk: np.ndarray):
        """Yield (batch, n_valid) as the chunk fills batches."""
        pos = 0
        rows = self.buf.shape[0]
        while pos < chunk.shape[0]:
            take = min(rows - self.fill, chunk.shape[0] - pos)
            self.buf[self.fill:self.fill + take] = chunk[pos:pos + take]
            self.fill += take
            pos += take
            if self.fill == rows:
                yield self.buf, rows
                self.fill = 0

    def flush(self):
        """Yield the last partial batch, padded with its last row."""
        if self.fill:
            self.buf[self.fill:] = self.buf[self.fill - 1]
            yield self.buf, self.fill
            self.fill = 0


def _gather_rows(source, ids: np.ndarray, probe: BuildProbe) -> np.ndarray:
    """The rows ``ids`` (sorted global ids) in one more pass over the
    source: one chunk plus the requested rows are resident."""
    ids = np.asarray(ids)
    out = None
    base = 0
    for chunk in _chunks(source):
        probe.note_chunk(chunk.shape[0])
        if out is None:
            out = np.empty((ids.shape[0], chunk.shape[1]), np.float32)
        lo = np.searchsorted(ids, base)
        hi = np.searchsorted(ids, base + chunk.shape[0])
        if hi > lo:
            out[lo:hi] = chunk[ids[lo:hi] - base]
        base += chunk.shape[0]
    probe.passes += 1
    return out


def _assign(pts: torch.Tensor, centroids: torch.Tensor,
            c_sq: torch.Tensor) -> torch.Tensor:
    """Owning cluster of each row: the first minimum of ``csq − 2·p·cᵀ``
    (``ops.filter_topk`` at nprobe 1, ``_EVAL_ROWS`` rows a call).
    Returns (N,) int64."""
    return torch.cat([
        ops.filter_topk(pts[lo:lo + _EVAL_ROWS], centroids, c_sq, nprobe=1,
                        metric="l2")[1][:, 0]
        for lo in range(0, pts.shape[0], _EVAL_ROWS)])


def _encode_batch(pts, centroids, c_sq, codebook, counts, lo, hi, n_valid):
    """One eval batch (B, D): labels (B,) int64, codes (B, S) uint8, the
    updated density counts (pad rows weighted 0) and ‖p‖² (B,)."""
    labels = ops.filter_topk(pts, centroids, c_sq, nprobe=1,
                             metric="l2")[1][:, 0]
    res = pts - centroids[labels]
    codes = encode(res, codebook)
    sub = split_subspaces(res, codebook.sub_dim).transpose(0, 1)
    w = (torch.arange(pts.shape[0], device=pts.device) < n_valid).float()
    counts = density_lib.accumulate_density_counts(counts, sub, lo, hi, w)
    return labels, codes, counts, torch.sum(pts * pts, dim=-1)


def _merge_topk(best_s, best_i, queries, pts, psq, base: int, n_valid: int,
                metric: str):
    """Fold one batch into the calibration queries' running exact top-k.

    Scores as ``core.ref.exact_topk`` gives them (l2 leaves out ‖q‖²;
    higher is better inside); pad rows score −inf. The running best comes
    before the batch in a stable descending sort, so a tie keeps the lower
    id (``lax.top_k``'s order)."""
    dots = queries @ pts.T                                        # (Q, B)
    scores = -(psq[None, :] - 2.0 * dots) if metric == "l2" else dots
    b = pts.shape[0]
    pos = torch.arange(b, device=pts.device)
    scores = torch.where(pos[None, :] < n_valid, scores,
                         torch.tensor(float("-inf"), device=pts.device))
    cat_s = torch.cat([best_s, scores], dim=1)
    cat_i = torch.cat([best_i, (base + pos)[None].expand(best_s.shape[0], b)],
                      dim=1)
    top, sel = torch.sort(cat_s, dim=1, descending=True, stable=True)
    k = best_s.shape[1]
    return top[:, :k], torch.gather(cat_i, 1, sel[:, :k])


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous (B, ...) tensor as (B, bytes a row) uint8."""
    return t.contiguous().view(torch.uint8).reshape(t.shape[0], -1)


def build_streaming(source, config: JunoConfig, *, seed: int = 0,
                    draws: StreamDraws | None = None,
                    probe: BuildProbe | None = None,
                    device=None) -> JunoIndexData:
    """Out-of-core build: two (or three) passes over a chunk source.

    The index has the shapes and dtypes of ``core.build``'s on the same
    data; for N <= ``max_train_points`` and no overflow spill it trains on
    the same points, so its arrays match the in-memory build's up to the
    assignment's rounding. The raw points are resident one chunk at a time
    beside the training sample.

    Parameters
    ----------
    source : callable or iterable
        Chunk source of (B, D) float arrays: a callable is called once a
        pass; an iterable must be re-iterable (a list, not a generator).
        :func:`array_source` adapts an array or memmap.
    config : JunoConfig
        Build knobs; ``max_train_points`` bounds the sample (<= 0 means
        200,000: a streaming build cannot train on all points).
    seed : int
        Seed of the port's own draws; ignored when ``draws`` is given.
    draws : StreamDraws, optional
        Every random draw, injected (e.g. the reference's).
    probe : BuildProbe, optional
        Filled with the pass, chunk and residency counters.
    device : str or torch.device, optional
        ``None`` = ``cuda``; ``"cpu"`` for the plain versions.

    Returns
    -------
    JunoIndexData
        The index, every tensor on ``device``.
    """
    dev = resolve_device(device)
    probe = probe if probe is not None else BuildProbe()
    t_max = config.max_train_points if config.max_train_points > 0 else 200_000
    own = np.random.default_rng(seed) if draws is None else None
    res_seed = (int(own.integers(0, 2 ** 31 - 1)) if draws is None
                else draws.reservoir_seed)

    # ---- pass 1: reservoir sample + count ----------------------------------
    sample = None
    fill = seen = 0
    rng = np.random.default_rng(res_seed)
    for chunk in _chunks(source):
        probe.note_chunk(chunk.shape[0])
        if sample is None:
            sample = np.empty((t_max, chunk.shape[1]), np.float32)
        fill, seen = _reservoir_extend(sample, fill, seen, chunk, rng)
    if sample is None:
        raise ValueError("empty point source")
    probe.passes += 1
    n, d = seen, sample.shape[1]
    probe.train_rows = fill
    probe.n_points = n
    s = d // config.sub_dim
    bd = (draw_build(fill, d, config, int(own.integers(0, 2 ** 31 - 1)))
          if draws is None else draws.build)
    if bd.ivf_train_idx is not None or bd.pq_train_idx is not None:
        raise ValueError("the sample is never subsampled again: draws with "
                         "training subsamples do not apply")

    def idx(a):
        return torch.from_numpy(np.array(a, np.int64)).to(dev)

    # ---- train on the sample -----------------------------------------------
    smp = torch.from_numpy(sample[:fill]).to(dev)
    centroids = kmeans_subsampled(smp, idx(bd.ivf_init_idx),
                                  n_iters=config.kmeans_iters,
                                  chunk=_TRAIN_CHUNK).centroids
    c_sq = torch.sum(centroids * centroids, dim=-1)
    s_res = smp - centroids[_assign(smp, centroids, c_sq)]
    codebook = train_codebook(s_res, idx(bd.pq_init_idx), m=config.sub_dim,
                              n_iters=config.kmeans_iters, chunk=_TRAIN_CHUNK)
    s_sub = split_subspaces(s_res, config.sub_dim).transpose(0, 1)
    dens_lo, dens_hi = torch.amin(s_sub, dim=1), torch.amax(s_sub, dim=1)
    queries = _calib_queries(smp, bd)      # from the sample, its std
    del smp, s_res, s_sub

    # ---- pass 2: encode + density + streamed ground truth --------------------
    g = config.grid_size
    counts = torch.zeros((s, g, g), dtype=torch.float32, device=dev)
    kcal = min(config.calib_topk, n)
    best_s = torch.full((queries.shape[0], kcal), float("-inf"), device=dev)
    best_i = torch.full((queries.shape[0], kcal), -1, dtype=torch.int64,
                        device=dev)
    labels_all = np.empty((n,), np.int32)
    codes_all = np.empty((n, s), np.uint8)
    psq_all = np.empty((n,), np.float32)
    batcher = _EvalBatcher(d)
    pos = 0

    def eat(batch: np.ndarray, n_valid: int):
        nonlocal counts, best_s, best_i, pos
        pts = torch.from_numpy(batch).to(dev)
        labels, codes, counts, psq = _encode_batch(
            pts, centroids, c_sq, codebook, counts, dens_lo, dens_hi, n_valid)
        best_s, best_i = _merge_topk(best_s, best_i, queries, pts, psq, pos,
                                     n_valid, config.metric)
        # one device→host copy a batch: labels, codes and ‖p‖² as bytes
        host = torch.cat([_bytes(labels.to(torch.int32)), codes,
                          _bytes(psq)], dim=1)[:n_valid].cpu().numpy()
        sl = slice(pos, pos + n_valid)
        labels_all[sl] = np.ascontiguousarray(host[:, :4]).view(np.int32)[:, 0]
        codes_all[sl] = host[:, 4:4 + s]
        psq_all[sl] = np.ascontiguousarray(host[:, 4 + s:]).view(
            np.float32)[:, 0]
        pos += n_valid

    for chunk in _chunks(source):
        probe.note_chunk(chunk.shape[0])
        for batch, n_valid in batcher.feed(chunk):
            eat(batch, n_valid)
    for batch, n_valid in batcher.flush():
        eat(batch, n_valid)
    probe.passes += 1
    if pos != n:
        raise ValueError(
            f"source yielded {pos} rows on pass 2 but {n} on pass 1: the "
            "chunk source must be re-iterable and stable")

    # ---- finalize: layout, spill patch, density model -------------------------
    cap = cluster_capacity(n, config.n_clusters, config.capacity_mult)
    labels_pre = labels_all.copy()
    point_ids, labels_all = padded_layout(labels_all, config.n_clusters, cap)
    # a spilled point's code must be its residual to the adoptive centroid
    # (the in-memory build encodes after the spill): fetch those rows again
    changed = np.nonzero(labels_pre != labels_all)[0]
    if changed.size:
        rows = torch.from_numpy(_gather_rows(source, changed, probe)).to(dev)
        old_res = rows - centroids[idx(labels_pre[changed])]
        new_res = rows - centroids[idx(labels_all[changed])]
        codes_all[changed] = encode(new_res, codebook).cpu().numpy()
        one = torch.ones((changed.size,), dtype=torch.float32, device=dev)
        for res, w in ((old_res, -one), (new_res, one)):
            counts = density_lib.accumulate_density_counts(
                counts, split_subspaces(res, config.sub_dim).transpose(0, 1),
                dens_lo, dens_hi, w)
    pid = torch.from_numpy(point_ids).to(dev)
    ivf = IVFIndex(centroids=centroids, centroid_sq=c_sq, point_ids=pid,
                   valid=pid >= 0,
                   labels=torch.from_numpy(labels_all.astype(np.int32)).to(dev))
    codes = torch.from_numpy(codes_all).to(dev)
    cluster_codes = codes[torch.clamp(pid, min=0).long()]
    grid = density_lib.density_grid_from_counts(counts, dens_lo, dens_hi)
    qsub = _calib_query_subspaces(queries, ivf, config)
    tau_needed = _calib_tau_needed(qsub, codes[best_i].long(), codebook,
                                   config.metric)
    dens = density_lib.calibrate_from_grid(grid, dens_lo, dens_hi, qsub,
                                           tau_needed,
                                           degree=config.poly_degree)
    return JunoIndexData(ivf=ivf, codebook=codebook, codes=codes,
                         cluster_codes=cluster_codes, density=dens,
                         points_sq=torch.from_numpy(psq_all).to(dev))


def split_shards(data: JunoIndexData, n_shards: int) -> list[JunoIndexData]:
    """Slice a built index into cluster-partitioned parts: part ``i`` owns
    clusters ``[i·C/n, (i+1)·C/n)`` (centroids, their norms, point ids,
    validity and codes); the codebook, density model, flat codes and the
    global labels and ids are shared. ``n_shards`` must divide C."""
    c = data.ivf.centroids.shape[0]
    if c % n_shards:
        raise ValueError(f"clusters ({c}) must divide over {n_shards} shards")
    cl = c // n_shards
    out = []
    for i in range(n_shards):
        sl = slice(i * cl, (i + 1) * cl)
        out.append(data._replace(
            ivf=data.ivf._replace(
                centroids=data.ivf.centroids[sl],
                centroid_sq=data.ivf.centroid_sq[sl],
                point_ids=data.ivf.point_ids[sl], valid=data.ivf.valid[sl]),
            cluster_codes=data.cluster_codes[sl]))
    return out


def merge_shards(parts: list[JunoIndexData]) -> JunoIndexData:
    """Reassemble :func:`split_shards` parts (in shard order) into one
    index; the shared components come from part 0."""
    first = parts[0]

    def cat(f):
        return torch.cat([getattr(p.ivf, f) for p in parts])
    return first._replace(
        ivf=first.ivf._replace(
            centroids=cat("centroids"), centroid_sq=cat("centroid_sq"),
            point_ids=cat("point_ids"), valid=cat("valid")),
        cluster_codes=torch.cat([p.cluster_codes for p in parts]))


def build_streaming_sharded(source, config: JunoConfig, n_shards: int, **kw
                            ) -> list[JunoIndexData]:
    """:func:`build_streaming`, then :func:`split_shards` into ``n_shards``
    parts (``kw`` goes to the build)."""
    return split_shards(build_streaming(source, config, **kw), n_shards)
