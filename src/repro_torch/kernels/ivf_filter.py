"""IVF filter (stage A): the CUDA kernel and its plain versions.

Port of ``repro/kernels/ivf_filter.py``: every query against every
centroid, ``csq − 2·q·cᵀ`` for l2 (lower is better; ‖q‖² left out, it
does not change a row's order) or ``q·cᵀ`` for ip (higher is better).
Contract: ``repro/kernels/ref.py:ivf_filter_ref``. The kernel
(``csrc/ivf_filter.cu``) has two epilogues: the (Q, C) matrix
(:func:`ivf_filter`), and each row's best ``nprobe`` centroids in
``lax.top_k``'s order (:func:`ivf_filter_topk`, stage A of
``repro/core/ivf.py:filter_clusters`` in one launch). It sums over D in
full f32 in another order than the plain version's matrix product, so the
two agree within ~D ulps of ``Σ_d |q_d c_d|`` (twice that for l2).

The top-nprobe kernel keeps one int32 counter a row tile of 8 queries per
device (:func:`_counters`), zeroed once when it is allocated and left at
zero by every launch; it serves PyTorch's current stream only.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build


def ivf_filter_plain(queries: torch.Tensor, centroids: torch.Tensor,
                     centroid_sq: torch.Tensor, *, metric: str = "l2"
                     ) -> torch.Tensor:
    """The plain PyTorch version, on any device: queries (Q, D) f32,
    centroids (C, D) f32, centroid_sq (C,) f32 -> (Q, C) f32."""
    qc = queries @ centroids.T
    if metric == "l2":
        return centroid_sq[None, :] - 2.0 * qc
    if metric == "ip":
        return qc
    raise ValueError(f"unknown metric {metric!r}")


def ivf_filter_topk_plain(queries: torch.Tensor, centroids: torch.Tensor,
                          centroid_sq: torch.Tensor, *, nprobe: int,
                          metric: str = "l2"
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain top-nprobe, on any device: :func:`ivf_filter_plain`'s
    matrix, a stable sort and a slice -> (scores (Q, nprobe) f32, ids (Q,
    nprobe) int64). l2 ascending, ip descending, equal scores by smaller
    centroid index (``lax.top_k``'s order); l2 scores as they are."""
    _check_nprobe(nprobe, centroids.shape[0])
    scores = ivf_filter_plain(queries, centroids, centroid_sq, metric=metric)
    if metric == "l2":
        vals, ids = torch.sort(-scores, dim=1, descending=True, stable=True)
        return -vals[:, :nprobe], ids[:, :nprobe]
    vals, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :nprobe], ids[:, :nprobe]


def _check_nprobe(nprobe: int, c: int) -> None:
    if not 1 <= nprobe <= c:
        raise ValueError(f"nprobe must lie in [1, C={c}], got {nprobe}")


def _checked_inputs(queries, centroids, centroid_sq, metric):
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError("ivf_filter launches on CUDA tensors only")
    q, d = queries.shape
    c = centroids.shape[0]
    if q * c >= 2 ** 31 or c >= 2 ** 31 or q >= 65535 * 8:
        raise ValueError(f"unsupported shape Q={q} C={c}")
    return [_build.checked(n, t, torch.float32, shp, dev) for n, t, shp in (
        ("queries", queries, (q, d)), ("centroids", centroids, (c, d)),
        ("centroid_sq", centroid_sq, (c,)))]


def ivf_filter(queries: torch.Tensor, centroids: torch.Tensor,
               centroid_sq: torch.Tensor, *, metric: str = "l2"
               ) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only; same contract as
    :func:`ivf_filter_plain`). Counts one launch in
    ``_build.LAUNCHES["ivf_filter"]``."""
    args = _checked_inputs(queries, centroids, centroid_sq, metric)
    dev = queries.device
    (q, d), c = queries.shape, centroids.shape[0]
    out = torch.empty((q, c), dtype=torch.float32, device=dev)
    rc = _launcher()(*[a.data_ptr() for a in args], out.data_ptr(), q, c, d,
                     int(metric == "l2"), _build.stream_ptr(dev))
    _build.check(rc, "ivf_filter")
    _build.LAUNCHES["ivf_filter"] += 1
    return out


#: past nprobe 32 the top-nprobe kernel's merge holds 2 warps x 4 rows x
#: (C tiles x min(nprobe, 128)) 64-bit keys in shared memory: at most a
#: block's 227 KB less 1 KB for the rest
_MERGE_SMEM = 232_448 - 1024


def _tile_keys(nprobe: int) -> int:
    """Keys each 128-centroid tile keeps of a row (``tile_keys`` in
    ``csrc/ivf_filter.cu``): nprobe rounded up to a power of two up to 32,
    else ``min(nprobe, 128)``."""
    if nprobe > 32:
        return min(nprobe, 128)
    return 1 << (nprobe - 1).bit_length()


def ivf_filter_topk(queries: torch.Tensor, centroids: torch.Tensor,
                    centroid_sq: torch.Tensor, *, nprobe: int,
                    metric: str = "l2") -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel with its top-nprobe epilogue (CUDA tensors only;
    same contract as :func:`ivf_filter_topk_plain`), one launch in all.
    Counts one launch in ``_build.LAUNCHES["ivf_filter"]``."""
    args = _checked_inputs(queries, centroids, centroid_sq, metric)
    dev = queries.device
    (q, d), c = queries.shape, centroids.shape[0]
    _check_nprobe(nprobe, c)
    n_ct, kt = math.ceil(c / 128), _tile_keys(nprobe)
    if nprobe > 32 and 64 * n_ct * kt > _MERGE_SMEM:
        raise ValueError(f"unsupported shape C={c} nprobe={nprobe}: the "
                         f"merge needs {64 * n_ct * kt} B of shared memory")
    scores = torch.empty((q, nprobe), dtype=torch.float32, device=dev)
    ids = torch.empty((q, nprobe), dtype=torch.int64, device=dev)
    scratch = torch.empty((q, n_ct, kt), dtype=torch.int64, device=dev)
    counters = _counters(dev, math.ceil(q / 8))
    rc = _topk_launcher()(*[a.data_ptr() for a in args], scores.data_ptr(),
                          ids.data_ptr(), scratch.data_ptr(),
                          counters.data_ptr(), q, c, d, nprobe,
                          int(metric == "l2"), _build.stream_ptr(dev))
    _build.check(rc, "ivf_filter")
    _build.LAUNCHES["ivf_filter"] += 1
    return scores, ids


#: device -> the top-nprobe kernel's row-tile counters (int32, all zero
#: between launches)
_COUNTERS: dict[torch.device, torch.Tensor] = {}


def _counters(dev: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed counters on ``dev``, grown (and zeroed) only
    when a launch needs more row tiles than any before."""
    have = _COUNTERS.get(dev)
    if have is None or have.numel() < n:
        have = torch.zeros(max(n, 128), dtype=torch.int32, device=dev)
        _COUNTERS[dev] = have
    return have


@functools.cache
def _launcher():
    fn = _build.library("ivf_filter").ivf_filter_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 4 + [ci] * 4 + [vp]
    fn.restype = ci
    return fn


@functools.cache
def _topk_launcher():
    fn = _build.library("ivf_filter").ivf_filter_topk_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 7 + [ci] * 5 + [vp]
    fn.restype = ci
    return fn
