"""Masked ADC scan: the CUDA kernels and their plain versions, with a
top-k epilogue.

Port of ``repro/kernels/pq_scan.py``: per probed point, the f32 sum of its
masked-LUT entries (tier H); invalid slots get +inf (l2) or -inf (ip).
Contract: ``repro/kernels/ref.py:pq_scan_ref``. The top-k form also takes
the ``probe_base`` add and the ``lax.top_k`` that the reference runs over
those sums (``repro/core/juno.py`` l.296-299 and l.354): the k best of
each query over the flat np·P axis, l2 distance ascending or ip similarity
descending, equal scores by position ascending.

The kernels (``csrc/pq_scan.cu``) take the index's per-cluster codes and
the probed cluster ids and index them themselves; the plain versions take
codes already gathered per probe, as the reference does. The two sum over
S in different orders, so they agree within ~S ulps of the sum of the
terms' magnitudes. Both entries run one scan body, so the top-k route's
values and positions are bit-equal to a stable sort of the scores-only
kernel's output plus ``probe_base``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import bad_score, pq_scan_ref

#: the most results the top-k kernels take (``kKMax`` in ``csrc/pq_scan.cu``)
K_MAX = 1024
#: the most slots a cluster may have for the top-k kernels (8192 points: 16
#: registers a thread of 512)
P_MAX = 8192
#: the most static shared memory the scan kernels take beside the LUT
#: (``kTopkStaticSmem`` in ``csrc/pq_scan.cu``, which asserts it), and
#: the most shared memory a block may have on Hopper
TOPK_STATIC_SMEM = 3072
SMEM_MAX = 227 * 1024

#: the plain PyTorch version, on any device: lut (Q, np, S, E) f32, codes
#: (Q, np, P, S) uint8, valid (Q, np, P) bool -> (Q, np, P) f32
pq_scan_plain = pq_scan_ref


def _sorted_top(scores: torch.Tensor, k: int, metric: str
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The first k of each row of (Q, W) ``scores`` in ``lax.top_k``'s
    order (``core/juno.py:_top_k``): a stable descending sort of the
    scores (ip) or of their negation (l2)."""
    key = scores if metric == "ip" else -scores
    vals, order = torch.sort(key, dim=1, descending=True, stable=True)
    vals = vals[:, :k]
    return (vals if metric == "ip" else -vals), order[:, :k]


def pq_scan_topk_plain(lut: torch.Tensor, codes: torch.Tensor,
                       valid: torch.Tensor, k: int, *, metric: str = "l2",
                       probe_base: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain top-k form: :func:`pq_scan_plain`, plus ``probe_base``
    (Q, np) f32 when given, then a stable sort of each query's np·P scores
    and the first k.

    Returns (values (Q, k) f32, positions (Q, k) int64); a position is
    ``probe * P + p``.
    """
    scores = pq_scan_plain(lut, codes, valid, metric=metric)
    if probe_base is not None:
        scores = scores + probe_base[..., None]
    return _sorted_top(scores.reshape(codes.shape[0], -1), k, metric)


def _check_args(lut, cluster_codes, cluster_valid, cids, probe_ok):
    dev = lut.device
    if dev.type != "cuda":
        raise ValueError("pq_scan launches on CUDA tensors only")
    q, n_probe, s, e = lut.shape
    n_cl, p = cluster_valid.shape
    if q * n_probe >= 2 ** 31 or n_probe * p >= 2 ** 31 \
            or 4 * s * e + TOPK_STATIC_SMEM > SMEM_MAX:
        raise ValueError(f"unsupported shape Q={q} np={n_probe} P={p} S={s} "
                         f"E={e}")
    args = [_build.checked(n, t, dt, shp, dev) for n, t, dt, shp in (
        ("lut", lut, torch.float32, (q, n_probe, s, e)),
        ("cluster_codes", cluster_codes, torch.uint8, (n_cl, p, s)),
        ("cluster_valid", cluster_valid, torch.bool, (n_cl, p)),
        ("cids", cids, torch.int64, (q, n_probe)))]
    pok = _build.optional("probe_ok", probe_ok, torch.bool, (q, n_probe), dev)
    return [a.data_ptr() for a in args] + [pok], (q, n_probe, p, s, e), dev


def _scores(ptrs, shape, dev, metric: str) -> torch.Tensor:
    """Launch the scores-only kernel; returns (Q, np, P) f32."""
    q, n_probe, p, s, e = shape
    out = torch.empty((q, n_probe, p), dtype=torch.float32, device=dev)
    rc = _launcher()(*ptrs, out.data_ptr(), q, n_probe, p, s, e,
                     bad_score(metric), _build.stream_ptr(dev))
    _build.check(rc, "pq_scan")
    return out


def pq_scan(lut: torch.Tensor, cluster_codes: torch.Tensor,
            cluster_valid: torch.Tensor, cids: torch.Tensor, *,
            metric: str = "l2", probe_ok: torch.Tensor | None = None
            ) -> torch.Tensor:
    """Launch the scores-only kernel (CUDA tensors only).

    lut (Q, np, S, E) f32, cluster_codes (n_clusters, P, S) uint8,
    cluster_valid (n_clusters, P) bool, cids (Q, np) int64 probed cluster
    ids in [0, n_clusters), probe_ok (Q, np) bool or ``None`` (every probe
    kept). Returns what :func:`pq_scan_plain` returns for
    ``codes = cluster_codes[cids]``,
    ``valid = cluster_valid[cids] & probe_ok[..., None]``. One kernel a
    call, on the top-k route's scan body; counts one launch in
    ``_build.LAUNCHES["pq_scan"]``.
    """
    bad_score(metric)
    ptrs, shape, dev = _check_args(lut, cluster_codes, cluster_valid, cids,
                                   probe_ok)
    out = _scores(ptrs, shape, dev, metric)
    _build.LAUNCHES["pq_scan"] += 1
    return out


def _topk_args(lut, cluster_codes, cluster_valid, cids, k, probe_ok,
               probe_base):
    ptrs, shape, dev = _check_args(lut, cluster_codes, cluster_valid, cids,
                                   probe_ok)
    q, n_probe, p = shape[:3]
    if not 1 <= k <= n_probe * p:
        raise ValueError(f"k={k} outside [1, np*P={n_probe * p}]")
    if probe_base is not None:
        probe_base = _build.checked("probe_base", probe_base, torch.float32,
                                    (q, n_probe), dev)
    return ptrs, shape, dev, probe_base


def pq_scan_topk(lut: torch.Tensor, cluster_codes: torch.Tensor,
                 cluster_valid: torch.Tensor, cids: torch.Tensor, k: int, *,
                 metric: str = "l2", probe_ok: torch.Tensor | None = None,
                 probe_base: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the top-k kernels (CUDA tensors only).

    Inputs as for :func:`pq_scan`, ``probe_base`` (Q, np) f32 or ``None``,
    and 1 <= k <= np·P. Returns what :func:`pq_scan_topk_plain` returns for
    the same gathered inputs: (values (Q, k) f32, positions (Q, k) int64).

    For k <= :data:`K_MAX` and P <= :data:`P_MAX` (every call the engines
    make): two kernels a call (the per-probe select, the per-query merge)
    and nothing else on the stream; counts one launch in
    ``_build.LAUNCHES["pq_scan"]``, so that count is of calls, two kernels
    each. Above either limit, chosen by shape alone:
    :func:`pq_scan_sort_topk`.
    """
    bad = bad_score(metric)
    if k > K_MAX or cluster_valid.shape[-1] > P_MAX:
        return pq_scan_sort_topk(lut, cluster_codes, cluster_valid, cids, k,
                                 metric=metric, probe_ok=probe_ok,
                                 probe_base=probe_base)
    ptrs, shape, dev, probe_base = _topk_args(
        lut, cluster_codes, cluster_valid, cids, k, probe_ok, probe_base)
    q, n_probe, p, s, e = shape
    kk = min(k, p)
    cand_val = torch.empty((q, n_probe, kk), dtype=torch.float32, device=dev)
    cand_pos = torch.empty((q, n_probe, kk), dtype=torch.int32, device=dev)
    vals = torch.empty((q, k), dtype=torch.float32, device=dev)
    pos = torch.empty((q, k), dtype=torch.int64, device=dev)
    rc = _topk_launcher()(
        *ptrs, None if probe_base is None else probe_base.data_ptr(),
        cand_val.data_ptr(), cand_pos.data_ptr(), vals.data_ptr(),
        pos.data_ptr(), q, n_probe, p, s, e, k, bad, int(metric == "l2"),
        _build.stream_ptr(dev))
    _build.check(rc, "pq_scan")
    _build.LAUNCHES["pq_scan"] += 1
    return vals, pos


def pq_scan_sort_topk(lut: torch.Tensor, cluster_codes: torch.Tensor,
                      cluster_valid: torch.Tensor, cids: torch.Tensor,
                      k: int, *, metric: str = "l2",
                      probe_ok: torch.Tensor | None = None,
                      probe_base: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The top-k by a sort (CUDA tensors only): the scores-only kernel,
    the ``probe_base`` add and a stable sort with a slice, at any k and P.
    :func:`pq_scan_topk` takes it past :data:`K_MAX` or :data:`P_MAX`; it
    is also the route tier H took before the top-k kernels. Arguments and
    result as for :func:`pq_scan_topk`, whose values and positions it
    equals bit for bit; counts one launch in
    ``_build.LAUNCHES["pq_scan_sort"]``.
    """
    bad_score(metric)
    ptrs, shape, dev, probe_base = _topk_args(
        lut, cluster_codes, cluster_valid, cids, k, probe_ok, probe_base)
    scores = _scores(ptrs, shape, dev, metric)
    if probe_base is not None:
        scores = scores + probe_base[..., None]
    _build.LAUNCHES["pq_scan_sort"] += 1
    return _sorted_top(scores.reshape(shape[0], -1), k, metric)


@functools.cache
def _launcher():
    fn = _build.library("pq_scan").pq_scan_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 6 + [ci] * 5 + [ctypes.c_float, vp]
    fn.restype = ci
    return fn


@functools.cache
def _topk_launcher():
    fn = _build.library("pq_scan").pq_scan_topk_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 10 + [ci] * 6 + [ctypes.c_float, ci, vp]
    fn.restype = ci
    return fn
