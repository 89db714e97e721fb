"""Hit-count scan: the CUDA kernel and its plain version, with a top-k
epilogue.

Port of ``repro/kernels/hit_count.py``: per probed point, the int32 sum of
its int8 hit-table entries (tiers M and L, and stage 1 of the composed
two-stage search); invalid slots get -2^30. Contract:
``repro/kernels/ref.py:hit_count_ref``. The top-k form also takes the
``lax.top_k`` that the reference runs over those counts
(``repro/core/juno.py`` l.354 and l.508): the k largest counts of each
query over the flat np·P axis, in (count desc, index asc) order.

The kernels (``csrc/hit_count.cu``, on the count kernel of
``csrc/two_stage.cuh``) take the index's per-cluster codes and the probed
cluster ids and index them themselves; the plain versions take codes
already gathered per probe, as the reference does. The kernels read a
table entry by its sign: the table must hold {-1, 0, +1} (tier M's, as
stage B writes it) or {0, 1} (tier L's clip), narrower than the
reference's any-int8 contract.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import hit_count_ref

#: the plain PyTorch version, on any device: table (Q, np, S, E) int8,
#: codes (Q, np, P, S) uint8, valid (Q, np, P) bool -> (Q, np, P) int32
hit_count_plain = hit_count_ref


def hit_count_topk_plain(table: torch.Tensor, codes: torch.Tensor,
                         valid: torch.Tensor, k: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain top-k form: :func:`hit_count_plain`, a stable descending
    sort of each query's np·P counts, then the first k.

    Returns (values (Q, k) f32, positions (Q, k) int64); a position is
    ``probe * P + p``.
    """
    counts = hit_count_plain(table, codes, valid).reshape(codes.shape[0], -1)
    vals, order = torch.sort(counts, dim=1, descending=True, stable=True)
    return vals[:, :k].float(), order[:, :k]


def _check_args(table, cluster_codes, cluster_valid, cids, probe_ok):
    dev = table.device
    if dev.type != "cuda":
        raise ValueError("hit_count launches on CUDA tensors only")
    q, n_probe, s, e = table.shape
    n_cl, p = cluster_valid.shape
    if q * n_probe >= 2 ** 31 or n_probe * p >= 2 ** 31 \
            or s * 64 + (2 * s + 2) * 4 > 227 * 1024:
        raise ValueError(f"unsupported shape Q={q} np={n_probe} P={p} S={s}")
    args = [_build.checked(n, t, dt, shp, dev) for n, t, dt, shp in (
        ("table", table, torch.int8, (q, n_probe, s, e)),
        ("cluster_codes", cluster_codes, torch.uint8, (n_cl, p, s)),
        ("cluster_valid", cluster_valid, torch.bool, (n_cl, p)),
        ("cids", cids, torch.int64, (q, n_probe)))]
    pok = _build.optional("probe_ok", probe_ok, torch.bool, (q, n_probe), dev)
    return [a.data_ptr() for a in args] + [pok], (q, n_probe, p, s, e), dev


def hit_count(table: torch.Tensor, cluster_codes: torch.Tensor,
              cluster_valid: torch.Tensor, cids: torch.Tensor, *,
              probe_ok: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the counts-only kernel (CUDA tensors only).

    table (Q, np, S, E) int8 with entries in {-1, 0, +1} or {0, 1},
    cluster_codes (n_clusters, P, S) uint8, cluster_valid (n_clusters, P)
    bool, cids (Q, np) int64 probed cluster ids in [0, n_clusters),
    probe_ok (Q, np) bool or ``None`` (every probe kept). Returns what
    :func:`hit_count_plain` returns for ``codes = cluster_codes[cids]``,
    ``valid = cluster_valid[cids] & probe_ok[..., None]``. One kernel a
    call, the top-k route's count kernel (its histograms go to a scratch
    buffer); counts one launch in ``_build.LAUNCHES["hit_count"]``.
    """
    ptrs, (q, n_probe, p, s, e), dev = _check_args(
        table, cluster_codes, cluster_valid, cids, probe_ok)
    out = torch.empty((q, n_probe, p), dtype=torch.int32, device=dev)
    hist = torch.empty((q, n_probe, 2 * s + 2), dtype=torch.int32, device=dev)
    rc = _launcher()(*ptrs, out.data_ptr(), hist.data_ptr(), q, n_probe, p,
                     s, e, _build.stream_ptr(dev))
    _build.check(rc, "hit_count")
    _build.LAUNCHES["hit_count"] += 1
    return out


def hit_count_topk(table: torch.Tensor, cluster_codes: torch.Tensor,
                   cluster_valid: torch.Tensor, cids: torch.Tensor, k: int, *,
                   probe_ok: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the count and top-k kernels (CUDA tensors only).

    Inputs as for :func:`hit_count`, and 1 <= k <= np·P. Returns what
    :func:`hit_count_topk_plain` returns for the same gathered inputs:
    (values (Q, k) f32, positions (Q, k) int64) in (count desc, position
    asc) order. Two kernels a call and nothing else on the stream (the
    counts and histograms are scratch that the count kernel writes whole);
    counts one launch in ``_build.LAUNCHES["hit_count"]``, so that count is
    of calls: two kernels each.
    """
    ptrs, (q, n_probe, p, s, e), dev = _check_args(
        table, cluster_codes, cluster_valid, cids, probe_ok)
    if not 1 <= k <= n_probe * p:
        raise ValueError(f"k={k} outside [1, np*P={n_probe * p}]")
    counts = torch.empty((q, n_probe, p), dtype=torch.int32, device=dev)
    hist = torch.empty((q, n_probe, 2 * s + 2), dtype=torch.int32, device=dev)
    vals = torch.empty((q, k), dtype=torch.float32, device=dev)
    pos = torch.empty((q, k), dtype=torch.int64, device=dev)
    rc = _topk_launcher()(*ptrs, counts.data_ptr(), hist.data_ptr(),
                          vals.data_ptr(), pos.data_ptr(), q, n_probe, p, s,
                          e, k, _build.stream_ptr(dev))
    _build.check(rc, "hit_count")
    _build.LAUNCHES["hit_count"] += 1
    return vals, pos


@functools.cache
def _launcher():
    fn = _build.library("hit_count").hit_count_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 7 + [ci] * 5 + [vp]
    fn.restype = ci
    return fn


@functools.cache
def _topk_launcher():
    fn = _build.library("hit_count").hit_count_topk_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 9 + [ci] * 6 + [vp]
    fn.restype = ci
    return fn
