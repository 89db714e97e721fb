"""IVF filter (stage A's score matrix): the CUDA kernel and its plain version.

Port of ``repro/kernels/ivf_filter.py``: every query against every
centroid, ``csq − 2·q·cᵀ`` for l2 (lower is better; ‖q‖² left out, it
does not change a row's order) or ``q·cᵀ`` for ip (higher is better).
Contract: ``repro/kernels/ref.py:ivf_filter_ref``. The kernel
(``csrc/ivf_filter.cu``) sums over D in full f32 in another order than the
plain version's matrix product, so the two agree within ~D ulps of
``Σ_d |q_d c_d|`` (twice that for l2).
"""
from __future__ import annotations

import ctypes
import functools

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


def ivf_filter(queries: torch.Tensor, centroids: torch.Tensor,
               centroid_sq: torch.Tensor, *, metric: str = "l2"
               ) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only; same contract as
    :func:`ivf_filter_plain`). Counts one launch in
    ``_build.LAUNCHES["ivf_filter"]``."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError("ivf_filter launches on CUDA tensors only")
    q, d = queries.shape
    c = centroids.shape[0]
    if q * c >= 2 ** 31 or q >= 65535 * 32:
        raise ValueError(f"unsupported shape Q={q} C={c}")
    args = [_build.checked(n, t, torch.float32, shp, dev) for n, t, shp in (
        ("queries", queries, (q, d)), ("centroids", centroids, (c, d)),
        ("centroid_sq", centroid_sq, (c,)))]
    out = torch.empty((q, c), dtype=torch.float32, device=dev)
    rc = _launcher()(*[a.data_ptr() for a in args], out.data_ptr(), q, c, d,
                     int(metric == "l2"), _build.stream_ptr(dev))
    _build.check(rc, "ivf_filter")
    _build.LAUNCHES["ivf_filter"] += 1
    return out


@functools.cache
def _launcher():
    fn = _build.library("ivf_filter").ivf_filter_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 4 + [ci] * 4 + [vp]
    fn.restype = ci
    return fn
