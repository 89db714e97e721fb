"""Hit-count scan: the CUDA kernel and its plain version.

Port of ``repro/kernels/hit_count.py``: per probed point, the int32 sum of
its int8 hit-table entries (tiers M and L, and stage 1 of the composed
two-stage search); invalid slots get -2^30. Contract:
``repro/kernels/ref.py:hit_count_ref``.

The kernel (``csrc/hit_count.cu``) takes the index's per-cluster codes and
the probed cluster ids and indexes them itself; the plain version takes
codes already gathered per probe, as the reference does.
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


def hit_count(table: torch.Tensor, cluster_codes: torch.Tensor,
              cluster_valid: torch.Tensor, cids: torch.Tensor, *,
              probe_ok: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only).

    table (Q, np, S, E) int8, cluster_codes (n_clusters, P, S) uint8,
    cluster_valid (n_clusters, P) bool, cids (Q, np) int64 probed cluster
    ids in [0, n_clusters), probe_ok (Q, np) bool or ``None`` (every probe
    kept). Returns what :func:`hit_count_plain` returns for
    ``codes = cluster_codes[cids]``,
    ``valid = cluster_valid[cids] & probe_ok[..., None]``. Counts one
    launch in ``_build.LAUNCHES["hit_count"]``.
    """
    dev = table.device
    if dev.type != "cuda":
        raise ValueError("hit_count launches on CUDA tensors only")
    q, n_probe, s, e = table.shape
    n_cl, p = cluster_valid.shape
    if q * n_probe >= 2 ** 31 or s * e > 227 * 1024:
        raise ValueError(f"unsupported shape Q={q} np={n_probe} S={s} E={e}")
    args = [_build.checked(n, t, dt, shp, dev) for n, t, dt, shp in (
        ("table", table, torch.int8, (q, n_probe, s, e)),
        ("cluster_codes", cluster_codes, torch.uint8, (n_cl, p, s)),
        ("cluster_valid", cluster_valid, torch.bool, (n_cl, p)),
        ("cids", cids, torch.int64, (q, n_probe)))]
    pok = _build.optional("probe_ok", probe_ok, torch.bool, (q, n_probe), dev)
    out = torch.empty((q, n_probe, p), dtype=torch.int32, device=dev)
    rc = _launcher()(*[a.data_ptr() for a in args], pok, out.data_ptr(), q,
                     n_probe, p, s, e, _build.stream_ptr(dev))
    _build.check(rc, "hit_count")
    _build.LAUNCHES["hit_count"] += 1
    return out


@functools.cache
def _launcher():
    fn = _build.library("hit_count").hit_count_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 6 + [ci] * 5 + [vp]
    fn.restype = ci
    return fn
