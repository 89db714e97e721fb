"""Masked ADC scan: the CUDA kernel and its plain version.

Port of ``repro/kernels/pq_scan.py``: per probed point, the f32 sum of its
masked-LUT entries (tier H); invalid slots get +inf (l2) or -inf (ip).
Contract: ``repro/kernels/ref.py:pq_scan_ref``.

The kernel (``csrc/pq_scan.cu``) takes the index's per-cluster codes and
the probed cluster ids and indexes them itself; the plain version takes
codes already gathered per probe, as the reference does. The two sum over
S in different orders, so they agree within ~S ulps of the sum of the
terms' magnitudes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import bad_score, pq_scan_ref

#: the plain PyTorch version, on any device: lut (Q, np, S, E) f32, codes
#: (Q, np, P, S) uint8, valid (Q, np, P) bool -> (Q, np, P) f32
pq_scan_plain = pq_scan_ref


def pq_scan(lut: torch.Tensor, cluster_codes: torch.Tensor,
            cluster_valid: torch.Tensor, cids: torch.Tensor, *,
            metric: str = "l2", probe_ok: torch.Tensor | None = None
            ) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only).

    lut (Q, np, S, E) f32, cluster_codes (n_clusters, P, S) uint8,
    cluster_valid (n_clusters, P) bool, cids (Q, np) int64 probed cluster
    ids in [0, n_clusters), probe_ok (Q, np) bool or ``None`` (every probe
    kept). Returns what :func:`pq_scan_plain` returns for
    ``codes = cluster_codes[cids]``,
    ``valid = cluster_valid[cids] & probe_ok[..., None]``. Counts one
    launch in ``_build.LAUNCHES["pq_scan"]``.
    """
    bad = bad_score(metric)
    dev = lut.device
    if dev.type != "cuda":
        raise ValueError("pq_scan launches on CUDA tensors only")
    q, n_probe, s, e = lut.shape
    n_cl, p = cluster_valid.shape
    if q * n_probe >= 2 ** 31 or 4 * s * e > 227 * 1024:
        raise ValueError(f"unsupported shape Q={q} np={n_probe} S={s} E={e}")
    args = [_build.checked(n, t, dt, shp, dev) for n, t, dt, shp in (
        ("lut", lut, torch.float32, (q, n_probe, s, e)),
        ("cluster_codes", cluster_codes, torch.uint8, (n_cl, p, s)),
        ("cluster_valid", cluster_valid, torch.bool, (n_cl, p)),
        ("cids", cids, torch.int64, (q, n_probe)))]
    pok = _build.optional("probe_ok", probe_ok, torch.bool, (q, n_probe), dev)
    out = torch.empty((q, n_probe, p), dtype=torch.float32, device=dev)
    rc = _launcher()(*[a.data_ptr() for a in args], pok, out.data_ptr(), q,
                     n_probe, p, s, e, bad, _build.stream_ptr(dev))
    _build.check(rc, "pq_scan")
    _build.LAUNCHES["pq_scan"] += 1
    return out


@functools.cache
def _launcher():
    fn = _build.library("pq_scan").pq_scan_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 6 + [ci] * 5 + [ctypes.c_float, vp]
    fn.restype = ci
    return fn
