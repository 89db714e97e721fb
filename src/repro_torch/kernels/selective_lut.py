"""Selective LUT construction: the CUDA kernel and its plain version.

Port of ``repro/kernels/selective_lut.py``. One pass over the codebook
produces, per (probed residual, subspace), the masked LUT row and the
int8 hit table (+1 inner sphere, 0 ring, -1 miss). The kernel
(``csrc/selective_lut.cu``) also does the ip row-min substitution that the
TPU kernel left to a post-pass, so both functions here return the final
masked LUT. Contract: ``repro/kernels/ref.py:selective_lut_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import selective_lut_ref


#: the plain PyTorch version, on any device: each product and sum is a
#: separate IEEE operation in the reference's order (``dot = q0*e0 + q1*e1``)
selective_lut_plain = selective_lut_ref


def selective_lut(q0: torch.Tensor, q1: torch.Tensor, e0: torch.Tensor,
                  e1: torch.Tensor, esq: torch.Tensor, tau: torch.Tensor, *,
                  metric: str = "l2") -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel (CUDA tensors only; same contract as
    :func:`selective_lut_plain`). Counts one launch in
    ``_build.LAUNCHES["selective_lut"]``."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    dev = q0.device
    if dev.type != "cuda":
        raise ValueError("selective_lut launches on CUDA tensors only")
    b, s = q0.shape
    e = e0.shape[1]
    if not 0 < e <= 1024 or b * s >= 2 ** 31:
        raise ValueError(f"unsupported shape B={b} S={s} E={e}")
    args = [_build.checked(n, t, torch.float32, shp, dev) for n, t, shp in (
        ("q0", q0, (b, s)), ("q1", q1, (b, s)), ("e0", e0, (s, e)),
        ("e1", e1, (s, e)), ("esq", esq, (s, e)), ("tau", tau, (b, s)))]
    lut = torch.empty((b, s, e), dtype=torch.float32, device=dev)
    hit = torch.empty((b, s, e), dtype=torch.int8, device=dev)
    rc = _launcher()(*[a.data_ptr() for a in args], lut.data_ptr(),
                     hit.data_ptr(), b, s, e, int(metric == "ip"),
                     _build.stream_ptr(dev))
    _build.check(rc, "selective_lut")
    _build.LAUNCHES["selective_lut"] += 1
    return lut, hit


@functools.cache
def _launcher():
    fn = _build.library("selective_lut").selective_lut_launch
    vp = ctypes.c_void_p
    fn.argtypes = [vp] * 8 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, vp]
    fn.restype = ctypes.c_int
    return fn
