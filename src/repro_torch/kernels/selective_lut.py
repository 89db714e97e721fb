"""Selective LUT construction: the CUDA kernel and its plain version.

Port of ``repro/kernels/selective_lut.py``. One pass over the codebook
produces, per (probed residual, subspace), the masked LUT row and the
int8 hit table (+1 inner sphere, 0 ring, -1 miss). The kernel
(``csrc/selective_lut.cu``) also does the ip row-min substitution that the
TPU kernel left to a post-pass, so both functions here return the final
masked LUT. Contract: ``repro/kernels/ref.py:selective_lut_ref``.

The kernel reads every input through its strides: ``q0``, ``q1`` and
``tau`` may be (B, S) planes or (Q, NP, S) views (a stride of 0 over NP
reads an expanded view in place, as stage B's ip ``qsub`` is), and the
codebook planes views of ``entries (S, E, 2)``. So a stage B is one launch
and no copy.
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
    """Launch the CUDA kernel (CUDA tensors only; the contract of
    :func:`selective_lut_plain`).

    q0, q1, tau (B, S) or (Q, NP, S) f32 with any strides (B = Q·NP, rows
    in (Q, NP) order); e0, e1, esq (S, E) f32 with any strides -> lut
    (B, S, E) f32 and hit (B, S, E) int8, contiguous. Counts one launch in
    ``_build.LAUNCHES["selective_lut"]``.
    """
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    dev = q0.device
    if dev.type != "cuda":
        raise ValueError("selective_lut launches on CUDA tensors only")
    rows = [t if t.dim() == 3 else t[:, None] for t in (q0, q1, tau)]
    q, n_probe, s = rows[0].shape
    e = e0.shape[-1]
    if not 0 < e <= 1024 or q * n_probe * s >= 2 ** 31:
        raise ValueError(f"unsupported shape B={q * n_probe} S={s} E={e}")
    for name, t, shp in (("q0", rows[0], (q, n_probe, s)),
                         ("q1", rows[1], (q, n_probe, s)),
                         ("e0", e0, (s, e)), ("e1", e1, (s, e)),
                         ("esq", esq, (s, e)), ("tau", rows[2], (q, n_probe, s))):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shp:
            raise ValueError(f"{name}: expected float32 {shp} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    lut = torch.empty((q * n_probe, s, e), dtype=torch.float32, device=dev)
    hit = torch.empty((q * n_probe, s, e), dtype=torch.int8, device=dev)
    if lut.numel() == 0:
        return lut, hit
    strides = (ctypes.c_longlong * 15)(*[
        st for t in (rows[0], rows[1], rows[2], e0, e1, esq)
        for st in t.stride()])
    rc = _launcher()(rows[0].data_ptr(), rows[1].data_ptr(), e0.data_ptr(),
                     e1.data_ptr(), esq.data_ptr(), rows[2].data_ptr(),
                     lut.data_ptr(), hit.data_ptr(), strides, q, n_probe, s,
                     e, int(metric == "ip"), _build.stream_ptr(dev))
    _build.check(rc, "selective_lut")
    _build.LAUNCHES["selective_lut"] += 1
    return lut, hit


@functools.cache
def _launcher():
    fn = _build.library("selective_lut").selective_lut_launch
    vp = ctypes.c_void_p
    fn.argtypes = [vp] * 8 + [ctypes.POINTER(ctypes.c_longlong)] + \
        [ctypes.c_int] * 5 + [vp]
    fn.restype = ctypes.c_int
    return fn
