"""RT sphere-intersection filter: the CUDA kernel and its plain version.

Port of ``repro/rt/intersect.py``: for every query and every slot of the
centroid grid, whether the query disc touches the cluster disc in the
ray plane (int8, cell-major (Q, n_cells·cap)). Contract:
``repro/kernels/ref.py:rt_sphere_hits_ref``; the kernel
(``csrc/sphere_hits.cu``) and the plain version both round as that oracle
does on the reference's CPU backend, so they agree bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import rt_sphere_hits_ref

#: the plain PyTorch version, on any device: q0, q1, radius (Q,) f32, c0,
#: c1, slot_reach (n_cells, cap) f32 -> (Q, n_cells·cap) int8 (the body of
#: the reference's host path ``sphere_hits_host``, the dense oracle)
sphere_hits_plain = rt_sphere_hits_ref


def sphere_hits(q0: torch.Tensor, q1: torch.Tensor, radius: torch.Tensor,
                c0: torch.Tensor, c1: torch.Tensor, slot_reach: torch.Tensor
                ) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only; same contract as
    :func:`sphere_hits_plain`). Counts one launch in
    ``_build.LAUNCHES["sphere_hits"]``."""
    dev = q0.device
    if dev.type != "cuda":
        raise ValueError("sphere_hits launches on CUDA tensors only")
    (q,) = q0.shape
    n_cells, cap = c0.shape
    n_slots = n_cells * cap
    if q * n_slots >= 2 ** 31:
        raise ValueError(f"unsupported shape Q={q} slots={n_slots}")
    args = [_build.checked(n, t, torch.float32, shp, dev) for n, t, shp in (
        ("q0", q0, (q,)), ("q1", q1, (q,)), ("radius", radius, (q,)),
        ("c0", c0, (n_cells, cap)), ("c1", c1, (n_cells, cap)),
        ("slot_reach", slot_reach, (n_cells, cap)))]
    out = torch.empty((q, n_slots), dtype=torch.int8, device=dev)
    rc = _launcher()(*[a.data_ptr() for a in args], out.data_ptr(), q,
                     n_slots, _build.stream_ptr(dev))
    _build.check(rc, "sphere_hits")
    _build.LAUNCHES["sphere_hits"] += 1
    return out


@functools.cache
def _launcher():
    fn = _build.library("sphere_hits").sphere_hits_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 7 + [ci] * 2 + [vp]
    fn.restype = ci
    return fn
