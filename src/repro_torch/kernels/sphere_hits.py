"""RT sphere-intersection filter: the CUDA kernel's two entries and their
plain versions.

Port of ``repro/rt/intersect.py``: whether the query disc touches a cluster
disc in the ray plane. Two entries share one test (``csrc/sphere.cuh``):

* :func:`sphere_probe`, the rt search's probe mask
  (``core/juno.py:_rt_probe_mask``): the verdict of each probed cluster
  only, at its slot ``slot_of[cids]``, probe 0 forced True, with the query
  radius (``ref.rt_query_radius_ref``) computed in the same launch from the
  probe-0 row of τ. One launch from the search's tensors to ``probe_ok``,
  no host copy.
* :func:`sphere_hits`, the reference's dense contract
  (``repro/kernels/ref.py:rt_sphere_hits_ref``): every query against every
  grid slot, int8, cell-major (Q, n_cells·cap). No engine launches it.

The kernels and the plain versions round as that oracle does on the
reference's CPU backend, so they agree bit for bit, and the probe entry's
verdicts equal the dense table gathered at ``slot_of[cids]``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import rt_query_radius_ref, rt_sphere_hits_ref, sphere_test

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


def sphere_probe_plain(q0: torch.Tensor, q1: torch.Tensor, tau: torch.Tensor,
                       cids: torch.Tensor, slot_of: torch.Tensor,
                       c0: torch.Tensor, c1: torch.Tensor,
                       slot_reach: torch.Tensor, radius_scale: torch.Tensor,
                       radius_bias: torch.Tensor, scale: float = 1.0
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the probe entry, on any device.

    q0, q1 (Q,) f32 ray-plane queries; tau (Q, S) f32, the probe-0 row of
    the search's thresholds; cids (Q, np) int probed cluster ids; slot_of
    (C,) int32; c0, c1, slot_reach (n_cells, cap) f32 grid planes;
    radius_scale, radius_bias () f32; scale the rt knob. Returns
    ``(probe_ok (Q, np) bool with probe 0 True, radius (Q,) f32, slot
    (Q, np) int32 = slot_of[cids])``.
    """
    radius = rt_query_radius_ref(tau, scale, radius_scale, radius_bias)
    slot = slot_of.long()[cids.long()]
    probe_ok = sphere_test(q0[:, None], q1[:, None], radius[:, None],
                           c0.reshape(-1)[slot], c1.reshape(-1)[slot],
                           slot_reach.reshape(-1)[slot])
    probe_ok[:, 0] = True
    return probe_ok, radius, slot.to(torch.int32)


def sphere_probe(q0: torch.Tensor, q1: torch.Tensor, tau: torch.Tensor,
                 cids: torch.Tensor, slot_of: torch.Tensor, c0: torch.Tensor,
                 c1: torch.Tensor, slot_reach: torch.Tensor,
                 radius_scale: torch.Tensor, radius_bias: torch.Tensor,
                 scale: float = 1.0
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the probe entry (CUDA tensors only; the contract of
    :func:`sphere_probe_plain`).

    ``q0``, ``q1`` and ``tau`` may be strided views (the columns of the
    search's (Q, 2) projection, τ's probe-0 row): the kernel reads them in
    place. ``cids`` is int64 or int32 with unit column stride, every id in
    [0, C). One kernel a call; counts one launch in
    ``_build.LAUNCHES["sphere_probe"]``.
    """
    dev = q0.device
    if dev.type != "cuda":
        raise ValueError("sphere_probe launches on CUDA tensors only")
    q, n_probe = cids.shape
    s = tau.shape[-1]
    n_cells, cap = c0.shape
    if q * n_probe >= 2 ** 31:
        raise ValueError(f"unsupported shape Q={q} np={n_probe}")
    for name, t, shp in (("q0", q0, (q,)), ("q1", q1, (q,)),
                         ("tau", tau, (q, s))):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shp:
            raise ValueError(f"{name}: expected float32 {shp} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if cids.device != dev or cids.dtype not in (torch.int64, torch.int32) \
            or (n_probe > 1 and cids.stride(1) != 1):
        raise ValueError(f"cids: expected int64 or int32 ({q}, {n_probe}) "
                         f"with unit column stride on {dev}, got {cids.dtype} "
                         f"strides {cids.stride()} on {cids.device}")
    args = [_build.checked(n, t, dt, shp, dev) for n, t, dt, shp in (
        ("slot_of", slot_of, torch.int32, tuple(slot_of.shape[:1])),
        ("c0", c0, torch.float32, (n_cells, cap)),
        ("c1", c1, torch.float32, (n_cells, cap)),
        ("slot_reach", slot_reach, torch.float32, (n_cells, cap)),
        ("radius_scale", radius_scale, torch.float32, ()),
        ("radius_bias", radius_bias, torch.float32, ()))]
    slot_of, c0, c1, slot_reach, radius_scale, radius_bias = args
    probe_ok = torch.empty((q, n_probe), dtype=torch.bool, device=dev)
    radius = torch.empty((q,), dtype=torch.float32, device=dev)
    slot = torch.empty((q, n_probe), dtype=torch.int32, device=dev)
    rc = _probe_launcher()(
        q0.data_ptr(), q1.data_ptr(), q0.stride(0), q1.stride(0),
        tau.data_ptr(), tau.stride(0), tau.stride(1), scale,
        radius_scale.data_ptr(), radius_bias.data_ptr(), c0.data_ptr(),
        c1.data_ptr(), slot_reach.data_ptr(), slot_of.data_ptr(),
        cids.data_ptr(), cids.stride(0), int(cids.dtype == torch.int64),
        probe_ok.data_ptr(), radius.data_ptr(), slot.data_ptr(), q, n_probe, s,
        _build.stream_ptr(dev))
    _build.check(rc, "sphere_probe")
    _build.LAUNCHES["sphere_probe"] += 1
    return probe_ok, radius, slot


def sphere_floor(q: int, device) -> None:
    """Launch an empty kernel on the probe entry's grid for ``q`` queries:
    the launch floor that the entry's time is read against (not counted)."""
    _build.check(_floor_launcher()(q, _build.stream_ptr(device)),
                 "sphere_floor")


@functools.cache
def _launcher():
    fn = _build.library("sphere_hits").sphere_hits_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 7 + [ci] * 2 + [vp]
    fn.restype = ci
    return fn


@functools.cache
def _probe_launcher():
    fn = _build.library("sphere_hits").sphere_probe_launch
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp, vp, ll, ll, vp, ll, ll, ctypes.c_float] + [vp] * 7 + \
        [ll, ci] + [vp] * 3 + [ci] * 3 + [vp]
    fn.restype = ci
    return fn


@functools.cache
def _floor_launcher():
    fn = _build.library("sphere_hits").sphere_floor_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
