"""Three-stage scan: the CUDA kernel and its plain version.

Port of ``repro/kernels/fused_three_stage.py``: the RT sphere test, the
int8 hit-count prefilter and the masked ADC of the top-C survivors in one
call. The contract is the reference's off-TPU path
``fused_three_stage_host`` (l.308): the dense sphere test gathered at each
probed cluster's grid slot gives ``probe_ok``, probe 0 is forced True, and
the fused two-stage scan runs over ``valid & probe_ok``. Outputs are the
two-stage scan's four (``fused_two_stage.py``'s contract) plus
``probe_ok`` (Q, np) bool.

The kernel (``csrc/fused_three_stage.cu``) runs the sphere test once per
(query, probe) at the top of the two-stage count kernel, so neither the
hit table nor the probe mask passes through the host; it reads codes
through the probed cluster ids. The plain version takes codes already
gathered per probe, as the reference does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .fused_two_stage import fused_two_stage_plain
from .ref import bad_score, probe_verdicts, rt_sphere_hits_ref


def fused_three_stage_plain(lut: torch.Tensor, table: torch.Tensor,
                            codes: torch.Tensor, valid: torch.Tensor,
                            q0: torch.Tensor, q1: torch.Tensor,
                            radius: torch.Tensor, cell_c0: torch.Tensor,
                            cell_c1: torch.Tensor, slot_reach: torch.Tensor,
                            slot_idx: torch.Tensor, *, cap_c: int,
                            metric: str = "l2"):
    """Plain PyTorch version, step for step the reference's host path.

    lut (Q, np, S, E) f32, table (Q, np, S, E) int8, codes (Q, np, P, S)
    uint8, valid (Q, np, P) bool; q0, q1, radius (Q,) f32 ray-plane
    queries; cell_c0, cell_c1, slot_reach (n_cells, cap) f32 grid planes;
    slot_idx (Q, np) int grid slot of each probed cluster -> ``(counts,
    dist, cand, cand_dist, probe_ok)``.
    """
    probe_ok = probe_verdicts(rt_sphere_hits_ref(q0, q1, radius, cell_c0,
                                                 cell_c1, slot_reach), slot_idx)
    out = fused_two_stage_plain(lut, table, codes, valid & probe_ok[:, :, None],
                                cap_c=cap_c, metric=metric)
    return (*out, probe_ok)


def fused_three_stage(lut: torch.Tensor, table: torch.Tensor,
                      cluster_codes: torch.Tensor, cluster_valid: torch.Tensor,
                      cids: torch.Tensor, q0: torch.Tensor, q1: torch.Tensor,
                      radius: torch.Tensor, cell_c0: torch.Tensor,
                      cell_c1: torch.Tensor, slot_reach: torch.Tensor,
                      slot_idx: torch.Tensor, *, cap_c: int,
                      metric: str = "l2", count_threads: int = 256,
                      count_per_thread: int = 16, select_threads: int = 256):
    """Launch the CUDA kernel (CUDA tensors only).

    lut, table, cluster_codes, cluster_valid and cids as for
    ``fused_two_stage.fused_two_stage``; q0, q1, radius, the grid planes
    and slot_idx (Q, np) int32 as for :func:`fused_three_stage_plain`; q0
    and q1 may be strided views (the columns of a (Q, 2) projection): the
    kernel reads them in place. Returns what
    :func:`fused_three_stage_plain` returns for
    ``codes = cluster_codes[cids]``, ``valid = cluster_valid[cids]``. The
    call is two kernels on the card (count with the sphere test, select),
    at the launch shape given as for ``fused_two_stage.fused_two_stage``.
    Counts one launch in ``_build.LAUNCHES["fused_three_stage"]``.
    """
    bad = bad_score(metric)
    dev = lut.device
    if dev.type != "cuda":
        raise ValueError("fused_three_stage launches on CUDA tensors only")
    q, n_probe, s, e = lut.shape
    n_cl, p = cluster_valid.shape
    n_cells, cap = cell_c0.shape
    if q * n_probe >= 2 ** 31 or n_probe * p >= 2 ** 31:
        raise ValueError(f"unsupported shape Q={q} np={n_probe} P={p}")
    cap_c = max(1, min(cap_c, n_probe * p))
    args = [_build.checked(n, t, dt, shp, dev) for n, t, dt, shp in (
        ("lut", lut, torch.float32, (q, n_probe, s, e)),
        ("table", table, torch.int8, (q, n_probe, s, e)),
        ("cluster_codes", cluster_codes, torch.uint8, (n_cl, p, s)),
        ("cluster_valid", cluster_valid, torch.bool, (n_cl, p)),
        ("cids", cids, torch.int64, (q, n_probe)),
        ("radius", radius, torch.float32, (q,)),
        ("cell_c0", cell_c0, torch.float32, (n_cells, cap)),
        ("cell_c1", cell_c1, torch.float32, (n_cells, cap)),
        ("slot_reach", slot_reach, torch.float32, (n_cells, cap)),
        ("slot_idx", slot_idx, torch.int32, (q, n_probe)))]
    for name, t in (("q0", q0), ("q1", q1)):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != (q,):
            raise ValueError(f"{name}: expected float32 ({q},) on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    probe_ok = torch.empty((q, n_probe), dtype=torch.bool, device=dev)
    counts = torch.empty((q, n_probe, p), dtype=torch.int32, device=dev)
    dist = torch.empty((q, n_probe, p), dtype=torch.float32, device=dev)
    cand = torch.empty((q, cap_c), dtype=torch.int32, device=dev)
    cand_dist = torch.empty((q, cap_c), dtype=torch.float32, device=dev)
    hist = torch.empty((q, n_probe, 2 * s + 2), dtype=torch.int32, device=dev)
    ptrs = [a.data_ptr() for a in args]
    rc = _launcher()(*ptrs[:5], q0.data_ptr(), q1.data_ptr(), *ptrs[5:],
                     probe_ok.data_ptr(), counts.data_ptr(), dist.data_ptr(),
                     cand.data_ptr(), cand_dist.data_ptr(), hist.data_ptr(),
                     q0.stride(0), q1.stride(0), q, n_probe, p, s, e, cap_c,
                     bad, count_threads, count_per_thread, select_threads,
                     _build.stream_ptr(dev))
    _build.check(rc, "fused_three_stage")
    _build.LAUNCHES["fused_three_stage"] += 1
    return counts, dist, cand, cand_dist, probe_ok


@functools.cache
def _launcher():
    fn = _build.library("fused_three_stage").fused_three_stage_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 18 + [ctypes.c_longlong] * 2 + [ci] * 6 + \
        [ctypes.c_float] + [ci] * 3 + [vp]
    fn.restype = ci
    return fn
