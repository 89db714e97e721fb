"""Fused two-stage scan: the CUDA kernel and its plain version.

Port of ``repro/kernels/fused_two_stage.py``: int8 hit-count prefilter,
survivor threshold θ_q (the C-th largest count), the top-C candidates and
their masked-ADC distances in one call. The contract is the reference's
off-TPU serving path ``fused_two_stage_host`` (l.259-335):

* ``cand`` is the top-C-by-count SET in index-ascending order (the Pallas
  kernel's order is count desc, index asc);
* ``dist`` holds ADC totals only at ``cand`` and ``bad`` elsewhere;
* ``cap_c`` is clamped to ``max(1, min(cap_c, np·P))``.

The kernel (``csrc/fused_two_stage.cu``, its count and select kernels in
``csrc/two_stage.cuh``, one block per (query, probe) each) takes the
index's per-cluster codes and the probed cluster ids and indexes them
itself; the plain version takes codes already gathered per probe, as the
reference does. The kernel reads a hit-table entry by its sign, which is
the entry itself for the {-1, 0, +1} tables stage B writes.

The kernel takes the autotuner's result-invariant launch shape
(``kernels/autotune.py``): ``count_threads``, ``count_per_thread`` and
``select_threads``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import bad_score, hit_count_ref


def fused_two_stage_plain(lut: torch.Tensor, table: torch.Tensor,
                          codes: torch.Tensor, valid: torch.Tensor, *,
                          cap_c: int, metric: str = "l2"):
    """Plain PyTorch version, step for step the reference's host path.

    lut (Q, np, S, E) f32, table (Q, np, S, E) int8, codes (Q, np, P, S)
    uint8, valid (Q, np, P) bool -> (counts (Q, np, P) int32, dist
    (Q, np, P) f32, cand (Q, C) int32, cand_dist (Q, C) f32): a
    values-only sort gives θ_q, a cumsum ranks the θ-ties by index, and
    searchsorted over the take-cumsum compacts the C selected indices.
    """
    q, n_probe, p, s = codes.shape
    w = n_probe * p
    cap_c = max(1, min(cap_c, w))
    bad = bad_score(metric)
    dev = codes.device

    # stage 1: hit counts by direct gather
    counts = hit_count_ref(table, codes, valid)
    flat = counts.reshape(q, w)

    # survivor threshold: exact θ-selection
    srt = torch.sort(flat, dim=1).values
    theta = srt[:, w - cap_c]
    n_gt = w - torch.searchsorted(srt, theta[:, None].contiguous(), right=True)[:, 0]
    tie = flat == theta[:, None]
    tie_rank = torch.cumsum(tie.to(torch.int64), dim=1) - 1
    take = (flat > theta[:, None]) | (tie & (tie_rank < (cap_c - n_gt)[:, None]))

    # compaction: the C selected flat indices, index-ascending
    cum = torch.cumsum(take.to(torch.int64), dim=1)
    ranks = torch.arange(1, cap_c + 1, device=dev)
    cand = torch.searchsorted(cum, ranks.expand(q, -1).contiguous())

    # stage 2: masked-LUT ADC for the C survivors only
    cand_probe = cand // p
    cand_codes = torch.gather(codes.reshape(q, w, s), 1,
                              cand[..., None].expand(-1, -1, s)).long()
    e = lut.shape[-1]
    idx = (cand_probe[..., None] * (s * e)
           + torch.arange(s, device=dev) * e + cand_codes)       # (Q, C, S)
    vals = torch.gather(lut.reshape(q, -1), 1, idx.reshape(q, -1))
    vals = vals.reshape(q, cap_c, s)
    cand_valid = torch.gather(valid.reshape(q, w), 1, cand)
    cdist = torch.where(cand_valid, vals.sum(-1),
                        torch.tensor(bad, device=dev))
    dist = torch.full((q, w), bad, dtype=torch.float32, device=dev)
    dist.scatter_(1, cand, cdist)
    return counts, dist.reshape(q, n_probe, p), cand.to(torch.int32), cdist


def fused_two_stage(lut: torch.Tensor, table: torch.Tensor,
                    cluster_codes: torch.Tensor, cluster_valid: torch.Tensor,
                    cids: torch.Tensor, *, cap_c: int, metric: str = "l2",
                    probe_ok: torch.Tensor | None = None,
                    count_threads: int = 256, count_per_thread: int = 16,
                    select_threads: int = 256):
    """Launch the CUDA kernel (CUDA tensors only).

    lut (Q, np, S, E) f32, table (Q, np, S, E) int8 with entries in
    {-1, 0, +1}, cluster_codes (n_clusters, P, S) uint8, cluster_valid
    (n_clusters, P) bool, cids (Q, np) int64 probed cluster ids in
    [0, n_clusters), probe_ok (Q, np) bool or ``None`` (every probe kept).
    Returns what :func:`fused_two_stage_plain` returns for
    ``codes = cluster_codes[cids]``,
    ``valid = cluster_valid[cids] & probe_ok[..., None]``: ``counts`` and
    ``cand`` equal, ``cand_dist`` and ``dist`` summed in subspace order.
    The call is two kernels on the card (count, select) and nothing else:
    the histogram scratch the count kernel writes needs no zeroing.
    ``count_threads``/``count_per_thread``/``select_threads`` pick the
    launch shape from ``two_stage.cuh``'s lattice (``autotune``'s
    ``COUNT_SHAPES`` and ``SELECT_THREADS``); every shape gives the same
    bits, and one off the lattice raises without launching. Counts one
    launch in ``_build.LAUNCHES["fused_two_stage"]``.
    """
    bad = bad_score(metric)
    dev = lut.device
    if dev.type != "cuda":
        raise ValueError("fused_two_stage launches on CUDA tensors only")
    q, n_probe, s, e = lut.shape
    n_cl, p = cluster_valid.shape
    if q * n_probe >= 2 ** 31 or n_probe * p >= 2 ** 31:
        raise ValueError(f"unsupported shape Q={q} np={n_probe} P={p}")
    w = n_probe * p
    cap_c = max(1, min(cap_c, w))
    args = [_build.checked(n, t, dt, shp, dev) for n, t, dt, shp in (
        ("lut", lut, torch.float32, (q, n_probe, s, e)),
        ("table", table, torch.int8, (q, n_probe, s, e)),
        ("cluster_codes", cluster_codes, torch.uint8, (n_cl, p, s)),
        ("cluster_valid", cluster_valid, torch.bool, (n_cl, p)),
        ("cids", cids, torch.int64, (q, n_probe)))]
    pok = _build.optional("probe_ok", probe_ok, torch.bool, (q, n_probe), dev)
    counts = torch.empty((q, n_probe, p), dtype=torch.int32, device=dev)
    dist = torch.empty((q, n_probe, p), dtype=torch.float32, device=dev)
    cand = torch.empty((q, cap_c), dtype=torch.int32, device=dev)
    cand_dist = torch.empty((q, cap_c), dtype=torch.float32, device=dev)
    hist = torch.empty((q, n_probe, 2 * s + 2), dtype=torch.int32, device=dev)
    rc = _launcher()(*[a.data_ptr() for a in args], pok, counts.data_ptr(),
                     dist.data_ptr(), cand.data_ptr(), cand_dist.data_ptr(),
                     hist.data_ptr(), q, n_probe, p, s, e, cap_c, bad,
                     count_threads, count_per_thread, select_threads,
                     _build.stream_ptr(dev))
    _build.check(rc, "fused_two_stage")
    _build.LAUNCHES["fused_two_stage"] += 1
    return counts, dist, cand, cand_dist


@functools.cache
def _launcher():
    fn = _build.library("fused_two_stage").fused_two_stage_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 11 + [ci] * 6 + [ctypes.c_float] + [ci] * 3 + [vp]
    fn.restype = ci
    return fn
