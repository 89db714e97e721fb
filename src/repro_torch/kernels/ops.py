"""Public wrappers over the ported kernels.

Port of ``repro/kernels/ops.py:build_selective_lut`` (l.79),
``masked_adc_scan`` (l.121), ``hit_count_scan`` (l.135),
``fused_two_stage_scan`` (l.147), ``fused_three_stage_scan`` (l.183),
``rt_sphere_hits`` (l.225) and ``filter_scores`` (l.263), with
``filter_topk`` (stage A of ``repro/core/ivf.py:filter_clusters``),
``rt_probe_mask`` (the radius, sphere test and gathers of
``repro/core/juno.py:_rt_probe_mask``),
``masked_adc_topk_scan`` (tier H's ``probe_base`` add and top-k,
``repro/core/juno.py`` l.296-299 and l.354) and ``hit_count_topk_scan``
(the hit counts' top-k of ``repro/core/juno.py`` l.354 and l.508). Dispatch
follows the tensors' device: a CPU tensor goes to the kernel's plain
PyTorch version; a CUDA tensor goes to the hand-written CUDA kernel, or
the call raises. There is no fallback from a kernel to its plain
version.

The scans take the whole index (``codes (n_clusters, P, S)``,
``valid (n_clusters, P)``) and the probed cluster ids ``cids (Q, np)``
int64: the kernels read the probed rows through ``cids`` and never
materialise the gathered copy the reference scans; the plain versions
scan ``codes[cids]``. The three single-pass scans take an optional
``probe_ok (Q, np)`` bool, the RT prefilter's verdict: a pruned probe's
points score as invalid slots, as the reference's
``valid & probe_ok[..., None]`` makes them.
"""
from __future__ import annotations

import contextlib
import sys

import torch

from . import autotune
from .fused_three_stage import fused_three_stage, fused_three_stage_plain
from .fused_two_stage import fused_two_stage, fused_two_stage_plain
from .hit_count import (hit_count, hit_count_plain, hit_count_topk,
                        hit_count_topk_plain)
from .ivf_filter import (ivf_filter, ivf_filter_plain, ivf_filter_topk,
                         ivf_filter_topk_plain)
from .pq_scan import pq_scan, pq_scan_plain, pq_scan_topk, pq_scan_topk_plain
from .selective_lut import selective_lut, selective_lut_plain
from .sphere_hits import (sphere_hits, sphere_hits_plain, sphere_probe,
                          sphere_probe_plain)


def _on_cuda(*tensors: torch.Tensor | None) -> bool:
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _probed_valid(valid: torch.Tensor, cids: torch.Tensor,
                  probe_ok: torch.Tensor | None) -> torch.Tensor:
    """``valid[cids]``, masked by ``probe_ok`` when given (plain path)."""
    v = valid[cids]
    return v if probe_ok is None else v & probe_ok[..., None]


def build_selective_lut(qsub: torch.Tensor, entries: torch.Tensor,
                        entry_sq: torch.Tensor, tau: torch.Tensor, *,
                        metric: str = "l2"
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage B: the masked LUT and the int8 hit table.

    qsub (..., S, 2) f32, entries (S, E, 2), entry_sq (S, E), tau (..., S)
    -> (masked_lut (..., S, E) f32, hit_table (..., S, E) int8). Leading
    dims are flattened into the kernel's batch axis. For ip the pruned
    entries already carry their row's minimum kept similarity (the
    reference's ``ip_pruned_fill`` post-pass is fused into the kernel).
    On the card this is one launch: the kernel reads ``qsub``, ``tau``
    and ``entries`` through their strides (stage B's ip ``qsub`` is
    expanded over the probes), and with two leading dims or fewer nothing
    is copied.
    """
    lead = qsub.shape[:-2]
    s, e = entries.shape[0], entries.shape[1]
    if _on_cuda(qsub, entries, entry_sq, tau):
        n_probe = lead[-1] if lead else 1
        q = qsub.reshape(-1, n_probe, s, 2)
        lut, hit = selective_lut(q[..., 0], q[..., 1], entries[..., 0],
                                 entries[..., 1], entry_sq,
                                 tau.reshape(-1, n_probe, s), metric=metric)
        return lut.reshape(*lead, s, e), hit.reshape(*lead, s, e)
    return build_selective_lut_plain(qsub, entries, entry_sq, tau,
                                     metric=metric)


def build_selective_lut_plain(qsub, entries, entry_sq, tau, *,
                              metric: str = "l2"):
    """:func:`build_selective_lut`'s plain version, on any device."""
    lead = qsub.shape[:-2]
    s, e = entries.shape[0], entries.shape[1]
    lut, hit = selective_lut_plain(
        qsub[..., 0].reshape(-1, s), qsub[..., 1].reshape(-1, s),
        entries[..., 0], entries[..., 1], entry_sq, tau.reshape(-1, s),
        metric=metric)
    return lut.reshape(*lead, s, e), hit.reshape(*lead, s, e)


def masked_adc_scan(mlut: torch.Tensor, codes: torch.Tensor,
                    valid: torch.Tensor, cids: torch.Tensor, *,
                    metric: str = "l2",
                    probe_ok: torch.Tensor | None = None) -> torch.Tensor:
    """Tier H: every probed point's masked-LUT total.

    mlut (Q, np, S, E) f32 -> (Q, np, P) f32; invalid slots and the slots
    of pruned probes get +inf (l2) or -inf (ip).
    """
    if _on_cuda(mlut, codes, valid, cids, probe_ok):
        return pq_scan(mlut.contiguous(), codes.contiguous(),
                       valid.contiguous(), cids.contiguous(), metric=metric,
                       probe_ok=None if probe_ok is None
                       else probe_ok.contiguous())
    return pq_scan_plain(mlut, codes[cids], _probed_valid(valid, cids, probe_ok),
                         metric=metric)


def masked_adc_topk_scan(mlut: torch.Tensor, codes: torch.Tensor,
                         valid: torch.Tensor, cids: torch.Tensor, k: int, *,
                         metric: str = "l2",
                         probe_ok: torch.Tensor | None = None,
                         probe_base: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Tier H: each query's k best masked-LUT totals.

    The rest as for :func:`masked_adc_scan`, ``probe_base`` (Q, np) f32 or
    ``None`` (ip's stage-A offset, added to every point of its probe), and
    1 <= k <= np·P. Returns (values (Q, k) f32, positions (Q, k) int64
    over the flat np·P axis) in ``lax.top_k``'s order (l2 distance
    ascending, ip similarity descending, equal scores by position
    ascending): the top-k of :func:`masked_adc_scan`'s scores plus
    ``probe_base``. On the card a call is two kernels (per-probe select,
    per-query merge) and no sort for k <= ``pq_scan.K_MAX`` and P <=
    ``pq_scan.P_MAX``; past them the scores kernel and a stable sort.
    """
    n_flat = cids.shape[1] * codes.shape[1]
    if not 1 <= k <= n_flat:
        raise ValueError(f"k={k} outside [1, np*P={n_flat}]")
    if _on_cuda(mlut, codes, valid, cids, probe_ok, probe_base):
        return pq_scan_topk(
            mlut.contiguous(), codes.contiguous(), valid.contiguous(),
            cids.contiguous(), k, metric=metric,
            probe_ok=None if probe_ok is None else probe_ok.contiguous(),
            probe_base=None if probe_base is None
            else probe_base.contiguous())
    return masked_adc_topk_scan_plain(mlut, codes, valid, cids, k,
                                      metric=metric, probe_ok=probe_ok,
                                      probe_base=probe_base)


def masked_adc_topk_scan_plain(mlut, codes, valid, cids, k: int, *,
                               metric: str = "l2", probe_ok=None,
                               probe_base=None):
    """:func:`masked_adc_topk_scan`'s plain version, on any device."""
    return pq_scan_topk_plain(mlut, codes[cids],
                              _probed_valid(valid, cids, probe_ok), k,
                              metric=metric, probe_base=probe_base)


def hit_count_scan(table: torch.Tensor, codes: torch.Tensor,
                   valid: torch.Tensor, cids: torch.Tensor, *,
                   probe_ok: torch.Tensor | None = None) -> torch.Tensor:
    """Tiers M/L and composed H2: every probed point's hit count.

    table (Q, np, S, E) int8 -> (Q, np, P) int32; invalid slots and the
    slots of pruned probes get -2^30.
    """
    if _on_cuda(table, codes, valid, cids, probe_ok):
        return hit_count(table.contiguous(), codes.contiguous(),
                         valid.contiguous(), cids.contiguous(),
                         probe_ok=None if probe_ok is None
                         else probe_ok.contiguous())
    return hit_count_plain(table, codes[cids],
                           _probed_valid(valid, cids, probe_ok))


def hit_count_topk_scan(table: torch.Tensor, codes: torch.Tensor,
                        valid: torch.Tensor, cids: torch.Tensor, k: int, *,
                        probe_ok: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Tiers M/L and composed H2: each query's k best hit counts.

    table (Q, np, S, E) int8 with entries in {-1, 0, +1} or {0, 1}, the
    rest as for :func:`hit_count_scan`; 1 <= k <= np·P. Returns (values
    (Q, k) f32, positions (Q, k) int64 over the flat np·P axis) in
    ``lax.top_k``'s order (count desc, position asc): the top-k of
    :func:`hit_count_scan`'s counts. On the card a call is two kernels
    (count, top-k) and no sort.
    """
    n_flat = cids.shape[1] * codes.shape[1]
    if not 1 <= k <= n_flat:
        raise ValueError(f"k={k} outside [1, np*P={n_flat}]")
    if _on_cuda(table, codes, valid, cids, probe_ok):
        return hit_count_topk(table.contiguous(), codes.contiguous(),
                              valid.contiguous(), cids.contiguous(), k,
                              probe_ok=None if probe_ok is None
                              else probe_ok.contiguous())
    return hit_count_topk_scan_plain(table, codes, valid, cids, k,
                                     probe_ok=probe_ok)


def hit_count_topk_scan_plain(table, codes, valid, cids, k: int, *,
                              probe_ok=None):
    """:func:`hit_count_topk_scan`'s plain version, on any device."""
    return hit_count_topk_plain(table, codes[cids],
                                _probed_valid(valid, cids, probe_ok), k)


def fused_two_stage_scan(mlut: torch.Tensor, table: torch.Tensor,
                         codes: torch.Tensor, valid: torch.Tensor,
                         cids: torch.Tensor, *, cap_c: int,
                         metric: str = "l2",
                         probe_ok: torch.Tensor | None = None):
    """Stage C: hit-count prefilter → survivor threshold → top-C → ADC.

    mlut/table (Q, np, S, E); codes, valid, cids and probe_ok as for the
    other scans.

    Returns
    -------
    tuple
        ``(counts (Q, np, P) int32, dist (Q, np, P) f32, cand (Q, C)
        int32, cand_dist (Q, C) f32)``: ``cand`` is the top-C-by-count
        set in index-ascending order over the flat np·P axis and
        ``cand_dist`` its masked-LUT totals (``fused_two_stage_host``'s
        contract). On the card a call is two kernels (count, select).

    On the card the launch shape comes from the active
    ``autotune.KernelConfig`` for ``"fused_two_stage"``, read on every
    call; it is result-invariant. The CPU's plain version has no knob.
    """
    if _on_cuda(mlut, table, codes, valid, cids, probe_ok):
        cfg = autotune.active_config("fused_two_stage")
        return fused_two_stage(mlut.contiguous(), table.contiguous(),
                               codes.contiguous(), valid.contiguous(),
                               cids.contiguous(), cap_c=cap_c, metric=metric,
                               probe_ok=None if probe_ok is None
                               else probe_ok.contiguous(), **cfg.launch())
    return fused_two_stage_plain(mlut, table, codes[cids],
                                 _probed_valid(valid, cids, probe_ok),
                                 cap_c=cap_c, metric=metric)


def fused_three_stage_scan(mlut: torch.Tensor, table: torch.Tensor,
                           codes: torch.Tensor, valid: torch.Tensor,
                           cids: torch.Tensor, q0: torch.Tensor,
                           q1: torch.Tensor, radius: torch.Tensor,
                           cell_c0: torch.Tensor, cell_c1: torch.Tensor,
                           slot_reach: torch.Tensor, slot_idx: torch.Tensor,
                           *, cap_c: int, metric: str = "l2"):
    """RT sphere test → hit-count prefilter → top-C → ADC in one pass.

    The :func:`fused_two_stage_scan` contract with the RT probe filter
    folded in as stage 0: ``q0``/``q1``/``radius`` (Q,) are the ray-plane
    queries, ``cell_c0``/``cell_c1``/``slot_reach`` (n_cells, cap) the
    ``CentroidGrid`` slot planes and ``slot_idx`` (Q, np) int32 the probed
    clusters' grid slots (``grid.slot_of[cids]``). Returns the two-stage
    4-tuple plus ``probe_ok`` (Q, np) bool, probe 0 always True — equal
    to composing :func:`rt_sphere_hits`, the probe gather and
    :func:`fused_two_stage_scan` with that mask. The grid's boxes and cell
    reaches, which the TPU kernel's cell walk reads, are not needed: the
    test runs once per probe, at its slot. On the card a call is two
    kernels: nothing is copied (``q0``/``q1`` are read through their
    strides) and no scratch is zeroed. The launch shape comes from the
    active ``autotune`` config for ``"fused_three_stage"``, as for
    :func:`fused_two_stage_scan`.
    """
    args = (q0, q1, radius, cell_c0, cell_c1, slot_reach, slot_idx)
    if _on_cuda(mlut, table, codes, valid, cids, *args):
        cfg = autotune.active_config("fused_three_stage")
        return fused_three_stage(
            mlut.contiguous(), table.contiguous(), codes.contiguous(),
            valid.contiguous(), cids.contiguous(), q0, q1,
            *(a.contiguous() for a in args[2:-1]),
            slot_idx.to(torch.int32).contiguous(), cap_c=cap_c, metric=metric,
            **cfg.launch())
    return fused_three_stage_plain(mlut, table, codes[cids], valid[cids],
                                   *args, cap_c=cap_c, metric=metric)


def rt_sphere_hits(q0: torch.Tensor, q1: torch.Tensor, radius: torch.Tensor,
                   c0: torch.Tensor, c1: torch.Tensor,
                   slot_reach: torch.Tensor) -> torch.Tensor:
    """The RT stage-1 filter: query disc vs every grid slot's cluster disc.

    q0, q1, radius (Q,) f32 ray-plane queries and radii; c0, c1, slot_reach
    (n_cells, cap) f32 centroid planes and reaches (``-inf`` = pad) ->
    (Q, n_cells·cap) int8, cell-major. Takes what the reference's host path
    ``sphere_hits_host`` takes: the cell boxes of its TPU cell walk are not
    needed (see ``csrc/sphere_hits.cu``).
    """
    args = (q0, q1, radius, c0, c1, slot_reach)
    if _on_cuda(*args):
        return sphere_hits(*(a.contiguous() for a in args))
    return sphere_hits_plain(*args)


def rt_probe_mask(q0: torch.Tensor, q1: torch.Tensor, tau: torch.Tensor,
                  cids: torch.Tensor, slot_of: torch.Tensor,
                  cell_c0: torch.Tensor, cell_c1: torch.Tensor,
                  slot_reach: torch.Tensor, radius_scale: torch.Tensor,
                  radius_bias: torch.Tensor, *, scale: float = 1.0
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The rt search's probe mask: which probed clusters survive the sphere
    test.

    q0, q1 (Q,) f32 ray-plane queries (the columns of ``q @ grid.proj``);
    tau (Q, S) f32, the probe-0 row of the search's thresholds; cids
    (Q, np) int64 or int32 probed cluster ids; slot_of, the slot planes,
    radius_scale and radius_bias the ``CentroidGrid``'s; ``scale`` the rt
    knob. Returns ``(probe_ok (Q, np) bool, probe 0 True; radius (Q,) f32;
    slot (Q, np) int32 = slot_of[cids])``, the last two for the three-stage
    scan. The radius is ``kernels/ref.py:rt_query_radius_ref``;
    the verdicts equal the dense :func:`rt_sphere_hits` table at that
    radius gathered at ``slot_of[cids]``. On the card a call is one kernel
    and copies nothing: the views are read through their strides and
    ``scale`` is a kernel argument.
    """
    args = (q0, q1, tau, cids, slot_of, cell_c0, cell_c1, slot_reach,
            radius_scale, radius_bias)
    if _on_cuda(*args):
        return sphere_probe(*args, scale)
    return sphere_probe_plain(*args, scale)


def filter_scores(queries: torch.Tensor, centroids: torch.Tensor,
                  centroid_sq: torch.Tensor, *, metric: str = "l2"
                  ) -> torch.Tensor:
    """Stage A's score matrix: every query against every centroid.

    queries (Q, D) f32, centroids (C, D) f32, centroid_sq (C,) f32 ->
    (Q, C) f32: ``csq − 2·q·cᵀ`` for l2 (lower is better, ‖q‖² left out),
    ``q·cᵀ`` for ip (higher is better).
    """
    args = (queries, centroids, centroid_sq)
    if _on_cuda(*args):
        return ivf_filter(*(a.contiguous() for a in args), metric=metric)
    return ivf_filter_plain(*args, metric=metric)


def filter_topk(queries: torch.Tensor, centroids: torch.Tensor,
                centroid_sq: torch.Tensor, *, nprobe: int, metric: str = "l2"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage A: each query's ``nprobe`` best centroids, in one launch on
    the card.

    queries (Q, D) f32, centroids (C, D) f32, centroid_sq (C,) f32 ->
    (scores (Q, nprobe) f32, ids (Q, nprobe) int64), in ``lax.top_k``'s
    order: l2 ascending (scores as :func:`filter_scores` gives them), ip
    descending, equal scores by smaller centroid index.
    """
    args = (queries, centroids, centroid_sq)
    if _on_cuda(*args):
        return ivf_filter_topk(*(a.contiguous() for a in args),
                               nprobe=nprobe, metric=metric)
    return ivf_filter_topk_plain(*args, nprobe=nprobe, metric=metric)


def filter_topk_plain(queries, centroids, centroid_sq, *, nprobe: int,
                      metric: str = "l2"):
    """:func:`filter_topk`'s plain version, on any device."""
    return ivf_filter_topk_plain(queries, centroids, centroid_sq,
                                 nprobe=nprobe, metric=metric)


# --------------------------------------------------------------------------
# the plain route, named (the reference's impl="ref")
# --------------------------------------------------------------------------


class _PlainRoute:
    """The scans the non-fused search reaches, by their plain versions:
    what :func:`route` gives inside :func:`plain_route`."""

    filter_topk = staticmethod(filter_topk_plain)
    build_selective_lut = staticmethod(build_selective_lut_plain)
    masked_adc_topk_scan = staticmethod(masked_adc_topk_scan_plain)
    hit_count_topk_scan = staticmethod(hit_count_topk_scan_plain)


_PLAIN = [False]
_WRAPPERS = sys.modules[__name__]


def route():
    """The functions ``core/juno.py`` and ``core/ivf.py`` call for stage A,
    stage B and the non-fused scans: this module's wrappers (which follow
    the tensors' device), or, inside :func:`plain_route`, their plain
    versions by name."""
    return _PlainRoute if _PLAIN[0] else _WRAPPERS


@contextlib.contextmanager
def plain_route():
    """While active, the search runs the plain versions of stage A, stage
    B and the non-fused scans whatever the tensors' device (the
    reference's ``impl="ref"``; the dry run's fake "cuda" tensors). The
    fused scans and the rt prefilter have no plain route here."""
    before = _PLAIN[0]
    _PLAIN[0] = True
    try:
        yield
    finally:
        _PLAIN[0] = before
