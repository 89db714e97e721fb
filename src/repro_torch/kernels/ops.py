"""Public wrappers over the ported kernels.

Port of ``repro/kernels/ops.py:build_selective_lut`` (l.79),
``masked_adc_scan`` (l.121), ``hit_count_scan`` (l.135) and
``fused_two_stage_scan`` (l.147). Dispatch follows the tensors' device: a
CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor goes
to the hand-written CUDA kernel, or the call raises. There is no fallback
from a kernel to its plain version.

The three scans take the whole index (``codes (n_clusters, P, S)``,
``valid (n_clusters, P)``) and the probed cluster ids ``cids (Q, np)``
int64: the kernels read the probed rows through ``cids`` and never
materialise the gathered copy the reference scans; the plain versions
scan ``codes[cids]``.
"""
from __future__ import annotations

import torch

from .fused_two_stage import fused_two_stage, fused_two_stage_plain
from .hit_count import hit_count, hit_count_plain
from .pq_scan import pq_scan, pq_scan_plain
from .selective_lut import selective_lut, selective_lut_plain


def _on_cuda(*tensors: torch.Tensor) -> bool:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


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
    """
    lead = qsub.shape[:-2]
    s, e = entries.shape[0], entries.shape[1]
    q0 = qsub[..., 0].reshape(-1, s).contiguous()
    q1 = qsub[..., 1].reshape(-1, s).contiguous()
    tau2 = tau.reshape(-1, s).contiguous()
    e0 = entries[..., 0].contiguous()
    e1 = entries[..., 1].contiguous()
    fn = selective_lut if _on_cuda(qsub, entries, entry_sq, tau) \
        else selective_lut_plain
    lut, hit = fn(q0, q1, e0, e1, entry_sq.contiguous(), tau2, metric=metric)
    return lut.reshape(*lead, s, e), hit.reshape(*lead, s, e)


def masked_adc_scan(mlut: torch.Tensor, codes: torch.Tensor,
                    valid: torch.Tensor, cids: torch.Tensor, *,
                    metric: str = "l2") -> torch.Tensor:
    """Tier H: every probed point's masked-LUT total.

    mlut (Q, np, S, E) f32 -> (Q, np, P) f32; invalid slots get +inf (l2)
    or -inf (ip).
    """
    if _on_cuda(mlut, codes, valid, cids):
        return pq_scan(mlut.contiguous(), codes.contiguous(),
                       valid.contiguous(), cids.contiguous(), metric=metric)
    return pq_scan_plain(mlut, codes[cids], valid[cids], metric=metric)


def hit_count_scan(table: torch.Tensor, codes: torch.Tensor,
                   valid: torch.Tensor, cids: torch.Tensor) -> torch.Tensor:
    """Tiers M/L and composed H2: every probed point's hit count.

    table (Q, np, S, E) int8 -> (Q, np, P) int32; invalid slots get -2^30.
    """
    if _on_cuda(table, codes, valid, cids):
        return hit_count(table.contiguous(), codes.contiguous(),
                         valid.contiguous(), cids.contiguous())
    return hit_count_plain(table, codes[cids], valid[cids])


def fused_two_stage_scan(mlut: torch.Tensor, table: torch.Tensor,
                         codes: torch.Tensor, valid: torch.Tensor,
                         cids: torch.Tensor, *, cap_c: int,
                         metric: str = "l2"):
    """Stage C: hit-count prefilter → survivor threshold → top-C → ADC.

    mlut/table (Q, np, S, E); codes, valid and cids as for the other scans.

    Returns
    -------
    tuple
        ``(counts (Q, np, P) int32, dist (Q, np, P) f32, cand (Q, C)
        int32, cand_dist (Q, C) f32)``: ``cand`` is the top-C-by-count
        set in index-ascending order over the flat np·P axis and
        ``cand_dist`` its masked-LUT totals (``fused_two_stage_host``'s
        contract).
    """
    if _on_cuda(mlut, table, codes, valid, cids):
        return fused_two_stage(mlut.contiguous(), table.contiguous(),
                               codes.contiguous(), valid.contiguous(),
                               cids.contiguous(), cap_c=cap_c, metric=metric)
    return fused_two_stage_plain(mlut, table, codes[cids], valid[cids],
                                 cap_c=cap_c, metric=metric)
