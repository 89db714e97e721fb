"""Distance-calculation stage (the paper's Fig. 1 stage D): the plain
tensor oracles of one cluster's scan.

Port of ``repro/core/scan.py``. Three functions over the PQ codes of one
probed cluster, each running on the device of its inputs:

* ``adc_scan``        exact masked accumulation (JUNO-H): gathers the LUT
                      value of each (point, subspace) and sums over the
                      subspaces in order;
* ``hit_count_scan``  JUNO-L/M: int8 reward/penalty accumulation, no f32
                      LUT read at all (the aggressive approximation, §5.4);
* ``adc_scan_onehot`` the same sums as one_hot(codes) contracted with the
                      LUT, the formulation the reference's TPU kernel maps
                      onto its matrix unit.

They are the stage-D oracles: the engines' scans run the batched kernels
of ``kernels/`` (``pq_scan``, ``hit_count``), whose plain versions are
``kernels/ref.py``'s.
"""
from __future__ import annotations

import torch

from ..kernels.ref import NEG, bad_score


def _gather(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut (S, E), codes (P, S) -> (P, S): out[p, s] = lut[s, codes[p, s]]."""
    s_idx = torch.arange(lut.shape[0], device=lut.device)[None, :]
    return lut[s_idx, codes.long()]


def adc_scan(lut: torch.Tensor, codes: torch.Tensor, valid: torch.Tensor,
             *, metric: str = "l2") -> torch.Tensor:
    """lut (S, E) f32 (already mask-substituted), codes (P, S) uint8,
    valid (P,) bool -> (P,) scores; invalid slots get +inf (l2) or -inf
    (ip)."""
    total = torch.sum(_gather(lut, codes), dim=-1)
    return torch.where(valid, total,
                       torch.tensor(bad_score(metric), device=lut.device))


def hit_count_scan(table: torch.Tensor, codes: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """table (S, E) int8 hit table, codes (P, S) uint8, valid (P,) bool ->
    (P,) int32 counts (higher = closer); invalid slots get -2^30."""
    total = torch.sum(_gather(table.to(torch.int32), codes), dim=-1,
                      dtype=torch.int32)
    return torch.where(valid, total,
                       torch.tensor(NEG, dtype=torch.int32,
                                    device=table.device))


def adc_scan_onehot(lut: torch.Tensor, codes: torch.Tensor,
                    valid: torch.Tensor, *, metric: str = "l2"
                    ) -> torch.Tensor:
    """The matrix-unit form of :func:`adc_scan`: one_hot(codes) (P, S, E)
    contracted with lut (S, E). The same sums as :func:`adc_scan`, added
    in the contraction's order."""
    oh = torch.nn.functional.one_hot(codes.long(), lut.shape[-1]).to(lut.dtype)
    total = torch.einsum("pse,se->p", oh, lut)
    return torch.where(valid, total,
                       torch.tensor(bad_score(metric), device=lut.device))
