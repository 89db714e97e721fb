"""Incremental fold of minor delta generations into the base index.

Port of ``repro/build/merge.py:fold_step``. The artifact-backed minors of
the reference (``save_minor``, ``commit_minor``, ``load_minor``,
``minor_codes_loader``) wait for ``ArtifactStore`` (ROADMAP.md, queue 1,
item 8): the port's minor generations keep their codes in memory.
"""
from __future__ import annotations

import numpy as np
import torch


def fold_step(mid, *, max_clusters: int = 32,
              lane: tuple[int, int] | None = None) -> int:
    """Fold minor-generation points into free base slots of their clusters.

    Walks generations oldest first; for each, groups live positions by
    owning cluster and moves up to ``len(_free[c])`` of them into that
    cluster's freed padded slots, touching at most ``max_clusters``
    clusters in all. Plan, check the plan (a base slot listed twice raises
    ``RuntimeError`` with nothing mutated), write the device, then the
    host bookkeeping, as ``insert``/``compact``. Generations left with no
    live point are dropped.

    Parameters
    ----------
    mid : MutableJunoIndex
        Tier-enabled mutable index.
    max_clusters : int
        Budget: clusters folded in this call.
    lane : (lo, hi), optional
        Fold only clusters in ``[lo, hi)`` (one shard's range).

    Returns
    -------
    int
        Number of points moved into the base.
    """
    budget = int(max_clusters)
    moved = 0
    for m in list(mid._minors):
        if budget <= 0:
            break
        pos_all = np.flatnonzero(m.valid)
        if lane is not None:
            lo, hi = lane
            pos_all = pos_all[(m.cluster[pos_all] >= lo)
                              & (m.cluster[pos_all] < hi)]
        if pos_all.size == 0:
            continue
        cl: list[int] = []
        sl: list[int] = []
        pos_l: list[int] = []
        plan: list[tuple[int, int]] = []
        for c in np.unique(m.cluster[pos_all]).tolist():
            if budget <= 0:
                break
            free = mid._free[c]
            if not free:
                continue
            ppos = pos_all[m.cluster[pos_all] == c][:len(free)]
            cl += [c] * len(ppos)
            sl += [int(s) for s in free[-len(ppos):][::-1]]
            pos_l += ppos.tolist()
            plan.append((c, len(ppos)))
            budget -= 1
        if not pos_l:
            continue
        if len(set(zip(cl, sl))) != len(sl):
            raise RuntimeError(
                "fold plan references a base slot twice (corrupted free "
                "list / double-free); refusing to fold")
        pos_t = torch.as_tensor(pos_l, device=m.codes.device)
        mid._apply_insert(cl, sl, m.ids[pos_l].astype(np.int32),
                          m.codes[pos_t])
        for c, take in plan:
            del mid._free[c][-take:]
        for c, slot, pos in zip(cl, sl, pos_l):
            mid._loc[int(m.ids[pos])] = (c, slot)
        m.valid[np.asarray(pos_l)] = False
        moved += len(pos_l)
    if moved:
        mid._minors = [m for m in mid._minors if m.live]
        mid._delta_epoch += 1
    return moved
