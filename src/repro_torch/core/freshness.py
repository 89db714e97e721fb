"""LSM-style freshness tiers of the mutable index.

Port of ``repro/core/freshness.py`` (``MinorGeneration``,
``combined_delta``, ``promote_l0``, ``MergeScheduler``):

* **L0** — the side buffer: inserts land there when their owning
  cluster's padded slots are full.
* **Minor generations** — sealed snapshots of a full L0
  (:class:`MinorGeneration`, made by :func:`promote_l0`); deletes
  tombstone their host-side ``valid``. With a minor sink
  (``enable_tiers(minor_store=...)``) a generation is committed to the
  store and its codes are faulted back in, every row verified, on first
  touch (``build/merge.py``).
* **Base** — the padded per-cluster storage; ``build.merge.fold_step``
  moves minor points into freed base slots, a bounded number of clusters
  a call.

:func:`combined_delta` presents L0 ⊕ minors to the search as one
:class:`~repro_torch.core.juno.SideBuffer` of constant capacity
``B · (1 + max_minors)``, so promotions and folds change its contents
and never its shape; delta points are scored (the rt verdict included)
exactly as in-cluster points are. :class:`MergeScheduler` drives the
merges: the engine calls :meth:`MergeScheduler.maybe_step` between ticks,
``compact()`` calls :meth:`MergeScheduler.drain`; with a registry it
keeps the ``juno_merge_*`` series.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from .juno import SideBuffer, empty_side_buffer


@dataclasses.dataclass
class MinorGeneration:
    """One sealed, PQ-encoded delta generation (a promoted L0).

    ``cluster``/``ids``/``valid`` are host arrays; ``valid`` is the only
    mutable field (deletes tombstone it, folds clear drained positions).
    ``codes`` is ``None`` for a disk-backed generation until
    :meth:`materialize` faults it in through ``loader``, which verifies
    every row against the minor's manifest (``build/merge.py``).
    """

    gen: int                          #: monotone generation number
    cluster: np.ndarray               #: (B,) int32 owning clusters
    ids: np.ndarray                   #: (B,) int32 global point ids
    valid: np.ndarray                 #: (B,) bool host-mutable tombstones
    codes: torch.Tensor | None        #: (B, S) uint8, or None until faulted
    loader: Callable[[], torch.Tensor] | None = None
    path: str | None = None           #: artifact directory when disk-backed

    @property
    def capacity(self) -> int:
        """Fixed slot count B of this generation."""
        return int(self.ids.shape[0])

    @property
    def live(self) -> int:
        """Number of non-tombstoned points still in this generation."""
        return int(self.valid.sum())

    def materialize(self) -> torch.Tensor:
        """The (B, S) codes on the index's device, faulted in (and every
        row verified; ``ArtifactError`` on corruption) at first call when
        the generation is disk-backed."""
        if self.codes is None:
            self.codes = self.loader()
        return self.codes


def combined_delta(side: SideBuffer, minors: list[MinorGeneration],
                   max_minors: int) -> SideBuffer:
    """L0 ⊕ minor generations as one side buffer of fixed capacity.

    Parameters
    ----------
    side : SideBuffer
        The live L0 tier.
    minors : list of MinorGeneration
        Current sealed generations, oldest first.
    max_minors : int
        Configured generation cap (``enable_tiers``).

    Returns
    -------
    SideBuffer
        Capacity ``side.capacity · (1 + max_minors)`` whatever the number
        of minors; empty and tombstoned slots carry cluster −1, and empty
        tail slots id −1.
    """
    total = side.capacity * (1 + len(minors))
    cap = side.capacity * (1 + max_minors)
    if total > cap:
        raise RuntimeError(
            f"{len(minors)} minor generations exceed max_minors="
            f"{max_minors} (bookkeeping bug)")
    dev = side.codes.device
    parts = [side]
    for m in minors:
        parts.append(SideBuffer(
            codes=m.materialize(),
            cluster=torch.from_numpy(np.where(m.valid, m.cluster, -1)
                                     .astype(np.int32)).to(dev),
            ids=torch.from_numpy(m.ids.astype(np.int32)).to(dev),
            valid=torch.from_numpy(m.valid.copy()).to(dev)))
    if cap > total:
        parts.append(empty_side_buffer(cap - total, int(side.codes.shape[1]),
                                       dev))
    return SideBuffer(*(torch.cat(f) for f in zip(*parts)))


def promote_l0(mid) -> MinorGeneration:
    """Seal the current L0 side buffer into a new minor generation.

    Every promoted id's location is re-pointed at the generation and L0
    resets to empty. With a minor sink (``enable_tiers(minor_store=...)``)
    the generation is committed to the store first, so a failed write
    changes nothing, and its codes leave memory until first search touch.

    Parameters
    ----------
    mid : MutableIndexBase
        The index whose L0 to promote (``enable_tiers(max_minors > 0)``).

    Returns
    -------
    MinorGeneration
        The sealed generation (also appended to the index's tier list).
    """
    if getattr(mid, "_max_minors", 0) <= 0:
        raise RuntimeError("delta tiers are disabled; call "
                           "enable_tiers(max_minors=...) first")
    if len(mid._minors) >= mid._max_minors:
        raise RuntimeError(
            f"minor tier full ({mid._max_minors} generations); fold "
            f"them into the base (build.merge.fold_step) or rebuild")
    if mid.side_fill == 0:
        raise RuntimeError("L0 is empty; nothing to promote")
    side = mid.side
    gen = mid._minor_gen
    host = lambda t: t.cpu().numpy().copy()  # noqa: E731
    cluster, ids, valid = host(side.cluster), host(side.ids), host(side.valid)
    codes, loader, path = side.codes, None, None
    if mid._minor_sink is not None:
        # the fallible commit first: a failed write leaves the index as it was
        from ..build import merge
        store, name = mid._minor_sink
        path = merge.commit_minor(store, name, host(side.codes), cluster,
                                  ids, valid, gen=gen)
        loader = merge.minor_codes_loader(path, side.codes.device)
        codes = None
    minor = MinorGeneration(gen=gen, cluster=cluster, ids=ids, valid=valid,
                            codes=codes, loader=loader, path=path)
    for pos in np.flatnonzero(minor.valid).tolist():
        mid._loc[int(minor.ids[pos])] = (-2 - gen, pos)
    mid._minors.append(minor)
    mid._minor_gen = gen + 1
    mid.side = empty_side_buffer(side.capacity, int(side.codes.shape[1]),
                                 side.codes.device)
    mid._side_free = list(range(side.capacity))[::-1]
    mid._delta_epoch += 1
    return minor


class MergeScheduler:
    """Incremental merge policy over a tiered mutable index.

    One :meth:`step` does bounded work: fold L0 points into free base
    slots (``compact()``), promote a full L0 into a minor generation when
    one is open, and fold up to ``clusters_per_step`` clusters of the
    oldest minor generations into the base (``build.merge.fold_step``).
    An index with a ``merge_lanes()`` hook (the distributed index: one
    cluster range a shard) has its folds scheduled one lane a step,
    round-robin, so each fold writes one shard.
    """

    def __init__(self, index, *, clusters_per_step: int = 32,
                 registry=None):
        """Attach a scheduler to a tier-enabled mutable index.

        Parameters
        ----------
        index : MutableIndexBase
            The index to merge (``enable_tiers`` already called).
        clusters_per_step : int
            Fold budget: clusters merged per :meth:`step`.
        registry : repro_torch.obs.MetricsRegistry, optional
            Receives the ``juno_merge_*`` series: step and drain seconds,
            step/fold/move/drain counters and the L0 fill, minor count and
            delta rows as gauges, refreshed a step. ``None`` keeps only
            ``stats``.
        """
        self.index = index
        self.clusters_per_step = int(clusters_per_step)
        lanes = getattr(index, "merge_lanes", None)
        #: the fold lanes, ``(lo, hi)`` cluster ranges (``None``: all)
        self._lanes: list = list(lanes()) if callable(lanes) else [None]
        self._lane_i = 0
        self.stats = {"steps": 0, "promotions": 0, "folded": 0,
                      "compacted": 0, "drains": 0}
        self.registry = registry

    @property
    def pending(self) -> int:
        """Delta points not yet folded into the base (L0 + minors)."""
        return self.index.delta_fill

    def _can_promote(self) -> bool:
        idx = self.index
        return (idx._max_minors > 0 and idx.side_fill > 0
                and len(idx._minors) < idx._max_minors)

    def maybe_step(self) -> int:
        """Between-ticks hook: one :meth:`step` when work is pending.

        Returns the points moved (0 when the tiers are off, or L0 is not
        full and no minor generation exists).
        """
        idx = self.index
        if idx._max_minors <= 0:
            return 0
        if not idx._minors and idx.side_fill < idx.side.capacity:
            return 0
        return self.step()

    def step(self) -> int:
        """One bounded merge step; returns points moved between tiers."""
        from ..build.merge import fold_step
        idx = self.index
        t0 = time.perf_counter()
        moved = idx.compact()
        self.stats["compacted"] += moved
        if idx.side_fill >= idx.side.capacity and self._can_promote():
            moved += idx.side_fill
            promote_l0(idx)
            self.stats["promotions"] += 1
        lane = self._lanes[self._lane_i]
        self._lane_i = (self._lane_i + 1) % len(self._lanes)
        folded = fold_step(idx, max_clusters=self.clusters_per_step,
                           lane=lane)
        self.stats["folded"] += folded
        self.stats["steps"] += 1
        if self.registry is not None:
            self._observe(time.perf_counter() - t0, moved, folded)
        return moved + folded

    def _observe(self, dt: float, moved: int, folded: int) -> None:
        """Refresh the ``juno_merge_*`` series after one step."""
        reg = self.registry
        reg.histogram("juno_merge_step_seconds").add(dt)
        reg.counter("juno_merge_steps_total").inc()
        reg.counter("juno_merge_folded_total").inc(folded)
        reg.counter("juno_merge_moved_total").inc(moved)
        idx = self.index
        reg.gauge("juno_merge_l0_fill").set(
            idx.side_fill / max(1, idx.side.capacity))
        reg.gauge("juno_merge_minors").set(len(idx._minors))
        reg.gauge("juno_merge_delta_rows").set(self.pending)

    def drain(self, max_rounds: int = 10_000) -> int:
        """Run rounds of one merge step a lane until a round moves nothing;
        then promote a stuck non-empty L0 when a minor slot is open, and go
        on. Returns the points moved between tiers."""
        t0 = time.perf_counter()
        total = 0
        for _ in range(max_rounds):
            progress = sum(self.step() for _ in self._lanes)
            if progress == 0:
                if self.index.side_fill and self._can_promote():
                    total += self.index.side_fill
                    promote_l0(self.index)
                    self.stats["promotions"] += 1
                    continue
                break
            total += progress
        self.stats["drains"] += 1
        if self.registry is not None:
            self.registry.histogram("juno_merge_drain_seconds").add(
                time.perf_counter() - t0)
            self.registry.counter("juno_merge_drains_total").inc()
        return total
