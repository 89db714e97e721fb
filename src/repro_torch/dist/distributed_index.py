"""Cluster-sharded distributed JUNO search and the sharded mutable index.

Port of ``repro/dist/distributed_index.py``. The IVF cluster dimension
(centroids, padded point-id lists, validity and per-cluster PQ codes) is
split into equal contiguous ranges, one a shard; queries, the PQ codebook,
the density model and the flat per-point arrays are replicated. Each shard
runs the single-device search (``core/juno.py:_search_batch`` /
``_search_batch_two_stage``, so every kernel of the search, on its
``local_nprobe`` nearest local clusters), and the per-shard top-k lists
are concatenated in shard order and merged by one stable top-k: point ids
are global, so the merge is exact.

The reference is single-controller: one process, ``shard_map`` over a
mesh, then an ``all_gather`` and ``lax.top_k``. The port keeps that model
in one process: a sharded index is a tuple of per-shard
:class:`~repro_torch.core.juno.JunoIndexData`, each on its own
``torch.device`` (one entry of ``devices`` a shard; entries may repeat, so
four shards may share one card or the CPU), the shards are searched in
turn, and the gather is each shard's (Q, k) result moved to the first
shard's device. No ``torch.distributed`` process group is involved: the
fleet's routing, admission and slot bookkeeping stay in one process, as
in the reference.

:class:`DistributedMutableIndex` is the mutable form: the host-side slot
bookkeeping of :class:`~repro_torch.core.juno.MutableIndexBase`, each
insert, delete and row rewrite written in place into the shard that owns
the cluster, a replicated side buffer that every shard localises to its
own cluster range, per-shard rebuilds and merge lanes.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.ivf import IVFIndex
from ..core.juno import (JunoIndexData, MutableIndexBase, _as_tensor,
                         _label_encode, _own_copy, _search_batch,
                         _search_batch_two_stage, _side_set, _top_k, index_to)
from ..device import resolve_device
from ..kernels import ops
from ..rt import grid as rt_lib


def resolve_devices(devices=None) -> list[torch.device]:
    """The shards' devices, one entry a shard (``resolve_device`` each;
    ``None`` = one shard on ``cuda``). Raises without a card, as
    ``resolve_device`` does."""
    if devices is None:
        return [resolve_device(None)]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("a sharded index needs at least one device")
    return devs


def _local_clusters(n_clusters: int, n_shards: int) -> int:
    """Clusters a shard owns; they must divide evenly."""
    if n_clusters % n_shards:
        raise ValueError(f"clusters ({n_clusters}) must divide evenly over "
                         f"{n_shards} shards")
    return n_clusters // n_shards


def shard_index(idx: JunoIndexData, devices=None
                ) -> tuple[JunoIndexData, ...]:
    """Place a built index on its shards: shard ``s`` holds cluster rows
    ``[s·C/n, (s+1)·C/n)`` of ``centroids``, ``centroid_sq``,
    ``point_ids``, ``valid`` and ``cluster_codes`` on ``devices[s]``, and
    the replicated rest (``labels``, ``codebook``, ``codes``, ``density``,
    ``points_sq``). Point ids stay global. A shard on the index's own
    device holds views of its tensors, not copies."""
    devs = resolve_devices(devices)
    n_local = _local_clusters(idx.ivf.point_ids.shape[0], len(devs))
    ivf = idx.ivf
    out = []
    for s, dev in enumerate(devs):
        rows = slice(s * n_local, (s + 1) * n_local)
        out.append(JunoIndexData(
            ivf=IVFIndex(centroids=ivf.centroids[rows].to(dev),
                         centroid_sq=ivf.centroid_sq[rows].to(dev),
                         point_ids=ivf.point_ids[rows].to(dev),
                         valid=ivf.valid[rows].to(dev),
                         labels=ivf.labels.to(dev)),
            codebook=index_to(idx.codebook, dev), codes=idx.codes.to(dev),
            cluster_codes=idx.cluster_codes[rows].to(dev),
            density=index_to(idx.density, dev),
            points_sq=idx.points_sq.to(dev)))
    return tuple(out)


def search_shard(part: JunoIndexData, q: torch.Tensor, lo: int, *,
                 local_nprobe: int, k: int, mode: str = "H",
                 metric: str = "l2", thres_scale: float = 1.0,
                 rerank: int = 0, fused: bool = False,
                 fused3: bool | None = None, side=None,
                 prefilter: str = "scan", rt_grid=None,
                 rt_scale: float = 1.0, impl: str = "kernel"):
    """One shard's search: ``part`` holds clusters ``lo ..``, ``q`` the
    queries on its device, ``side`` and ``rt_grid`` the replicated side
    buffer and grid (or ``None``). ``impl="ref"`` runs the plain route of
    the non-fused scan search (``kernels.ops.plain_route``, the
    reference's ``impl="ref"``; the dry run's fake tensors), ``"kernel"``
    the kernels' wrappers. Returns the shard's (scores (Q, k), ids (Q, k)
    int32)."""
    if impl == "ref" and (fused or prefilter == "rt"):
        raise ValueError("impl='ref' has no plain route for the fused "
                         "scans or the rt prefilter")
    kw = {}
    if side is not None:
        local = index_to(side, q.device)
        kw["side"] = local._replace(cluster=local.cluster - lo)
    if prefilter == "rt":
        kw.update(prefilter="rt", rt_grid=index_to(rt_grid, q.device),
                  rt_scale=rt_scale, rt_offset=lo)
    route = ops.plain_route() if impl == "ref" else contextlib.nullcontext()
    with route:
        if mode == "H2":
            return _search_batch_two_stage(
                part, q, nprobe=local_nprobe, k=k, metric=metric,
                thres_scale=thres_scale, rerank=rerank, fused=fused,
                fused3=fused3, **kw)
        return _search_batch(part, q, nprobe=local_nprobe, k=k, mode=mode,
                             metric=metric, thres_scale=thres_scale, **kw)


def merge_shards(scores, ids, k: int, higher_better: bool):
    """The exact merge: the shards' (Q, k) results concatenated in shard
    order, one stable top-k (point ids are global)."""
    top, order = _top_k(torch.cat(scores, dim=1), k, higher_better)
    return top, torch.gather(torch.cat(ids, dim=1), 1, order)


def make_distributed_search(devices, local_nprobe: int, k: int, *,
                            mode: str = "H", metric: str = "l2",
                            thres_scale: float = 1.0, rerank: int = 0,
                            fused: bool = False, fused3: bool | None = None,
                            with_side: bool = False, prefilter: str = "scan",
                            rt_scale: float = 1.0):
    """Build ``dsearch(sharded, queries[, side][, rt_grid])``.

    ``sharded`` is :func:`shard_index`'s tuple over the same ``devices``;
    ``local_nprobe`` is the probe budget of each shard. Each shard runs
    the search of ``mode`` over its clusters, and the (Q, shards·k)
    concatenation of the shards' results, in shard order, is merged by a
    stable top-k on ``s`` (higher better: ip H/H2, and the counts of M/L)
    or ``-s`` (l2 H/H2). Returns (scores (Q, k) f32, ids (Q, k) int32) on
    the first shard's device.

    With ``with_side=True`` the callable takes a replicated
    :class:`~repro_torch.core.juno.SideBuffer` (or ``None``) third: each
    shard subtracts its first cluster id from the buffer's owning
    clusters, so a point owned by another shard never matches a probed
    local cluster and every side point is scored by the shard that owns
    it. With ``prefilter="rt"`` the callable takes the global
    :class:`~repro_torch.rt.CentroidGrid` last, and each shard looks its
    local probes up at ``cid + lo`` (``rt_offset``); at full-coverage
    radii the results equal ``prefilter="scan"``'s. ``fused=True`` (mode
    "H2" only) runs each shard's fused two-stage scan, or with rt the
    three-stage scan unless ``fused3=False``.

    Raises
    ------
    ValueError
        For ``fused=True`` with a mode other than "H2", an unknown mode or
        prefilter, and (at call time) shards that do not match
        ``devices`` or an rt search without a grid.
    """
    if mode not in ("H", "M", "L", "H2"):
        raise ValueError(f"unknown mode {mode!r}")
    if fused and mode != "H2":
        raise ValueError(f"fused=True requires mode='H2', got mode={mode!r}")
    if prefilter not in ("scan", "rt"):
        raise ValueError(f"unknown prefilter {prefilter!r}")
    devs = resolve_devices(devices)
    # core/juno.py's sign convention: H/H2 report distances for l2 (lower
    # better); ip similarities and M/L counts are higher-better
    higher_better = metric == "ip" if mode in ("H", "H2") else True

    def dsearch(sharded, queries, *rest):
        """Per-shard search of ``queries``, then the exact shard-major
        merge (see :func:`make_distributed_search`)."""
        rest = list(rest)
        side = rest.pop(0) if with_side else None
        rt_grid = rest.pop(0) if prefilter == "rt" else None
        if rest:
            raise TypeError(f"{len(rest)} unexpected arguments")
        if len(sharded) != len(devs):
            raise ValueError(f"{len(sharded)} shards for {len(devs)} devices")
        if prefilter == "rt" and rt_grid is None:
            raise ValueError("prefilter='rt' requires the rt grid")
        q_all = _as_tensor(queries)
        n_local = sharded[0].ivf.point_ids.shape[0]
        out_s, out_i = [], []
        for s, (part, dev) in enumerate(zip(sharded, devs)):
            sc, ids = search_shard(
                part, q_all.to(dev), s * n_local, local_nprobe=local_nprobe,
                k=k, mode=mode, metric=metric, thres_scale=thres_scale,
                rerank=rerank, fused=fused, fused3=fused3, side=side,
                prefilter=prefilter, rt_grid=rt_grid, rt_scale=rt_scale)
            out_s.append(sc.to(devs[0]))
            out_i.append(ids.to(devs[0]))
        return merge_shards(out_s, out_i, k, higher_better)

    return dsearch


class DistributedMutableIndex(MutableIndexBase):
    """Sharded, online-mutable JUNO index (the counterpart of
    :class:`~repro_torch.core.juno.MutableJunoIndex` over several shards).

    Data plane: :attr:`shards`, the cluster-sharded index
    (:func:`shard_index`), and a replicated side buffer on the first
    shard's device; :meth:`searcher` gives the side-aware
    :func:`make_distributed_search`. Control plane: the host-side slot
    bookkeeping of :class:`~repro_torch.core.juno.MutableIndexBase`; each
    insert, delete or fold is written in place into the shard that owns
    its cluster, at ``cluster − lo``. Like ``MutableJunoIndex`` the
    wrapper owns copies of the tensors its writes touch (``point_ids``,
    ``valid``, ``cluster_codes``), so the caller's index, and any other
    wrapper over it, is left as built.

    :attr:`data` is the index as one global ``JunoIndexData`` on the
    host (the shards' cluster rows concatenated, built at each read), for
    what reads the whole index: ``build.rebuild_index``. Serving never
    builds it: the engine reads :attr:`n_clusters` and :attr:`device`,
    and the rt grid is built from the replicated parts.

    With an ``rt_grid`` (built from the unsharded index), inserts grow the
    touched clusters' reaches as ``MutableJunoIndex``'s do; hand the
    current :attr:`rt_grid` to a ``searcher(..., prefilter="rt")``.
    """

    def __init__(self, idx: JunoIndexData, devices=None, *,
                 side_capacity: int = 256, rt_grid=None):
        """Shard a built global index over ``devices`` (one entry a shard;
        ``None``: one shard on ``cuda``).

        Raises ``ValueError`` when the clusters do not divide evenly over
        the shards.
        """
        self.devices = resolve_devices(devices)
        self.n_shards = len(self.devices)
        self._n_local = _local_clusters(idx.ivf.point_ids.shape[0],
                                        self.n_shards)
        self.rt_grid = rt_grid
        self._install(idx)
        self._init_bookkeeping(idx.ivf.valid.to(self.devices[0]),
                               idx.ivf.point_ids,
                               side_capacity=side_capacity,
                               first_new_id=int(idx.codes.shape[0]),
                               n_subspaces=int(idx.codes.shape[1]))

    def _install(self, idx: JunoIndexData) -> None:
        """Own copies of ``idx``'s shards, and its replicated centroids and
        codebook for insert-time encoding on the first shard's device."""
        self.shards = tuple(_own_copy(p) for p in shard_index(idx,
                                                               self.devices))
        self._ivf = index_to(idx.ivf, self.devices[0])
        self._codebook = index_to(idx.codebook, self.devices[0])

    @property
    def data(self) -> JunoIndexData:
        """The global view on the host (see the class docstring): a copy
        built at each read; writing it changes nothing."""
        def cat(get):
            return torch.cat([get(p).cpu() for p in self.shards])
        s0 = index_to(self.shards[0]._replace(
            cluster_codes=self.shards[0].cluster_codes[:0]), "cpu")
        ivf = IVFIndex(centroids=cat(lambda p: p.ivf.centroids),
                       centroid_sq=cat(lambda p: p.ivf.centroid_sq),
                       point_ids=cat(lambda p: p.ivf.point_ids),
                       valid=cat(lambda p: p.ivf.valid),
                       labels=s0.ivf.labels)
        return s0._replace(ivf=ivf,
                           cluster_codes=cat(lambda p: p.cluster_codes))

    @property
    def n_clusters(self) -> int:
        """Global clusters, over every shard."""
        return self._n_local * self.n_shards

    @property
    def device(self) -> torch.device:
        """The first shard's device: queries go there, and the merge."""
        return self.devices[0]

    def _labels_codes(self, pts):
        return _label_encode(pts, self._ivf, self._codebook)

    def _rt_centroids(self):
        """The replicated centroids (the grid indexes global cluster ids)."""
        return self._ivf.centroids

    # ---- routed device writes --------------------------------------------
    def _by_shard(self, cl):
        """``(shard, positions, local cluster ids)`` of the cells in ``cl``
        (global cluster ids), grouped by owning shard."""
        cl = np.asarray(cl, np.int64)
        owner = cl // self._n_local
        for s in np.unique(owner).tolist():
            sel = np.flatnonzero(owner == s)
            yield s, sel, cl[sel] - s * self._n_local

    def _apply_insert(self, cl, sl, ids, codes):
        sl = np.asarray(sl, np.int64)
        ids = np.asarray(ids, np.int32)
        for s, sel, local in self._by_shard(cl):
            part, dev = self.shards[s], self.devices[s]
            c_t = torch.as_tensor(local, device=dev)
            s_t = torch.as_tensor(sl[sel], device=dev)
            # valid last: a write that fails part-way leaves invisible slots
            part.cluster_codes[c_t, s_t] = codes[
                torch.as_tensor(sel, device=codes.device)].to(dev)
            part.ivf.point_ids[c_t, s_t] = torch.as_tensor(ids[sel],
                                                           device=dev)
            part.ivf.valid[c_t, s_t] = True

    def _apply_delete(self, cl, sl):
        sl = np.asarray(sl, np.int64)
        for s, sel, local in self._by_shard(cl):
            dev = self.devices[s]
            self.shards[s].ivf.valid[torch.as_tensor(local, device=dev),
                                     torch.as_tensor(sl[sel],
                                                     device=dev)] = False

    # ---- search -------------------------------------------------------
    def searcher(self, local_nprobe: int, k: int, **kw):
        """:func:`make_distributed_search` over this index's devices with
        the side buffer (``with_side=True``): call it as
        ``fn(self.shards, queries, self.delta_view()[, self.rt_grid])``."""
        return make_distributed_search(self.devices, local_nprobe, k,
                                       with_side=True, **kw)

    def ensure_rt_grid(self, *, metric: str = "l2", **kw
                       ) -> rt_lib.CentroidGrid:
        """Build and attach the global centroid grid if none is attached;
        returns it. ``rt.build_grid`` reads only replicated parts (the
        centroids, labels, codes, codebook and density), so it gets the
        first shard with the replicated global ``ivf``, on that shard's
        device: the grid equals one built from the unsharded index."""
        if self.rt_grid is None:
            self.rt_grid = rt_lib.build_grid(
                self.shards[0]._replace(ivf=self._ivf), metric=metric, **kw)
        return self.rt_grid

    def merge_lanes(self) -> list[tuple[int, int]]:
        """Per-shard cluster ranges: ``core.freshness.MergeScheduler``
        folds one lane a step, round-robin, so each fold writes one
        shard."""
        n = self._n_local
        return [(s * n, (s + 1) * n) for s in range(self.n_shards)]

    # ---- rebuild / hot swap ---------------------------------------------
    def swap_data(self, new_data: JunoIndexData, *,
                  side_capacity: int | None = None) -> None:
        """Install a rebuilt global index on the same devices.

        As ``MutableJunoIndex.swap_data``: the new index is sharded (and
        copied), the bookkeeping is rederived from its ``point_ids`` and
        ``valid``, the side buffer resets to empty, the id watermark is
        kept and the rt grid is dropped (``ensure_rt_grid`` rebuilds it).
        The clusters must still divide over the shards.
        """
        _local_clusters(new_data.ivf.point_ids.shape[0], self.n_shards)
        pids = new_data.ivf.point_ids
        first_new = max(self._next_id,
                        int(pids.max()) + 1 if pids.numel() else 0)
        self._install(new_data)
        self.rt_grid = None
        self._init_bookkeeping(
            new_data.ivf.valid.to(self.devices[0]), pids,
            side_capacity=(self.side.capacity if side_capacity is None
                           else side_capacity),
            first_new_id=first_new,
            n_subspaces=int(new_data.codes.shape[1]))

    def rebuild_shard(self, shard: int) -> int:
        """Re-pack one shard in place: drop tombstones, drain the delta
        tiers into free slots.

        For each cluster of ``shard``, its live points are compacted to
        the front of its padded row (slot order kept) and the delta tiers'
        points it owns follow, in position order (``build.live_points``).
        The capacity is fixed, so points that do not fit stay in their
        tier (:meth:`rebuild` escalates them). The shard's three tensors
        are rewritten whole; no other shard is touched. Results are
        bit-equal on the CPU, where a delta point is scored as the
        in-cluster point it becomes; on the card a moved point's score can
        differ in its last bits (a side point is summed by torch, an
        in-cluster point by the scan kernel).

        Returns
        -------
        int
            Delta points drained into this shard's clusters.
        """
        from ..build.rebuild import live_points

        n_local = self._n_local
        lo = shard * n_local
        part = self.shards[shard]

        def host(t):
            return t.cpu().numpy()
        point_ids = host(part.ivf.point_ids)
        cap = point_ids.shape[1]
        clusters, ids, codes = live_points(
            self, point_ids, host(part.ivf.valid), host(part.cluster_codes),
            clusters=range(lo, lo + n_local))
        local = clusters - lo
        fill = np.bincount(local, minlength=n_local)
        starts = np.concatenate([[0], np.cumsum(fill)[:-1]])
        slot = np.arange(ids.size) - starts[local]
        keep = slot < cap            # overflow stays in the delta tiers
        row_ids = np.full((n_local, cap), -1, np.int32)
        row_codes = np.zeros((n_local, cap, codes.shape[-1]), np.uint8)
        row_ids[local[keep], slot[keep]] = ids[keep]
        row_codes[local[keep], slot[keep]] = codes[keep]

        # the device first: the shard's rows, valid last …
        ids_t = torch.from_numpy(row_ids).to(self.devices[shard])
        part.cluster_codes.copy_(torch.from_numpy(row_codes))
        part.ivf.point_ids.copy_(ids_t)
        part.ivf.valid.copy_(ids_t >= 0)
        # … then the host bookkeeping
        self._loc.update(zip(ids[keep].tolist(),
                             zip(clusters[keep].tolist(),
                                 slot[keep].tolist())))
        packed = np.minimum(fill, cap).tolist()
        for c in range(n_local):
            self._free[lo + c] = list(range(packed[c], cap))[::-1]

        def moved(tier_ids, tier_valid):
            # delta positions whose id now has an in-cluster location
            return [int(p) for p in np.flatnonzero(tier_valid)
                    if self._loc.get(int(tier_ids[p]), (-1, -1))[0] >= 0]
        freed_pos = moved(host(self.side.ids), host(self.side.valid))
        if freed_pos:
            self.side = _side_set(
                self.side, torch.as_tensor(freed_pos,
                                           device=self.side.valid.device),
                valid=False)
            self._side_free.extend(freed_pos)
        freed_minor = 0
        for m in self._minors:
            mpos = moved(m.ids, m.valid)
            if mpos:
                m.valid[np.asarray(mpos)] = False
                freed_minor += len(mpos)
        if freed_minor:
            self._minors = [m for m in self._minors if m.live]
        if freed_pos or freed_minor:
            self._delta_epoch += 1
        return len(freed_pos) + freed_minor

    def rebuild(self) -> int:
        """Drain the delta tiers: :meth:`rebuild_shard` on every shard, then,
        for points still stuck (their cluster full), a capacity-growing
        ``build.rebuild_index`` and :meth:`swap_data`, so the tiers always
        end empty. Returns the points drained."""
        drained = sum(self.rebuild_shard(s) for s in range(self.n_shards))
        stuck = self.delta_fill
        if stuck:
            from ..build.rebuild import rebuild_index
            self.swap_data(rebuild_index(self))
            drained += stuck
        return drained
