"""Out-of-core paged ANN serving: an index whose PQ codes stay on disk.

Port of ``repro/serve/paged.py``. The index's small arrays go to the
device at load time and its bulk, the per-cluster code rows, is paged in
from a memory-mapped artifact (``build/store.py``):

* **Resident tier** — IVF centroids, point ids and validity, the PQ
  codebook, the density model and the artifact's rt grid, on the device.
  Stage A, the rt probe and stage B run over this tier alone.
* **Paged tier** — ``cluster_codes`` memory-mapped
  (``load_index(mmap_mode="r")``) behind :class:`ClusterCache`, an LRU of
  cluster rows bounded in device bytes. A row's sha256 is checked against
  the manifest's ``sha256_rows`` the first time it is read: a corrupt row
  raises ``ArtifactError`` and serves nothing.
* **Exact-rerank tier** (optional) — the search returns C candidates and
  the final top-k is scored exactly from the raw vectors of those C only,
  read from a memory-mapped ``.npy``.

Each batch's scans read a page buffer: the rows of the batch's distinct
probed clusters, stacked on the device, with local indices into it in
place of the cluster ids (the scan view of ``core/juno.py``). The kernels
index only codes and validity with the ids they are given, and the buffer
holds the same bytes at the same flat positions, so paged results equal
resident results bit for bit. :class:`PagedJunoIndex` is the mutable
wrapper (inserts go to the side buffer, deletes tombstone the resident
validity) and :class:`PagedAnnServeEngine` the serving engine.

Observability: :meth:`ClusterCache.bind` mirrors the cache's counters
into the ``juno_cache_*`` series, :meth:`PagedIndexData.bind_obs` turns
each cache miss into a ``paged.fault`` span and the ``juno_paged_*``
counters (the first-touch digest's seconds into a histogram), and the
paged engine splits each dispatch into ``paged.filter`` (stage A, queued
on the device), ``paged.gather`` (the page buffer: the misses' host reads
and host→device copies) and ``paged.score`` spans. All of it is
host-side bookkeeping: the served ids and scores do not change.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from ..build.store import ArtifactError, _array_digest, _tensor, load_index
from ..core.juno import (JunoIndexData, MutableIndexBase, _label_encode,
                         _top_k, search)
from ..device import resolve_device
from ..rt.grid import CentroidGrid, grid_from_arrays
from .ann import AnnServeEngine


class ClusterCache:
    """LRU cache of cluster code rows, bounded in bytes.

    Keys are cluster ids, values the ``(P, S)`` uint8 rows (tensors on the
    index's device in the paged tier, so ``capacity_bytes`` counts device
    bytes). Rows are evicted least recently used first until a new row
    fits; a row larger than the whole capacity is served but never cached.
    ``hits``/``misses``/``evictions`` count as in the reference, and
    :meth:`bind` mirrors them into a registry.
    """

    def __init__(self, capacity_bytes: int):
        """An empty cache of ``capacity_bytes`` bytes."""
        self.capacity_bytes = int(capacity_bytes)
        self._rows: collections.OrderedDict = collections.OrderedDict()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._m = None          # registry handles once bound
        self._bound_to = None   # the registry they live in

    def bind(self, registry) -> None:
        """Mirror the counters into ``registry`` as the ``juno_cache_*``
        series, seeded with the counts so far (binding after warm-up loses
        nothing); binding again to the same registry does nothing (a
        generation swap re-binds the adopted cache)."""
        if self._bound_to is registry:
            return
        self._bound_to = registry
        m = {"hits": registry.counter("juno_cache_hits_total"),
             "misses": registry.counter("juno_cache_misses_total"),
             "evictions": registry.counter("juno_cache_evictions_total"),
             "evicted_bytes": registry.counter(
                 "juno_cache_evicted_bytes_total"),
             "bytes": registry.gauge("juno_cache_bytes", agg="sum"),
             "rows": registry.gauge("juno_cache_rows", agg="sum")}
        m["hits"].inc(self.hits)
        m["misses"].inc(self.misses)
        m["evictions"].inc(self.evictions)
        m["bytes"].set(self.bytes)
        m["rows"].set(len(self._rows))
        self._m = m

    def get(self, cid: int):
        """The cached row of ``cid`` (made most recent), or ``None``."""
        row = self._rows.get(cid)
        if row is None:
            self.misses += 1
            if self._m is not None:
                self._m["misses"].inc()
            return None
        self._rows.move_to_end(cid)
        self.hits += 1
        if self._m is not None:
            self._m["hits"].inc()
        return row

    def put(self, cid: int, row) -> None:
        """Cache ``row`` under ``cid``, evicting the oldest rows to fit."""
        nb = row.nbytes
        if nb > self.capacity_bytes:
            return                     # larger than the whole cache: bypass
        while self._rows and self.bytes + nb > self.capacity_bytes:
            _, old = self._rows.popitem(last=False)
            self.bytes -= old.nbytes
            self.evictions += 1
            if self._m is not None:
                self._m["evictions"].inc()
                self._m["evicted_bytes"].inc(old.nbytes)
        self._rows[cid] = row
        self.bytes += nb
        if self._m is not None:
            self._m["bytes"].set(self.bytes)
            self._m["rows"].set(len(self._rows))

    def clear(self) -> None:
        """Drop every row; capacity and counters are kept."""
        self._rows.clear()
        self.bytes = 0

    def __len__(self) -> int:
        """Number of cached rows."""
        return len(self._rows)

    def stats(self) -> dict:
        """``{"capacity_bytes", "bytes", "rows", "hits", "misses",
        "evictions"}``."""
        return {"capacity_bytes": self.capacity_bytes, "bytes": self.bytes,
                "rows": len(self._rows), "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions}


class PagedIndexData:
    """One artifact generation served out of core.

    Loads the artifact with ``load_index(mmap_mode="r")`` (the store's
    ``"manifest"`` check by default: schema, config hash, array set,
    shapes, dtypes). The resident tier goes to the device as :attr:`meta`,
    a :class:`~repro_torch.core.juno.JunoIndexData` whose ``codes``,
    ``cluster_codes`` and ``points_sq`` are zero-length placeholders, and
    :attr:`rt_grid` (the artifact's grid, or ``None``); the code rows stay
    memory-mapped behind :attr:`cache`. Each row is sha256-checked on its
    first read; an artifact without row digests is refused unless the
    caller opts out with ``verify_rows=False``.
    """

    def __init__(self, path: str, *, cache_bytes: int = 64 << 20,
                 expect_config=None, vectors=None, verify_rows: bool = True,
                 verify: str | None = None, device=None):
        """Open an artifact directory for paged serving.

        Parameters
        ----------
        path : str
            Artifact directory (``save_index`` of either package, usually
            ``ArtifactStore.path(name, version)``).
        cache_bytes : int
            Cluster cache capacity in device bytes.
        expect_config : JunoConfig, optional
            Config-hash guard, as in ``load_index``.
        vectors : array-like or str, optional
            Raw ``(N, D)`` vectors for the exact-rerank tier, or the path
            of an ``.npy`` opened with ``mmap_mode="r"``; only the
            candidates' rows are read.
        verify_rows : bool
            Check each row's sha256 on first read (default); ``False`` is
            the explicit opt-out for an artifact without row digests.
        verify : str, optional
            Load-time level for ``load_index`` (default ``"manifest"``).
        device : str or torch.device, optional
            The resident tier's and the cache's device (``None`` = ``cuda``).
        """
        loaded = load_index(path, expect_config=expect_config,
                            mmap_mode="r", verify=verify)
        dev = resolve_device(device)
        self.device = dev
        self.path = path
        self.config = loaded.config
        self.manifest = loaded.manifest
        self.rt_grid = (None if loaded.rt_grid is None else grid_from_arrays(
            loaded.rt_grid._asdict(), dev, prefix=""))
        data = loaded.data
        self._cluster_codes = data.cluster_codes          # (C, P, S) memmap
        c, p, s = self._cluster_codes.shape
        promote = lambda nt: type(nt)(  # noqa: E731
            *(_tensor(a, dev) for a in nt))
        empty = lambda shape, a: torch.from_numpy(  # noqa: E731
            np.zeros(shape, a.dtype)).to(dev)
        self.meta = JunoIndexData(
            ivf=promote(data.ivf), codebook=promote(data.codebook),
            density=promote(data.density), codes=empty((0, s), data.codes),
            cluster_codes=empty((0, p, s), self._cluster_codes),
            points_sq=empty((0,), data.points_sq))
        self.cluster_bytes = int(self._cluster_codes.nbytes)
        self._row_digests = (self.manifest["arrays"]["cluster_codes"]
                             .get("sha256_rows"))
        if verify_rows and self._row_digests is None:
            raise ArtifactError(
                f"artifact has no per-row digests for cluster_codes; re-save "
                f"it with the current store, or opt out with "
                f"verify_rows=False ({path})")
        if not verify_rows:
            self._row_digests = None
        self._verified = np.zeros(c, bool)
        self.verified_rows = 0
        if isinstance(vectors, str):
            vectors = np.load(vectors, mmap_mode="r")
        self.vectors = vectors
        self.cache = ClusterCache(cache_bytes)
        self._obs = None        # Observability bundle once bound
        #: the smallest id no committed point uses: the mutable wrapper's
        #: first new id
        self.first_new_id = int(
            data.ivf.point_ids[data.ivf.valid].max(initial=-1)) + 1

    def bind_obs(self, obs) -> None:
        """Attach an ``obs.Observability`` bundle to the fetch plane: the
        cache's counters go to ``obs.registry`` (:meth:`ClusterCache.bind`),
        each miss becomes a ``paged.fault`` span and
        ``juno_paged_faults_total`` / ``juno_paged_fault_bytes_total``
        counts, and a row's first-touch digest time goes to the
        ``juno_paged_verify_seconds`` histogram."""
        self._obs = obs
        reg = obs.registry
        # handles looked up once: a pass faults in thousands of rows
        self._obs_m = (reg.counter("juno_paged_faults_total"),
                       reg.counter("juno_paged_fault_bytes_total"),
                       reg.histogram("juno_paged_verify_seconds"))
        self.cache.bind(reg)

    # ---- paged fetch plane ----------------------------------------------
    def fetch_cluster(self, cid: int) -> torch.Tensor:
        """One cluster's ``(P, S)`` code row on the device, through the
        cache: a hit returns the cached row; a miss copies the row out of
        the memory map (the read the cache counts), checks its sha256 on
        the row's first read (``ArtifactError`` on a mismatch), moves it to
        the device and caches it."""
        row = self.cache.get(cid)
        if row is not None:
            return row
        if self._obs is not None:
            with self._obs.tracer.span("paged.fault", cluster=cid):
                row = self._fault_in(cid)
            self._obs_m[0].inc()
            self._obs_m[1].inc(row.nbytes)
        else:
            row = self._fault_in(cid)
        self.cache.put(cid, row)
        return row

    def _fault_in(self, cid: int) -> torch.Tensor:
        """The miss path of one row: the copy out of the memory map, the
        first-touch digest check, the move to the device."""
        host = np.array(self._cluster_codes[cid], copy=True)
        if self._row_digests is not None and not self._verified[cid]:
            t0 = time.perf_counter()
            if _array_digest(host) != self._row_digests[cid]:
                raise ArtifactError(f"cluster_codes[{cid}]: checksum "
                                    f"mismatch on first touch ({self.path})")
            self._verified[cid] = True
            self.verified_rows += 1
            if self._obs is not None:
                self._obs_m[2].add(time.perf_counter() - t0)
        return torch.from_numpy(host).to(self.device)

    def gather(self, cids: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The page buffer of a batch's probed clusters.

        Each distinct cluster of ``cids`` (Q, np) goes through
        :meth:`fetch_cluster` once, in ``np.unique`` order (so the cache
        counters follow the reference's for the same stream). The buffer
        holds every one of the U rows whatever the cache keeps: a row
        evicted later in the loop has already been taken.

        Returns
        -------
        tuple of torch.Tensor
            ``(rows (U, P, S) uint8, local (Q, np) with cids' dtype, the
            index of each probe's row in ``rows``, uniq (U,) int64, the
            cluster id of each row)``, on ``cids``' device.
        """
        host = cids.cpu().numpy()
        uniq, inv = np.unique(host, return_inverse=True)
        rows = torch.stack([self.fetch_cluster(c) for c in uniq.tolist()])
        dev = cids.device
        return (rows,
                torch.from_numpy(inv.reshape(host.shape)).to(dev, cids.dtype),
                torch.from_numpy(uniq.astype(np.int64)).to(dev))

    def fetch_vectors(self, ids) -> torch.Tensor:
        """Raw vectors of the exact-rerank tier: ``(Q, C)`` ids ->
        ``(Q, C, D)`` f32 on the device, read from the vector source
        (sentinel ids < 0 read row 0; the caller masks them by score)."""
        if self.vectors is None:
            raise RuntimeError("no raw-vector source attached "
                               "(PagedIndexData(vectors=...))")
        ids = ids.cpu().numpy() if isinstance(ids, torch.Tensor) \
            else np.asarray(ids)
        safe = np.clip(ids, 0, self.vectors.shape[0] - 1)
        return torch.from_numpy(np.array(self.vectors[safe], np.float32)
                                ).to(self.device)

    # ---- generation retargeting ------------------------------------------
    def adopt_cache(self, cache: ClusterCache) -> None:
        """Take over ``cache`` for this generation: its rows are dropped
        (they belong to the generation that read them), its capacity and
        counters are kept."""
        cache.clear()
        self.cache = cache

    def stats(self) -> dict:
        """The cache's counters, the shard bytes, the rows verified so far
        and the generation's path."""
        out = self.cache.stats()
        out.update({"cluster_bytes": self.cluster_bytes,
                    "verified_rows": self.verified_rows,
                    "generation": self.path})
        return out


class PagedJunoIndex(MutableIndexBase):
    """Mutable serving wrapper over a :class:`PagedIndexData` generation.

    The code rows on disk are read-only, so every insert goes to the side
    buffer (the free lists stay empty) and a deleted slot is never reused:
    a delete tombstones the resident validity, which the scans gather at
    scoring time, so a cached row needs no invalidation. ``compact()``
    moves nothing; the next generation comes from an offline rebuild
    (:meth:`swap_data`). With the freshness tiers on
    (``enable_tiers(max_minors, minor_store=...)``) a full L0 is committed
    as a minor artifact and faulted back in on first search touch.
    """

    def __init__(self, paged: PagedIndexData, *, side_capacity: int = 256):
        """Wrap one paged generation; ``side_capacity`` is the only insert
        room between generations."""
        self.paged = paged
        self._adopt(paged)
        self._init_bookkeeping(
            self.data.ivf.valid, self.data.ivf.point_ids,
            side_capacity=side_capacity, first_new_id=paged.first_new_id,
            n_subspaces=int(paged.meta.cluster_codes.shape[-1]))
        self._seal_clusters()

    def _adopt(self, paged: PagedIndexData) -> None:
        # deletes write the validity in place: this index's own copy
        meta = paged.meta
        self.data = meta._replace(
            ivf=meta.ivf._replace(valid=meta.ivf.valid.clone()))
        self.rt_grid = paged.rt_grid

    def _seal_clusters(self) -> None:
        # read-only rows: no cluster slot is ever an insert target
        self._free = [[] for _ in self._free]

    def _labels_codes(self, pts):
        return _label_encode(pts, self.data.ivf, self.data.codebook)

    def _rt_centroids(self):
        return self.data.ivf.centroids

    def _apply_insert(self, cl, sl, ids, codes):
        raise RuntimeError(
            "paged cluster rows are read-only; inserts must land in the "
            "side buffer (this indicates a bookkeeping bug)")

    def _apply_delete(self, cl, sl):
        dev = self.data.ivf.valid.device
        self.data.ivf.valid[torch.as_tensor(cl, device=dev),
                            torch.as_tensor(sl, device=dev)] = False

    def delete(self, ids) -> int:
        """Tombstone points by global id (``MutableIndexBase.delete``); the
        freed slots stay dead until the next generation."""
        n = super().delete(ids)
        self._seal_clusters()
        return n

    def ensure_rt_grid(self, *, metric: str = "l2", **kw) -> CentroidGrid:
        """The artifact's rt grid. A paged index cannot build one (the
        calibration decodes every code): without a saved grid this raises
        ``RuntimeError``."""
        if self.rt_grid is None:
            raise RuntimeError(
                "paged serving cannot build an rt grid lazily (calibration "
                "decodes every point); save the grid into the artifact: "
                "save_index(path, data, config, rt_grid=build_grid(...))")
        return self.rt_grid

    def swap_data(self, new_data, *, side_capacity: int | None = None
                  ) -> None:
        """Retarget serving to the next paged generation.

        ``new_data`` must be a :class:`PagedIndexData`. It adopts the
        current cache (rows dropped, counters kept), so no request after
        the swap reads the old generation's rows; the bookkeeping is
        rederived, the side buffer resets, the id counter never goes
        backwards and the rt grid becomes the new artifact's.
        """
        if not isinstance(new_data, PagedIndexData):
            raise TypeError(
                f"a paged index swaps to a new PagedIndexData generation, "
                f"got {type(new_data).__name__} (build the artifact "
                f"offline and wrap it)")
        new_data.adopt_cache(self.paged.cache)
        first_new = max(self._next_id, new_data.first_new_id)
        self.paged = new_data
        self._adopt(new_data)
        self._init_bookkeeping(
            self.data.ivf.valid, self.data.ivf.point_ids,
            side_capacity=(self.side.capacity if side_capacity is None
                           else side_capacity),
            first_new_id=first_new,
            n_subspaces=int(new_data.meta.cluster_codes.shape[-1]))
        self._seal_clusters()

    def scan_view(self, cids: torch.Tensor):
        """The scan view of a batch (``core/juno.py``): the page buffer,
        its rows' current validity and the local indices."""
        rows, local, uniq = self.paged.gather(cids)
        return rows, self.data.ivf.valid[uniq], local

    def search(self, queries, *, prefilter: str = "scan", **kw):
        """``core.juno.search`` over the paged tier: stage A over the
        resident tier, the page buffer through the cache, the same scoring
        tail as resident search (so the same results), delta tiers
        included. ``prefilter="rt"`` needs the artifact's grid."""
        if prefilter == "rt" and kw.get("rt_grid") is None:
            kw["rt_grid"] = self.ensure_rt_grid()
        return search(self.data, queries, side=self.delta_view(),
                      prefilter=prefilter, gather=self.scan_view, **kw)


class PagedAnnServeEngine(AnnServeEngine):
    """An :class:`~repro_torch.serve.ann.AnnServeEngine` over a paged index.

    The request plane is the resident engine's; :meth:`_dispatch` runs
    each batch over the page buffer and, with ``exact_rerank=C > 0``,
    widens the search to C candidates and scores them exactly from the raw
    vectors (squared l2 distances or inner products). Mutations follow
    :class:`PagedJunoIndex`; ``swap_index`` needs the next generation.
    """

    def __init__(self, index, *, exact_rerank: int = 0,
                 side_capacity: int = 256, minor_store=None,
                 minor_name: str = "minors", **kw):
        """Wrap a paged index (a bare :class:`PagedIndexData` is wrapped in
        a :class:`PagedJunoIndex`).

        Parameters
        ----------
        index : PagedIndexData or PagedJunoIndex
            The generation to serve.
        exact_rerank : int
            Candidate budget C of the exact rerank (0 disables it); needs
            ``PagedIndexData(vectors=...)``.
        side_capacity : int
            Side-buffer capacity when wrapping a bare ``PagedIndexData``.
        minor_store : repro_torch.build.ArtifactStore, optional
            With ``max_minors > 0``, promoted minors are committed here and
            faulted back in on first search touch.
        minor_name : str
            Store name of the minors.
        **kw
            The remaining :class:`AnnServeEngine` knobs.
        """
        if isinstance(index, PagedIndexData):
            index = PagedJunoIndex(index, side_capacity=side_capacity)
        if not isinstance(index, PagedJunoIndex):
            raise TypeError(f"PagedAnnServeEngine serves a PagedIndexData/"
                            f"PagedJunoIndex, got {type(index).__name__}")
        if exact_rerank and index.paged.vectors is None:
            raise ValueError("exact_rerank needs a raw-vector source: "
                             "PagedIndexData(vectors=...)")
        self.exact_rerank = int(exact_rerank)
        if minor_store is not None:
            index._minor_sink = (minor_store, minor_name)
        super().__init__(index, side_capacity=side_capacity, **kw)
        if self.obs is not None:
            index.paged.bind_obs(self.obs)

    def _dispatch(self, qb, k, mode, nprobe, side):
        """One padded batch in three spans: stage A over the resident tier
        (``paged.filter``), the page buffer of its probed clusters
        (``paged.gather``) and the scoring tail over it (``paged.score``);
        with the exact rerank, ``min(max(k, C), nprobe·P)`` candidates
        rescored to the top k."""
        p = self.index.data.ivf.point_ids.shape[1]
        kq = (min(max(k, self.exact_rerank), nprobe * p)
              if self.exact_rerank else k)
        q = qb.float()
        with self._span("paged.filter", nprobe=nprobe):
            base, cids = self._filter(q, nprobe)
        with self._span("paged.gather"):
            view = self.index.scan_view(cids)
        with self._span("paged.score", mode=mode):
            s, ids = self._score(q, base, cids, k, mode, side, k_search=kq,
                                 view=view)
        if self.exact_rerank:
            s, ids = self._rerank_exact(qb, ids, k)
        return s, ids

    def _rerank_exact(self, qb: torch.Tensor, cand_ids: torch.Tensor,
                      k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Score the candidates exactly from their raw vectors and keep the
        top k (``lax.top_k`` order: a stable sort); sentinel ids (< 0)
        score +inf (l2) or -inf (ip)."""
        vecs = self.index.paged.fetch_vectors(cand_ids)          # (Q, C, D)
        ok = cand_ids >= 0
        higher_better = self.metric != "l2"
        if higher_better:
            d = torch.einsum("qcd,qd->qc", vecs, qb)
        else:
            d = ((vecs - qb[:, None, :]) ** 2).sum(-1)
        d = torch.where(ok, d, float("-inf") if higher_better
                        else float("inf"))
        s, order = _top_k(d, k, higher_better)
        return s, torch.gather(cand_ids, 1, order)

    def compact(self, *, rebuild: bool | str = "auto") -> int:
        """Merge work only, never a rebuild in process: ``rebuild=True``
        raises (build the next generation offline and :meth:`swap_index`
        it). With the freshness tiers on the scheduler drains, promoting a
        stuck L0 into a minor artifact; otherwise nothing moves."""
        if rebuild is True:
            raise RuntimeError(
                "paged serving cannot rebuild in-process; build the next "
                "generation offline (ArtifactStore.put) and swap_index() "
                "a new PagedIndexData")
        if self.scheduler is not None:
            return self.scheduler.drain()
        return self.index.compact()

    def swap_index(self, new_data=None) -> int:
        """Swap to the next artifact generation (a :class:`PagedIndexData`,
        required: there is no in-process rebuild); the cache is retargeted
        with its rows dropped. Returns the new engine generation."""
        if new_data is None:
            raise RuntimeError(
                "paged serving cannot rebuild in-process; pass a "
                "PagedIndexData over the next artifact generation")
        gen = super().swap_index(new_data)
        if self.obs is not None:
            # the adopted cache keeps its registry handles; the new
            # generation's fetch plane needs its own binding
            self.index.paged.bind_obs(self.obs)
        return gen

    def cache_stats(self) -> dict:
        """The paged tier's counters (:meth:`PagedIndexData.stats`)."""
        return self.index.paged.stats()
