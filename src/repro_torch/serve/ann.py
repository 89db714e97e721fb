"""Online ANN query serving over tiers H, M, L and H2.

Port of ``repro/serve/ann.py`` (``AnnRequest``, ``AnnServeEngine``:
``submit``, ``route``, ``step``, ``run``, ``insert``, ``delete``,
``compact``, ``swap_index``, ``latency_stats``). Requests
queue FIFO; each engine tick drains ONE group of requests that resolve to
the same signature ``(k, mode, nprobe)`` into one search call:

* **Knob quantization** — k and nprobe round up onto ``K_BUCKETS`` and
  ``NPROBE_BUCKETS``, so arbitrary client knobs map onto a small set of
  batch shapes.
* **Size-bucketed batching** — a group is padded up to the next
  ``BATCH_BUCKETS`` entry with copies of its last row (in-distribution
  work whose results are sliced off); a group larger than the top bucket
  runs in top-bucket chunks.
* **Recall-target routing** — ``mode="auto"`` requests route by
  ``recall_target`` through ``ROUTES``: H (≥ 0.9), H2 (≥ 0.8), M (≥ 0.5),
  L below.
* **Fused serving** (``fused=True``) — the H and H2 tiers fold onto one
  fused-H2 signature with rerank budget ``FUSED_RERANK_MULT · k``. With
  ``fused=False`` (the default, as in the reference) H runs the masked
  ADC scan and H2 the composed hit count → rerank of C = 4k.
* **RT-prefilter serving** (``prefilter="rt"``) — every search prunes
  probes by the sphere test (``rt/``; fused H2 through the three-stage
  kernel), and the router shrinks each request's probe budget to the
  smallest ``RT_NPROBE_BUCKETS`` entry covering its queries' last
  surviving probe (``rt.probe_budget``, host numpy, once a request and
  again after each insert batch, which grows the grid's reaches).
* **Mutation plane** — the engine owns a
  :class:`~repro_torch.core.juno.MutableIndexBase` (a bare index is
  wrapped in a ``MutableJunoIndex``, which copies it; a wrapper passed in,
  such as the paged tier's ``PagedJunoIndex``, is shared): ``insert``,
  ``delete`` and ``compact`` run between ticks with no change to any
  search shape (the delta tiers ride along as one fixed-capacity side
  buffer); ``swap_index`` installs a rebuilt index; with ``max_minors``
  a ``MergeScheduler`` folds the freshness tiers back between ticks.
* **Observability** (``obs=``) — an ``obs.Observability`` bundle: the
  ``juno_engine_*`` series in its registry, an ``engine.tick`` span a
  tick with ``engine.rt_probe``, ``engine.dispatch`` and ``engine.merge``
  children and a retro-stamped ``engine.enqueue`` a request, and its
  recall probe fed a sample of the served requests. It is host-side
  bookkeeping only: no device synchronisation, no device tensor, no
  kernel, and the same ids and scores as with it off. On the card a
  search call returns once its kernels are queued, so an
  ``engine.dispatch`` span times the host's enqueue, not the device;
  the wait shows up in ``engine.merge``, at the device→host copy of the
  tick's results.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core.freshness import MergeScheduler
from ..core.ivf import filter_clusters
from ..core.juno import (JunoIndexData, MutableIndexBase, MutableJunoIndex,
                         _score_probed, _score_probed_two_stage)
from ..rt import grid as rt_lib


@dataclasses.dataclass
class AnnRequest:
    """One queued search request (inputs + engine-filled results).

    The engine stamps ``t_submit`` (queued) → ``t_batch`` (picked into a
    tick's batch) → ``t_compute`` (the tick's results on the host) →
    ``t_done`` (results sliced back onto the request).
    """

    rid: int
    queries: np.ndarray                 # (q, D) f32
    k: int = 10
    mode: str = "auto"                  # "H" | "M" | "L" | "H2" | "auto"
    nprobe: int = 0                     # 0 → engine default for the mode
    recall_target: float = 0.9          # router input when mode == "auto"
    rt_probes: int = -1                 # cached rt probe budget (-1 unset)
    rt_epoch: int = -1                  # index rt_mutations the cache is for
    scores: Optional[np.ndarray] = None
    ids: Optional[np.ndarray] = None
    done: bool = False
    t_submit: float = 0.0
    t_batch: float = 0.0
    t_compute: float = 0.0
    t_done: float = 0.0

    @property
    def latency(self) -> float:
        """Submit → completion wall time in seconds."""
        return self.t_done - self.t_submit


class AnnServeEngine:
    """Dynamic-batching ANN serving engine over a mutable JUNO index."""

    K_BUCKETS = (10, 100)
    NPROBE_BUCKETS = (4, 8, 16, 32)
    # the lattice the rt shrink may route down onto: explicit client knobs
    # still quantize to NPROBE_BUCKETS
    RT_NPROBE_BUCKETS = (2,) + NPROBE_BUCKETS
    BATCH_BUCKETS = (8, 32, 128)
    MODE_NPROBE = {"L": 8, "M": 8, "H2": 16, "H": 16}
    # recall_target lower bound → mode, checked in order
    ROUTES = ((0.9, "H"), (0.8, "H2"), (0.5, "M"), (0.0, "L"))
    # fused serving: rerank budget C = FUSED_RERANK_MULT · k
    FUSED_RERANK_MULT = 32

    def __init__(self, index: JunoIndexData | MutableIndexBase, *,
                 metric: str = "l2", thres_scale: float = 1.0,
                 side_capacity: int = 256,
                 batch_buckets: tuple[int, ...] | None = None,
                 fused: bool = False, fused3: bool | None = None,
                 prefilter: str = "scan", rt_scale: float = 1.0,
                 rt_grid: rt_lib.CentroidGrid | None = None,
                 max_minors: int = 0, merge_clusters_per_step: int = 32,
                 obs=None):
        """Wrap an index (mutable or not) in a serving engine.

        Parameters
        ----------
        index : JunoIndexData or MutableIndexBase
            The index to serve; searches run on its device. A bare
            ``JunoIndexData`` is wrapped in a ``MutableJunoIndex``, which
            owns a copy of the tensors a mutation writes: the caller's
            index, and any other engine over it, is left as it was. A
            mutable index passed in is shared.
        metric : str
            "l2" | "ip".
        thres_scale : float
            Threshold multiplier forwarded to every search.
        side_capacity : int
            Side-buffer capacity when wrapping a bare index.
        batch_buckets : tuple of int, optional
            Batch sizes the groups pad up to (default ``BATCH_BUCKETS``).
        fused : bool
            Serve tier H2 through the fused kernel and fold tier H into it
            (rerank ``FUSED_RERANK_MULT · k``); ``False`` serves H by the
            masked ADC scan and H2 composed (C = 4k).
        fused3 : bool, optional
            With ``fused=True`` and ``prefilter="rt"``, ``None`` serves H2
            through the three-stage kernel and ``False`` through the RT
            probe mask composed with the two-stage kernel (same results).
        prefilter : str
            "scan" | "rt". With "rt" every search prunes probes by the
            sphere test and the router shrinks each request's probe
            budget (see the module docstring).
        rt_scale : float
            Radius knob for "rt" (monotone; large values prune nothing).
        rt_grid : repro_torch.rt.CentroidGrid, optional
            A grid to attach to the index for "rt"; ``None`` builds one
            from the index when "rt" needs it (``ensure_rt_grid``).
        max_minors : int
            With a value > 0, turn on the LSM freshness tiers
            (``core/freshness.py``): a full side buffer is promoted into one
            of up to ``max_minors`` minor generations instead of refusing
            inserts, and a ``MergeScheduler`` folds them back between
            ticks. 0 (default) keeps the single side buffer.
        merge_clusters_per_step : int
            Fold budget per between-ticks merge step (clusters).
        obs : repro_torch.obs.Observability or bool, optional
            Observability bundle (``True`` makes a fresh one; default off):
            the ``juno_engine_*`` series, the engine spans and the recall
            probe's samples (see the module docstring); the merge
            scheduler's ``juno_merge_*`` series go to its registry too.
        """
        if prefilter not in ("scan", "rt"):
            raise ValueError(f"unknown prefilter {prefilter!r}")
        self.index = (index if isinstance(index, MutableIndexBase)
                      else MutableJunoIndex(index,
                                            side_capacity=side_capacity))
        if rt_grid is not None:
            self.index.rt_grid = rt_grid
        self.fused = fused
        self.fused3 = fused3
        self.prefilter = prefilter
        self.rt_scale = rt_scale
        self.metric = metric
        self.thres_scale = thres_scale
        #: (grid, routing_state, rt_mutations) of the last route(); the
        #: grid's identity and the mutation count invalidate it
        self._rt_state = None
        if prefilter == "rt":
            self.index.ensure_rt_grid(metric=metric)
        if obs is True:
            from ..obs import Observability
            obs = Observability()
        self.obs = obs or None
        #: signatures dispatched so far (juno_engine_jit_retraces_total)
        self._obs_sigs: set = set()
        #: between-ticks merge scheduler when the freshness tiers are on
        self.scheduler = None
        if max_minors:
            self.index.enable_tiers(max_minors)
            self.scheduler = MergeScheduler(
                self.index, clusters_per_step=merge_clusters_per_step,
                registry=self.obs.registry if self.obs else None)
        self.batch_buckets = tuple(batch_buckets or self.BATCH_BUCKETS)
        self.queue: collections.deque[AnnRequest] = collections.deque()
        self.completed: list[AnnRequest] = []
        self._rid = 0
        #: bumped by every swap_index(); later results come from the new
        #: index generation
        self.generation = 0
        self.stats = {"queries": 0, "requests": 0, "ticks": 0,
                      "padded_rows": 0, "inserts": 0, "deletes": 0,
                      "swaps": 0, "signatures": collections.Counter()}

    @property
    def rt_grid(self) -> rt_lib.CentroidGrid | None:
        """The centroid grid attached to the served index, if any."""
        return self.index.rt_grid

    def _span(self, name: str, trace_id: str | None = None, **attrs):
        """A tracer span when obs is on; a no-op context otherwise."""
        if self.obs is None:
            return contextlib.nullcontext()
        return self.obs.tracer.span(name, trace_id=trace_id, **attrs)

    def submit(self, queries, *, k: int = 10, mode: str = "auto",
               nprobe: int = 0, recall_target: float = 0.9) -> AnnRequest:
        """Enqueue a search request; ``step``/``run`` fills its results.

        Parameters
        ----------
        queries : array-like
            (q, D) f32 query rows (a single (D,) vector is promoted).
        k : int
            Results per query (rounded up to a ``K_BUCKETS`` entry).
        mode : str
            "H" | "M" | "L" | "H2", or "auto" to route by ``recall_target``.
        nprobe : int
            Explicit probe budget; 0 uses the mode default.
        recall_target : float
            Router input for ``mode="auto"``.

        Returns
        -------
        AnnRequest
            The queued request.
        """
        req = AnnRequest(rid=self._rid, queries=np.atleast_2d(
            np.asarray(queries, np.float32)), k=k, mode=mode, nprobe=nprobe,
            recall_target=recall_target, t_submit=time.perf_counter())
        self._rid += 1
        self.queue.append(req)
        return req

    @property
    def queued_rows(self) -> int:
        """Total query rows waiting in the queue (a router's load signal)."""
        return sum(r.queries.shape[0] for r in self.queue)

    def route(self, req: AnnRequest) -> tuple[int, str, int]:
        """Resolve a request's knobs to one signature ``(k, mode, nprobe)``.

        With ``fused=True`` the H tier folds into H2, so H and H2 requests
        batch together. With ``prefilter="rt"`` the probe budget shrinks to
        the smallest ``RT_NPROBE_BUCKETS`` entry covering the request's
        last surviving probe (``rt.probe_budget``, computed once a request
        and cached in ``req.rt_probes`` until the next insert batch).
        """
        mode = req.mode
        if mode == "auto":
            mode = next(m for lo, m in self.ROUTES if req.recall_target >= lo)
        if self.fused and mode == "H":
            mode = "H2"
        k = next((b for b in self.K_BUCKETS if b >= req.k), None) or req.k
        nprobe = req.nprobe or self.MODE_NPROBE[mode]
        nprobe = next((b for b in self.NPROBE_BUCKETS if b >= nprobe),
                      self.NPROBE_BUCKETS[-1])
        if self.prefilter == "rt":
            muts = self.index.rt_mutations
            if req.rt_probes < 0 or req.rt_epoch != muts:
                # a cached budget holds only for the index state it was
                # computed on: inserts grow reaches, so a pre-insert budget
                # could under-probe fresh points
                grid = self.index.ensure_rt_grid(metric=self.metric)
                if (self._rt_state is None or self._rt_state[0] is not grid
                        or self._rt_state[2] != muts):
                    self._rt_state = (grid, rt_lib.routing_state(
                        grid, self.index.data), muts)
                with self._span("engine.rt_probe", trace_id=str(req.rid),
                                rows=req.queries.shape[0]):
                    # the routing state holds all that the budget reads
                    # of the index: ``data`` is read once an epoch (a
                    # sharded index builds it on the host at each read)
                    req.rt_probes = int(rt_lib.probe_budget(
                        grid, None, req.queries,
                        metric=self.metric, scale=self.rt_scale,
                        thres_scale=self.thres_scale, max_probes=nprobe,
                        state=self._rt_state[1]).max())
                req.rt_epoch = muts
            shrunk = next((b for b in self.RT_NPROBE_BUCKETS
                           if b >= max(req.rt_probes, 1)),
                          self.RT_NPROBE_BUCKETS[-1])
            nprobe = min(nprobe, shrunk)
        return k, mode, min(nprobe, self.index.n_clusters)

    def step(self) -> int:
        """Serve one signature group. Returns the number of query rows."""
        if not self.queue:
            return 0
        if self.obs is not None:
            # sampled at tick entry; "sum" adds replicas' backlogs
            self.obs.registry.gauge("juno_engine_queue_rows",
                                    agg="sum").set(self.queued_rows)
        with self._span("engine.tick"):
            return self._step_inner()

    def _step_inner(self) -> int:
        """One tick's pick → dispatch → merge (inside the tick span)."""
        sig = self.route(self.queue[0])
        max_rows = self.batch_buckets[-1]
        # one FIFO pass: take head-signature requests until the batch
        # budget closes; everything else keeps its order for later ticks
        picked, rest, rows, closed = [], [], 0, False
        for req in self.queue:
            if closed or self.route(req) != sig:
                rest.append(req)
                continue
            if picked and rows + req.queries.shape[0] > max_rows:
                closed = True
                rest.append(req)
                continue
            picked.append(req)
            rows += req.queries.shape[0]
        self.queue = collections.deque(rest)
        t_batch = time.perf_counter()

        k, mode, nprobe = sig
        batch = np.concatenate([r.queries for r in picked], axis=0)
        dev = self.index.device
        # an empty delta tier is left out of the search; with the tiers on
        # this is the fixed-capacity L0 ⊕ minors view
        side = self.index.delta_view()
        out_s, out_i = [], []
        for lo in range(0, rows, max_rows):
            chunk = batch[lo:lo + max_rows]
            n = chunk.shape[0]
            bucket = next(b for b in self.batch_buckets if b >= n)
            if n < bucket:
                chunk = np.pad(chunk, ((0, bucket - n), (0, 0)), mode="edge")
            if self.obs is not None:
                self._observe_dispatch(k, mode, nprobe, bucket, n)
            with self._span("engine.dispatch", mode=mode, k=k,
                            nprobe=nprobe, bucket=bucket, rows=n):
                s, ids = self._dispatch(torch.from_numpy(chunk).to(dev), k,
                                        mode, nprobe, side)
            out_s.append(s[:n])
            out_i.append(ids[:n])
            self.stats["padded_rows"] += bucket - n
            self.stats["signatures"][(k, mode, nprobe, bucket)] += 1

        with self._span("engine.merge", requests=len(picked)):
            # the device→host copy: on the card the tick's kernels end here
            s = torch.cat(out_s).cpu().numpy()
            ids = torch.cat(out_i).cpu().numpy()
            t_compute = time.perf_counter()
            off, now = 0, time.perf_counter()
            for req in picked:
                q = req.queries.shape[0]
                req.scores = s[off:off + q, :req.k]
                req.ids = ids[off:off + q, :req.k]
                req.t_batch, req.t_compute = t_batch, t_compute
                req.done, req.t_done = True, now
                off += q
                self.completed.append(req)
        self.stats["queries"] += rows
        self.stats["requests"] += len(picked)
        self.stats["ticks"] += 1
        if self.obs is not None:
            self._observe_served(picked, mode, rows)
        if self.scheduler is not None:
            # one bounded merge step between ticks
            self.scheduler.maybe_step()
        return rows

    def _dispatch(self, qb: torch.Tensor, k: int, mode: str, nprobe: int,
                  side):
        """Run one padded batch through the search of its tier: stage A,
        then :meth:`_score`."""
        q = qb.float()
        base, cids = self._filter(q, nprobe)
        return self._score(q, base, cids, k, mode, side)

    def _filter(self, q: torch.Tensor, nprobe: int):
        """Stage A of one batch over the served index's centroids:
        ``(base, cids)`` (Q, nprobe), as ``core.ivf.filter_clusters``."""
        return filter_clusters(q, self.index.data.ivf, nprobe=nprobe,
                               metric=self.metric)

    def _score(self, q: torch.Tensor, base: torch.Tensor, cids: torch.Tensor,
               k: int, mode: str, side, *, k_search: int | None = None,
               view=None):
        """The scoring tail of one batch over stage A's ``base``/``cids``:
        ``k_search`` results (default ``k``; the fused rerank budget stays
        ``FUSED_RERANK_MULT · k``), the scans reading ``view`` when given
        (the paged engine's page buffer)."""
        grid = (self.index.ensure_rt_grid(metric=self.metric)
                if self.prefilter == "rt" else None)
        kw = dict(k=k_search or k, metric=self.metric,
                  thres_scale=self.thres_scale, side=side,
                  prefilter=self.prefilter, rt_grid=grid,
                  rt_scale=self.rt_scale, view=view)
        if mode == "H2":
            return _score_probed_two_stage(
                self.index.data, q, base, cids, fused=self.fused,
                fused3=self.fused3,
                rerank=self.FUSED_RERANK_MULT * k if self.fused else 0, **kw)
        return _score_probed(self.index.data, q, base, cids, mode=mode, **kw)

    def _observe_dispatch(self, k: int, mode: str, nprobe: int, bucket: int,
                          n: int) -> None:
        """Per-dispatch series: the batch's fill and
        ``juno_engine_jit_retraces_total``, which keeps the reference's
        name (its jit compiles a program a signature) and here counts the
        first dispatch of each ``(k, mode, nprobe, bucket)`` signature."""
        reg = self.obs.registry
        reg.histogram("juno_engine_batch_fill_ratio", lo=1e-3, hi=1.0,
                      mode=mode).add(n / bucket)
        sig = (k, mode, nprobe, bucket)
        if sig not in self._obs_sigs:
            self._obs_sigs.add(sig)
            reg.counter("juno_engine_jit_retraces_total").inc()

    def _observe_served(self, picked: list, mode: str, rows: int) -> None:
        """Per-tick series and spans: the tick, query and per-tier request
        counters, the request latency histograms (the registry form of
        :meth:`latency_stats`) and their queue/compute/merge segments, one
        retro-stamped ``engine.enqueue`` span a request (submit → batch),
        and the recall probe's sample."""
        reg, tracer = self.obs.registry, self.obs.tracer
        reg.counter("juno_engine_ticks_total").inc()
        reg.counter("juno_engine_queries_total").inc(rows)
        reg.counter("juno_engine_requests_total", mode=mode).inc(len(picked))
        lat = reg.histogram("juno_engine_request_seconds", mode=mode)
        h_queue = reg.histogram("juno_engine_queue_seconds")
        h_compute = reg.histogram("juno_engine_compute_seconds")
        h_merge = reg.histogram("juno_engine_merge_seconds")
        for req in picked:
            lat.add(req.latency)
            h_queue.add(req.t_batch - req.t_submit)
            h_compute.add(req.t_compute - req.t_batch)
            h_merge.add(req.t_done - req.t_compute)
            tracer.record("engine.enqueue", req.t_submit, req.t_batch,
                          trace_id=str(req.rid),
                          rows=req.queries.shape[0], mode=mode)
            if self.obs.recall is not None:
                self.obs.recall.observe(req, mode)

    def run(self, max_ticks: int = 100_000) -> int:
        """Drain the queue; returns total query rows served."""
        total = 0
        for _ in range(max_ticks):
            if not self.queue:
                break
            total += self.step()
        return total

    # ---- mutation plane (between ticks) ---------------------------------
    def insert(self, points) -> list[int]:
        """Insert a (B, D) point batch into the served index; returns the
        assigned global ids (see ``MutableIndexBase.insert``)."""
        ids = self.index.insert(points)
        self.stats["inserts"] += len(ids)
        if self.obs is not None:
            self.obs.registry.counter(
                "juno_engine_inserts_total").inc(len(ids))
        return ids

    def delete(self, ids) -> int:
        """Tombstone points by global id; returns how many were removed.
        An unknown or duplicated id raises before any state is touched."""
        n = self.index.delete(ids)
        self.stats["deletes"] += n
        if self.obs is not None:
            self.obs.registry.counter("juno_engine_deletes_total").inc(n)
        return n

    def compact(self, *, rebuild: bool | str = "auto") -> int:
        """Fold the delta tiers into the base, rebuilding only if needed.

        With the freshness tiers on, the merge scheduler drains (L0 into
        free base slots, a full L0 into a minor generation, generations
        into the base); without them, the side buffer folds into free
        slots. Then, with ``rebuild="auto"``, side points still stuck
        (their cluster full) trigger :meth:`swap_index`, so the side
        buffer always ends empty; ``True`` always rebuilds, ``False``
        never.

        Returns
        -------
        int
            Total points moved between tiers.
        """
        if self.scheduler is not None:
            moved = self.scheduler.drain()
        else:
            moved = self.index.compact()
        stuck = self.index.side_fill
        if rebuild is True or (rebuild == "auto" and stuck):
            self.swap_index()
            moved += stuck
        return moved

    def swap_index(self, new_data: JunoIndexData | None = None) -> int:
        """Install a rebuilt index between ticks (a hot swap).

        Requests served before the call saw the old generation; every
        later one (queued ones included) sees the new. The rt grid and
        the router's state are dropped and rebuilt at the next rt search.

        Parameters
        ----------
        new_data : JunoIndexData, optional
            The replacement index. Default: ``build.rebuild_index`` of the
            live state, which keeps every live point and the results. A
            caller's index replaces the state wholesale (mutations not in
            it are dropped).

        Returns
        -------
        int
            The new generation number.
        """
        if new_data is None:
            from ..build.rebuild import rebuild_index
            new_data = rebuild_index(self.index)
        self.index.swap_data(new_data)
        self._rt_state = None
        self.generation += 1
        self.stats["swaps"] += 1
        if self.obs is not None:
            self.obs.registry.counter("juno_engine_swaps_total").inc()
        return self.generation

    def latency_stats(self) -> dict:
        """Latency percentiles over completed requests (the registry's
        ``juno_engine_request_seconds`` histograms, with obs on, hold the
        same observations).

        Returns
        -------
        dict
            ``{"n", "p50", "p95", "p99", "max"}`` in seconds (submit →
            done), or ``{"n": 0}`` when nothing has completed.
        """
        lats = sorted(r.latency for r in self.completed)
        if not lats:
            return {"n": 0}
        pick = lambda p: lats[min(len(lats) - 1, int(p * len(lats)))]  # noqa: E731
        return {"n": len(lats), "p50": pick(0.5), "p95": pick(0.95),
                "p99": pick(0.99), "max": lats[-1]}
