"""Online ANN query serving over tiers H, M, L and H2.

Port of ``repro/serve/ann.py`` (``AnnRequest``, ``AnnServeEngine``:
``submit``, ``route``, ``step``, ``run``, ``latency_stats``). Requests
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
  surviving probe (``rt.probe_budget``, host numpy, once a request).

Mutation (and with it the router's mutation epochs), the freshness tiers,
observability and index swaps are later slices (ROADMAP.md).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core.juno import JunoIndexData, _search_batch, _search_batch_two_stage
from ..rt import grid as rt_lib


@dataclasses.dataclass
class AnnRequest:
    """One queued search request (inputs + engine-filled results).

    The engine stamps ``t_submit`` (queued) → ``t_batch`` (picked into a
    tick's batch) → ``t_compute`` (search returned, on the host) →
    ``t_done`` (results sliced back onto the request).
    """

    rid: int
    queries: np.ndarray                 # (q, D) f32
    k: int = 10
    mode: str = "auto"                  # "H" | "M" | "L" | "H2" | "auto"
    nprobe: int = 0                     # 0 → engine default for the mode
    recall_target: float = 0.9          # router input when mode == "auto"
    rt_probes: int = -1                 # cached rt probe budget (-1 unset)
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
    """Dynamic-batching ANN serving engine over a JUNO index."""

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

    def __init__(self, index: JunoIndexData, *, metric: str = "l2",
                 thres_scale: float = 1.0,
                 batch_buckets: tuple[int, ...] | None = None,
                 fused: bool = False, fused3: bool | None = None,
                 prefilter: str = "scan", rt_scale: float = 1.0,
                 rt_grid: rt_lib.CentroidGrid | None = None):
        """Wrap a built or loaded index in a serving engine.

        Parameters
        ----------
        index : JunoIndexData
            The index to serve; searches run on its device.
        metric : str
            "l2" | "ip".
        thres_scale : float
            Threshold multiplier forwarded to every search.
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
            The grid for "rt"; ``None`` builds one from the index
            (``rt.build_grid``), as the reference's ``ensure_rt_grid``
            does.
        """
        if prefilter not in ("scan", "rt"):
            raise ValueError(f"unknown prefilter {prefilter!r}")
        self.index = index
        self.fused = fused
        self.fused3 = fused3
        self.prefilter = prefilter
        self.rt_scale = rt_scale
        self.rt_grid = None
        #: host snapshot of what probe_budget reads (rt.routing_state)
        self._rt_state = None
        if prefilter == "rt":
            self.rt_grid = (rt_grid if rt_grid is not None
                            else rt_lib.build_grid(index, metric=metric))
            self._rt_state = rt_lib.routing_state(self.rt_grid, index)
        self.metric = metric
        self.thres_scale = thres_scale
        self.batch_buckets = tuple(batch_buckets or self.BATCH_BUCKETS)
        self.queue: collections.deque[AnnRequest] = collections.deque()
        self.completed: list[AnnRequest] = []
        self._rid = 0
        self.stats = {"queries": 0, "requests": 0, "ticks": 0,
                      "padded_rows": 0, "signatures": collections.Counter()}

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
        and cached in ``req.rt_probes``).
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
            if req.rt_probes < 0:
                req.rt_probes = int(rt_lib.probe_budget(
                    self.rt_grid, self.index, req.queries, metric=self.metric,
                    scale=self.rt_scale, thres_scale=self.thres_scale,
                    max_probes=nprobe, state=self._rt_state).max())
            shrunk = next((b for b in self.RT_NPROBE_BUCKETS
                           if b >= max(req.rt_probes, 1)),
                          self.RT_NPROBE_BUCKETS[-1])
            nprobe = min(nprobe, shrunk)
        return k, mode, min(nprobe, self.index.ivf.centroids.shape[0])

    def step(self) -> int:
        """Serve one signature group. Returns the number of query rows."""
        if not self.queue:
            return 0
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
        dev = self.index.ivf.centroids.device
        out_s, out_i = [], []
        for lo in range(0, rows, max_rows):
            chunk = batch[lo:lo + max_rows]
            n = chunk.shape[0]
            bucket = next(b for b in self.batch_buckets if b >= n)
            if n < bucket:
                chunk = np.pad(chunk, ((0, bucket - n), (0, 0)), mode="edge")
            s, ids = self._dispatch(torch.from_numpy(chunk).to(dev), k, mode,
                                    nprobe)
            out_s.append(s[:n].cpu().numpy())
            out_i.append(ids[:n].cpu().numpy())
            self.stats["padded_rows"] += bucket - n
            self.stats["signatures"][(k, mode, nprobe, bucket)] += 1
        t_compute = time.perf_counter()
        s, ids = np.concatenate(out_s), np.concatenate(out_i)

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
        return rows

    def _dispatch(self, qb: torch.Tensor, k: int, mode: str, nprobe: int):
        """Run one padded batch through the search of its tier."""
        kw = dict(nprobe=nprobe, k=k, metric=self.metric,
                  thres_scale=self.thres_scale, prefilter=self.prefilter,
                  rt_grid=self.rt_grid, rt_scale=self.rt_scale)
        if mode == "H2":
            return _search_batch_two_stage(
                self.index, qb, fused=self.fused, fused3=self.fused3,
                rerank=self.FUSED_RERANK_MULT * k if self.fused else 0, **kw)
        return _search_batch(self.index, qb, mode=mode, **kw)

    def run(self, max_ticks: int = 100_000) -> int:
        """Drain the queue; returns total query rows served."""
        total = 0
        for _ in range(max_ticks):
            if not self.queue:
                break
            total += self.step()
        return total

    def latency_stats(self) -> dict:
        """Latency percentiles over completed requests.

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
