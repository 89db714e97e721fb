"""Replica-fleet ANN serving with admission control and latency tracing.

Port of ``repro/serve/fleet.py``. :class:`AnnServeFleet` puts a
**replica group × shard group** topology on top of
:class:`~repro_torch.serve.ann.AnnServeEngine`:

* **Replicas** — each replica wraps one engine over its own copy of the
  index. A read goes to one replica; a write goes to every replica, and
  the deterministic slot bookkeeping gives every replica the same ids, so
  any replica answers any query the same way.
* **Shards** — with ``shards_per_replica > 1`` a replica's engine is a
  :class:`_ShardedAnnServeEngine` over a
  :class:`~repro_torch.dist.DistributedMutableIndex` on its own
  ``shards_per_replica`` entries of ``devices``, dispatching through the
  exact-merge ``make_distributed_search``.
* **Routing** — least outstanding rows: a request goes to the healthy
  replica whose engine has the fewest queued query rows.
* **Admission** — per-replica queues hold at most ``max_queue`` rows. When
  the least-loaded replica is full, ``policy="shed"`` marks the request
  with a typed :class:`Rejection` (never an exception) and
  ``policy="queue"`` parks it in a fleet backlog that drains as capacity
  frees. A request whose deadline passes while queued is dropped before
  any compute, with a ``"deadline"`` rejection.
* **Latency** — each served request's arrival → batch → compute → done
  chain (stamped by the engine tick) feeds a log-bucketed
  :class:`LatencyHistogram` and per-segment sums; with ``obs=`` the
  ``juno_fleet_*`` series and a ``fleet.request`` span a request go to
  the fleet's registry and tracer, under the reference's names.

Failover is a routing state: :meth:`AnnServeFleet.fail_replica` takes a
replica out of rotation and re-admits its queued requests to the others,
whose results are the same (the replicas hold the same state).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from ..core.juno import JunoIndexData
from ..obs import Histogram as _ObsHistogram
from .ann import AnnRequest, AnnServeEngine


class LatencyHistogram(_ObsHistogram):
    """Streaming log-bucketed latency histogram: ``obs.Histogram`` under
    the fleet's name (fixed memory, fail-closed ``merge`` on bucket edges,
    ``percentile`` the conservative upper bucket edge clamped to the
    observed max)."""


@dataclasses.dataclass(frozen=True)
class Rejection:
    """Typed admission verdict on a shed or expired request.

    ``reason`` is ``"queue_full"`` (every healthy replica at ``max_queue``
    under ``policy="shed"``), ``"deadline"`` (expired while queued, dropped
    before compute) or ``"no_replica"`` (every replica down).
    """

    reason: str
    detail: str = ""


@dataclasses.dataclass
class FleetRequest:
    """One fleet request: the routing envelope around an ``AnnRequest``.

    ``status`` goes ``"queued" → "done"``, or ends ``"shed"`` or
    ``"expired"`` with :attr:`rejection` set. ``t_arrival`` defaults to the
    submit time; an open-loop load generator passes the intended arrival
    time, so a server that falls behind is charged its schedule slip.
    """

    rid: int
    queries: np.ndarray
    k: int = 10
    mode: str = "auto"
    nprobe: int = 0
    recall_target: float = 0.9
    deadline: Optional[float] = None     # absolute perf_counter() time
    t_arrival: float = 0.0
    replica: int = -1
    status: str = "queued"               # queued | done | shed | expired
    rejection: Optional[Rejection] = None
    inner: Optional[AnnRequest] = None

    @property
    def done(self) -> bool:
        """True once the request was served (not shed or expired)."""
        return self.status == "done"

    @property
    def ids(self) -> Optional[np.ndarray]:
        """(q, k) result ids, or None unless served."""
        return self.inner.ids if self.status == "done" else None

    @property
    def scores(self) -> Optional[np.ndarray]:
        """(q, k) result scores, or None unless served."""
        return self.inner.scores if self.status == "done" else None

    def trace(self) -> dict:
        """Per-segment seconds of a served request: ``queue`` (arrival →
        batch), ``compute`` (batch → results on the host), ``merge``
        (→ sliced onto the request) and ``total``; ``{}`` unless done."""
        if self.status != "done" or self.inner is None:
            return {}
        i = self.inner
        return {"queue": i.t_batch - self.t_arrival,
                "compute": i.t_compute - i.t_batch,
                "merge": i.t_done - i.t_compute,
                "total": i.t_done - self.t_arrival}


class _ShardedAnnServeEngine(AnnServeEngine):
    """An engine whose dispatch is cluster-sharded over its own devices.

    The served index is a :class:`~repro_torch.dist.DistributedMutableIndex`
    and every batch runs through ``make_distributed_search(...,
    with_side=True)`` with the tick's delta view (``None`` when every tier
    is empty; the reference always passes one, since ``shard_map`` needs a
    fixed signature); the request plane is the engine's. A resolved ``nprobe`` runs as ``ceil(nprobe /
    n_shards)`` probes a shard, and H2 reranks ``FUSED_RERANK_MULT · k``,
    as in the reference. Fused and rt serving are not wired (ValueError).
    """

    def __init__(self, index: JunoIndexData, devices, *,
                 side_capacity: int = 256, **kw):
        """Build the replica engine over ``devices``, one entry a shard."""
        from ..dist import DistributedMutableIndex
        if kw.get("fused") or kw.get("prefilter", "scan") != "scan":
            raise ValueError("sharded fleet replicas serve the composed "
                             "scan path only (fused/rt not wired)")
        super().__init__(DistributedMutableIndex(
            index, devices, side_capacity=side_capacity), **kw)

    def _dispatch(self, qb, k, mode, nprobe, side):
        """One padded batch through the distributed search."""
        from ..dist import make_distributed_search
        fn = make_distributed_search(
            self.index.devices, max(1, math.ceil(nprobe / self.index.n_shards)),
            k, mode=mode, metric=self.metric, thres_scale=self.thres_scale,
            rerank=self.FUSED_RERANK_MULT * k if mode == "H2" else 0,
            with_side=True)
        return fn(self.index.shards, qb, side)


class AnnServeFleet:
    """Replica-group × shard-group serving fleet over ``AnnServeEngine``.

    * :meth:`submit` — route one request (a :class:`FleetRequest`, maybe
      already shed; never raises for load);
    * :meth:`step` / :meth:`run` — expire, drain the backlog, tick every
      healthy replica once / until idle;
    * :meth:`insert` / :meth:`delete` / :meth:`compact` — to every replica
      (identical ids checked);
    * :meth:`fail_replica` / :meth:`restore_replica` — failover, queued
      work re-admitted to the others;
    * :meth:`latency_summary` — percentiles, segment means and admission
      counters.
    """

    POLICIES = ("queue", "shed")

    def __init__(self, index, *, n_replicas: int = 2,
                 shards_per_replica: int = 1, max_queue: int = 1024,
                 policy: str = "queue",
                 default_deadline_s: Optional[float] = None,
                 side_capacity: int = 256, obs=None, devices=None,
                 **engine_kw):
        """Build the fleet over a built index.

        Parameters
        ----------
        index : JunoIndexData or repro_torch.serve.paged.PagedIndexData
            The index every replica serves (each replica wraps its own
            mutable copy). A ``PagedIndexData`` makes
            ``PagedAnnServeEngine`` replicas that share its one memory map
            and one cluster cache (``shards_per_replica`` must be 1: the
            paged tier is a storage split, not a device split).
        n_replicas : int
            Replicas (reads go to one, writes to all).
        shards_per_replica : int
            1: single-device engines on the index's device; > 1: each
            replica serves a ``DistributedMutableIndex`` over its own
            ``shards_per_replica`` consecutive entries of ``devices``.
        max_queue : int
            Per-replica admission bound, in queued query rows.
        policy : str
            ``"shed"`` (a typed rejection when every healthy replica is
            full) or ``"queue"`` (a fleet backlog).
        default_deadline_s : float, optional
            Relative deadline of a request that carries none; an expired
            request is dropped before compute.
        side_capacity : int
            Side-buffer capacity of each replica.
        obs : repro_torch.obs.Observability or bool, optional
            Fleet observability: each replica engine gets a child registry
            (the tracer and recall probe shared), the fleet's
            ``juno_fleet_*`` series go to ``obs.registry``, and
            :meth:`merged_registry` folds them all. ``True`` makes a fresh
            bundle; default off.
        devices : sequence of devices, optional
            The shards' devices with ``shards_per_replica > 1``, at least
            ``n_replicas · shards_per_replica`` entries (entries may
            repeat: shards may share a card). ``None`` takes every card
            (``torch.cuda.device_count()`` of them).
        **engine_kw
            Forwarded to every replica engine (``metric``,
            ``batch_buckets``, ...).

        Raises
        ------
        ValueError
            For an unknown policy, no replica, a paged index with shards,
            or fewer devices than the sharded topology needs.
        """
        if policy not in self.POLICIES:
            raise ValueError(f"unknown admission policy {policy!r}")
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        self.policy = policy
        self.max_queue = max_queue
        self.default_deadline_s = default_deadline_s
        if obs is True:
            from ..obs import Observability
            obs = Observability()
        self.obs = obs or None
        if self.obs is not None and self.obs.recall is not None:
            # recall gauges land in the fleet registry (first bind wins)
            self.obs.recall.bind(self.obs.registry)
        self.engines: list[AnnServeEngine] = []

        def _ekw() -> dict:
            # each replica its own child registry, for merged_registry()
            kw = dict(engine_kw)
            if self.obs is not None:
                kw["obs"] = self.obs.child()
            return kw
        from .paged import PagedAnnServeEngine, PagedIndexData
        if isinstance(index, PagedIndexData):
            if shards_per_replica > 1:
                raise ValueError(
                    "paged serving does not compose with device sharding "
                    "(shards_per_replica > 1): the paged tier is a storage "
                    "split; scale reads with n_replicas instead")
            for _ in range(n_replicas):
                self.engines.append(PagedAnnServeEngine(
                    index, side_capacity=side_capacity, **_ekw()))
            if self.obs is not None:
                # one shared memory map and cache: their series belong to
                # the fleet registry (this rebind wins over the engines')
                index.bind_obs(self.obs)
        elif shards_per_replica > 1:
            devs = (list(devices) if devices is not None else
                    [torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())])
            need = n_replicas * shards_per_replica
            if len(devs) < need:
                raise ValueError(f"{n_replicas}x{shards_per_replica} fleet "
                                 f"needs {need} devices, have {len(devs)}")
            for r in range(n_replicas):
                self.engines.append(_ShardedAnnServeEngine(
                    index, devs[r * shards_per_replica:
                                (r + 1) * shards_per_replica],
                    side_capacity=side_capacity, **_ekw()))
        else:
            for _ in range(n_replicas):
                self.engines.append(AnnServeEngine(
                    index, side_capacity=side_capacity, **_ekw()))
        self.n_replicas = n_replicas
        self.shards_per_replica = shards_per_replica
        self.backlog: collections.deque[FleetRequest] = collections.deque()
        self.down: set[int] = set()
        self._by_inner: dict[int, FleetRequest] = {}
        self._rid = 0
        self.hist = LatencyHistogram()
        self.seg = {"queue": 0.0, "compute": 0.0, "merge": 0.0}
        self.stats = {
            "submitted": 0, "served": 0, "shed": 0, "expired": 0,
            "rerouted": 0, "inserts": 0, "deletes": 0, "ticks": 0,
            "per_replica": [collections.Counter() for _ in range(n_replicas)],
        }

    # ---- request plane ---------------------------------------------------
    def outstanding(self, replica: int) -> int:
        """Queued query rows waiting on ``replica``."""
        return self.engines[replica].queued_rows

    def _pick_replica(self) -> Optional[int]:
        """The healthy replica with the fewest outstanding rows (the lowest
        index among equals); None when all are down."""
        healthy = [r for r in range(self.n_replicas) if r not in self.down]
        if not healthy:
            return None
        return min(healthy, key=self.outstanding)

    def _place(self, freq: FleetRequest, replica: int) -> None:
        """Hand a request to a replica engine's queue (first or re-route)."""
        eng = self.engines[replica]
        if freq.inner is None:
            freq.inner = eng.submit(
                freq.queries, k=freq.k, mode=freq.mode, nprobe=freq.nprobe,
                recall_target=freq.recall_target)
        else:
            eng.queue.append(freq.inner)
        freq.replica = replica
        freq.status = "queued"
        self._by_inner[id(freq.inner)] = freq
        self.stats["per_replica"][replica]["admitted"] += 1

    def _shed(self, freq: FleetRequest, reason: str, detail: str) -> None:
        """Terminal shed with a typed rejection."""
        freq.status = "shed"
        freq.rejection = Rejection(reason, detail)
        self.stats["shed"] += 1
        if self.obs is not None:
            self.obs.registry.counter("juno_fleet_shed_total",
                                      reason=reason).inc()

    def _admit(self, freq: FleetRequest) -> None:
        """Route, shed or backlog one request by the admission policy."""
        replica = self._pick_replica()
        if replica is None:
            self._shed(freq, "no_replica", "all replicas down")
            return
        if self.outstanding(replica) >= self.max_queue:
            if self.policy == "shed":
                self._shed(freq, "queue_full",
                           f"least-loaded replica {replica} at max_queue="
                           f"{self.max_queue} rows")
            else:
                self.backlog.append(freq)   # stays "queued"
            return
        self._place(freq, replica)

    def submit(self, queries, *, k: int = 10, mode: str = "auto",
               nprobe: int = 0, recall_target: float = 0.9,
               deadline_s: Optional[float] = None,
               t_arrival: Optional[float] = None) -> FleetRequest:
        """Route one search request into the fleet.

        The engine's knobs, plus ``deadline_s`` (relative; overrides the
        fleet default; a request still queued past it is dropped before
        compute) and ``t_arrival`` (the intended arrival time on the
        ``perf_counter`` clock; default now). Never raises for load: an
        inadmissible request comes back ``status="shed"`` with a
        :class:`Rejection`.
        """
        now = time.perf_counter()
        dl = self.default_deadline_s if deadline_s is None else deadline_s
        freq = FleetRequest(
            rid=self._rid,
            queries=np.atleast_2d(np.asarray(queries, np.float32)),
            k=k, mode=mode, nprobe=nprobe, recall_target=recall_target,
            deadline=None if dl is None else now + dl,
            t_arrival=now if t_arrival is None else t_arrival)
        self._rid += 1
        self.stats["submitted"] += 1
        if self.obs is not None:
            self.obs.registry.counter("juno_fleet_submitted_total").inc()
        self._admit(freq)
        return freq

    # ---- engine ticks ----------------------------------------------------
    def _drop_expired(self, freq: FleetRequest) -> None:
        """Terminal transition of a deadline-expired queued request."""
        freq.status = "expired"
        freq.rejection = Rejection("deadline", "expired before compute")
        if freq.inner is not None:
            self._by_inner.pop(id(freq.inner), None)
        self.stats["expired"] += 1
        if self.obs is not None:
            self.obs.registry.counter("juno_fleet_expired_total").inc()

    def _expire(self, now: float) -> None:
        """Drop queued and backlogged requests whose deadline has passed."""
        def live(freq):
            if freq is not None and freq.deadline is not None \
                    and now > freq.deadline:
                self._drop_expired(freq)
                return False
            return True
        for eng in self.engines:
            if eng.queue:
                eng.queue = collections.deque(
                    inner for inner in eng.queue
                    if live(self._by_inner.get(id(inner))))
        if self.backlog:
            self.backlog = collections.deque(f for f in self.backlog
                                             if live(f))

    def _drain_backlog(self) -> None:
        """Admit backlogged requests while a replica has capacity."""
        while self.backlog:
            replica = self._pick_replica()
            if replica is None or self.outstanding(replica) >= self.max_queue:
                return
            self._place(self.backlog.popleft(), replica)

    def _collect(self, replica: int) -> None:
        """Fold a replica's completed requests into the fleet's metrics."""
        eng = self.engines[replica]
        for inner in eng.completed:
            freq = self._by_inner.pop(id(inner), None)
            if freq is None:
                continue
            freq.status = "done"
            tr = freq.trace()
            self.hist.add(tr["total"])
            for segment in ("queue", "compute", "merge"):
                self.seg[segment] += tr[segment]
            self.stats["served"] += 1
            self.stats["per_replica"][replica]["served"] += 1
            if self.obs is not None:
                self._observe_served(freq, inner, tr, replica)
        eng.completed.clear()

    def _observe_served(self, freq: FleetRequest, inner: AnnRequest,
                        tr: dict, replica: int) -> None:
        """Registry and tracer view of one served request: the
        ``juno_fleet_*`` counters and histograms (cumulative, unlike
        :attr:`hist`), and a retro-stamped ``fleet.request`` span with
        ``fleet.queue``/``fleet.compute``/``fleet.merge`` children."""
        reg, tracer = self.obs.registry, self.obs.tracer
        reg.counter("juno_fleet_served_total", replica=str(replica)).inc()
        reg.histogram("juno_fleet_request_seconds").add(tr["total"])
        for segment in ("queue", "compute", "merge"):
            reg.histogram(f"juno_fleet_{segment}_seconds").add(tr[segment])
        tid = f"fleet-{freq.rid}"
        root = tracer.record("fleet.request", freq.t_arrival, inner.t_done,
                             trace_id=tid, replica=replica, mode=freq.mode,
                             rows=freq.queries.shape[0])
        tracer.record("fleet.queue", freq.t_arrival, inner.t_batch,
                      trace_id=tid, parent=root)
        tracer.record("fleet.compute", inner.t_batch, inner.t_compute,
                      trace_id=tid, parent=root)
        tracer.record("fleet.merge", inner.t_compute, inner.t_done,
                      trace_id=tid, parent=root)

    def step(self) -> int:
        """One fleet tick: expire (before any compute), drain the backlog,
        tick every healthy replica with work. Returns the rows served."""
        self._expire(time.perf_counter())
        self._drain_backlog()
        rows = 0
        for r, eng in enumerate(self.engines):
            if r in self.down or not eng.queue:
                continue
            rows += eng.step()
            self._collect(r)
        self.stats["ticks"] += 1
        return rows

    @property
    def pending(self) -> bool:
        """True while the backlog or a healthy replica's queue holds work."""
        return bool(self.backlog) or any(
            self.engines[r].queue for r in range(self.n_replicas)
            if r not in self.down)

    def run(self, max_ticks: int = 100_000) -> int:
        """Tick until the fleet is idle; returns the rows served."""
        rows = 0
        for _ in range(max_ticks):
            if not self.pending:
                break
            rows += self.step()
        return rows

    # ---- failover --------------------------------------------------------
    def fail_replica(self, replica: int) -> int:
        """Take a replica out of rotation and re-admit its queued requests
        through normal admission (they may land on any other replica, or
        shed under ``policy="shed"``). Returns the requests re-admitted."""
        if replica in self.down:
            return 0
        self.down.add(replica)
        eng = self.engines[replica]
        moved = list(eng.queue)
        eng.queue.clear()
        n = 0
        for inner in moved:
            freq = self._by_inner.pop(id(inner), None)
            if freq is None:
                continue
            freq.replica = -1
            self._admit(freq)
            n += 1
        self.stats["rerouted"] += n
        if self.obs is not None and n:
            self.obs.registry.counter("juno_fleet_rerouted_total").inc(n)
        return n

    def restore_replica(self, replica: int) -> None:
        """Return a failed replica to the rotation."""
        self.down.discard(replica)

    # ---- mutation plane --------------------------------------------------
    def insert(self, points) -> list[int]:
        """Insert a point batch into every replica, down ones included;
        returns the ids. Raises ``RuntimeError`` if two replicas assign
        different ids (their states have forked)."""
        ids0: Optional[list[int]] = None
        for r, eng in enumerate(self.engines):
            ids = eng.insert(points)
            if ids0 is None:
                ids0 = ids
            elif ids != ids0:
                raise RuntimeError(
                    f"replica {r} id divergence: {ids[:4]} vs {ids0[:4]}")
        self.stats["inserts"] += len(ids0)
        if self.obs is not None:
            self.obs.registry.counter(
                "juno_fleet_inserts_total").inc(len(ids0))
        return ids0

    def delete(self, ids) -> int:
        """Tombstone points by id on every replica; returns the count."""
        n = 0
        for eng in self.engines:
            n = eng.delete(ids)
        self.stats["deletes"] += n
        return n

    def compact(self, **kw) -> int:
        """:meth:`AnnServeEngine.compact` on every replica; the points
        moved, summed."""
        return sum(eng.compact(**kw) for eng in self.engines)

    # ---- observability ---------------------------------------------------
    def merged_registry(self):
        """A fresh ``MetricsRegistry`` merging (fail-closed) the fleet's
        registry and every replica's: counters sum, sum gauges add,
        histograms fold bucket by bucket; the live registries are not
        changed. Raises ``RuntimeError`` for a fleet built without
        ``obs=``."""
        if self.obs is None:
            raise RuntimeError("fleet was built without obs=; nothing "
                               "to merge")
        from ..obs import MetricsRegistry
        merged = MetricsRegistry()
        merged.merge(self.obs.registry)
        for eng in self.engines:
            if eng.obs is not None:
                merged.merge(eng.obs.registry)
        return merged

    def latency_summary(self) -> dict:
        """The latency histogram's summary (``n/mean/p50/p95/p99/max``
        seconds over served requests, arrival → done), the segment means
        (``queue_mean``/``compute_mean``/``merge_mean``) and the admission
        counters (``served``/``shed``/``expired``/``rerouted``)."""
        out = self.hist.summary()
        served = max(1, self.stats["served"])
        out.update({f"{k}_mean": v / served for k, v in self.seg.items()})
        for key in ("served", "shed", "expired", "rerouted"):
            out[key] = self.stats[key]
        return out

    def reset_metrics(self) -> None:
        """Zero the latency histogram, segment sums and counters (between
        a warm-up and a timed run). The ``obs`` registries are cumulative
        and left as they are."""
        self.hist = LatencyHistogram()
        self.seg = {k: 0.0 for k in self.seg}
        for key in ("submitted", "served", "shed", "expired", "rerouted",
                    "inserts", "deletes", "ticks"):
            self.stats[key] = 0
        for counter in self.stats["per_replica"]:
            counter.clear()
