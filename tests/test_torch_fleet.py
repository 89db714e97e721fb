"""The port's replica fleet (``repro_torch.serve.fleet``) against
``repro.serve.fleet.AnnServeFleet``.

Both fleets take the same request sequence over the same index (built by
``repro``, carried across bit-exactly), with no sleeps (a deadline that
has already passed is a negative one). Requests served by tier M or L
(hit counts) must match exactly; the others' ids up to score ties and
their scores within rtol 1e-5. The routing (which replica served each
request), the admission verdicts, the counters (``stats``,
``latency_summary``), the id fan-out of inserts and the merged registry's
series (by name and value, timings by count only) must be the reference's.

The sharded fleet (replicas of 2 shards, every shard on the CPU) runs
here although the reference's own sharded tests need 4 emulated devices:
replicas agree bit for bit, full coverage equals the reference's
unsharded search, inserts are visible, fused and rt serving are refused.
A fleet over a paged generation shares one memory map and one cluster
cache and serves what the resident engine serves.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_ids_equal_up_to_ties, to_port
from repro.build import ArtifactStore as JaxStore
from repro.core import JunoConfig, build
from repro.core import search as jax_search
from repro.serve import fleet as jfleet
from repro.serve import paged as jpaged
from repro_torch.core import search
from repro_torch.data import DEEP_LIKE, make_dataset
from repro_torch.dist import DistributedMutableIndex
from repro_torch.obs import Histogram, Observability
from repro_torch.serve import AnnServeEngine, PagedIndexData
from repro_torch.serve.fleet import (AnnServeFleet, LatencyHistogram,
                                     Rejection, _ShardedAnnServeEngine)

WAVES = [(slice(0, 5), dict(k=10, mode="H", nprobe=8)),
         (slice(5, 9), dict(k=10, mode="M", nprobe=8)),
         (slice(9, 10), dict(k=50, mode="H2")),
         (slice(10, 20), dict(k=10, mode="L", nprobe=4))]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """3000 DEEP-like points in 16 clusters (``capacity_mult`` 1.1: most
    clusters full, so inserts spill), the port's copy, and the index
    committed to a reference ``ArtifactStore`` for the paged fleet."""
    pts, q = make_dataset(DEEP_LIKE, 3000, 40, seed=17)
    cfg = JunoConfig(n_clusters=16, n_entries=32, calib_queries=16,
                     kmeans_iters=4, capacity_mult=1.1)
    ref = build(pts, cfg)
    store = JaxStore(str(tmp_path_factory.mktemp("fleet") / "store"))
    assert store.put("main", ref, cfg) == 1
    return dict(pts=pts, q=q, ref=ref, port=to_port(ref),
                path=store.path("main", 1))


def _fleets(served, **kw):
    """(port fleet, reference fleet) of the same topology."""
    return (AnnServeFleet(served["port"], **kw),
            jfleet.AnnServeFleet(served["ref"], **kw))


def _same_request(a, b):
    """One request of each fleet: the same status, replica and rejection,
    and ids and scores by the module's rule."""
    assert a.status == b.status and a.replica == b.replica
    assert (a.rejection is None) == (b.rejection is None)
    if a.rejection is not None:
        assert a.rejection == Rejection(b.rejection.reason,
                                        b.rejection.detail)
    if not a.done:
        assert a.ids is None
        return
    if a.inner.mode in ("M", "L"):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)
    else:
        assert_ids_equal_up_to_ties(a.ids, b.ids, a.scores, b.scores)


def _same_stats(pf, jf):
    assert pf.stats == jf.stats
    ps, js = pf.latency_summary(), jf.latency_summary()
    for key in ("n", "served", "shed", "expired", "rerouted"):
        assert ps[key] == js[key], key


@pytest.mark.parametrize("n_replicas", [1, 3])
def test_fleet_matches_reference_fleet(served, n_replicas):
    """The waves of the reference's test, request by request; and each
    result equal to the port's own ``search`` at the resolved signature."""
    q, port = served["q"], served["port"]
    pf, jf = _fleets(served, n_replicas=n_replicas)
    rp = [pf.submit(q[s], **kw) for s, kw in WAVES]
    rj = [jf.submit(q[s], **kw) for s, kw in WAVES]
    assert pf.run() == jf.run() == 20
    for a, b in zip(rp, rj):
        _same_request(a, b)
        k, mode, nprobe = pf.engines[a.replica].route(a.inner)
        s, ids = search(port, a.queries, nprobe=nprobe, k=k, mode=mode,
                        batch=a.queries.shape[0])
        np.testing.assert_array_equal(ids.numpy()[:, :a.k], a.ids)
        np.testing.assert_array_equal(s.numpy()[:, :a.k], a.scores)
    _same_stats(pf, jf)


def test_least_outstanding_routing(served):
    q = served["q"]
    pf, jf = _fleets(served, n_replicas=2)
    for f in (pf, jf):
        for i in range(4):
            f.submit(q[i * 2:(i + 1) * 2], k=10, mode="H", nprobe=8)
    assert [pf.outstanding(r) for r in range(2)] == [4, 4] == \
        [jf.outstanding(r) for r in range(2)]
    pf.run()
    jf.run()
    assert all(c["served"] == 2 for c in pf.stats["per_replica"])
    _same_stats(pf, jf)


def test_queue_full_sheds_typed_rejection(served):
    """``policy="shed"`` at capacity: a typed rejection, no exception, no
    compute for the shed request."""
    q = served["q"]
    pf, jf = _fleets(served, n_replicas=2, max_queue=8, policy="shed")
    rp = [pf.submit(q[:8]) for _ in range(3)]
    rj = [jf.submit(q[:8]) for _ in range(3)]
    shed = rp[-1]
    assert shed.status == "shed" and not shed.done and shed.ids is None
    assert isinstance(shed.rejection, Rejection)
    assert shed.rejection.reason == "queue_full"
    assert pf.run() == jf.run() == 16
    for a, b in zip(rp, rj):
        _same_request(a, b)
    assert pf.latency_summary()["shed"] == 1
    _same_stats(pf, jf)


def test_queue_policy_backlogs_and_drains(served):
    q = served["q"]
    pf, jf = _fleets(served, n_replicas=2, max_queue=8, policy="queue")
    rp = [pf.submit(q[:8]) for _ in range(4)]
    rj = [jf.submit(q[:8]) for _ in range(4)]
    assert len(pf.backlog) == len(jf.backlog) == 2
    pf.run()
    jf.run()
    assert all(r.done for r in rp) and not pf.backlog
    for a, b in zip(rp, rj):
        _same_request(a, b)
    _same_stats(pf, jf)


@pytest.mark.parametrize("default", [None, -1.0])
def test_deadline_expires_before_compute(served, default):
    """A request whose deadline has passed (its own, or the fleet's
    default) is dropped before any compute: the engine serves only the
    live rows."""
    q = served["q"]
    pf, jf = _fleets(served, n_replicas=1, default_deadline_s=default)
    dl = -1.0 if default is None else None
    rp = [pf.submit(q[:4], deadline_s=dl), pf.submit(q[4:6], deadline_s=60.0)]
    rj = [jf.submit(q[:4], deadline_s=dl), jf.submit(q[4:6], deadline_s=60.0)]
    pf.run()
    jf.run()
    assert rp[0].status == "expired" and rp[0].rejection.reason == "deadline"
    assert rp[1].done
    assert pf.engines[0].stats["queries"] == 2
    for a, b in zip(rp, rj):
        _same_request(a, b)
    assert pf.latency_summary()["expired"] == 1
    _same_stats(pf, jf)


def test_failover_preserves_results(served):
    """A failed replica's queued work moves to the survivor; the results
    are a 1-replica fleet's; the failed replica computes nothing; a
    restored replica takes the next request."""
    q = served["q"]
    pf, jf = _fleets(served, n_replicas=2)
    solo = AnnServeFleet(served["port"], n_replicas=1)
    subs = [(q[i * 2:(i + 1) * 2], dict(k=10, mode="H", nprobe=8))
            for i in range(6)]
    rp = [pf.submit(x, **kw) for x, kw in subs]
    rj = [jf.submit(x, **kw) for x, kw in subs]
    rs = [solo.submit(x, **kw) for x, kw in subs]
    assert pf.fail_replica(0) == jf.fail_replica(0) == 3
    assert pf.fail_replica(0) == 0
    pf.run()
    jf.run()
    solo.run()
    assert all(r.done and r.replica == 1 for r in rp)
    for a, b, c in zip(rp, rj, rs):
        _same_request(a, b)
        np.testing.assert_array_equal(a.ids, c.ids)
        np.testing.assert_array_equal(a.scores, c.scores)
    assert pf.stats["rerouted"] == 3
    assert pf.engines[0].stats["queries"] == 0
    for f in (pf, jf):
        f.restore_replica(0)
    back = pf.submit(q[:2], k=10, mode="H", nprobe=8)
    jf.submit(q[:2], k=10, mode="H", nprobe=8)
    pf.run()
    jf.run()
    assert back.done and back.replica == 0
    _same_stats(pf, jf)


def test_all_down_sheds_no_replica(served):
    pf, jf = _fleets(served, n_replicas=1)
    for f in (pf, jf):
        f.fail_replica(0)
    a, b = pf.submit(served["q"][:2]), jf.submit(served["q"][:2])
    assert a.status == "shed" and a.rejection.reason == "no_replica"
    _same_request(a, b)
    assert not pf.pending and pf.run() == 0
    _same_stats(pf, jf)


def test_mutations_fan_out_to_all_replicas(served):
    """Inserts and deletes reach every replica, a down one included, with
    the reference's ids (spills into the side buffer included); a replica
    whose state has forked makes the insert raise."""
    q = served["q"]
    pf, jf = _fleets(served, n_replicas=2)
    rng = np.random.default_rng(2)
    newpts = (q[:4] + 0.03 * rng.standard_normal(q[:4].shape)
              ).astype(np.float32)
    for f in (pf, jf):
        f.fail_replica(1)
    ids = pf.insert(newpts)
    assert ids == jf.insert(newpts)
    for f in (pf, jf):
        f.restore_replica(1)
        f.fail_replica(0)
    a = pf.submit(newpts, k=10, mode="H", nprobe=16)
    b = jf.submit(newpts, k=10, mode="H", nprobe=16)
    pf.run()
    jf.run()
    assert a.replica == 1
    assert all(ids[j] in a.ids[j] for j in range(4))
    _same_request(a, b)
    for f in (pf, jf):
        f.restore_replica(0)
    assert pf.delete(ids[:2]) == jf.delete(ids[:2]) == 2
    a = pf.submit(newpts[:2], k=10, mode="H", nprobe=16)
    b = jf.submit(newpts[:2], k=10, mode="H", nprobe=16)
    pf.run()
    jf.run()
    assert all(ids[j] not in a.ids[j] for j in range(2))
    _same_request(a, b)
    assert pf.compact() == jf.compact()
    _same_stats(pf, jf)
    pf.engines[1].insert(newpts[:1])          # replica 1 forks
    with pytest.raises(RuntimeError, match="id divergence"):
        pf.insert(newpts[:1])


def test_trace_timestamps_ordered(served):
    pf = AnnServeFleet(served["port"], n_replicas=2)
    reqs = [pf.submit(served["q"][i:i + 1]) for i in range(6)]
    pf.run()
    for req in reqs:
        tr = req.trace()
        assert set(tr) == {"queue", "compute", "merge", "total"}
        assert all(v >= 0 for v in tr.values())
        assert tr["total"] >= tr["compute"]
    summ = pf.latency_summary()
    assert summ["n"] == summ["served"] == 6
    assert summ["p50"] <= summ["p95"] <= summ["p99"] <= summ["max"]
    pf.reset_metrics()
    assert pf.latency_summary()["n"] == 0 and pf.stats["submitted"] == 0


def test_latency_histogram_is_the_registry_histogram():
    """The fleet's histogram is ``obs.Histogram``: conservative upper-edge
    percentiles, exact counts on merge, refused merges across bucketings."""
    h = LatencyHistogram()
    assert isinstance(h, Histogram)
    vals = [10 ** (i / 250.0 - 4) for i in range(1000)]
    for v in vals:
        h.add(v)
    for p, e in zip([0.5, 0.95, 0.99], np.quantile(vals, [0.5, 0.95, 0.99])):
        assert e <= h.percentile(p) <= e * 1.11
    h2 = LatencyHistogram()
    h2.add(5.0)
    h2.merge(h)
    assert h2.n == 1001 and h2.max == 5.0
    with pytest.raises(ValueError):
        h.merge(LatencyHistogram(bins_per_decade=10))


def _series(reg):
    """A registry's snapshot with timings reduced to their counts."""
    out = {}
    for key, val in reg.snapshot().items():
        if isinstance(val, dict):
            val = ({"n": val["n"]} if "_seconds" in key else
                   {k: v for k, v in val.items()})
        out[key] = val
    return out


def test_merged_registry_matches_reference(served):
    """With ``obs=True`` the merged fleet registry holds the reference's
    series (``juno_fleet_*`` and every replica's ``juno_engine_*``) with
    its values, timings by count; one ``fleet.request`` span a served
    request, with its three children."""
    q = served["q"]
    pf, jf = _fleets(served, n_replicas=2, max_queue=8, policy="shed",
                     obs=True)
    for f in (pf, jf):
        f.submit(q[:2], deadline_s=-1.0)         # expires before compute
        for s, kw in WAVES:                      # the last ones shed
            f.submit(q[s], **kw)
        f.fail_replica(1)                        # its queue moves
        f.run()
        f.restore_replica(1)
        f.insert(q[20:22])
    got, want = _series(pf.merged_registry()), _series(jf.merged_registry())
    assert got == want
    assert got["juno_fleet_shed_total{reason=\"queue_full\"}"] == \
        pf.stats["shed"] >= 1
    assert got["juno_fleet_expired_total"] == pf.stats["expired"] == 1
    assert got["juno_fleet_rerouted_total"] == pf.stats["rerouted"] >= 1
    spans = pf.obs.tracer.spans()
    roots = [sp for sp in spans if sp.name == "fleet.request"]
    assert len(roots) == pf.stats["served"]
    by_parent = {sp.parent_id for sp in spans if sp.name in (
        "fleet.queue", "fleet.compute", "fleet.merge")}
    assert by_parent == {sp.span_id for sp in roots}
    with pytest.raises(RuntimeError, match="without obs"):
        AnnServeFleet(served["port"], n_replicas=1).merged_registry()


def test_fleet_argument_errors(served):
    with pytest.raises(ValueError, match="admission policy"):
        AnnServeFleet(served["port"], policy="drop")
    with pytest.raises(ValueError, match="at least one replica"):
        AnnServeFleet(served["port"], n_replicas=0)
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        AnnServeFleet(served["port"], n_replicas=2, shards_per_replica=2,
                      devices=["cpu"] * 2)
    # without devices a sharded fleet takes the cards, and needs them
    n_cards = torch.cuda.device_count()
    if n_cards < 4:
        with pytest.raises(ValueError, match=f"needs 4 devices, have "
                                             f"{n_cards}"):
            AnnServeFleet(served["port"], n_replicas=2,
                          shards_per_replica=2)


# ---------------------------------------------------------------------------
# sharded replicas (the reference's needs-4-devices tests, on the CPU)
# ---------------------------------------------------------------------------

def _sharded(served, n_replicas, **kw):
    return AnnServeFleet(served["port"], n_replicas=n_replicas,
                         shards_per_replica=2, devices=["cpu"] * 4,
                         batch_buckets=(8, 16), **kw)


def test_sharded_fleet_replica_invariance(served):
    """2 replicas × 2 shards and 1 × 2 agree bit for bit, in every tier."""
    q = served["q"]
    f22, f12 = _sharded(served, 2), _sharded(served, 1)
    for f in (f22, f12):
        assert isinstance(f.engines[0], _ShardedAnnServeEngine)
        assert f.engines[0].index.n_shards == 2
    waves = [(q[i * 4:(i + 1) * 4], dict(k=10, mode=m, nprobe=8))
             for i, m in enumerate(("M", "H", "H2", "L"))]
    r22 = [f22.submit(x, **kw) for x, kw in waves]
    r12 = [f12.submit(x, **kw) for x, kw in waves]
    assert f22.run() == f12.run() == 16
    assert {r.replica for r in r22} == {0, 1}
    for a, b in zip(r22, r12):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)


def test_sharded_fleet_full_coverage_matches_unsharded(served):
    """At nprobe = C each shard scans all of its clusters: the merge equals
    the unsharded search, the port's bit for bit in its scores and the
    reference's up to ties."""
    q = served["q"]
    fleet = _sharded(served, 2)
    req = fleet.submit(q[:8], k=10, mode="H", nprobe=16)
    fleet.run()
    s, ids = search(served["port"], q[:8], nprobe=16, k=10, mode="H",
                    batch=8)
    np.testing.assert_array_equal(s.numpy(), req.scores)
    assert_ids_equal_up_to_ties(req.ids, ids.numpy(), req.scores, s.numpy(),
                                rtol=0.0, atol=0.0)
    s_r, ids_r = jax_search(served["ref"], jnp.asarray(q[:8]), nprobe=16,
                            k=10, mode="H", batch=8)
    assert_ids_equal_up_to_ties(req.ids, np.asarray(ids_r), req.scores,
                                np.asarray(s_r))


def test_sharded_fleet_insert_visible(served):
    """Inserts fan out to both replicas' shards with identical ids and are
    served at once, side-buffer spills included; the sharded engine's
    merge scheduler takes one lane a shard."""
    q = served["q"]
    fleet = _sharded(served, 2, max_minors=2)
    assert fleet.engines[0].scheduler._lanes == [(0, 8), (8, 16)]
    rng = np.random.default_rng(3)
    newpts = (q[:4] + 0.03 * rng.standard_normal(q[:4].shape)
              ).astype(np.float32)
    ids = fleet.insert(newpts)
    assert fleet.engines[0].index._loc == fleet.engines[1].index._loc
    req = fleet.submit(newpts, k=10, mode="H", nprobe=16)
    fleet.run()
    assert all(ids[j] in req.ids[j] for j in range(4))


def test_sharded_serving_never_builds_the_global_view(served, monkeypatch):
    """A sharded replica serves, takes fan-out writes and serves again
    without reading ``DistributedMutableIndex.data`` (the whole index
    gathered on the host), and its results equal a fleet's that could."""
    q = served["q"]
    want = _sharded(served, 1)
    w_ids = want.insert(q[:3] + 0.01)
    w_req = want.submit(q[:8], k=10, mode="H", nprobe=8)
    want.run()

    def no_view(self):
        raise AssertionError("serving built the global view")
    monkeypatch.setattr(DistributedMutableIndex, "data", property(no_view))
    fleet = _sharded(served, 2)
    first = fleet.submit(q[:8], k=10, mode="H2")
    fleet.run()
    assert first.done
    assert fleet.insert(q[:3] + 0.01) == w_ids
    fleet.delete(w_ids[:1] + [5])
    want.delete(w_ids[:1] + [5])
    reqs = [fleet.submit(q[:8], k=10, mode=m, nprobe=8) for m in "HML"]
    fleet.run()
    w_reqs = [want.submit(q[:8], k=10, mode=m, nprobe=8) for m in "HML"]
    want.run()
    assert w_req.done and all(r.done for r in reqs)
    for a, b in zip(reqs, w_reqs):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)


@pytest.mark.parametrize("kw", [dict(fused=True), dict(prefilter="rt")])
def test_sharded_fleet_rejects_unwired_paths(served, kw):
    with pytest.raises(ValueError, match="scan path only"):
        AnnServeFleet(served["port"], n_replicas=1, shards_per_replica=2,
                      devices=["cpu"] * 2, **kw)


# ---------------------------------------------------------------------------
# a fleet over a paged generation
# ---------------------------------------------------------------------------

def test_fleet_over_paged_generation(served):
    """Replicas share the one memory map and cluster cache (its series in
    the fleet's registry), serve what a resident engine serves and what
    the reference's paged fleet serves, with its cache counters; inserts
    fan out; the shard split is refused."""
    q, path = served["q"], served["path"]
    quarter = int(served["port"].cluster_codes.numel()) // 4
    paged = PagedIndexData(path, cache_bytes=quarter, device="cpu")
    with pytest.raises(ValueError, match="n_replicas"):
        AnnServeFleet(paged, n_replicas=2, shards_per_replica=2)
    obs = Observability()
    fleet = AnnServeFleet(paged, n_replicas=2, obs=obs)
    assert all(e.index.paged.cache is paged.cache for e in fleet.engines)
    jpaged_data = jpaged.PagedIndexData(path, cache_bytes=quarter)
    jf = jfleet.AnnServeFleet(jpaged_data, n_replicas=2)
    reng = AnnServeEngine(served["port"])
    waves = [(q[i * 4:(i + 1) * 4], dict(k=10, mode=m, nprobe=8))
             for i, m in enumerate(("H", "M", "H", "L"))]
    rf = [fleet.submit(x, **kw) for x, kw in waves]
    rj = [jf.submit(x, **kw) for x, kw in waves]
    rr = [reng.submit(x, **kw) for x, kw in waves]
    fleet.run()
    jf.run()
    reng.run()
    for a, b, c in zip(rf, rj, rr):
        np.testing.assert_array_equal(a.ids, c.ids)
        np.testing.assert_array_equal(a.scores, c.scores)
        _same_request(a, b)
    st, jst = paged.stats(), jpaged_data.stats()
    assert {k: st[k] for k in ("hits", "misses", "evictions")} == \
        {k: jst[k] for k in ("hits", "misses", "evictions")}
    assert st["evictions"] > 0
    snap = obs.registry.snapshot()
    assert snap["juno_cache_misses_total"] == st["misses"]
    newpts = (served["pts"][:4] + 0.01).astype(np.float32)
    ids = fleet.insert(newpts)
    assert ids == jf.insert(newpts)
    req = fleet.submit(newpts, k=10, mode="H", nprobe=16)
    fleet.run()
    assert all(ids[j] in req.ids[j] for j in range(len(ids)))
