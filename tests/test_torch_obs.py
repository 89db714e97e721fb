"""The port's observability (``repro_torch.obs``) against ``repro.obs``.

Mirrors ``tests/test_obs.py`` but for its fleet test (the fleet is not
ported). The primitives: the registry's merge algebra and fail-closed
conflicts, the tracer's nesting and bounded buffer, the JSONL round trip
and validation, the recall probe; the port's and the reference's
registries and tracers agree on the same operations, and each package's
dump passes the other's ``validate_events`` and ``tools/obs_report.py``.
The serving integration: ids and scores bit-equal with obs on and off
in every tier, scan and rt, fused and not, and on a paged engine; the
engine's series equal its own counts and the reference engine's on the
same requests; the paged tier's, the store's and the merge scheduler's
series equal their own counters.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.build.store import load_index as jax_load_index
from repro.serve.ann import AnnServeEngine as JaxEngine
from repro_torch import obs as pobs
from repro_torch import rt
from repro_torch.build import ArtifactStore, save_index
from repro_torch.core import JunoConfig, build
from repro_torch.data import DEEP_LIKE, make_dataset
from repro_torch.obs import (Counter, Gauge, Histogram, MetricsRegistry,
                             Observability, RecallProbe, Tracer,
                             exact_topk_ids, read_jsonl, registry_from_events,
                             validate_events, write_jsonl)
from repro_torch.serve.ann import AnnServeEngine
from repro_torch.serve.paged import PagedAnnServeEngine, PagedIndexData

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# registry primitives: merge algebra, fail-closed everywhere
# ---------------------------------------------------------------------------

def test_counter_merge_commutative():
    a, b = Counter(), Counter()
    a.inc(3)
    a.inc(4.5)
    b.inc(10)
    ab, ba = Counter(), Counter()
    ab.merge(a)
    ab.merge(b)
    ba.merge(b)
    ba.merge(a)
    assert ab.value == ba.value == 17.5
    with pytest.raises(ValueError):
        a.inc(-1)


def test_gauge_agg_semantics_and_mismatch():
    last, mx = Gauge(agg="last"), Gauge(agg="max")
    last.set(3.0)
    other = Gauge(agg="last")
    other.set(7.0)
    last.merge(other)
    assert last.value == 7.0
    last.merge(Gauge(agg="last"))       # no updates: no new information
    assert last.value == 7.0
    with pytest.raises(ValueError):
        last.merge(mx)
    with pytest.raises(ValueError):
        Gauge(agg="median")


def test_histogram_merge_requires_identical_edges():
    a, b = Histogram(), Histogram()
    for v in (0.001, 0.01, 0.1):
        a.add(v)
        b.add(v * 2)
    n_before = a.n
    a.merge(b)
    assert a.n == n_before + b.n
    skewed = Histogram(lo=1e-5, hi=5000.0)
    assert len(skewed._counts) == len(Histogram()._counts)
    with pytest.raises(ValueError):
        Histogram().merge(skewed)


def test_registry_kind_and_bucketing_conflicts_raise():
    reg = MetricsRegistry()
    reg.counter("juno_test_total")
    with pytest.raises(ValueError):
        reg.gauge("juno_test_total")
    reg.histogram("juno_test_seconds")
    with pytest.raises(ValueError):
        reg.histogram("juno_test_seconds", lo=1e-5, hi=5000.0)
    other = MetricsRegistry()
    other.histogram("juno_test_seconds", lo=1e-5, hi=5000.0)
    with pytest.raises(ValueError):
        reg.merge(other)


def test_registry_merge_sums_and_copies():
    a, b = MetricsRegistry(), MetricsRegistry()
    a.counter("juno_x_total", mode="H").inc(2)
    b.counter("juno_x_total", mode="H").inc(3)
    b.counter("juno_only_b_total").inc(1)
    a.merge(b)
    assert a.snapshot()['juno_x_total{mode="H"}'] == 5
    assert a.snapshot()["juno_only_b_total"] == 1
    b.counter("juno_only_b_total").inc(1)   # deep copy: no aliasing back
    assert a.snapshot()["juno_only_b_total"] == 1


@pytest.mark.parametrize("bad", ["Juno_x", "juno x", "9juno", "juno-x"])
def test_metric_name_scheme_enforced(bad):
    with pytest.raises(ValueError):
        MetricsRegistry().counter(bad)


def _registry_ops(pkg):
    """The same operations on a registry of ``pkg`` (either package)."""
    a, b = pkg.MetricsRegistry(), pkg.MetricsRegistry()
    a.counter("juno_engine_requests_total", mode="H").inc(4)
    b.counter("juno_engine_requests_total", mode="H").inc(2.5)
    b.counter("juno_engine_requests_total", mode="M").inc(1)
    for agg, vals in (("sum", (3, 4)), ("max", (9, 2)), ("last", (1, 5))):
        a.gauge(f"juno_test_{agg}", agg=agg).set(vals[0])
        b.gauge(f"juno_test_{agg}", agg=agg).set(vals[1])
    for reg, scale in ((a, 1.0), (b, 3.0)):
        h = reg.histogram("juno_engine_request_seconds", mode="H")
        for v in (1e-7, 0.001, 0.02, 0.5, 900.0):
            h.add(v * scale)
        reg.histogram("juno_engine_batch_fill_ratio", lo=1e-3,
                      hi=1.0).add(0.25 * scale)
    return a.merge(b)


def test_registry_agrees_with_the_reference():
    port, ref = _registry_ops(pobs), _registry_ops(jobs)
    assert port.snapshot() == ref.snapshot()
    assert port.render_text() == ref.render_text()
    assert port.to_events() == ref.to_events()
    for name in ("juno_engine_request_seconds",):
        for p in (0.5, 0.95, 0.99):
            assert (port.get(name, mode="H").percentile(p)
                    == ref.get(name, mode="H").percentile(p))


# ---------------------------------------------------------------------------
# tracer: nesting, ordering, bounded buffer
# ---------------------------------------------------------------------------

def test_tracer_nesting_and_order():
    tr = Tracer()
    with tr.span("tick", trace_id="t1"):
        with tr.span("dispatch", rows=8):
            pass
        with tr.span("merge"):
            pass
    spans = {s.name: s for s in tr.spans()}
    assert spans["dispatch"].parent_id == spans["tick"].span_id
    assert spans["merge"].parent_id == spans["tick"].span_id
    assert spans["dispatch"].trace_id == "t1"
    assert spans["tick"].parent_id is None
    names = [s.name for s in tr.spans()]
    assert names.index("dispatch") < names.index("merge") < names.index("tick")
    assert all(s.t_end >= s.t_start for s in tr.spans())


def test_tracer_retro_record_and_bounded_buffer():
    tr = Tracer(max_spans=3)
    with tr.span("serve") as root:
        tr.record("queue", 1.0, 2.0, parent=root)
    assert [s.name for s in tr.spans()] == ["queue", "serve"]
    for i in range(5):
        tr.record(f"extra_{i}", 0.0, 1.0)
    assert len(tr.spans()) == 3
    assert tr.dropped == 4


def _tracer_ops(pkg):
    tr = pkg.Tracer(max_spans=5)
    with tr.span("engine.tick"):
        with tr.span("engine.dispatch", mode="H", k=10):
            with tr.span("paged.fault", cluster=3):
                pass
        tr.record("engine.enqueue", 1.0, 2.0, trace_id="7", rows=4)
        with tr.span("engine.merge", requests=2):
            pass
    for i in range(3):
        tr.record("extra", float(i), float(i) + 1.0)
    return tr


def test_tracer_agrees_with_the_reference():
    port, ref = _tracer_ops(pobs), _tracer_ops(jobs)
    strip = lambda evs: [{k: v for k, v in ev.items()  # noqa: E731
                          if k not in ("t_start", "t_end")} for ev in evs]
    assert strip(port.to_events()) == strip(ref.to_events())
    assert port.dropped == ref.dropped == 3


# ---------------------------------------------------------------------------
# export: JSONL round trip, fail-closed validation, across the packages
# ---------------------------------------------------------------------------

def _sample_bundle(pkg):
    obs = pkg.Observability()
    obs.registry.counter("juno_engine_requests_total", mode="H").inc(4)
    obs.registry.gauge("juno_engine_queue_rows", agg="sum").set(3)
    h = obs.registry.histogram("juno_engine_request_seconds")
    for v in (0.001, 0.02, 0.5):
        h.add(v)
    with obs.tracer.span("engine.tick", trace_id="r1"):
        with obs.tracer.span("engine.dispatch"):
            pass
    return obs


def test_jsonl_round_trip(tmp_path):
    obs = _sample_bundle(pobs)
    events = obs.events(extra_meta={"who": "test"})
    assert validate_events(events) == []
    path = str(tmp_path / "dump.jsonl")
    write_jsonl(path, events)
    back = read_jsonl(path)
    assert back == events
    rebuilt = registry_from_events(back)
    assert rebuilt.snapshot() == obs.registry.snapshot()
    assert rebuilt.render_text() == obs.registry.render_text()


def test_validate_flags_corruption():
    events = _sample_bundle(pobs).events()
    assert validate_events([ev for ev in events if ev.get("event") != "meta"])
    bad_hist = [dict(ev) for ev in events]
    for ev in bad_hist:
        if ev.get("kind") == "histogram":
            ev["counts"] = ev["counts"][:-1]
    assert validate_events(bad_hist)
    bad_span = [dict(ev) for ev in events]
    for ev in bad_span:
        if ev.get("event") == "span" and ev["parent_id"] is not None:
            ev["parent_id"] = "no-such-span"
    assert validate_events(bad_span)
    # the reference's check flags the same defects
    for evs in (bad_hist, bad_span):
        assert len(jobs.validate_events(evs)) == len(validate_events(evs))


@pytest.mark.parametrize("writer,reader", [(pobs, jobs), (jobs, pobs)])
def test_dumps_cross_between_the_packages(tmp_path, writer, reader):
    obs = _sample_bundle(writer)
    path = str(tmp_path / "dump.jsonl")
    writer.write_jsonl(path, obs.events(extra_meta={"by": "test"}))
    events = reader.read_jsonl(path)
    assert reader.validate_events(events) == []
    assert (reader.registry_from_events(events).snapshot()
            == obs.registry.snapshot())
    spec = importlib.util.spec_from_file_location(
        "obs_report", os.path.join(REPO, "tools", "obs_report.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main([path, "--validate"]) == 0
    assert tool.main([path]) == 0


# ---------------------------------------------------------------------------
# recall probe
# ---------------------------------------------------------------------------

class _FakeReq:
    """What RecallProbe.observe reads of a request."""

    def __init__(self, queries, ids, k):
        self.queries, self.ids, self.k = queries, ids, k


def test_recall_probe_every1_exact():
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((200, 8)).astype(np.float32)
    q = rng.standard_normal((6, 8)).astype(np.float32)
    exact = exact_topk_ids(q, vecs, 10)
    np.testing.assert_array_equal(exact, jobs.exact_topk_ids(q, vecs, 10))
    probe = RecallProbe(vecs, k=10, every=1, device="cpu")
    reg = MetricsRegistry()
    probe.bind(reg)
    probe.bind(MetricsRegistry())       # first bind wins
    probe.observe(_FakeReq(q, exact, 10), "H")
    assert probe.estimate("H") == 1.0
    half = exact.copy()
    half[:, 5:] = -1
    probe.observe(_FakeReq(q, half, 10), "H")
    assert probe.estimate("H") == pytest.approx(0.75)
    snap = reg.snapshot()
    assert snap['juno_recall_samples_total{mode="H"}'] == 12
    assert snap['juno_recall_online_at_k{k="10",mode="H"}'] == (
        pytest.approx(0.75))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_recall_probe_agrees_with_the_reference(metric):
    rng = np.random.default_rng(1)
    vecs = rng.standard_normal((300, 8)).astype(np.float32)
    port = RecallProbe(vecs, k=5, every=3, metric=metric, device="cpu")
    ref = jobs.RecallProbe(vecs, k=5, every=3, metric=metric)
    regs = MetricsRegistry(), jobs.MetricsRegistry()
    port.bind(regs[0])
    ref.bind(regs[1])
    for i in range(7):
        q = rng.standard_normal((4, 8)).astype(np.float32)
        ids = rng.integers(-1, 300, (4, 10))
        for probe in (port, ref):
            probe.observe(_FakeReq(q, ids, 10), ("H", "M")[i % 2])
    for mode in ("H", "M"):
        assert port.estimate(mode) == ref.estimate(mode)
    assert regs[0].snapshot() == regs[1].snapshot()


def test_observability_child_shares_tracer_and_probe():
    probe = RecallProbe(np.zeros((4, 2), np.float32), k=1, device="cpu")
    parent = Observability(recall=probe)
    child = parent.child()
    assert child.tracer is parent.tracer
    assert child.recall is parent.recall
    assert child.registry is not parent.registry
    child.registry.counter("juno_x_total").inc()
    assert "juno_x_total" not in parent.registry.snapshot()


# ---------------------------------------------------------------------------
# serving integration
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def obs_env(tmp_path_factory):
    pts, q = make_dataset(DEEP_LIKE, 4000, 32, seed=9)
    cfg = JunoConfig(n_clusters=16, n_entries=16, calib_queries=12,
                     kmeans_iters=4, capacity_mult=1.2)
    idx = build(pts, cfg, device="cpu")
    store = ArtifactStore(str(tmp_path_factory.mktemp("obs_store")))
    assert store.put("main", idx, cfg) == 1
    return pts, q, cfg, idx, store, rt.build_grid(idx, metric="l2")


def _wave(eng, q):
    reqs = [eng.submit(q[:5], k=10, mode="H", nprobe=8),
            eng.submit(q[5:9], k=10, mode="H2", nprobe=8),
            eng.submit(q[9:12], k=10, mode="M"),
            eng.submit(q[12:16], k=10, mode="L", nprobe=4),
            eng.submit(q[16:26], k=100, mode="H"),
            eng.submit(q[26:28], k=10, mode="H2")]
    eng.run()
    return reqs


def _check_engine_series(eng, reqs):
    snap = eng.obs.registry.snapshot()
    assert snap["juno_engine_ticks_total"] == eng.stats["ticks"]
    assert snap["juno_engine_queries_total"] == eng.stats["queries"]
    routed = {}
    for r in reqs:
        mode = eng.route(r)[1]
        routed[mode] = routed.get(mode, 0) + 1
    got = {k.split('"')[1]: v for k, v in snap.items()
           if k.startswith("juno_engine_requests_total")}
    assert got == routed
    assert snap["juno_engine_jit_retraces_total"] == len(
        {s[:4] for s in eng.stats["signatures"]})
    spans = eng.obs.tracer.spans()
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        if s.name in ("engine.dispatch", "engine.merge", "engine.enqueue"):
            assert by_id[s.parent_id].name == "engine.tick"
    assert sum(s.name == "engine.tick" for s in spans) == eng.stats["ticks"]
    assert sum(s.name == "engine.dispatch" for s in spans) == sum(
        eng.stats["signatures"].values())
    assert {s.trace_id for s in spans if s.name == "engine.enqueue"} == {
        str(r.rid) for r in reqs}
    assert validate_events(eng.obs.events()) == []
    assert jobs.validate_events(eng.obs.events()) == []


@pytest.mark.parametrize("prefilter", ["scan", "rt"])
@pytest.mark.parametrize("fused", [False, True])
def test_obs_on_off_bit_parity_resident(obs_env, fused, prefilter):
    pts, q, _, idx, _, grid = obs_env
    kw = dict(fused=fused, prefilter=prefilter, batch_buckets=(8, 32),
              rt_grid=grid if prefilter == "rt" else None)
    plain = AnnServeEngine(idx, **kw)
    inst = AnnServeEngine(idx, obs=Observability(
        recall=RecallProbe(pts, k=10, every=1, device="cpu")), **kw)
    r_plain, r_inst = _wave(plain, q), _wave(inst, q)
    for a, b in zip(r_plain, r_inst, strict=True):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)
    assert plain.stats["signatures"] == inst.stats["signatures"]
    _check_engine_series(inst, r_inst)
    snap = inst.obs.registry.snapshot()
    tier = "H2" if fused else "H"
    assert snap[f'juno_recall_online_at_k{{k="10",mode="{tier}"}}'] > 0.0
    rt_spans = [s for s in inst.obs.tracer.spans()
                if s.name == "engine.rt_probe"]
    assert (len(rt_spans) > 0) == (prefilter == "rt")


@pytest.mark.parametrize("fused", [False, True])
def test_obs_on_off_bit_parity_paged(obs_env, fused):
    _, q, cfg, idx, store, _ = obs_env
    path = store.path("main", 1)
    cache = 2 * idx.cluster_codes[0].numel()    # two rows: evictions

    def make(obs):
        paged = PagedIndexData(path, cache_bytes=cache, expect_config=cfg,
                               device="cpu")
        return PagedAnnServeEngine(paged, obs=obs, fused=fused,
                                   batch_buckets=(8, 32))
    plain = make(None)
    obs = Observability(tracer=Tracer(max_spans=100_000))
    inst = make(obs)
    r_plain, r_inst = _wave(plain, q), _wave(inst, q)
    for a, b in zip(r_plain, r_inst, strict=True):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)
    _check_engine_series(inst, r_inst)
    stats = inst.cache_stats()
    assert stats == plain.cache_stats() and stats["evictions"] > 0
    snap = obs.registry.snapshot()
    for key in ("hits", "misses", "evictions", "bytes", "rows"):
        assert snap[f"juno_cache_{key}" + ("" if key in ("bytes", "rows")
                                           else "_total")] == stats[key]
    spans = obs.tracer.spans()
    assert obs.tracer.dropped == 0
    assert sum(s.name == "paged.fault" for s in spans) == stats["misses"]
    assert snap["juno_paged_faults_total"] == stats["misses"]
    assert (obs.registry.get("juno_paged_verify_seconds").n
            == stats["verified_rows"])
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        if s.name in ("paged.filter", "paged.gather", "paged.score"):
            assert by_id[s.parent_id].name == "engine.dispatch"
        if s.name == "paged.fault":
            assert by_id[s.parent_id].name == "paged.gather"


def test_engine_series_equal_the_references(obs_env, tmp_path):
    """The same requests through the reference's engine and the port's,
    both with obs on: the same series, counts and span tree."""
    _, q, cfg, idx, _, _ = obs_env
    path = str(tmp_path / "idx")
    save_index(path, idx, cfg)
    jidx = jax_load_index(path).data
    engines = (AnnServeEngine(idx, obs=True, batch_buckets=(8, 32)),
               JaxEngine(jidx, obs=True, batch_buckets=(8, 32)))
    for eng in engines:
        for lo in (0, 5, 9, 14):
            eng.submit(q[lo:lo + 4], k=10, mode="M", nprobe=8)
        eng.submit(q[20:60], k=10, mode="M", nprobe=8)
        eng.run()
    snaps = [e.obs.registry.snapshot() for e in engines]
    assert snaps[0].keys() == snaps[1].keys()
    for key, v in snaps[1].items():
        if isinstance(v, dict):
            assert snaps[0][key]["n"] == v["n"], key
        elif key != "juno_engine_queue_rows":
            assert snaps[0][key] == v, key
    trees = []
    for e in engines:
        spans = e.obs.tracer.spans()
        names = {s.span_id: s.name for s in spans}
        trees.append(sorted((s.name, s.trace_id, names.get(s.parent_id))
                            for s in spans))
    assert trees[0] == trees[1]


def test_latency_stats_is_registry_alias(obs_env):
    _, q, _, idx, _, _ = obs_env
    obs = Observability()
    eng = AnnServeEngine(idx, obs=obs, batch_buckets=(8, 32))
    reqs = _wave(eng, q)
    lat = eng.latency_stats()
    merged = Histogram()
    for mode in {eng.route(r)[1] for r in reqs}:
        merged.merge(obs.registry.histogram("juno_engine_request_seconds",
                                            mode=mode))
    assert merged.n == lat["n"] == len(reqs)
    assert merged.max == lat["max"]
    assert lat["p50"] <= merged.percentile(0.75) <= lat["max"]


def test_store_series_count_its_operations(obs_env, tmp_path):
    _, _, cfg, idx, _, _ = obs_env
    reg = MetricsRegistry()
    store = ArtifactStore(str(tmp_path / "s"), registry=reg)
    for _ in range(2):
        store.put("main", idx, cfg)
    store.get("main", device="cpu")
    for v in (1, 2, None):
        store.verify("main", v)
    snap = reg.snapshot()
    for op, n in (("put", 2), ("load", 1), ("verify", 3)):
        assert snap[f'juno_store_ops_total{{op="{op}"}}'] == n
        assert snap[f'juno_store_op_seconds{{op="{op}"}}']["n"] == n


def test_merge_scheduler_series_equal_its_stats(obs_env):
    _, _, _, idx, _, _ = obs_env
    eng = AnnServeEngine(idx, side_capacity=16, max_minors=2, obs=True)
    mut = eng.index
    rng = np.random.default_rng(3)
    for _ in range(3):
        c = int(np.argmin([mut.free_slots(c) for c in range(16)]))
        cent = mut.data.ivf.centroids[c].numpy()
        eng.insert((cent[None] + 0.02 * rng.standard_normal(
            (mut.free_slots(c) + 16, cent.shape[0]))).astype(np.float32))
    row = mut.data.ivf.point_ids[c][mut.data.ivf.valid[c]].tolist()
    eng.delete(row[:40])
    eng.compact()
    st = eng.scheduler.stats
    assert st["folded"] > 0 and st["drains"] == 1 and mut._max_minors == 2
    snap = eng.obs.registry.snapshot()
    assert snap["juno_merge_steps_total"] == st["steps"]
    assert snap["juno_merge_folded_total"] == st["folded"]
    assert snap["juno_merge_drains_total"] == st["drains"]
    assert snap["juno_merge_step_seconds"]["n"] == st["steps"]
    assert snap["juno_engine_inserts_total"] == eng.stats["inserts"]
    assert snap["juno_engine_deletes_total"] == eng.stats["deletes"] == 40


def test_recall_probe_reranks_on_the_vectors_device():
    v = torch.randn(100, 4)
    probe = RecallProbe(v, k=3, every=1)      # a tensor stays where it is
    assert probe.vectors.device == v.device
    ids = exact_topk_ids(v[:2].numpy(), v, 3)
    assert ids.shape == (2, 3) and (ids[:, 0] == [0, 1]).all()
