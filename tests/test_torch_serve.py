"""The port's serving engine against ``repro.serve.ann.AnnServeEngine``.

Both engines, in the same configuration (``fused`` True or False), get the
same request stream over the same index (built by ``repro``, carried
across bit-exactly); the stream routes to all four tiers. Requests served
by tier M or L (hit counts) must match exactly; the others' ids must match
up to score ties and their scores within rtol 1e-5 (f32 sums over S in
another order). The engines must batch identically: the same
``stats["signatures"]`` lattice points and counts, and the same ticks.

The mutation plane (``insert``, ``delete``, ``compact(rebuild="auto")``,
``swap_index``, and the freshness tiers with ``max_minors``) is held to
the reference engine's the same way, with the same ``stats`` and
``generation``; the rt engine's probe budgets are recomputed after an
insert batch, as the reference's.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_mutable import assert_same_state, fresh_points, near_points
from _torch_parity import assert_ids_equal_up_to_ties, to_port
from repro.core import JunoConfig, build
from repro.data import DEEP_LIKE, TTI_LIKE, make_dataset
from repro.serve.ann import AnnServeEngine as JaxEngine
from repro_torch.serve.ann import AnnServeEngine


@pytest.fixture(scope="module", params=["l2", "ip"])
def served(request):
    metric = request.param
    spec = DEEP_LIKE if metric == "l2" else TTI_LIKE
    pts, q = make_dataset(spec, 4000, 96, key=jax.random.PRNGKey(31))
    cfg = JunoConfig(n_clusters=16, n_entries=32, metric=metric,
                     calib_queries=16, kmeans_iters=4)
    ref = build(pts, cfg, jax.random.PRNGKey(4))
    return metric, np.asarray(q), ref, to_port(ref)


def _stream(q):
    """A mixed stream: k in {10, 100} (request k 7 and 60 round up),
    recall targets 0.95 (tier H), 0.85 (H2), 0.6 (M) and 0.3 (L), explicit
    and default nprobe, 1 to 40 rows."""
    rng = np.random.default_rng(0)
    out, lo = [], 0
    for i in range(20):
        rows = int(rng.integers(1, 12)) if i != 5 else 40
        rows = min(rows, q.shape[0] - lo) or 1
        out.append(dict(queries=q[lo:lo + rows], k=(7, 10, 60, 100)[i % 4],
                        recall_target=(0.95, 0.85, 0.6, 0.3)[(i // 4 + i) % 4],
                        nprobe=(0, 8)[(i // 3) % 2]))
        lo = (lo + rows) % (q.shape[0] - 1)
    return out


@pytest.mark.parametrize("fused", [True, False])
def test_engine_matches_reference_engine(served, fused):
    metric, q, ref, port = served
    jeng = JaxEngine(ref, metric=metric, fused=fused)
    peng = AnnServeEngine(port, metric=metric, fused=fused)
    stream = _stream(q)
    jreqs = [jeng.submit(**r) for r in stream]
    preqs = [peng.submit(**r) for r in stream]
    tiers = [peng.route(r)[1] for r in preqs]
    assert set(tiers) == ({"H2", "M", "L"} if fused else {"H", "H2", "M", "L"})
    assert jeng.run() == peng.run() == sum(len(r["queries"]) for r in stream)
    assert peng.stats["signatures"] == jeng.stats["signatures"]
    assert peng.stats["ticks"] == jeng.stats["ticks"]
    for jr, pr, tier in zip(jreqs, preqs, tiers):
        assert pr.done and pr.ids.shape == jr.ids.shape
        if tier in ("M", "L"):
            np.testing.assert_array_equal(pr.ids, jr.ids)
            np.testing.assert_array_equal(pr.scores, jr.scores)
        else:
            assert_ids_equal_up_to_ties(pr.ids, jr.ids, pr.scores, jr.scores)
    assert peng.latency_stats()["n"] == len(stream)
    assert peng.queued_rows == 0


@pytest.mark.parametrize("fused", [True, False])
def test_engine_routes_every_tier(served, fused):
    """M and L route to themselves; H folds into H2 only when fused."""
    metric, q, ref, port = served
    peng = AnnServeEngine(port, metric=metric, fused=fused)
    jeng = JaxEngine(ref, metric=metric, fused=fused)
    h = "H2" if fused else "H"
    cases = [(dict(recall_target=0.95), h), (dict(recall_target=0.85), "H2"),
             (dict(recall_target=0.6), "M"), (dict(recall_target=0.3), "L"),
             (dict(mode="H"), h), (dict(mode="M"), "M"), (dict(mode="L"), "L")]
    for kw, tier in cases:
        req = peng.submit(q[:3], k=10, **kw)
        assert peng.route(req) == jeng.route(jeng.submit(q[:3], k=10, **kw))
        assert peng.route(req)[1] == tier
    assert peng.queued_rows == 3 * len(cases)


def _serve_both(jeng, peng, stream):
    jreqs = [jeng.submit(**r) for r in stream]
    preqs = [peng.submit(**r) for r in stream]
    assert jeng.run() == peng.run()
    for jr, pr in zip(jreqs, preqs):
        if peng.route(pr)[1] in ("M", "L"):
            np.testing.assert_array_equal(pr.ids, jr.ids)
            np.testing.assert_array_equal(pr.scores, jr.scores)
        else:
            assert_ids_equal_up_to_ties(pr.ids, jr.ids, pr.scores, jr.scores)


@pytest.mark.parametrize("max_minors", [0, 2])
@pytest.mark.parametrize("fused", [True, False])
def test_engine_mutation_plane_matches_reference(served, fused, max_minors):
    """Insert, spill past the side buffer's capacity (max_minors=2 promotes
    it instead of refusing), delete, compact(rebuild="auto") and serve
    after each: the same results, bookkeeping, stats and generation."""
    metric, q, ref, _ = served
    kw = dict(metric=metric, fused=fused, side_capacity=16,
              max_minors=max_minors)
    jeng = JaxEngine(ref, **kw)
    peng = AnnServeEngine(to_port(ref), **kw)
    stream = _stream(q)[:8]          # every tier, both k
    rng = np.random.default_rng(7)
    pts = np.asarray(ref.ivf.centroids)[np.asarray(ref.ivf.labels)]
    pm = peng.index
    c = int(np.argmin([pm.free_slots(i) for i in range(16)]))
    for step in ("insert", "spill", "delete", "compact"):
        if step == "insert":
            new = fresh_points(pts, 50, rng)
            assert peng.insert(new) == jeng.insert(new)
        elif step == "spill":
            # with tiers, each later batch promotes the full L0
            for extra in ((16, 16, 8) if max_minors else (12,)):
                new = near_points(pm.data.ivf.centroids[c].numpy(),
                                  pm.free_slots(c) + extra, rng)
                assert peng.insert(new) == jeng.insert(new)
            assert len(pm._minors) == (2 if max_minors else 0)
            assert pm.delta_fill == jeng.index.delta_fill > 0
        elif step == "delete":
            ids = pm.data.ivf.point_ids[c][pm.data.ivf.valid[c]][:5].tolist()
            ids += sorted(set(pm._loc) - set(ids))[:30:3]
            assert peng.delete(ids) == jeng.delete(ids) == len(ids)
        else:
            assert peng.compact() == jeng.compact()
            assert pm.delta_fill == 0
        assert_same_state(pm, jeng.index)
        _serve_both(jeng, peng, stream)
    assert peng.generation == jeng.generation
    for key in ("inserts", "deletes", "swaps", "ticks", "signatures"):
        assert peng.stats[key] == jeng.stats[key], key
    if max_minors:
        assert peng.scheduler.stats == jeng.scheduler.stats


def test_engine_swap_index(served):
    """swap_index() with no argument rebuilds from the live state (the
    results stay); with a caller's index it replaces the state."""
    metric, q, ref, _ = served
    jeng = JaxEngine(ref, metric=metric, side_capacity=16)
    peng = AnnServeEngine(to_port(ref), metric=metric, side_capacity=16)
    pm = peng.index
    c = int(np.argmin([pm.free_slots(i) for i in range(16)]))
    new = near_points(pm.data.ivf.centroids[c].numpy(),
                      pm.free_slots(c) + 8, np.random.default_rng(8))
    peng.insert(new)
    jeng.insert(new)
    assert peng.swap_index() == jeng.swap_index() == 1
    assert pm.side_fill == 0 and peng.stats["swaps"] == 1
    assert_same_state(pm, jeng.index)
    _serve_both(jeng, peng, _stream(q)[:8])
    assert peng.swap_index(to_port(ref)) == 2
    assert pm.n_live == int(np.asarray(ref.ivf.valid).sum())
    assert pm._next_id == jeng.index._next_id


def test_rt_engine_budget_refreshes_after_insert(served):
    """An insert batch bumps rt_mutations and grows the grid's reaches; the
    next route() recomputes the routing state and the request's budget,
    as the reference engine does."""
    metric, q, ref, _ = served
    jeng = JaxEngine(ref, metric=metric, prefilter="rt")
    grid = {f: np.asarray(getattr(jeng.index.rt_grid, f))
            for f in jeng.index.rt_grid._fields}
    from repro_torch import rt
    peng = AnnServeEngine(to_port(ref), metric=metric, prefilter="rt",
                          rt_grid=rt.grid_from_arrays(grid, "cpu", prefix=""))
    preq, jreq = peng.submit(q[:6], k=10), jeng.submit(q[:6], k=10)
    assert peng.route(preq) == jeng.route(jreq)
    grid0, state0 = peng.rt_grid, peng._rt_state
    assert preq.rt_epoch == peng.index.rt_mutations == 0
    # points far out along each probed centroid's residual grow its reach
    far = (np.asarray(ref.ivf.centroids)[:4] * 1.5).astype(np.float32)
    peng.insert(far)
    jeng.insert(far)
    assert peng.index.rt_mutations == jeng.index.rt_mutations == 1
    assert peng.rt_grid is not grid0
    np.testing.assert_array_equal(peng.rt_grid.slot_reach.numpy(),
                                  np.asarray(jeng.index.rt_grid.slot_reach))
    assert peng.route(preq) == jeng.route(jreq)
    assert preq.rt_epoch == 1 and peng._rt_state is not state0
    assert peng._rt_state[0] is peng.rt_grid
    peng.run()
    jeng.run()
    assert preq.done and preq.ids.shape == jreq.ids.shape


def _index_arrays(port):
    return [t.clone() for t in (port.cluster_codes, port.ivf.point_ids,
                                port.ivf.valid)]


def _assert_index_arrays(port, arrays):
    for got, want in zip((port.cluster_codes, port.ivf.point_ids,
                          port.ivf.valid), arrays):
        assert torch.equal(got, want)


def test_two_engines_over_one_index_match_reference(served):
    """Two engines over one bare index each own a copy: each equals its own
    reference engine (ids handed out, state, results) whatever the other
    one inserts and deletes."""
    metric, q, ref, _ = served
    port = to_port(ref)
    kw = dict(metric=metric, side_capacity=16)
    pengs = [AnnServeEngine(port, **kw), AnnServeEngine(port, **kw)]
    jengs = [JaxEngine(ref, **kw), JaxEngine(ref, **kw)]
    rng = np.random.default_rng(11)
    pts = np.asarray(ref.ivf.centroids)[np.asarray(ref.ivf.labels)]
    for i, (peng, jeng) in enumerate(zip(pengs, jengs)):
        new = fresh_points(pts, 5 + 10 * i, rng)
        assert peng.insert(new) == jeng.insert(new)
        gone = list(range(3 * i, 3 * i + 3))
        assert peng.delete(gone) == jeng.delete(gone) == 3
    for peng, jeng in zip(pengs, jengs):
        assert_same_state(peng.index, jeng.index)
        _serve_both(jeng, peng, _stream(q)[:8])


def test_bare_index_searches_as_built_after_engine_mutates(served):
    """An engine's inserts and deletes leave the index it was given as
    built: a later engine over it equals a fresh reference engine."""
    metric, q, ref, _ = served
    port = to_port(ref)
    before = _index_arrays(port)
    eng = AnnServeEngine(port, metric=metric, side_capacity=16)
    pts = np.asarray(ref.ivf.centroids)[np.asarray(ref.ivf.labels)]
    eng.insert(fresh_points(pts, 40, np.random.default_rng(12)))
    eng.delete(list(range(0, 60, 2)))
    eng.compact()
    _assert_index_arrays(port, before)
    _serve_both(JaxEngine(ref, metric=metric),
                AnnServeEngine(port, metric=metric), _stream(q)[:8])


def test_swap_data_leaves_callers_index_unchanged(served):
    metric, _, ref, _ = served
    new_data = to_port(ref)
    before = _index_arrays(new_data)
    eng = AnnServeEngine(to_port(ref), metric=metric, side_capacity=16)
    eng.swap_index(new_data)
    pts = np.asarray(ref.ivf.centroids)[np.asarray(ref.ivf.labels)]
    eng.insert(fresh_points(pts, 30, np.random.default_rng(13)))
    eng.delete(list(range(1, 40, 3)))
    assert eng.index.n_live == int(np.asarray(ref.ivf.valid).sum()) + 30 - 13
    _assert_index_arrays(new_data, before)
