"""The port's LSM freshness tiers against ``repro.core.freshness``.

Both packages' mutable index (``max_minors=2``, a 16-slot L0) take the
same forced spills into one cluster: the first fills L0, each later batch
promotes it into a minor generation (``promote_l0``). Then deletes free
slots in that cluster, and ``fold_step`` or ``MergeScheduler.drain`` fold
the minors back. After each step the bookkeeping, the minor generations
and the combined delta view (constant capacity ``B · (1 + max_minors)``)
must be equal, and every tier's results must match the reference's
(counts exactly, other scores within rtol 1e-5, ids up to ties). The
search over the tiers must equal the search after ``rebuild_index``.
"""
import copy

import jax
import numpy as np
import pytest

from _torch_mutable import (assert_same_results, assert_same_state,
                            near_points, port_grid)
from _torch_parity import assert_ids_equal_up_to_ties, to_port
from repro import rt as jrt
from repro.build.merge import fold_step as jax_fold_step
from repro.core import JunoConfig, build
from repro.core import freshness as jfresh
from repro.core import juno as jjuno
from repro.data import DEEP_LIKE, TTI_LIKE, make_dataset
from repro_torch.build import fold_step, rebuild_index
from repro_torch.core import freshness as pfresh
from repro_torch.core.juno import MutableJunoIndex

L0 = 16
MAX_MINORS = 2
NPROBE = 4
TIERS = {"H": dict(mode="H"), "M": dict(mode="M"), "L": dict(mode="L"),
         "H2": dict(mode="H2"), "H2_fused": dict(mode="H2", fused=True)}


@pytest.fixture(scope="module", params=["l2", "ip"])
def tiered(request):
    """Both indexes after three forced spills of L0 slots each into the
    fullest cluster (L0 full, two minor generations), then deletes of 20
    of that cluster's points, one of L0's and one of each minor's."""
    metric = request.param
    spec = DEEP_LIKE if metric == "l2" else TTI_LIKE
    pts, q = make_dataset(spec, 4000, 40, key=jax.random.PRNGKey(21))
    cfg = JunoConfig(n_clusters=16, n_entries=32, calib_queries=16,
                     kmeans_iters=4, metric=metric)
    ref = build(pts, cfg, jax.random.PRNGKey(6))
    grid = jrt.build_grid(ref, metric=metric)
    jm = jjuno.MutableJunoIndex(ref, side_capacity=L0, rt_grid=grid)
    pm = MutableJunoIndex(to_port(ref), side_capacity=L0,
                          rt_grid=port_grid(grid))
    for m in (jm, pm):
        m.enable_tiers(MAX_MINORS)
    rng = np.random.default_rng(1)
    c = int(np.argmin([pm.free_slots(i) for i in range(16)]))
    caps = []
    for i in range(3):
        extra = pm.free_slots(c) + L0 if i == 0 else L0
        new = near_points(pm.data.ivf.centroids[c].numpy(), extra, rng)
        assert pm.insert(new) == jm.insert(new)
        caps.append(pm.delta_view().capacity)
    assert len(pm._minors) == len(jm._minors) == MAX_MINORS
    assert caps == [L0 * (1 + MAX_MINORS)] * 3
    stages = {"promoted": (copy.deepcopy(pm), copy.deepcopy(jm))}
    in_c = pm.data.ivf.point_ids[c][pm.data.ivf.valid[c]][:20].tolist()
    ids = (in_c + pm.side.ids[:1].tolist()
           + [int(m.ids[0]) for m in pm._minors])
    assert pm.delete(ids) == jm.delete(ids)
    stages["deleted"] = (copy.deepcopy(pm), copy.deepcopy(jm))
    return metric, np.asarray(q), c, stages


def _assert_same_tiers(pm, jm):
    assert_same_state(pm, jm)
    assert [m.gen for m in pm._minors] == [m.gen for m in jm._minors]
    for pmin, jmin in zip(pm._minors, jm._minors):
        for f in ("cluster", "ids", "valid"):
            np.testing.assert_array_equal(getattr(pmin, f),
                                          getattr(jmin, f), err_msg=f)
        np.testing.assert_array_equal(pmin.codes.numpy(),
                                      np.asarray(jmin.materialize()))
    pv, jv = pm.delta_view(), jm.delta_view()
    assert (pv is None) == (jv is None)
    if pv is not None:
        for f in ("codes", "cluster", "ids", "valid"):
            np.testing.assert_array_equal(getattr(pv, f).numpy(),
                                          np.asarray(getattr(jv, f)),
                                          err_msg=f"delta.{f}")
    assert pm.delta_fill == jm.delta_fill


@pytest.mark.parametrize("stage", ["promoted", "deleted"])
def test_tiers_match_reference(tiered, stage):
    _, _, _, stages = tiered
    _assert_same_tiers(*stages[stage])


@pytest.mark.parametrize("prefilter", ["scan", "rt"])
@pytest.mark.parametrize("tier", list(TIERS))
def test_search_over_tiers_matches_reference(tiered, tier, prefilter):
    metric, q, _, stages = tiered
    pm, jm = stages["deleted"]
    assert_same_results(pm, jm, q, metric=metric, prefilter=prefilter,
                        nprobe=NPROBE, k=20, batch=20, **TIERS[tier])


@pytest.mark.parametrize("budget,lane", [(1, None), (32, None), (32, "c")])
def test_fold_step_matches_reference(tiered, budget, lane):
    _, _, c, stages = tiered
    pm, jm = copy.deepcopy(stages["deleted"])
    lane = (c, c + 1) if lane == "c" else lane
    moved = fold_step(pm, max_clusters=budget, lane=lane)
    assert moved == jax_fold_step(jm, max_clusters=budget, lane=lane) > 0
    _assert_same_tiers(pm, jm)
    # a lane without the spill cluster folds nothing
    assert fold_step(pm, lane=(c + 1, c + 2)) == 0


def test_promote_l0_matches_reference(tiered):
    _, _, _, stages = tiered
    pm, jm = copy.deepcopy(stages["deleted"])
    fold_step(pm)
    jax_fold_step(jm)
    assert pm.side_fill == jm.side_fill > 0
    gp, gj = pfresh.promote_l0(pm), jfresh.promote_l0(jm)
    assert gp.gen == gj.gen and gp.live == gj.live
    _assert_same_tiers(pm, jm)
    assert pm.side_fill == 0 and pm.delta_view().capacity == L0 * 3


def test_scheduler_drain_matches_reference(tiered):
    metric, q, _, stages = tiered
    pm, jm = copy.deepcopy(stages["deleted"])
    sp = pfresh.MergeScheduler(pm, clusters_per_step=1)
    sj = jfresh.MergeScheduler(jm, clusters_per_step=1)
    assert sp.pending == sj.pending > 0
    assert sp.drain() == sj.drain()
    assert sp.stats == sj.stats
    assert sp.pending == sj.pending
    _assert_same_tiers(pm, jm)
    assert_same_results(pm, jm, q, metric=metric, nprobe=NPROBE, k=20,
                        batch=20, mode="H")


def test_maybe_step_waits_for_work(tiered):
    _, _, _, stages = tiered
    pm, jm = copy.deepcopy(stages["deleted"])
    sp, sj = pfresh.MergeScheduler(pm), jfresh.MergeScheduler(jm)
    assert sp.maybe_step() == sj.maybe_step() > 0      # minors pending
    _assert_same_tiers(pm, jm)
    pm.swap_data(rebuild_index(pm))
    # tiers still on, but L0 empty and no minor generation: nothing to do
    assert pm._max_minors == MAX_MINORS and sp.maybe_step() == 0
    pm.enable_tiers(0)
    assert sp.maybe_step() == 0


@pytest.mark.parametrize("mode", ["H", "M", "L"])
def test_search_over_tiers_equals_rebuild(tiered, mode):
    """Delta points score exactly as in-cluster points: the rebuilt index
    returns the same scores, ids up to exact ties."""
    metric, q, _, stages = tiered
    pm, _ = copy.deepcopy(stages["deleted"])
    kw = dict(metric=metric, mode=mode, nprobe=NPROBE, k=20)
    s0, i0 = pm.search(q, **kw)
    pm.swap_data(rebuild_index(pm))
    assert pm.delta_view() is None and not pm._minors
    s1, i1 = pm.search(q, **kw)
    np.testing.assert_array_equal(s1.numpy(), s0.numpy())
    assert_ids_equal_up_to_ties(i1.numpy(), i0.numpy(), s1.numpy(),
                                s0.numpy(), rtol=0.0, atol=0.0)


def test_combined_delta_capacity_is_constant(tiered):
    _, _, _, stages = tiered
    pm, _ = copy.deepcopy(stages["deleted"])
    for minors in ([], pm._minors[:1], pm._minors):
        view = pfresh.combined_delta(pm.side, minors, MAX_MINORS)
        assert view.capacity == L0 * (1 + MAX_MINORS)
    with pytest.raises(RuntimeError, match="exceed max_minors"):
        pfresh.combined_delta(pm.side, pm._minors, 1)
