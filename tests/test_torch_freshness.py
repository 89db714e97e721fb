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

With a minor store (``enable_tiers(minor_store=...)``) a promoted L0 is
committed as a minor artifact, equal to the reference's, and faulted back
in on first search, every row verified: a corrupt row raises, a failed
commit changes nothing. A minor written by either package loads in the
other.
"""
import copy
import json
import os

import jax
import numpy as np
import pytest
import torch

from _torch_mutable import (assert_same_results, assert_same_state,
                            near_points, port_grid)
from _torch_parity import assert_ids_equal_up_to_ties, to_port
from repro import rt as jrt
from repro.build import store as jstore
from repro.build.merge import fold_step as jax_fold_step
from repro.core import JunoConfig, build
from repro.core import freshness as jfresh
from repro.core import juno as jjuno
from repro.data import DEEP_LIKE, TTI_LIKE, make_dataset
from repro_torch.build import ArtifactStore as PortStore
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


# ---------------------------------------------------------------------------
# artifact-backed minor generations (enable_tiers(minor_store=...))
# ---------------------------------------------------------------------------

def _minor_arrays(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (12, 6), dtype=np.uint8),
            rng.integers(0, 16, 12).astype(np.int32),
            np.arange(100, 112, dtype=np.int32), rng.random(12) < 0.8)


def test_minors_cross_packages(tmp_path):
    """A minor written by either package loads in the other, bit-equal,
    with equal manifests; a flipped code byte fails both loaders closed."""
    from repro.build import merge as jmerge
    from repro_torch.build import ArtifactError, merge as pmerge
    arrays = _minor_arrays(3)
    paths = {"port": str(tmp_path / "port"), "ref": str(tmp_path / "ref")}
    assert (pmerge.save_minor(paths["port"], *arrays, gen=4)
            == jmerge.save_minor(paths["ref"], *arrays, gen=4))
    loaders = {"port": pmerge.load_minor, "ref": jmerge.load_minor}
    for path in paths.values():
        for load in loaders.values():
            got = load(path)
            for a, b in zip(got[:4], arrays):
                assert a.dtype == np.asarray(b).dtype
                np.testing.assert_array_equal(a, b)
            assert got[4]["gen"] == 4 and got[4]["capacity"] == 12
    torch_codes = pmerge.minor_codes_loader(paths["ref"], "cpu")()
    np.testing.assert_array_equal(torch_codes.numpy(), arrays[0])
    for path in paths.values():
        bad = {k: v for k, v in zip(("codes", "cluster", "ids", "valid"),
                                    map(np.array, arrays))}
        bad["codes"][5, 2] ^= 1
        np.savez(os.path.join(path, "minor.npz"), **bad)
        with pytest.raises(ArtifactError, match="minor code row 5"):
            pmerge.load_minor(path)
        with pytest.raises(jstore.ArtifactError, match="minor code row 5"):
            jmerge.load_minor(path)
        pmerge.load_minor(path, verify_rows=False)    # the explicit opt-out


@pytest.fixture()
def stored(tmp_path):
    """Both packages' mutable index with ``max_minors=2`` and a minor store:
    an L0 of 16 filled by spills into the fullest cluster, then a batch
    that promotes it into a minor committed to each package's store."""
    pts, q = make_dataset(DEEP_LIKE, 3000, 24, key=jax.random.PRNGKey(23))
    cfg = JunoConfig(n_clusters=16, n_entries=32, calib_queries=16,
                     kmeans_iters=4, capacity_mult=1.1)
    ref = build(pts, cfg, jax.random.PRNGKey(6))
    jm = jjuno.MutableJunoIndex(ref, side_capacity=L0)
    pm = MutableJunoIndex(to_port(ref), side_capacity=L0)
    pstore = PortStore(str(tmp_path / "port"))
    jstore_ = jstore.ArtifactStore(str(tmp_path / "ref"))
    pm.enable_tiers(MAX_MINORS, minor_store=pstore)
    jm.enable_tiers(MAX_MINORS, minor_store=jstore_)
    rng = np.random.default_rng(5)
    c = int(np.argmin([pm.free_slots(i) for i in range(16)]))
    ids = []
    for n in (pm.free_slots(c) + L0, 4):
        new = near_points(pm.data.ivf.centroids[c].numpy(), n, rng)
        got = pm.insert(new)
        assert got == jm.insert(new)
        ids += got
    assert len(pm._minors) == len(jm._minors) == 1
    return pm, jm, pstore, jstore_, np.asarray(q), ids


def test_promoted_minor_is_committed(stored):
    pm, jm, pstore, jstore_, _, _ = stored
    pmin, jmin = pm._minors[0], jm._minors[0]
    assert pmin.codes is None and jmin.codes is None       # not faulted in
    assert pstore.latest("minors") == jstore_.latest("minors") == 1
    assert pmin.path == pstore.path("minors", 1)
    with open(os.path.join(pmin.path, "manifest.json")) as fh, \
            open(os.path.join(jmin.path, "manifest.json")) as gh:
        assert json.load(fh) == json.load(gh)
    assert pmin.capacity == L0
    for f in ("cluster", "ids", "valid"):
        np.testing.assert_array_equal(getattr(pmin, f), getattr(jmin, f))


@pytest.mark.parametrize("tier", ["H", "M", "H2", "H2_fused"])
def test_search_over_stored_minors_matches_reference(stored, tier):
    """The first search faults the minor in, every row verified; results
    equal the reference's, and in the distance tiers the promoted ids are
    found (the spills lie within 1e-3 of their centroid, which the queries
    are: the top 100 by distance hold every spill; tier M ranks by hit
    count)."""
    pm, jm, _, _, _, ids = stored
    pmin = pm._minors[0]
    assert len(ids) < 100
    q = pm.data.ivf.centroids.numpy()[pmin.cluster[:4]] + np.float32(1e-4)
    kw = dict(metric="l2", nprobe=NPROBE, k=100, batch=4, **TIERS[tier])
    assert_same_results(pm, jm, q, **kw)
    assert pmin.codes is not None
    np.testing.assert_array_equal(pmin.codes.numpy(),
                                  np.asarray(jm._minors[0].materialize()))
    if tier != "M":
        _, got = pm.search(q, **kw)
        assert np.isin(pmin.ids[pmin.valid], got.numpy()).all()


def test_corrupt_stored_minor_fails_closed(stored):
    from repro_torch.build import ArtifactError
    pm, _, _, _, q, _ = stored
    path = os.path.join(pm._minors[0].path, "minor.npz")
    with np.load(path) as z:
        arrays = {k: z[k].copy() for k in z.files}
    arrays["codes"][0, 0] ^= 1
    np.savez(path, **arrays)
    with pytest.raises(ArtifactError, match="minor code row 0"):
        pm.search(q, metric="l2", nprobe=NPROBE, k=10)
    assert pm._minors[0].codes is None                  # nothing served


def test_failed_minor_commit_changes_nothing(stored, monkeypatch):
    from repro_torch.build import merge as pmerge
    pm, _, _, _, _, _ = stored
    c = int(pm._minors[0].cluster[0])
    rng = np.random.default_rng(9)
    pm.insert(near_points(pm.data.ivf.centroids[c].numpy(),
                          L0 - pm.side_fill, rng))
    before = copy.deepcopy((pm._loc, pm._side_free, pm._next_id,
                            len(pm._minors), pm._minor_gen))
    side = [t.clone() for t in pm.side]

    def fail(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(pmerge, "commit_minor", fail)
    with pytest.raises(OSError, match="disk full"):
        pm.insert(near_points(pm.data.ivf.centroids[c].numpy(), 2, rng))
    assert copy.deepcopy((pm._loc, pm._side_free, pm._next_id,
                          len(pm._minors), pm._minor_gen)) == before
    assert all(torch.equal(a, b) for a, b in zip(pm.side, side))
