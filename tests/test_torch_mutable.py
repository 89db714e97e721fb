"""The port's mutable index against ``repro.core.juno.MutableJunoIndex``.

The same sequence (insert, a batch that spills into the side buffer,
delete, ``compact``, ``swap_data(rebuild_index(...))``, insert again) goes
to both packages' mutable index over the same index (built by ``repro``,
carried across bit-exactly) and the same rt grid. After each step the
bookkeeping (``_loc``, ``_free``, ``_side_free``, ``_next_id``), the side
buffer and the padded storage must be equal, and every tier's results
(scan and rt, side buffer included) must match: counts exactly, other
scores within rtol 1e-5 and ids up to score ties.

Also here: ``_label_encode``, ``update_radii`` and ``rebuild_index``
against the reference, ``compact`` as a search no-op on the CPU, and the
fail-closed cases (each raises the reference's error and changes nothing).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mutable import (assert_same_grid, assert_same_results,
                            assert_same_state, fresh_points, near_points,
                            port_grid)
from _torch_parity import assert_ids_equal_up_to_ties, to_port
from repro import rt as jrt
from repro.build.rebuild import _reconstructed_sq as jax_reconstructed_sq
from repro.build.rebuild import rebuild_index as jax_rebuild_index
from repro.core import JunoConfig, build
from repro.core import juno as jjuno
from repro.data import DEEP_LIKE, TTI_LIKE, make_dataset
from repro_torch import rt
from repro_torch.build import rebuild_index
from repro_torch.build.rebuild import _reconstructed_sq
from repro_torch.core import juno as pjuno
from repro_torch.core.juno import MutableJunoIndex

SIDE = 32
NPROBE = 4
TIERS = {
    "H": dict(mode="H"),
    "M": dict(mode="M"),
    "L": dict(mode="L"),
    "H2": dict(mode="H2"),
    "H2_fused": dict(mode="H2", fused=True),
}
STEPS = ("insert", "spill", "delete", "compact", "rebuild", "insert_after")


@pytest.fixture(scope="module", params=["l2", "ip"])
def base(request):
    metric = request.param
    spec = DEEP_LIKE if metric == "l2" else TTI_LIKE
    pts, q = make_dataset(spec, 4000, 40, key=jax.random.PRNGKey(11))
    cfg = JunoConfig(n_clusters=16, n_entries=32, calib_queries=16,
                     kmeans_iters=4, metric=metric)
    ref = build(pts, cfg, jax.random.PRNGKey(5))
    grid = jrt.build_grid(ref, metric=metric)
    return metric, np.asarray(pts), np.asarray(q), ref, grid


def _pair(base):
    _, _, _, ref, grid = base
    jm = jjuno.MutableJunoIndex(ref, side_capacity=SIDE, rt_grid=grid)
    pm = MutableJunoIndex(to_port(ref), side_capacity=SIDE,
                          rt_grid=port_grid(grid))
    return pm, jm


def _fullest(pm):
    return int(np.argmin([pm.free_slots(c)
                          for c in range(pm.data.ivf.n_clusters)]))


def _apply(step, pm, jm, pts, metric, rng, ctx):
    """One step of the sequence, applied to both indexes; ``ctx`` carries
    the spill cluster from step to step."""
    if step in ("insert", "insert_after"):
        new = fresh_points(pts, 120, rng)
        assert pm.insert(new) == jm.insert(new)
    elif step == "spill":
        c = ctx["c"] = _fullest(pm)
        fill = pm.side_fill
        new = near_points(pm.data.ivf.centroids[c].numpy(),
                          pm.free_slots(c) + 20, rng)
        assert pm.insert(new) == jm.insert(new)
        assert pm.side_fill == fill + 20
    elif step == "delete":
        c = ctx["c"]
        spilled = (pm.side.cluster == c) & pm.side.valid
        side_ids = pm.side.ids[spilled].tolist()
        in_c = pm.data.ivf.point_ids[c][pm.data.ivf.valid[c]].tolist()
        rest = sorted(set(pm._loc) - set(side_ids) - set(in_c))
        ids = (side_ids[:3] + in_c[:12]
               + rng.choice(rest, 60, replace=False).tolist())
        assert pm.delete(ids) == jm.delete(ids) == len(ids)
    elif step == "compact":
        assert pm.compact() == jm.compact() >= 12
        assert pm.side_fill == jm.side_fill >= 5
    elif step == "rebuild":
        pm.swap_data(rebuild_index(pm))
        jm.swap_data(jax_rebuild_index(jm))
        assert pm.rt_grid is None and pm.side_fill == 0
        pm.rt_grid = port_grid(jm.ensure_rt_grid(metric=metric))


@pytest.fixture(scope="module")
def states(base):
    """Both indexes after each step of the sequence (deep copies)."""
    metric, pts, _, _, _ = base
    rng = np.random.default_rng(0)
    pm, jm = _pair(base)
    out, ctx = {}, {}
    for step in STEPS:
        _apply(step, pm, jm, pts, metric, rng, ctx)
        out[step] = (copy.deepcopy(pm), copy.deepcopy(jm))
    return out


@pytest.mark.parametrize("step", STEPS)
def test_bookkeeping_matches_reference(base, states, step):
    pm, jm = states[step]
    assert_same_state(pm, jm)
    assert_same_grid(pm.rt_grid, jm.rt_grid)
    assert pm.n_live == jm.n_live and pm.side_fill == jm.side_fill
    if step in ("spill", "delete", "compact"):
        assert pm.side_fill > 0


@pytest.mark.parametrize("prefilter", ["scan", "rt"])
@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("step", STEPS)
def test_search_matches_reference(base, states, step, tier, prefilter):
    metric, _, q, _, _ = base
    pm, jm = states[step]
    assert_same_results(pm, jm, q, metric=metric, prefilter=prefilter,
                        nprobe=NPROBE, k=20, batch=20, **TIERS[tier])


def test_side_points_are_found(base, states):
    """Spilled points come back for a query on their cluster's centroid
    (tier H, scan and rt). They tie with the in-cluster points of the same
    spill batch (one PQ code), so k covers the whole cluster."""
    metric, _, _, _, _ = base
    pm, _ = states["spill"]
    pos = torch.nonzero(pm.side.valid)[:, 0]
    c = int(pm.side.cluster[pos[0]])
    q = pm.data.ivf.centroids[c][None].expand(4, -1).numpy().copy()
    for prefilter in ("scan", "rt"):
        _, ids = pm.search(q, metric=metric, mode="H", nprobe=NPROBE,
                           k=pm.data.cluster_codes.shape[1] + SIDE,
                           prefilter=prefilter)
        assert set(pm.side.ids[pos].tolist()) <= set(ids[0].tolist())


def test_three_stage_equals_composed_with_side(base, states):
    """Side points take the ``probe_ok`` the three-stage kernel returns:
    the same results as the composed rt mask."""
    metric, _, q, _, _ = base
    pm, _ = states["spill"]
    kw = dict(metric=metric, mode="H2", fused=True, nprobe=NPROBE, k=20,
              prefilter="rt")
    s3, i3 = pm.search(q, **kw)
    s2, i2 = pm.search(q, fused3=False, **kw)
    np.testing.assert_array_equal(i3.numpy(), i2.numpy())
    np.testing.assert_array_equal(s3.numpy(), s2.numpy())


@pytest.mark.parametrize("mode", ["H", "M", "L"])
def test_compact_is_bit_stable_on_cpu(base, states, mode):
    """Side points score exactly as in-cluster points on the CPU: folding
    them back changes no score, and ids only inside exact ties."""
    metric, _, q, _, _ = base
    before, _ = states["delete"]
    after, _ = states["compact"]
    for prefilter in ("scan", "rt"):
        kw = dict(metric=metric, mode=mode, nprobe=NPROBE, k=20,
                  prefilter=prefilter)
        s0, i0 = before.search(q, **kw)
        s1, i1 = after.search(q, **kw)
        np.testing.assert_array_equal(s1.numpy(), s0.numpy())
        assert_ids_equal_up_to_ties(i1.numpy(), i0.numpy(), s1.numpy(),
                                    s0.numpy(), rtol=0.0, atol=0.0)


def test_label_encode_matches_reference(base):
    _, pts, _, ref, _ = base
    pm, _ = _pair(base)
    new = fresh_points(pts, 200, np.random.default_rng(3))
    lab_r, codes_r = jjuno._label_encode(jnp.asarray(new), ref.ivf.centroids,
                                         ref.codebook)
    lab_p, codes_p = pjuno._label_encode(torch.from_numpy(new), pm.data.ivf,
                                         pm.data.codebook)
    np.testing.assert_array_equal(lab_p.numpy(), np.asarray(lab_r))
    np.testing.assert_array_equal(codes_p.numpy(), np.asarray(codes_r))


def test_label_encode_ties_go_to_the_smaller_index(base):
    """Centroid 9 made a copy of centroid 2: every point nearest to them
    scores both equally and takes 2, the first minimum, as ``jnp.argmin``
    does."""
    _, pts, _, ref, _ = base
    cents = np.asarray(ref.ivf.centroids).copy()
    cents[9] = cents[2]
    ivf = to_port(ref).ivf._replace(
        centroids=torch.from_numpy(cents),
        centroid_sq=torch.from_numpy(np.sum(cents * cents, -1)))
    new = near_points(cents[2], 20, np.random.default_rng(5))
    lab_r, codes_r = jjuno._label_encode(jnp.asarray(new), jnp.asarray(cents),
                                         ref.codebook)
    lab_p, codes_p = pjuno._label_encode(torch.from_numpy(new), ivf,
                                         to_port(ref).codebook)
    np.testing.assert_array_equal(lab_p.numpy(), np.asarray(lab_r))
    np.testing.assert_array_equal(codes_p.numpy(), np.asarray(codes_r))
    assert (lab_p == 2).any() and not (lab_p == 9).any()


def test_empty_side_buffer_device_matches_reference():
    side = pjuno.empty_side_buffer(5, 3, device="cpu")
    ref = jjuno.empty_side_buffer(5, 3)
    for name in ("codes", "cluster", "ids", "valid"):
        got, want = getattr(side, name), np.asarray(getattr(ref, name))
        assert got.device.type == "cpu"
        assert got.numpy().dtype == want.dtype, name
        np.testing.assert_array_equal(got.numpy(), want)
    if not torch.cuda.is_available():    # default is cuda, never the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pjuno.empty_side_buffer(5, 3)


def test_update_radii_bit_equal(base):
    _, _, _, _, grid = base
    rng = np.random.default_rng(4)
    clusters = rng.integers(0, 16, 50)
    reaches = (np.abs(rng.standard_normal(50)) * 3).astype(np.float32)
    want = jrt.update_radii(grid, clusters, reaches)
    got = rt.update_radii(port_grid(grid), clusters, reaches)
    assert_same_grid(got, want)
    assert not np.array_equal(np.asarray(want.slot_reach),
                              np.asarray(grid.slot_reach))


def test_rebuild_arrays_match_reference(base, states):
    pm, jm = states["compact"]
    got, want = rebuild_index(pm), jax_rebuild_index(jm)
    for g, w in ((got.ivf.point_ids, want.ivf.point_ids),
                 (got.ivf.valid, want.ivf.valid),
                 (got.ivf.labels, want.ivf.labels),
                 (got.cluster_codes, want.cluster_codes),
                 (got.codes, want.codes)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got.points_sq.numpy(),
                               np.asarray(want.points_sq), rtol=1e-6)


def test_rebuild_grows_capacity_only_when_needed(base):
    """A cluster filled past its capacity (through the side buffer) makes
    the rebuild grow P to the next multiple of 8 plus 8, as the reference."""
    _, pts, _, ref, _ = base
    pm, jm = _pair(base)
    rng = np.random.default_rng(5)
    c = _fullest(pm)
    new = near_points(pm.data.ivf.centroids[c].numpy(),
                      pm.free_slots(c) + 9, rng)
    pm.insert(new)
    jm.insert(new)
    got, want = rebuild_index(pm), jax_rebuild_index(jm)
    p = ref.cluster_codes.shape[1]
    assert got.cluster_codes.shape[1] == want.cluster_codes.shape[1] > p
    np.testing.assert_array_equal(got.ivf.point_ids.numpy(),
                                  np.asarray(want.ivf.point_ids))
    np.testing.assert_allclose(
        _reconstructed_sq(got.ivf.centroids.numpy(), got.codebook,
                          np.full(3, c), got.cluster_codes[c, :3].numpy()),
        jax_reconstructed_sq(np.asarray(ref.ivf.centroids), ref.codebook,
                             np.full(3, c),
                             np.asarray(want.cluster_codes[c, :3])),
        rtol=1e-6)


# ---------------------------------------------------------------------------
# fail-closed cases: the reference's error, and no change of state
# ---------------------------------------------------------------------------
def _snapshot(pm):
    return copy.deepcopy((pm._loc, pm._free, pm._side_free, pm._next_id,
                          tuple(pm.side), pm.data.ivf.point_ids,
                          pm.data.ivf.valid, pm.data.cluster_codes,
                          pm.rt_mutations))


def _assert_unchanged(pm, snap):
    now = _snapshot(pm)
    for a, b in zip(now, snap):
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                assert torch.equal(x, y)
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


def _spilled_pair(base):
    pm, jm = _pair(base)
    rng = np.random.default_rng(6)
    c = _fullest(pm)
    new = near_points(pm.data.ivf.centroids[c].numpy(),
                      pm.free_slots(c) + SIDE, rng)
    pm.insert(new)
    jm.insert(new)
    assert pm.side_fill == SIDE
    return pm, jm, c, rng


def test_overflowing_insert_raises_and_changes_nothing(base):
    pm, jm, c, rng = _spilled_pair(base)
    new = near_points(pm.data.ivf.centroids[c].numpy(), 3, rng)
    snap = _snapshot(pm)
    with pytest.raises(RuntimeError, match="does not fit"):
        jm.insert(new)
    with pytest.raises(RuntimeError, match="does not fit"):
        pm.insert(new)
    _assert_unchanged(pm, snap)
    assert_same_state(pm, jm)


def test_failing_device_write_changes_nothing(base, monkeypatch):
    pm, jm, c, rng = _spilled_pair(base)
    pm.delete(pm.side.ids[:2].tolist())
    other = (c + 1) % pm.data.ivf.n_clusters
    new = np.concatenate([
        near_points(pm.data.ivf.centroids[other].numpy(), 10, rng),
        near_points(pm.data.ivf.centroids[c].numpy(), 2, rng)])
    snap = _snapshot(pm)

    def boom(*a, **k):
        raise MemoryError("device out of memory")
    monkeypatch.setattr(pm, "_apply_insert", boom)
    with pytest.raises(MemoryError):
        pm.insert(new)
    _assert_unchanged(pm, snap)


def test_bad_delete_raises_and_changes_nothing(base):
    pm, jm, _, _ = _spilled_pair(base)
    live = sorted(pm._loc)[:3]
    snap = _snapshot(pm)
    for ids, what in ((live + [10 ** 7], "unknown"),
                      (live + live[:1], "duplicate")):
        with pytest.raises(KeyError):
            jm.delete(ids)
        with pytest.raises(KeyError):
            pm.delete(ids)
        _assert_unchanged(pm, snap)
    pm.delete(live[:1])
    with pytest.raises(KeyError):
        pm.delete(live[:1])                     # already deleted


@pytest.mark.parametrize("fault", ["double_free", "reused_side_slot"])
def test_corrupt_compact_plan_raises_and_changes_nothing(base, fault):
    pm, jm, c, _ = _spilled_pair(base)
    ids = pm.data.ivf.point_ids[c][pm.data.ivf.valid[c]][:4].tolist()
    pm.delete(ids)
    jm.delete(ids)
    for m in (pm, jm):
        if fault == "double_free":
            m._free[c].append(m._free[c][-1])
        else:
            m._side_free.append(int(np.flatnonzero(
                np.asarray(m.side.valid))[0]))
    snap = _snapshot(pm)
    match = "twice" if fault == "double_free" else "already on the free"
    with pytest.raises(RuntimeError, match=match):
        jm.compact()
    with pytest.raises(RuntimeError, match=match):
        pm.compact()
    _assert_unchanged(pm, snap)
