"""Shared helpers of the port's mutable-index tests
(``tests/test_torch_mutable.py``, ``test_torch_freshness.py``,
``test_torch_serve.py``): the same mutation sequence goes to the
reference's ``MutableJunoIndex`` and to the port's, and these helpers
compare their state and their search results.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import assert_ids_equal_up_to_ties
from repro import rt as jrt
from repro.core import density as jdensity
from repro.core import juno as jjuno
from repro.core.ivf import filter_clusters as jax_filter_clusters
from repro_torch import rt
from repro_torch.core import density as pdensity
from repro_torch.core.ivf import filter_clusters
from repro_torch.core.juno import _rt_probe_mask

MARGIN = 1e-5    # relative |d² − thr²| within which an rt verdict may flip
# the reference's mask and radius as its search computes them: jitted
_jax_mask = jax.jit(
    lambda g, x, t, c: jjuno._rt_probe_mask(g, x, t, c, 1.0, None))
_jax_radius = jax.jit(lambda g, t: jrt.query_radius(g, t, 1.0))


def port_grid(jgrid):
    """Carry a reference ``CentroidGrid`` across to the port (bit-exact)."""
    return rt.grid_from_arrays(
        {f: np.asarray(getattr(jgrid, f)) for f in jgrid._fields}, "cpu",
        prefix="")


def assert_same_grid(pgrid, jgrid):
    for f in jgrid._fields:
        np.testing.assert_array_equal(getattr(pgrid, f).numpy(),
                                      np.asarray(getattr(jgrid, f)),
                                      err_msg=f)


def assert_same_state(pm, jm):
    """Bookkeeping, side buffer and padded storage equal, exactly."""
    assert pm._loc == jm._loc
    assert pm._free == [[int(s) for s in f] for f in jm._free]
    assert pm._side_free == [int(s) for s in jm._side_free]
    assert pm._next_id == jm._next_id
    assert pm.rt_mutations == jm.rt_mutations
    for f in ("codes", "cluster", "ids", "valid"):
        np.testing.assert_array_equal(getattr(pm.side, f).numpy(),
                                      np.asarray(getattr(jm.side, f)),
                                      err_msg=f"side.{f}")
    for got, want in ((pm.data.ivf.point_ids, jm.data.ivf.point_ids),
                      (pm.data.ivf.valid, jm.data.ivf.valid),
                      (pm.data.cluster_codes, jm.data.cluster_codes)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def rt_flip_rows(pm, jm, q, metric, nprobe):
    """Queries with a probe whose rt verdict differs between the packages
    on the current state; each such probe must lie within MARGIN of its
    disc's boundary, and at most 1 in 20 queries may have one."""
    pgrid, jgrid = pm.rt_grid, jm.rt_grid
    qt = torch.from_numpy(np.array(q, np.float32))
    _, cids = filter_clusters(qt, pm.data.ivf, nprobe=nprobe, metric=metric)
    _, jcids = jax_filter_clusters(jnp.asarray(q), jm.data.ivf,
                                   nprobe=nprobe, metric=metric)
    np.testing.assert_array_equal(cids.numpy(), np.asarray(jcids))
    res = qt - pm.data.ivf.centroids[cids[:, 0]] if metric == "l2" else qt
    tau = pdensity.predict_threshold(pm.data.density,
                                     res.reshape(len(q), -1, 2))
    mine = _rt_probe_mask(pgrid, qt, tau[:, None], cids, 1.0).numpy()
    jtau = jdensity.predict_threshold(
        jm.data.density, jnp.asarray(res.numpy()).reshape(len(q), -1, 2),
        1.0)
    theirs = np.asarray(_jax_mask(jgrid, jnp.asarray(q), jtau[:, None],
                                  jnp.asarray(cids.numpy())))
    flips = mine != theirs
    if flips.any():
        jr = np.asarray(_jax_radius(jgrid, jtau), np.float64)
        qp = (qt @ pgrid.proj).double().numpy()
        slot = pgrid.slot_of.long()[cids].numpy()
        flat = lambda t: t.reshape(-1).double().numpy()[slot]  # noqa: E731
        d2 = ((qp[:, None, 0] - flat(pgrid.cell_c0)) ** 2
              + (qp[:, None, 1] - flat(pgrid.cell_c1)) ** 2)
        thr = jr[:, None] + flat(pgrid.slot_reach)
        gap = np.abs(d2 - thr * thr) / np.maximum(np.maximum(d2, thr * thr),
                                                   1e-30)
        assert (gap[flips] <= MARGIN).all(), gap[flips]
    rows = flips.any(axis=1)
    assert rows.sum() <= max(1, len(q) // 20), f"{rows.sum()} queries flip"
    return rows


def assert_same_results(pm, jm, q, *, metric, prefilter="scan", **kw):
    """The port's ``MutableJunoIndex.search`` against the reference's on
    the same state: counts (M, L) exactly, other scores within rtol 1e-5
    and ids up to score ties; under rt only the queries whose probe
    verdicts agree (:func:`rt_flip_rows`)."""
    s_p, i_p = pm.search(q, metric=metric, prefilter=prefilter, **kw)
    s_r, i_r = jm.search(jnp.asarray(q), metric=metric, prefilter=prefilter,
                         **kw)
    keep = np.ones(len(q), bool)
    if prefilter == "rt":
        keep = ~rt_flip_rows(pm, jm, q, metric, kw["nprobe"])
    s_p, i_p = s_p.numpy()[keep], i_p.numpy()[keep]
    s_r, i_r = np.asarray(s_r)[keep], np.asarray(i_r)[keep]
    if kw.get("mode") in ("M", "L"):
        np.testing.assert_array_equal(i_p, i_r)
        np.testing.assert_array_equal(s_p, s_r)
    else:
        assert_ids_equal_up_to_ties(i_p, i_r, s_p, s_r)


def near_points(center, n, rng, scale=1e-3):
    """``n`` points within ``scale`` of ``center`` (a cluster's centroid):
    their owning cluster is that centroid's (f32, numpy)."""
    center = np.asarray(center, np.float32)
    return (center + scale * rng.standard_normal((n, center.shape[0]))
            ).astype(np.float32)


def fresh_points(pts, n, rng, scale=0.05):
    """``n`` new points near random existing ones (in distribution)."""
    base = pts[rng.integers(0, len(pts), n)]
    return (base + scale * np.std(pts) * rng.standard_normal(base.shape)
            ).astype(np.float32)
