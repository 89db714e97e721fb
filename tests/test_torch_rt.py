"""The port's RT prefilter against ``repro.rt`` and ``repro``'s rt search.

Held against the reference on the same index (built by ``repro`` at the
reference tests' size, ``test_rt_filter.py``'s ``rt_data``: 5,000 points,
32 clusters, E = 32, carried across bit-exactly) and the same grid:

* **Grid.** ``build_grid`` with the reference's projection gives the
  same layout bit for bit (cell ids, slot map, boxes, slot coordinates)
  and the reaches and radius bias within rtol 1e-6 (the (N, D) × (D, 2)
  projection of the residuals sums in another order). Grids cross between
  the packages through ``save_grid``/``load_grid`` and the index
  artifact's ``rt_grid.*`` arrays bit-equal.
* **Router.** ``probe_budget`` is the reference's numpy and must be equal.
* **Sphere test.** The plain version equals the jitted dense oracle and
  the interpret-mode kernel bit for bit, radii on a disc's boundary
  included (where the oracle's fused multiply-add decides the hit).
* **Search.** At full coverage every rt tier returns the scan path's ids
  and scores exactly. At ``rt_scale`` 1 the port matches the reference's
  rt search as ``test_torch_search.py`` matches its scan search (M and L
  exactly, H and H2 up to score ties), except for queries with a probe
  whose sphere-test verdict flips: the two packages compute the query
  radius and the ray-plane projection in another order (ulps), so a probe
  whose ``|d² − thr²|`` lies within 1e-5·max(d², thr²) may flip; no other
  may, and such queries must be rare. The three-stage path equals the
  composed one (``fused3=False``) bit for bit.
* **Engine.** Both rt engine configurations against the reference's rt
  engine on a four-tier stream: the same routed signatures and ticks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_ids_equal_up_to_ties, to_port
from _torch_rt_grids import synth_grid
from repro import rt as jrt
from repro.build.store import save_index
from repro.core import JunoConfig, build, exact_topk
from repro.core import density as jdensity
from repro.core import juno as jjuno
from repro.core import search as jax_search
from repro.core.ivf import filter_clusters as jax_filter_clusters
from repro.data import DEEP_LIKE, TTI_LIKE, make_dataset
from repro.kernels import ref as jref
from repro.serve.ann import AnnServeEngine as JaxEngine
from repro_torch import rt
from repro_torch.build import load_index
from repro_torch.core import recall_n_at_k, search
from repro_torch.core.ivf import filter_clusters
from repro_torch.core.juno import _rt_probe_mask
from repro_torch.core import density as pdensity
from repro_torch.kernels import ops
from repro_torch.kernels.sphere_hits import sphere_hits_plain
from repro_torch.serve.ann import AnnServeEngine

NPROBE = 16
FULL = 1e6       # rt_scale at which every disc covers every cluster
MARGIN = 1e-5    # relative |d² − thr²| within which a verdict may flip
TIERS = {
    "H": dict(mode="H"),
    "M": dict(mode="M"),
    "L": dict(mode="L"),
    "H2_composed": dict(mode="H2"),
    "H2_fused3": dict(mode="H2", fused=True),
    "H2_fused_composed": dict(mode="H2", fused=True, fused3=False),
}


def _grid_arrays(grid) -> dict:
    return {f: np.asarray(getattr(grid, f)) for f in grid._fields}


@pytest.fixture(scope="module", params=["l2", "ip"])
def rt_data(request):
    metric = request.param
    spec = DEEP_LIKE if metric == "l2" else TTI_LIKE
    pts, q = make_dataset(spec, 5000, 48, key=jax.random.PRNGKey(7))
    cfg = JunoConfig(n_clusters=32, n_entries=32, calib_queries=24,
                     kmeans_iters=5, metric=metric)
    idx = build(pts, cfg)
    grid = jrt.build_grid(idx, metric=metric)
    port = to_port(idx)
    pgrid = rt.grid_from_arrays(_grid_arrays(grid), "cpu", prefix="")
    return metric, np.asarray(pts), np.asarray(q), idx, grid, port, pgrid


# ---------------------------------------------------------------------------
# grid
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_points", [False, True])
def test_build_grid_matches_reference(rt_data, with_points):
    metric, pts, _, idx, _, port, _ = rt_data
    points = pts if with_points else None
    want = jrt.build_grid(idx, metric=metric, points=points)
    got = rt.build_grid(port, metric=metric, points=points,
                        proj=jrt.grid._projection(pts.shape[1], 0))
    for f in ("proj", "lo", "hi", "boxes", "cell_ids", "cell_c0", "cell_c1",
              "slot_of", "radius_scale"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    for f in ("slot_reach", "cell_reach", "radius_bias"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   err_msg=f)
    assert got.slot_of.dtype == torch.int32 and got.capacity % 8 == 0


def test_build_grid_own_projection_is_orthonormal(rt_data):
    metric, _, q, _, _, port, _ = rt_data
    grid = rt.build_grid(port, metric=metric, calib_queries=0)
    p = grid.proj.double()
    torch.testing.assert_close(p.T @ p, torch.eye(2, dtype=torch.float64),
                               atol=1e-6, rtol=0)
    assert float(grid.radius_bias) == 0.0
    # the cell walk covers every cluster once, pads are -inf
    ids = grid.cell_ids.reshape(-1)
    assert sorted(ids[ids >= 0].tolist()) == list(range(32))
    assert torch.isneginf(grid.slot_reach.reshape(-1)[ids < 0]).all()


def test_grids_cross_bit_equal(rt_data, tmp_path):
    metric, _, _, idx, grid, port, pgrid = rt_data
    ref_arrays = _grid_arrays(grid)
    jrt.save_grid(str(tmp_path / "ref.npz"), grid)
    loaded = rt.load_grid(str(tmp_path / "ref.npz"), device="cpu")
    rt.save_grid(str(tmp_path / "port.npz"), pgrid)
    back = jrt.load_grid(str(tmp_path / "port.npz"))
    cfg = JunoConfig(n_clusters=32, n_entries=32, calib_queries=24,
                     kmeans_iters=5, metric=metric)
    save_index(str(tmp_path / "art"), idx, cfg, rt_grid=grid)
    from_artifact = load_index(str(tmp_path / "art"), device="cpu").rt_grid
    for f, want in ref_arrays.items():
        for g in (loaded, pgrid, from_artifact):
            got = getattr(g, f).numpy()
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)
        np.testing.assert_array_equal(np.asarray(getattr(back, f)), want)


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scale,thres_scale,max_probes",
                         [(1.0, 1.0, 16), (0.5, 1.0, 8), (4.0, 0.8, 32)])
def test_probe_budget_equals_reference(rt_data, scale, thres_scale,
                                       max_probes):
    metric, _, q, idx, grid, port, pgrid = rt_data
    kw = dict(metric=metric, scale=scale, thres_scale=thres_scale,
              max_probes=max_probes)
    want = jrt.probe_budget(grid, idx, q, **kw)
    got = rt.probe_budget(pgrid, port, q, **kw)
    np.testing.assert_array_equal(got, want)
    state = rt.routing_state(pgrid, port)
    np.testing.assert_array_equal(
        rt.probe_budget(pgrid, port, q, state=state, **kw), want)


def test_probe_budget_covers_every_survivor(rt_data):
    """No probe ranked past the routed budget survives the search's own
    sphere test: the engine's nprobe shrink loses nothing the mask keeps."""
    metric, _, q, _, _, port, pgrid = rt_data
    budget = rt.probe_budget(pgrid, port, q, metric=metric, max_probes=NPROBE)
    qt = torch.from_numpy(q)
    _, cids = filter_clusters(qt, port.ivf, nprobe=NPROBE, metric=metric)
    res = qt - port.ivf.centroids[cids[:, 0]] if metric == "l2" else qt
    tau = pdensity.predict_threshold(port.density, res.reshape(len(q), -1, 2))
    hits = rt.survivor_mask(pgrid, qt, rt.query_radius(pgrid, tau, 1.0))
    probe_hits = torch.gather(hits, 1, cids).numpy() > 0
    for i in range(len(q)):
        assert not probe_hits[i, budget[i]:].any(), i


# ---------------------------------------------------------------------------
# sphere test
# ---------------------------------------------------------------------------
def _oracle(*a):
    return np.asarray(jax.jit(jref.rt_sphere_hits_ref)(*map(jnp.asarray, a)))


def test_sphere_plain_bit_equal_on_boundary_radii():
    """A quarter of the queries sit on a disc's boundary, where a
    step-rounded ``dx*dx + dy*dy`` misses the oracle's fused multiply-add
    (this input is checked to contain such cases)."""
    q0, q1, r, _, _, c0, c1, reach, _ = synth_grid(0, 8, 16, 4096)
    want = _oracle(q0, q1, r, c0, c1, reach)
    got = sphere_hits_plain(*map(torch.from_numpy, (q0, q1, r, c0, c1,
                                                    reach))).numpy()
    np.testing.assert_array_equal(got, want)
    dx = q0[:, None] - c0.reshape(1, -1)
    dy = q1[:, None] - c1.reshape(1, -1)
    thr = r[:, None] + reach.reshape(1, -1)
    step = (thr >= 0) & (dx * dx + dy * dy <= thr * thr)
    assert (step != want.astype(bool)).any()


@pytest.mark.parametrize("seed,g,cap,q", [(0, 3, 8, 16), (1, 4, 16, 7),
                                          (2, 2, 8, 1), (3, 5, 24, 33)])
def test_sphere_plain_matches_oracle_and_interpret_kernel(seed, g, cap, q):
    q0, q1, r, boxes, creach, c0, c1, reach, _ = synth_grid(seed, g, cap, q)
    got = ops.rt_sphere_hits(*map(torch.from_numpy,
                                  (q0, q1, r, c0, c1, reach))).numpy()
    np.testing.assert_array_equal(got, _oracle(q0, q1, r, c0, c1, reach))
    kernel = jrt.sphere_hits(*map(jnp.asarray, (q0, q1, r, boxes, creach, c0,
                                                c1, reach)), interpret=True)
    np.testing.assert_array_equal(got, np.asarray(kernel))
    assert got.dtype == np.int8


def test_sphere_plain_on_built_grid(rt_data):
    metric, _, q, _, grid, _, pgrid = rt_data
    qp = q @ np.asarray(grid.proj)
    for r in (np.zeros(len(q), np.float32), np.full(len(q), 0.5, np.float32),
              np.full(len(q), FULL, np.float32)):
        args = (qp[:, 0].copy(), qp[:, 1].copy(), r,
                np.asarray(grid.cell_c0), np.asarray(grid.cell_c1),
                np.asarray(grid.slot_reach))
        got = sphere_hits_plain(*map(torch.from_numpy, args)).numpy()
        np.testing.assert_array_equal(got, _oracle(*args))


@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_survivors_monotone_in_scale(rt_data, scale):
    _, _, q, _, _, port, pgrid = rt_data
    qt = torch.from_numpy(q)
    tau = torch.ones((len(q), port.codes.shape[1]))
    lo = rt.survivor_mask(pgrid, qt, rt.query_radius(pgrid, tau, scale))
    hi = rt.survivor_mask(pgrid, qt, rt.query_radius(pgrid, tau, 4 * scale))
    full = rt.survivor_mask(pgrid, qt, rt.query_radius(pgrid, tau, FULL))
    assert (lo <= hi).all() and (hi <= full).all() and full.all()


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tier", list(TIERS))
def test_full_coverage_equals_scan(rt_data, tier):
    metric, _, q, _, _, port, pgrid = rt_data
    kw = dict(nprobe=NPROBE, k=100, metric=metric, batch=16, **TIERS[tier])
    s_scan, ids_scan = search(port, q, **kw)
    s_rt, ids_rt = search(port, q, prefilter="rt", rt_grid=pgrid,
                          rt_scale=FULL, **kw)
    np.testing.assert_array_equal(ids_rt.numpy(), ids_scan.numpy())
    np.testing.assert_array_equal(s_rt.numpy(), s_scan.numpy())


def _flipped_queries(rt_data, q):
    """Queries with a probe whose verdict differs between the packages; each
    such probe must lie within MARGIN of its disc's boundary."""
    metric, _, _, idx, grid, port, pgrid = rt_data
    qt = torch.from_numpy(q)
    _, cids = filter_clusters(qt, port.ivf, nprobe=NPROBE, metric=metric)
    _, jcids = jax_filter_clusters(jnp.asarray(q), idx.ivf, nprobe=NPROBE,
                                   metric=metric)
    np.testing.assert_array_equal(cids.numpy(), np.asarray(jcids))
    res = qt - port.ivf.centroids[cids[:, 0]] if metric == "l2" else qt
    tau = pdensity.predict_threshold(port.density, res.reshape(len(q), -1, 2))
    mine = _rt_probe_mask(pgrid, qt, tau[:, None], cids, 1.0).numpy()
    jtau = jdensity.predict_threshold(
        idx.density, jnp.asarray(res.numpy()).reshape(len(q), -1, 2), 1.0)
    # the reference's mask and radius as its search computes them: jitted
    theirs = np.asarray(jax.jit(
        lambda g, x, t, c: jjuno._rt_probe_mask(g, x, t, c, 1.0, None))(
            grid, jnp.asarray(q), jtau[:, None], jnp.asarray(cids.numpy())))
    jr = jax.jit(jrt.query_radius)(grid, jtau, 1.0)
    flips = mine != theirs
    if flips.any():
        qp = (qt @ pgrid.proj).double().numpy()
        slot = pgrid.slot_of.long()[cids].numpy()
        d2 = ((qp[:, None, 0] - pgrid.cell_c0.reshape(-1)[slot].double().numpy()) ** 2
              + (qp[:, None, 1] - pgrid.cell_c1.reshape(-1)[slot].double().numpy()) ** 2)
        thr = (np.asarray(jr, np.float64)[:, None]
               + pgrid.slot_reach.reshape(-1)[slot].double().numpy())
        gap = np.abs(d2 - thr * thr) / np.maximum(np.maximum(d2, thr * thr),
                                                   1e-30)
        assert (gap[flips] <= MARGIN).all(), gap[flips]
    rows = flips.any(axis=1)
    assert rows.sum() <= max(1, len(q) // 20), f"{rows.sum()} queries flip"
    return rows


@pytest.mark.parametrize("tier", list(TIERS))
def test_rt_search_matches_reference(rt_data, tier):
    metric, _, q, idx, grid, port, pgrid = rt_data
    kw = dict(nprobe=NPROBE, k=100, metric=metric, batch=16, **TIERS[tier])
    s_r, ids_r = jax_search(idx, q, prefilter="rt", rt_grid=grid, **kw)
    s_p, ids_p = search(port, q, prefilter="rt", rt_grid=pgrid, **kw)
    keep = ~_flipped_queries(rt_data, q)
    ids_p, s_p = ids_p.numpy()[keep], s_p.numpy()[keep]
    ids_r, s_r = np.asarray(ids_r)[keep], np.asarray(s_r)[keep]
    if TIERS[tier]["mode"] in ("M", "L"):
        np.testing.assert_array_equal(ids_p, ids_r)
        np.testing.assert_array_equal(s_p, s_r)
    else:
        assert_ids_equal_up_to_ties(ids_p, ids_r, s_p, s_r)


@pytest.mark.parametrize("rerank_mult", [0, 32])
@pytest.mark.parametrize("rt_scale", [0.5, 1.0, FULL])
def test_fused3_equals_composed(rt_data, rerank_mult, rt_scale):
    metric, _, q, _, _, port, pgrid = rt_data
    kw = dict(nprobe=NPROBE, k=10, metric=metric, mode="H2", fused=True,
              rerank=rerank_mult * 10, batch=16, prefilter="rt",
              rt_grid=pgrid, rt_scale=rt_scale)
    s3, i3 = search(port, q, **kw)
    s2, i2 = search(port, q, fused3=False, **kw)
    np.testing.assert_array_equal(i3.numpy(), i2.numpy())
    np.testing.assert_array_equal(s3.numpy(), s2.numpy())


def test_rt_recall_near_reference(rt_data):
    """Recall@10-in-100 of every rt tier within 0.02 of the reference's."""
    metric, pts, q, idx, grid, port, pgrid = rt_data
    _, gt = exact_topk(q, pts, k=10, metric=metric)
    gt = torch.from_numpy(np.asarray(gt)).long()
    for tier, tkw in TIERS.items():
        kw = dict(nprobe=NPROBE, k=100, metric=metric, **tkw)
        _, ids_r = jax_search(idx, q, prefilter="rt", rt_grid=grid, **kw)
        _, ids_p = search(port, q, prefilter="rt", rt_grid=pgrid, **kw)
        r_ref = recall_n_at_k(torch.from_numpy(np.asarray(ids_r)).long(), gt)
        r_port = recall_n_at_k(ids_p.long(), gt)
        assert abs(r_ref - r_port) <= 0.02, (tier, r_ref, r_port)


@pytest.mark.parametrize("fused", [False, True])
def test_pruned_candidates_get_sentinel_scores(rt_data, fused):
    """H2 under rt when fewer than C points survive (a negative radius
    keeps probe 0 alone): a candidate of a pruned probe scores ±inf, never
    a real distance, as in the reference."""
    metric, _, q, idx, grid, port, pgrid = rt_data
    kw = dict(nprobe=NPROBE, k=100, metric=metric, rerank=2000, batch=16,
              prefilter="rt", rt_scale=-FULL)
    s, ids = search(port, q, mode="H2", fused=fused, rt_grid=pgrid, **kw)
    s_h, _ = search(port, q, mode="H", rt_grid=pgrid, **kw)
    # tier H scans every kept point: its finite scores are the survivors
    n_fin = np.isfinite(s.numpy()).sum(1)
    np.testing.assert_array_equal(n_fin, np.isfinite(s_h.numpy()).sum(1))
    assert (n_fin < 100).any()
    s_r, ids_r = jax_search(idx, q, mode="H2", fused=fused, rt_grid=grid,
                            **kw)
    assert_ids_equal_up_to_ties(ids.numpy(), ids_r, s.numpy(), s_r)


def test_rt_argument_errors(rt_data):
    metric, _, q, _, _, port, pgrid = rt_data
    kw = dict(k=10, metric=metric)
    with pytest.raises(ValueError, match="requires rt_grid"):
        search(port, q[:2], prefilter="rt", **kw)
    for bad in (dict(mode="H2", fused3=True),
                dict(mode="H2", fused=True, fused3=True),
                dict(mode="H", fused3=True, prefilter="rt", rt_grid=pgrid)):
        with pytest.raises(ValueError, match="fused3=True requires"):
            search(port, q[:2], **kw, **bad)
    with pytest.raises(ValueError, match="unknown prefilter"):
        AnnServeEngine(port, metric=metric, prefilter="bvh")
    # the check passes when the three-stage kernel applies
    search(port, q[:2], mode="H2", fused=True, fused3=True, prefilter="rt",
           rt_grid=pgrid, **kw)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
def _stream(q):
    """k in {10, 100} (7 and 60 round up), recall targets for tiers H, H2,
    M and L, explicit and default nprobe, 1 to 40 rows a request."""
    rng = np.random.default_rng(1)
    out, lo = [], 0
    for i in range(16):
        rows = int(rng.integers(1, 10)) if i != 5 else 40
        rows = min(rows, q.shape[0] - lo) or 1
        out.append(dict(queries=q[lo:lo + rows], k=(7, 10, 60, 100)[i % 4],
                        recall_target=(0.95, 0.85, 0.6, 0.3)[(i // 4 + i) % 4],
                        nprobe=(0, 32)[(i // 3) % 2]))
        lo = (lo + rows) % (q.shape[0] - 1)
    return out


@pytest.mark.parametrize("fused", [True, False])
def test_rt_engine_matches_reference_engine(rt_data, fused):
    metric, _, q, idx, _, port, _ = rt_data
    jeng = JaxEngine(idx, metric=metric, fused=fused, prefilter="rt")
    grid = rt.grid_from_arrays(_grid_arrays(jeng.index.rt_grid), "cpu",
                               prefix="")
    peng = AnnServeEngine(port, metric=metric, fused=fused, prefilter="rt",
                          rt_grid=grid)
    stream = _stream(q)
    jreqs = [jeng.submit(**r) for r in stream]
    preqs = [peng.submit(**r) for r in stream]
    for jr, pr in zip(jreqs, preqs):
        assert peng.route(pr) == jeng.route(jr)
    tiers = {peng.route(r)[1] for r in preqs}
    assert tiers == ({"H2", "M", "L"} if fused else {"H", "H2", "M", "L"})
    assert jeng.run() == peng.run() == sum(len(r["queries"]) for r in stream)
    assert peng.stats["signatures"] == jeng.stats["signatures"]
    assert peng.stats["ticks"] == jeng.stats["ticks"]
    flipped = _flipped_queries(rt_data, q)
    for jr, pr, req in zip(jreqs, preqs, stream):
        rows = np.flatnonzero([not flipped[np.flatnonzero(
            (q == row).all(1))[0]] for row in req["queries"]])
        if peng.route(pr)[1] in ("M", "L"):
            np.testing.assert_array_equal(pr.ids[rows], jr.ids[rows])
            np.testing.assert_array_equal(pr.scores[rows], jr.scores[rows])
        else:
            assert_ids_equal_up_to_ties(pr.ids[rows], jr.ids[rows],
                                        pr.scores[rows], jr.scores[rows])


def test_rt_engine_full_coverage_equals_scan_engine(rt_data):
    metric, _, q, _, _, port, pgrid = rt_data
    out = {}
    for pf, kw in (("scan", {}), ("rt", dict(prefilter="rt", rt_scale=FULL,
                                            rt_grid=pgrid))):
        eng = AnnServeEngine(port, metric=metric, batch_buckets=(8, 16), **kw)
        reqs = [eng.submit(q[i:i + 8], k=10, recall_target=t)
                for i, t in ((0, 0.95), (8, 0.85), (16, 0.6), (24, 0.3))]
        eng.run()
        out[pf] = [r.ids for r in reqs]
    for a, b in zip(out["rt"], out["scan"]):
        np.testing.assert_array_equal(a, b)


def test_rt_engine_builds_its_grid(rt_data):
    """Without ``rt_grid`` the engine builds one from the index, as the
    reference's ``ensure_rt_grid`` does, and routes by it."""
    metric, _, q, _, _, port, _ = rt_data
    eng = AnnServeEngine(port, metric=metric, prefilter="rt")
    assert isinstance(eng.rt_grid, rt.CentroidGrid)
    req = eng.submit(q[:4], k=10, mode="H")
    assert eng.route(req)[2] in AnnServeEngine.RT_NPROBE_BUCKETS
    assert 1 <= req.rt_probes <= 16
    eng.run()
    assert req.done and req.ids.shape == (4, 10)
