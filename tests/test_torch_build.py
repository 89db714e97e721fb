"""Port build against ``repro.core.build`` with the same random draws.

The reference's draws are replayed with ``jax.random`` here
(``_torch_parity.jax_build_draws``) and injected into the port's build, so
the two builds see the same subsamples, inits and calibration queries.
What still differs is f32 rounding (GEMM and reduction order), which can
flip a near-tied k-means assignment; the tolerances below are set for that.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import jax_build_draws, port_config
from repro.core import JunoConfig
from repro.core import build as jax_build
from repro.core import search as jax_search
from repro.core.ref import exact_topk as jax_exact_topk
from repro.data import DEEP_LIKE, TTI_LIKE, make_dataset
from repro_torch.core import build, recall_n_at_k, search
from repro_torch.core.density import polyval


@pytest.fixture(scope="module", params=["l2", "ip"])
def builds(request):
    spec = DEEP_LIKE if request.param == "l2" else TTI_LIKE
    pts, q = make_dataset(spec, 6000, 64, key=jax.random.PRNGKey(3))
    pts, q = np.asarray(pts), np.asarray(q)
    # max_train_points < N: the subsampled IVF and PQ training draws run too
    cfg = JunoConfig(n_clusters=32, n_entries=32, metric=spec.metric,
                     calib_queries=32, kmeans_iters=4, max_train_points=3000)
    key = jax.random.PRNGKey(7)
    ref = jax_build(pts, cfg, key)
    port = build(pts, port_config(cfg), device="cpu",
                 draws=jax_build_draws(key, *pts.shape, cfg))
    return pts, q, cfg, ref, port


def test_build_ivf_and_codebook(builds):
    _, _, _, ref, port = builds
    # centroids: f32 GEMM/reduction order only (tolerance 1e-4 absolute)
    np.testing.assert_allclose(port.ivf.centroids.numpy(),
                               np.asarray(ref.ivf.centroids), atol=1e-4)
    np.testing.assert_array_equal(port.ivf.point_ids.numpy(),
                                  np.asarray(ref.ivf.point_ids))
    # one near-tied 2-D assignment can move a small codebook entry: 0.1 abs
    np.testing.assert_allclose(port.codebook.entries.numpy(),
                               np.asarray(ref.codebook.entries), atol=0.1)
    assert (port.codes.numpy() == np.asarray(ref.codes)).mean() >= 0.999
    assert port.cluster_codes.shape == ref.cluster_codes.shape


def test_build_density_model(builds):
    _, _, _, ref, port = builds
    d = ref.density
    np.testing.assert_allclose(port.density.lo.numpy(), np.asarray(d.lo),
                               atol=1e-5)
    np.testing.assert_allclose(port.density.hi.numpy(), np.asarray(d.hi),
                               atol=1e-5)
    # the fit's inputs inherit the codebook tolerance above: rtol 0.1
    np.testing.assert_allclose(port.density.coeffs.numpy(),
                               np.asarray(d.coeffs), rtol=0.1, atol=1e-2)
    np.testing.assert_allclose(float(port.density.tau_min),
                               float(d.tau_min), rtol=1e-2)
    np.testing.assert_allclose(float(port.density.tau_max),
                               float(d.tau_max), rtol=1e-2)
    # the fitted curves agree over the grid's densities within 5%
    x = torch.linspace(float(d.grid.min()), float(d.grid.max()), 64)
    tau_p = torch.clamp(polyval(port.density.coeffs, x),
                        float(port.density.tau_min), float(port.density.tau_max))
    tau_r = np.clip(np.polyval(np.asarray(d.coeffs, np.float64), x.double()),
                    float(d.tau_min), float(d.tau_max))
    np.testing.assert_allclose(tau_p.numpy(), tau_r, rtol=0.05)


def test_build_recall_matches(builds):
    pts, q, cfg, ref, port = builds
    kw = dict(nprobe=8, k=10, metric=cfg.metric)
    _, gt = jax_exact_topk(q, pts, k=10, metric=cfg.metric)
    gt = torch.tensor(np.asarray(gt)).long()
    _, ids_r = jax_search(ref, q, mode="H2", fused=True, **kw)
    _, ids_p = search(port, q, mode="H2", fused=True, **kw)
    r_ref = recall_n_at_k(torch.tensor(np.asarray(ids_r)).long(), gt)
    r_port = recall_n_at_k(ids_p.long(), gt)
    assert abs(r_ref - r_port) <= 0.02, (r_ref, r_port)
