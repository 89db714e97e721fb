"""Stages A, τ and B of the port against ``repro`` on a JAX-built index.

Stage A (``filter_clusters``) must return the same cluster ids; τ
(``lookup_density``/``predict_threshold``) and the stage-B tables
(``build_lut``/``masked_lut``/``hit_tables``/``hit_tables_ip``) must be
bit-equal: they reproduce the reference's rounding step for step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_port
from repro.core import JunoConfig, build
from repro.core import density as jdens
from repro.core import lut as jlut
from repro.core.ivf import filter_clusters as jfilter
from repro.data import DEEP_LIKE, TTI_LIKE, make_dataset
from repro_torch.core import density as pdens
from repro_torch.core import lut as plut
from repro_torch.core.ivf import filter_clusters as pfilter

NPROBE = 6


@pytest.fixture(scope="module", params=["l2", "ip"])
def stage_inputs(request):
    metric = request.param
    spec = DEEP_LIKE if metric == "l2" else TTI_LIKE
    pts, q = make_dataset(spec, 4000, 48, key=jax.random.PRNGKey(11))
    cfg = JunoConfig(n_clusters=24, n_entries=32, metric=metric,
                     calib_queries=32, kmeans_iters=4)
    ref = build(pts, cfg, jax.random.PRNGKey(5))
    q = np.array(q)
    base, cids = jfilter(jnp.asarray(q), ref.ivf, nprobe=NPROBE, metric=metric)
    m = cfg.sub_dim
    if metric == "l2":
        qsub = (q[:, None, :] - np.asarray(ref.ivf.centroids)[np.asarray(cids)]
                ).reshape(q.shape[0], NPROBE, -1, m)
    else:
        qsub = np.broadcast_to(q.reshape(q.shape[0], 1, -1, m),
                               (q.shape[0], NPROBE, q.shape[1] // m, m))
    return metric, q, ref, to_port(ref), np.ascontiguousarray(qsub)


def test_filter_clusters_ids_exact(stage_inputs):
    metric, q, ref, port, _ = stage_inputs
    s_r, ids_r = jfilter(jnp.asarray(q), ref.ivf, nprobe=NPROBE, metric=metric)
    s_p, ids_p = pfilter(torch.from_numpy(q), port.ivf, nprobe=NPROBE,
                         metric=metric)
    np.testing.assert_array_equal(ids_p.numpy(), np.asarray(ids_r))
    # scores: the two GEMMs sum D products in different orders
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_r), rtol=1e-5,
                               atol=1e-4)


def test_density_and_threshold_bit_equal(stage_inputs):
    _, _, ref, port, qsub = stage_inputs
    np.testing.assert_array_equal(
        pdens.lookup_density(port.density, torch.from_numpy(qsub)).numpy(),
        np.asarray(jdens.lookup_density(ref.density, jnp.asarray(qsub))))
    for scale in (1.0, 0.7):
        np.testing.assert_array_equal(
            pdens.predict_threshold(port.density, torch.from_numpy(qsub),
                                    scale).numpy(),
            np.asarray(jdens.predict_threshold(ref.density, jnp.asarray(qsub),
                                               scale)))


def test_lut_and_hit_tables_bit_equal(stage_inputs):
    metric, _, ref, port, qsub = stage_inputs
    tau = np.array(jdens.predict_threshold(ref.density, jnp.asarray(qsub)))
    lut_r, mask_r = jlut.build_lut(jnp.asarray(qsub), ref.codebook,
                                   jnp.asarray(tau), metric=metric)
    lut_p, mask_p = plut.build_lut(torch.from_numpy(qsub), port.codebook,
                                   torch.from_numpy(tau), metric=metric)
    np.testing.assert_array_equal(lut_p.numpy(), np.asarray(lut_r))
    np.testing.assert_array_equal(mask_p.numpy(), np.asarray(mask_r))
    t_tau = torch.from_numpy(tau)
    np.testing.assert_array_equal(
        plut.masked_lut(lut_p, mask_p, t_tau, metric=metric).numpy(),
        np.asarray(jlut.masked_lut(lut_r, mask_r, jnp.asarray(tau),
                                   metric=metric)))
    for mode in ("count", "reward_penalty"):
        if metric == "l2":
            got = plut.hit_tables(lut_p, mask_p, t_tau, mode=mode)
            want = jlut.hit_tables(lut_r, mask_r, jnp.asarray(tau), mode=mode)
        else:
            got = plut.hit_tables_ip(lut_p, port.codebook.entry_sq, t_tau,
                                     mode=mode)
            want = jlut.hit_tables_ip(lut_r, ref.codebook.entry_sq,
                                      jnp.asarray(tau), mode=mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.int8
