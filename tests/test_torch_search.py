"""The port's search against ``repro.core.search`` on one index, every tier.

The index is built by ``repro`` and carried across bit-exactly, so every
difference comes from the search. Cluster ids, τ and the integer planes
(hit tables, counts, candidate sets) are exact, so tiers M and L (scores
are hit counts, ties broken by index as ``lax.top_k`` does) must equal the
reference exactly, ids and scores. The masked-LUT sums over S of tiers H
and H2 run in another order, so their scores compare within rtol 1e-5 and
ids are equal except inside runs of tied scores
(``_torch_parity.assert_ids_equal_up_to_ties``). The reference serves
``impl="ref"`` (its core/lut.py rounding), the port its selective-LUT
kernel's contract (kernels/ref.py rounding); the two agree except at
entries within an ulp of a τ² boundary, which these inputs do not hit
(tier L's ``table >= 0`` against ``hit_tables(mode="count")`` included).
"""
import jax
import numpy as np
import pytest

from _torch_parity import assert_ids_equal_up_to_ties, to_port
from repro.core import JunoConfig, build
from repro.core import search as jax_search
from repro.data import DEEP_LIKE, TTI_LIKE, make_dataset
from repro_torch.core import MutableJunoIndex, search


@pytest.fixture(scope="module", params=["l2", "ip"])
def indexed(request):
    metric = request.param
    spec = DEEP_LIKE if metric == "l2" else TTI_LIKE
    pts, q = make_dataset(spec, 6000, 40, key=jax.random.PRNGKey(21))
    cfg = JunoConfig(n_clusters=24, n_entries=32, metric=metric,
                     calib_queries=32, kmeans_iters=4)
    ref = build(pts, cfg, jax.random.PRNGKey(2))
    return metric, np.asarray(q), ref, to_port(ref)


@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("rerank_mult", [0, 32])
def test_fused_h2_search_matches_reference(indexed, k, rerank_mult):
    metric, q, ref, port = indexed
    kw = dict(nprobe=8, k=k, metric=metric, rerank=rerank_mult * k, batch=16)
    s_r, ids_r = jax_search(ref, q, mode="H2", fused=True, impl="ref", **kw)
    s_p, ids_p = search(port, q, mode="H2", fused=True, **kw)
    assert ids_p.shape == (q.shape[0], k) and ids_p.dtype.itemsize == 4
    assert_ids_equal_up_to_ties(ids_p.numpy(), ids_r, s_p.numpy(), s_r)


@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("mode", ["H", "M", "L", "H2"])
def test_unfused_search_matches_reference(indexed, mode, k):
    """Tiers H, M, L and composed H2 (``fused=False``)."""
    metric, q, ref, port = indexed
    kw = dict(nprobe=8, k=k, metric=metric, mode=mode, batch=16)
    s_r, ids_r = jax_search(ref, q, impl="ref", **kw)
    s_p, ids_p = search(port, q, **kw)
    assert ids_p.shape == (q.shape[0], k) and ids_p.dtype.itemsize == 4
    if mode in ("M", "L"):
        np.testing.assert_array_equal(ids_p.numpy(), np.asarray(ids_r))
        np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_r))
    else:
        assert_ids_equal_up_to_ties(ids_p.numpy(), ids_r, s_p.numpy(), s_r)


@pytest.mark.parametrize("rerank_mult", [0, 32])
def test_composed_h2_matches_fused_h2(indexed, rerank_mult):
    """Both forms rerank the same top-C-by-count set (in another order)."""
    metric, q, _, port = indexed
    kw = dict(nprobe=8, k=100, metric=metric, mode="H2",
              rerank=rerank_mult * 100, batch=16)
    s_c, ids_c = search(port, q, fused=False, **kw)
    s_f, ids_f = search(port, q, fused=True, **kw)
    assert_ids_equal_up_to_ties(ids_c.numpy(), ids_f.numpy(), s_c.numpy(),
                                s_f.numpy())


def test_default_arguments_match_reference(indexed):
    """Both packages default to tier H, unfused, nprobe 16, k 100."""
    metric, q, ref, port = indexed
    s_r, ids_r = jax_search(ref, q[:16], metric=metric)
    s_p, ids_p = search(port, q[:16], metric=metric)
    assert ids_p.shape == (16, 100)
    assert_ids_equal_up_to_ties(ids_p.numpy(), ids_r, s_p.numpy(), s_r)


def test_fused_outside_h2_raises_value_error(indexed):
    metric, q, _, port = indexed
    for mode in ("H", "M", "L"):
        with pytest.raises(ValueError, match="fused=True requires"):
            search(port, q[:2], k=10, metric=metric, mode=mode, fused=True)


def test_unported_options_raise(indexed, tmp_path):
    """The options that raised while observability was unported now work:
    ``ArtifactStore(registry=...)`` counts its operations,
    ``ClusterCache.bind`` mirrors its counters (seeded with the counts so
    far) and ``PagedIndexData.bind_obs`` turns a miss into a fault span and
    counts (``test_torch_obs.py`` holds them to the reference); an object
    that is not a bundle still raises. The artifact-backed minors they once
    stood beside are ported (test_torch_freshness.py,
    test_torch_paged.py)."""
    from repro_torch.build import ArtifactStore
    from repro_torch.core.juno import JunoConfig as PortConfig
    from repro_torch.obs import MetricsRegistry, Observability
    from repro_torch.serve.paged import ClusterCache, PagedIndexData

    metric, q, _, port = indexed
    reg = MetricsRegistry()
    store = ArtifactStore(str(tmp_path / "store"), registry=reg)
    store.put("main", port, PortConfig(n_clusters=port.ivf.n_clusters,
                                       metric=metric))
    assert reg.snapshot()['juno_store_ops_total{op="put"}'] == 1
    cache = ClusterCache(1 << 20)
    assert cache.get(3) is None
    cache.bind(reg)
    assert reg.snapshot()["juno_cache_misses_total"] == 1
    paged = PagedIndexData(store.path("main", 1), device="cpu")
    obs = Observability()
    paged.bind_obs(obs)
    paged.fetch_cluster(0)
    assert [s.name for s in obs.tracer.spans()] == ["paged.fault"]
    assert obs.registry.snapshot()["juno_paged_faults_total"] == 1
    with pytest.raises(AttributeError):
        paged.bind_obs(object())
    mut = MutableJunoIndex(port)
    mut.enable_tiers(2, minor_store=store)      # ported: no longer raises
    assert mut._minor_sink == (store, "minors")
