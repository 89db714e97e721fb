"""The port's paged (out-of-core) serving tier against its resident search
and against ``repro.serve.paged``.

One artifact, written by the reference's ``ArtifactStore`` with its rt
grid, is served by both packages with a cluster cache of a quarter of the
code bytes, so rows are evicted during every pass. In the port the paged
search must equal the resident search on the same index bit for bit
(scores and ids) in every tier, scan and rt: the scans read a page buffer
of the batch's distinct clusters through local indices, and nothing else
may. Against the reference's paged engine on one stream the ids must be
equal up to score ties, the scores within rtol 1e-5 and the cache counters
equal. The exact rerank's scores are the raw vectors' distances or
similarities. Inserts land in the side buffer, deletes never come back, a
swap retargets the cache, a flipped byte fails closed on first touch, and
a promoted minor is committed to the store and faulted back in.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mutable import port_grid
from _torch_parity import assert_ids_equal_up_to_ties, port_config, to_port
from repro import rt as jrt
from repro.build import ArtifactStore as JaxStore
from repro.build import save_index as jax_save_index
from repro.core import JunoConfig, build
from repro.data import DEEP_LIKE, TTI_LIKE, make_dataset
from repro.serve import paged as jpaged
from repro_torch.build import ArtifactError, ArtifactStore, save_index
from repro_torch.core import exact_topk, recall_n_at_k, search
from repro_torch.serve import AnnServeEngine
from repro_torch.serve.paged import (ClusterCache, PagedAnnServeEngine,
                                     PagedIndexData, PagedJunoIndex)

NPROBE = 8
# (mode, fused): every scan the paged path runs over the page buffer
FORMS = [("H", False), ("M", False), ("L", False), ("H2", False),
         ("H2", True)]
WAVES = [(slice(0, 5), dict(k=10, mode="H", nprobe=8)),
         (slice(5, 9), dict(k=10, mode="M", nprobe=8)),
         (slice(9, 10), dict(k=10, mode="H2", nprobe=16)),
         (slice(10, 20), dict(k=10, mode="L", nprobe=4)),
         (slice(20, 32), dict(k=100, mode="H2", nprobe=16))]
# against the reference's engine (each signature a jit compile there): the
# waves of tiers H, M and H2 at k = 100
REF_WAVES = [WAVES[0], WAVES[1], WAVES[4]]


@pytest.fixture(scope="module", params=["l2", "ip"])
def env(request, tmp_path_factory):
    """The reference's index and rt grid of 6000 points in 16 clusters,
    committed once with the grid (generation 1 of "main"), the port's
    resident copy of both, and the raw vectors as ``.npy``."""
    metric = request.param
    spec = DEEP_LIKE if metric == "l2" else TTI_LIKE
    pts, q = make_dataset(spec, 6000, 32, key=jax.random.PRNGKey(5))
    pts, q = np.asarray(pts), np.asarray(q)
    cfg = JunoConfig(n_clusters=16, n_entries=16, calib_queries=12,
                     kmeans_iters=4, capacity_mult=1.2, metric=metric)
    idx = build(pts, cfg, jax.random.PRNGKey(0))
    grid = jrt.build_grid(idx, metric=metric, calib_queries=8, points=pts)
    root = tmp_path_factory.mktemp(f"paged_{metric}")
    store = JaxStore(str(root / "store"))
    assert store.put("main", idx, cfg, rt_grid=grid) == 1
    vec_path = str(root / "vectors.npy")
    np.save(vec_path, pts.astype(np.float32))
    return dict(metric=metric, pts=pts, q=q, cfg=cfg, idx=idx, grid=grid,
                port=to_port(idx), pgrid=port_grid(grid), root=root,
                path=store.path("main", 1), vectors=vec_path)


def _quarter(env) -> int:
    """A quarter of the code bytes: rows are evicted in every pass."""
    return int(np.asarray(env["idx"].cluster_codes).nbytes) // 4


def _new_points(env, n, rng):
    """``n`` points near the mean of the first few, each its own best match
    (ip: scaled past every point's norm)."""
    pts = env["pts"]
    new = pts[:n].mean(0)[None] + 0.01 * rng.standard_normal(
        (n, pts.shape[1]))
    if env["metric"] == "ip":
        new *= (2 * np.linalg.norm(pts, axis=1).max()
                / np.linalg.norm(new, axis=1, keepdims=True))
    return new.astype(np.float32)


def _paged(env, **kw) -> PagedIndexData:
    kw.setdefault("cache_bytes", _quarter(env))
    return PagedIndexData(env["path"], device="cpu", **kw)


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cluster_cache_counts_as_the_reference(seed):
    """A random get/put stream (rows of three sizes, one larger than the
    cache) leaves both caches with equal counters, bytes and rows after
    every call; ``clear`` keeps capacity and counters."""
    rng = np.random.default_rng(seed)
    mine, ref = ClusterCache(100), jpaged.ClusterCache(100)
    for _ in range(400):
        cid = int(rng.integers(0, 12))
        if rng.random() < 0.5:
            a, b = mine.get(cid), ref.get(cid)
            assert (a is None) == (b is None)
        else:
            row = np.full(int(rng.choice([16, 40, 120])), cid, np.uint8)
            mine.put(cid, torch.from_numpy(row))
            ref.put(cid, row)
        assert mine.stats() == ref.stats() and len(mine) == len(ref)
    assert mine.evictions > 0 and mine.hits > 0
    st = mine.stats()
    mine.clear()
    assert len(mine) == 0 and mine.bytes == 0
    assert {k: v for k, v in mine.stats().items() if k not in ("bytes",
                                                               "rows")} == \
        {k: v for k, v in st.items() if k not in ("bytes", "rows")}


# ---------------------------------------------------------------------------
# paged == resident, bit for bit (the port alone)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefilter", ["scan", "rt"])
@pytest.mark.parametrize("mode,fused", FORMS)
def test_paged_search_equals_resident(env, mode, fused, prefilter):
    paged = _paged(env)
    pidx = PagedJunoIndex(paged)
    # batches of 4 probe fewer than the 16 clusters: local indices differ
    # from the cluster ids, so a scan handed a cluster id reads a wrong row
    kw = dict(nprobe=NPROBE, k=10, mode=mode, fused=fused,
              metric=env["metric"], prefilter=prefilter, batch=4)
    s0, i0 = search(env["port"], env["q"], rt_grid=env["pgrid"]
                    if prefilter == "rt" else None, **kw)
    s1, i1 = pidx.search(env["q"], **kw)
    assert torch.equal(s0, s1) and torch.equal(i0, i1)
    st = paged.stats()
    assert st["evictions"] > 0 and 0 < st["verified_rows"] <= 16


def test_page_buffer_holds_every_row_a_batch_asks_for(env):
    """A cache of one row (and of none): every batch still scans all U
    distinct clusters, each read once a call, and the results stay the
    resident ones."""
    for cache in (int(np.asarray(env["idx"].cluster_codes[0]).nbytes), 0):
        paged = _paged(env, cache_bytes=cache)
        cids = torch.tensor([[3, 1, 3], [1, 7, 3]])
        rows, local, uniq = paged.gather(cids)
        assert uniq.tolist() == [1, 3, 7] and rows.shape[0] == 3
        assert torch.equal(uniq[local], cids)
        assert torch.equal(rows[local], env["port"].cluster_codes[cids])
        assert paged.cache.misses == 3 and len(paged.cache) <= 1
        s0, i0 = search(env["port"], env["q"], nprobe=16, k=10, mode="H",
                        metric=env["metric"])
        s1, i1 = PagedJunoIndex(paged).search(env["q"], nprobe=16, k=10,
                                              mode="H", metric=env["metric"])
        assert torch.equal(s0, s1) and torch.equal(i0, i1)


@pytest.mark.parametrize("prefilter", ["scan", "rt"])
@pytest.mark.parametrize("fused", [False, True])
def test_paged_engine_equals_resident_engine(env, fused, prefilter):
    peng = PagedAnnServeEngine(_paged(env), metric=env["metric"],
                               fused=fused, prefilter=prefilter)
    reng = AnnServeEngine(env["port"], metric=env["metric"], fused=fused,
                          prefilter=prefilter, rt_grid=env["pgrid"])
    rp = [peng.submit(env["q"][sl], **kw) for sl, kw in WAVES]
    rr = [reng.submit(env["q"][sl], **kw) for sl, kw in WAVES]
    assert peng.run() == reng.run() == 32
    for a, b in zip(rp, rr):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)
    assert peng.cache_stats()["evictions"] > 0


# ---------------------------------------------------------------------------
# the port's paged engine against the reference's
# ---------------------------------------------------------------------------

def _engines(env, **kw):
    port = PagedAnnServeEngine(_paged(env, vectors=env["vectors"]),
                               metric=env["metric"], **kw)
    ref = jpaged.PagedAnnServeEngine(
        jpaged.PagedIndexData(env["path"], cache_bytes=_quarter(env),
                              vectors=env["vectors"]),
        metric=env["metric"], **kw)
    return port, ref


def _serve_both(port, ref, env):
    rp = [port.submit(env["q"][sl], **kw) for sl, kw in REF_WAVES]
    rr = [ref.submit(env["q"][sl], **kw) for sl, kw in REF_WAVES]
    assert port.run() == ref.run() == 21
    return rp, rr


@pytest.mark.parametrize("fused", [False, True])
def test_paged_engine_matches_reference(env, fused):
    port, ref = _engines(env, fused=fused)
    for a, b in zip(*_serve_both(port, ref, env)):
        assert_ids_equal_up_to_ties(a.ids, b.ids, a.scores, b.scores)
    assert port.cache_stats() == ref.cache_stats()
    assert port.cache_stats()["evictions"] > 0


def test_exact_rerank_matches_reference(env):
    """Scores of the exact rerank equal the reference's within rtol 1e-5
    and are the raw vectors' squared distances (l2) or inner products
    (ip) of the returned ids, best first."""
    port, ref = _engines(env, exact_rerank=40)
    pts, metric = env["pts"], env["metric"]
    for a, b in zip(*_serve_both(port, ref, env)):
        assert_ids_equal_up_to_ties(a.ids, b.ids, a.scores, b.scores)
        q = a.queries
        v = pts[a.ids]
        want = (np.sum((v - q[:, None, :]) ** 2, -1) if metric == "l2"
                else np.einsum("qcd,qd->qc", v, q))
        np.testing.assert_allclose(a.scores, want, rtol=1e-4, atol=1e-4)
        step = np.diff(a.scores, axis=1)
        assert np.all(step >= 0) if metric == "l2" else np.all(step <= 0)
    with pytest.raises(ValueError, match="vector"):
        PagedAnnServeEngine(_paged(env), metric=metric, exact_rerank=40)


def test_exact_rerank_lifts_recall(env):
    plain = PagedAnnServeEngine(_paged(env), metric=env["metric"])
    rerank = PagedAnnServeEngine(_paged(env, vectors=env["vectors"]),
                                 metric=env["metric"], exact_rerank=40)
    q, pts = torch.tensor(env["q"]), torch.tensor(env["pts"])
    _, gt = exact_topk(q, pts, k=10, metric=env["metric"])
    rec = {}
    for name, eng in (("plain", plain), ("rerank", rerank)):
        req = eng.submit(env["q"], k=10, mode="H2", nprobe=16)
        eng.run()
        rec[name] = float(recall_n_at_k(torch.from_numpy(req.ids), gt))
    assert rec["rerank"] >= rec["plain"], rec


# ---------------------------------------------------------------------------
# mutation over read-only rows, generations, fail-closed first touch
# ---------------------------------------------------------------------------

def test_insert_delete_side_buffer_only(env):
    pts, metric = env["pts"], env["metric"]
    paged = _paged(env)
    eng = PagedAnnServeEngine(paged, metric=metric, side_capacity=64)
    new = _new_points(env, 4, np.random.default_rng(7))
    ids = eng.insert(new)
    assert min(ids) >= paged.first_new_id == len(pts)
    assert eng.index.side_fill == 4          # read-only rows: all spill
    assert all(not f for f in eng.index._free)
    req = eng.submit(new, k=10, mode="H", nprobe=16)
    eng.run()
    assert all(ids[j] in req.ids[j] for j in range(4))

    qv = env["q"][:1]
    r0 = eng.submit(qv, k=10, mode="H", nprobe=16)
    eng.run()
    victim = int(next(i for i in r0.ids[0] if 0 <= i < len(pts)))
    c, slot = eng.index._loc[victim]
    eng.delete([victim])
    assert not eng.index._free[c]            # a freed slot is never reused
    r1 = eng.submit(qv, k=10, mode="H", nprobe=16)
    eng.run()
    assert victim not in r1.ids[0]
    # the deletes are the engine's own: the artifact's tier is untouched
    assert bool(paged.meta.ivf.valid[c, slot])
    with pytest.raises(RuntimeError, match="read-only"):
        eng.index._apply_insert([0], [0], np.array([1]), None)
    assert eng.compact() == 0 and eng.index.side_fill == 4
    with pytest.raises(RuntimeError, match="offline"):
        eng.compact(rebuild=True)


def test_swap_generation_retargets_cache(env, tmp_path):
    """The next generation adopts the cache (rows dropped, counters kept),
    results are the resident engine's on it, and ids never go back."""
    store = ArtifactStore(str(tmp_path / "store"))
    store.put("main", env["port"], port_config(env["cfg"]),
              rt_grid=env["pgrid"])
    v2 = store.put("main", env["port"], port_config(env["cfg"]),
                   rt_grid=env["pgrid"])
    eng = PagedAnnServeEngine(PagedIndexData(store.path("main", 1),
                                             cache_bytes=1 << 22,
                                             device="cpu"),
                              metric=env["metric"])
    r0 = eng.submit(env["q"][:8], k=10, mode="H", nprobe=8)
    ids0 = eng.insert(env["pts"][:2] + np.float32(0.01))
    eng.run()
    cache = eng.index.paged.cache
    assert len(cache) > 0
    traffic = cache.hits + cache.misses
    with pytest.raises(RuntimeError, match="offline|generation"):
        eng.swap_index()
    with pytest.raises(TypeError):
        eng.swap_index(env["port"])
    paged2 = PagedIndexData(store.path("main", v2), cache_bytes=1 << 22,
                            device="cpu")
    assert eng.swap_index(paged2) == 1
    assert paged2.cache is cache and len(cache) == 0
    assert cache.hits + cache.misses == traffic
    assert eng.index.side_fill == 0
    r1 = eng.submit(env["q"][:8], k=10, mode="H", nprobe=8)
    eng.run()
    s, i = search(env["port"], env["q"][:8], nprobe=8, k=10, mode="H",
                  metric=env["metric"], batch=8)     # the engine's bucket
    np.testing.assert_array_equal(r1.ids, i.numpy())
    np.testing.assert_array_equal(r1.scores, s.numpy())
    assert not np.isin(ids0, r1.ids).any()
    assert min(eng.insert(env["pts"][:1])) > max(ids0)


def test_first_touch_corruption_fails_closed(env, tmp_path):
    path = str(tmp_path / "art")
    save_index(path, env["port"], port_config(env["cfg"]))
    apath = os.path.join(path, "arrays.npz")
    with np.load(apath) as z:
        arrays = {k: z[k].copy() for k in z.files}
    arrays["cluster_codes"][3, 0, 0] ^= 1
    np.savez(apath, **arrays)

    paged = PagedIndexData(path, cache_bytes=1 << 20, device="cpu")
    clean = paged.fetch_cluster(2)
    assert tuple(clean.shape) == arrays["cluster_codes"].shape[1:]
    with pytest.raises(ArtifactError, match="first touch"):
        paged.fetch_cluster(3)
    assert paged.verified_rows == 1 and 3 not in paged.cache._rows
    # a search that probes cluster 3 returns nothing
    eng = PagedAnnServeEngine(PagedIndexData(path, cache_bytes=1 << 20,
                                             device="cpu"),
                              metric=env["metric"])
    q3 = env["port"].ivf.centroids[3:4].numpy()
    req = eng.submit(q3, k=10, mode="H", nprobe=4)
    with pytest.raises(ArtifactError, match="cluster_codes\\[3\\]"):
        eng.run()
    assert not req.done and req.ids is None
    PagedIndexData(path, cache_bytes=1 << 20, verify_rows=False,
                   device="cpu").fetch_cluster(3)       # explicit opt-out

    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as fh:
        m = json.load(fh)
    del m["arrays"]["cluster_codes"]["sha256_rows"]
    with open(mpath, "w") as fh:
        json.dump(m, fh)
    with pytest.raises(ArtifactError, match="per-row digests"):
        PagedIndexData(path, cache_bytes=1 << 20, device="cpu")
    PagedIndexData(path, cache_bytes=1 << 20, verify_rows=False,
                   device="cpu")


def test_stats_and_vectors(env):
    paged = _paged(env, cache_bytes=1 << 22, vectors=env["vectors"])
    a, b = paged.fetch_cluster(0), paged.fetch_cluster(0)
    assert torch.equal(a, b)
    st = paged.stats()
    assert st["verified_rows"] == 1 and (st["hits"], st["misses"]) == (1, 1)
    assert st["cluster_bytes"] == np.asarray(env["idx"].cluster_codes).nbytes
    assert st["generation"] == env["path"]
    vv = paged.fetch_vectors(torch.tensor([[0, 5, -1]]))
    assert vv.shape == (1, 3, env["pts"].shape[1])
    np.testing.assert_array_equal(vv[0, 0].numpy(), env["pts"][0])
    np.testing.assert_array_equal(vv[0, 2].numpy(), env["pts"][0])
    with pytest.raises(RuntimeError, match="vector"):
        _paged(env).fetch_vectors(torch.tensor([0]))


def test_rt_needs_the_artifact_grid(env, tmp_path):
    path = str(tmp_path / "no_grid")
    jax_save_index(path, env["idx"], env["cfg"])
    bare = PagedJunoIndex(PagedIndexData(path, device="cpu"))
    with pytest.raises(RuntimeError, match="grid"):
        bare.ensure_rt_grid()
    with pytest.raises(RuntimeError, match="grid"):
        PagedAnnServeEngine(PagedIndexData(path, device="cpu"),
                            metric=env["metric"], prefilter="rt")
    paged = _paged(env)
    for f, want in env["pgrid"]._asdict().items():
        assert torch.equal(getattr(paged.rt_grid, f), want), f
    eng = PagedAnnServeEngine(paged, metric=env["metric"], prefilter="rt")
    assert eng.index.ensure_rt_grid() is eng.index.rt_grid


def test_reference_paged_search_matches(env):
    """``PagedJunoIndex.search`` against the reference's, one shot."""
    pidx = PagedJunoIndex(_paged(env))
    jidx = jpaged.PagedJunoIndex(jpaged.PagedIndexData(
        env["path"], cache_bytes=_quarter(env)))
    kw = dict(nprobe=NPROBE, k=10, mode="H", metric=env["metric"])
    s0, i0 = jidx.search(jnp.asarray(env["q"]), **kw)
    s1, i1 = pidx.search(env["q"], batch=32, **kw)
    assert_ids_equal_up_to_ties(i1.numpy(), i0, s1.numpy(), s0)
    assert pidx.paged.stats() == jidx.paged.stats()


# ---------------------------------------------------------------------------
# the freshness tiers over a paged index (minor artifacts)
# ---------------------------------------------------------------------------

@pytest.fixture()
def paged_tiered(env, tmp_path):
    store = ArtifactStore(str(tmp_path / "minors"))
    eng = PagedAnnServeEngine(_paged(env, cache_bytes=1 << 22),
                              metric=env["metric"], side_capacity=4,
                              minor_store=store, max_minors=2)
    new = _new_points(env, 6, np.random.default_rng(13))
    ids = eng.insert(new[:4])          # read-only rows: all 4 fill L0
    ids += eng.insert(new[4:])         # a full L0 commits a minor artifact
    assert len(eng.index._minors) == 1
    return eng, store, new, ids


def test_paged_minor_promotion_commits_artifact(paged_tiered):
    eng, store, new, ids = paged_tiered
    minor = eng.index._minors[0]
    assert minor.path == store.path("minors", 1) and minor.codes is None
    req = eng.submit(new, k=10, mode="H", nprobe=16)
    eng.run()                          # faults the minor's codes in
    assert minor.codes is not None
    assert all(pid in req.ids[j] for j, pid in enumerate(ids))
    eng.insert(new[:4] + np.float32(1e-3))
    assert len(eng.index._minors) == 2 and store.latest("minors") == 2


def test_paged_minor_corruption_fails_closed(paged_tiered):
    eng, _, new, _ = paged_tiered
    minor = eng.index._minors[0]
    apath = os.path.join(minor.path, "minor.npz")
    with np.load(apath) as z:
        arrays = {k: z[k].copy() for k in z.files}
    arrays["codes"][0, 0] ^= 1
    np.savez(apath, **arrays)
    eng.submit(new, k=10, mode="H", nprobe=16)
    with pytest.raises(ArtifactError, match="minor code row"):
        eng.run()
    assert minor.codes is None
