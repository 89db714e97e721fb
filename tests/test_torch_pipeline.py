"""The port's streaming build against ``repro.build.pipeline``.

The reference's draws are replayed with ``jax.random``
(``_torch_parity.jax_stream_draws``: the reservoir's seed and the
in-memory build's draws at ``n = fill``) and injected into the port's
``build_streaming``, so both builds train on the same sample with the
same inits and calibration queries. The index is held to the reference
at ``test_torch_build.py``'s tolerances (f32 rounding of the assignment
and of k-means' sums can move a near-tied point); the reservoir, the
build probe's counters, the density counts, the shard split/merge and the
refusal of an unstable source are exact (the density grid's log1p
within one ulp).
"""
import os

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (jax_build_draws, jax_stream_draws, port_config,
                           to_port)
from repro.build import BuildProbe as JaxProbe
from repro.build import array_source as jax_array_source
from repro.build import build_streaming as jax_build_streaming
from repro.build import pipeline as jpipe
from repro.core import JunoConfig
from repro.core import density as jdensity
from repro_torch.build import (ArtifactStore, BuildProbe, array_source,
                               build_streaming, build_streaming_sharded,
                               merge_shards, split_shards)
from repro_torch.build import pipeline as pipe
from repro_torch.core import build, exact_topk, recall_n_at_k, search
from repro_torch.core import density as pdensity
from repro_torch.data import DEEP_LIKE, TTI_LIKE, make_dataset, point_chunks
from repro_torch.data import synthetic
from repro_torch.serve.ann import AnnServeEngine

CHUNK = 1024


@pytest.fixture(scope="module")
def streamed():
    pts, q = make_dataset(DEEP_LIKE, 6000, 32, seed=3)
    # capacity_mult 1.1: the overflow spill runs, so pass 3 does too
    cfg = JunoConfig(n_clusters=16, n_entries=16, calib_queries=12,
                     kmeans_iters=4, capacity_mult=1.1)
    key = jax.random.PRNGKey(0)
    jprobe, pprobe = JaxProbe(), BuildProbe()
    ref = jax_build_streaming(jax_array_source(pts, CHUNK), cfg, key=key,
                              probe=jprobe)
    draws = jax_stream_draws(key, *pts.shape, cfg)
    port = build_streaming(array_source(pts, CHUNK), port_config(cfg),
                           draws=draws, probe=pprobe, device="cpu")
    mem = build(pts, port_config(cfg), device="cpu",
                draws=jax_build_draws(key, *pts.shape, cfg))
    _, gt = exact_topk(torch.from_numpy(q), torch.from_numpy(pts), k=10)
    return dict(pts=pts, q=q, gt=gt, cfg=cfg, key=key, draws=draws, ref=ref,
                port=port, mem=mem, jprobe=jprobe, pprobe=pprobe)


def _leaves(index):
    out = {}
    for group in ("ivf", "codebook", "density"):
        obj = getattr(index, group)
        for f in type(obj)._fields:
            out[f"{group}.{f}"] = getattr(obj, f)
    for f in ("codes", "cluster_codes", "points_sq"):
        out[f] = getattr(index, f)
    return out


def test_probe_counters_equal_the_reference(streamed):
    jp, pp = streamed["jprobe"], streamed["pprobe"]
    n = streamed["pts"].shape[0]
    assert vars(pp) == vars(jp)
    assert pp.passes in (2, 3)
    assert pp.chunks == pp.passes * -(-n // CHUNK)
    assert pp.max_chunk_rows <= CHUNK
    assert pp.n_points == n and pp.train_rows == n


def test_forced_spill_takes_a_third_pass(streamed):
    assert streamed["pprobe"].passes == streamed["jprobe"].passes == 3
    # the spilled points (owned by another cluster than their nearest)
    # were re-encoded against their new centroid, as the reference does
    ref, port = to_port(streamed["ref"]), streamed["port"]
    near = pipe._assign(torch.tensor(streamed["pts"]), port.ivf.centroids,
                        port.ivf.centroid_sq)
    spilled = near != port.ivf.labels.long()
    assert spilled.sum() > 0
    np.testing.assert_array_equal(port.ivf.labels.numpy(),
                                  ref.ivf.labels.numpy())
    assert (port.codes[spilled] == ref.codes[spilled]).float().mean() >= 0.99


def test_shapes_and_dtypes_equal_the_inmemory_build(streamed):
    got, want = _leaves(streamed["port"]), _leaves(streamed["mem"])
    assert got.keys() == want.keys()
    for name in got:
        assert got[name].shape == want[name].shape, name
        assert got[name].dtype == want[name].dtype, name


def test_index_matches_the_reference(streamed):
    ref, port = to_port(streamed["ref"]), streamed["port"]
    # as tests/test_torch_build.py: f32 GEMM/reduction order only
    np.testing.assert_allclose(port.ivf.centroids.numpy(),
                               ref.ivf.centroids.numpy(), atol=1e-4)
    np.testing.assert_array_equal(port.ivf.point_ids.numpy(),
                                  ref.ivf.point_ids.numpy())
    np.testing.assert_allclose(port.codebook.entries.numpy(),
                               ref.codebook.entries.numpy(), atol=0.1)
    assert (port.codes == ref.codes).float().mean() >= 0.999
    np.testing.assert_allclose(port.points_sq.numpy(), ref.points_sq.numpy(),
                               rtol=1e-5)
    d, pd = ref.density, port.density
    np.testing.assert_allclose(pd.lo.numpy(), d.lo.numpy(), atol=1e-5)
    np.testing.assert_allclose(pd.hi.numpy(), d.hi.numpy(), atol=1e-5)
    np.testing.assert_allclose(pd.coeffs.numpy(), d.coeffs.numpy(),
                               rtol=0.1, atol=1e-2)
    np.testing.assert_allclose(float(pd.tau_min), float(d.tau_min), rtol=1e-2)
    np.testing.assert_allclose(float(pd.tau_max), float(d.tau_max), rtol=1e-2)


@pytest.mark.parametrize("mode", ["H", "M", "L"])
def test_recall_within_001_of_the_inmemory_build(streamed, mode):
    q, gt = torch.from_numpy(streamed["q"]), streamed["gt"]
    recall = {tag: recall_n_at_k(search(streamed[tag], q, nprobe=8, k=10,
                                        mode=mode)[1].long(), gt)
              for tag in ("mem", "port")}
    assert recall["port"] >= recall["mem"] - 0.01, recall


def test_reservoir_is_the_references_bit_for_bit(streamed):
    pts = streamed["pts"][:5000]
    seed = jax_stream_draws(jax.random.PRNGKey(5), 5000, pts.shape[1],
                            streamed["cfg"]).reservoir_seed
    out = []
    for mod in (jpipe, pipe):
        sample = np.zeros((2000, pts.shape[1]), np.float32)
        rng, fill, seen = np.random.default_rng(seed), 0, 0
        for lo in range(0, 5000, 512):
            fill, seen = mod._reservoir_extend(sample, fill, seen,
                                               pts[lo:lo + 512], rng)
        out.append((sample, fill, seen))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1:] == out[1][1:] == (2000, 5000)


def test_subsampled_build_stays_bounded(streamed):
    pts = streamed["pts"][:3000]
    cfg = port_config(JunoConfig(n_clusters=16, n_entries=16,
                                 calib_queries=8, kmeans_iters=3,
                                 max_train_points=1200))
    probe = BuildProbe()
    idx = build_streaming(array_source(pts, 256), cfg, probe=probe,
                          device="cpu")
    assert probe.train_rows == 1200 and probe.n_points == 3000
    assert probe.max_chunk_rows <= 256
    q = torch.from_numpy(streamed["q"])
    _, gt = exact_topk(q, torch.from_numpy(pts), k=10)      # over the 3000
    _, ids = search(idx, q, nprobe=8, k=10, mode="H")
    assert recall_n_at_k(ids.long(), gt) > 0.3


def test_split_merge_is_bit_equal(streamed):
    whole = streamed["port"]
    parts = build_streaming_sharded(array_source(streamed["pts"], 2048),
                                    port_config(streamed["cfg"]), 4,
                                    draws=streamed["draws"], device="cpu")
    cl = whole.ivf.centroids.shape[0] // 4
    assert len(parts) == 4
    for i, part in enumerate(parts):
        assert torch.equal(part.ivf.point_ids,
                           whole.ivf.point_ids[i * cl:(i + 1) * cl])
    for name, got in _leaves(merge_shards(parts)).items():
        assert torch.equal(got, _leaves(whole)[name]), name
    for name, got in _leaves(merge_shards(split_shards(whole, 4))).items():
        assert torch.equal(got, _leaves(whole)[name]), name
    with pytest.raises(ValueError):
        split_shards(whole, 5)


def test_unstable_source_is_refused(streamed):
    pts = streamed["pts"]
    one_shot = iter([pts[:2048], pts[2048:]])
    with pytest.raises(ValueError):
        build_streaming(one_shot, port_config(streamed["cfg"]), device="cpu")


@pytest.mark.parametrize("weights", ["none", "pad_and_patch"])
def test_density_counts_equal_the_reference(weights):
    rng = np.random.default_rng(11)
    s, b, g = 3, 700, 16
    sub = rng.standard_normal((s, b, 2)).astype(np.float32)
    # the box from a part of the rows: the rest clip to edge cells
    lo = sub[:, :400].min(axis=1)
    hi = sub[:, :400].max(axis=1)
    counts = rng.integers(0, 5, (s, g, g)).astype(np.float32)
    w = None
    if weights != "none":
        w = np.ones((b,), np.float32)
        w[-50:] = 0.0
        w[:30] = -1.0
    want = np.asarray(jdensity.accumulate_density_counts(
        counts, sub, lo, hi, None if w is None else w))
    got = pdensity.accumulate_density_counts(
        torch.from_numpy(counts), torch.from_numpy(sub), torch.from_numpy(lo),
        torch.from_numpy(hi), None if w is None else torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)
    # the grid is log1p(count / area): torch's and XLA's f32 log1p are
    # different implementations, within one ulp of each other
    np.testing.assert_array_max_ulp(
        pdensity.density_grid_from_counts(got, torch.from_numpy(lo),
                                          torch.from_numpy(hi)).numpy(),
        np.asarray(jdensity.density_grid_from_counts(want, lo, hi)), maxulp=1)


def test_stream_store_serve_rebuild_lifecycle(streamed, tmp_path):
    pts, cfg = streamed["pts"], port_config(streamed["cfg"])
    store = ArtifactStore(str(tmp_path / "lifecycle"))
    store.put("prod", streamed["port"], cfg)       # the streamed build
    loaded = store.get("prod", expect_config=cfg, device="cpu")
    eng = AnnServeEngine(loaded.data, side_capacity=64)
    # overfill the fullest cluster (side spills) and tombstone two members
    mid = eng.index
    c = int(np.argmin([mid.free_slots(c) for c in range(cfg.n_clusters)]))
    cent = loaded.data.ivf.centroids[c].numpy()
    rng = np.random.default_rng(29)
    new = (cent[None] + 0.02 * rng.standard_normal(
        (mid.free_slots(c) + 4, cent.shape[0]))).astype(np.float32)
    ids = eng.insert(new)
    assert mid.side_fill >= 4
    row = mid.data.ivf.point_ids[c][mid.data.ivf.valid[c]].tolist()
    eng.delete([p for p in row if p < len(pts)][:2])
    before = eng.submit(new, k=10, mode="H", nprobe=16)
    eng.run()
    eng.swap_index()
    assert mid.side_fill == 0
    after = eng.submit(new, k=10, mode="H", nprobe=16)
    eng.run()
    for j, i in enumerate(ids):
        assert (i in before.ids[j]) == (i in after.ids[j])
    assert store.put("prod", eng.index.data, cfg) == 2
    again = store.get("prod", device="cpu")
    assert torch.equal(again.data.ivf.point_ids, eng.index.data.ivf.point_ids)
    assert sorted(os.listdir(os.path.join(store.root, "prod"))) == [
        "v0001", "v0002"]


def test_point_chunks_replay_make_dataset(monkeypatch):
    """The chunk source of a synthetic set is the set, pass after pass."""
    monkeypatch.setattr(synthetic, "_CHUNK", 1000)
    pts, _ = make_dataset(DEEP_LIKE, 2500, 4, seed=3)
    src = point_chunks(DEEP_LIKE, 2500, seed=3)
    for _ in range(2):
        chunks = list(src())
        assert [c.shape[0] for c in chunks] == [1000, 1000, 500]
        np.testing.assert_array_equal(np.concatenate(chunks), pts)
    with pytest.raises(ValueError):
        point_chunks(TTI_LIKE, 10)
