"""Index artifacts across the two packages, the port's ``ArtifactStore``,
and the port's import boundary.

An artifact written by either package loads in the other, every array
bit-equal in value and dtype and the manifests equal as dicts; the
memory-mapped load gives the same arrays and rt grid. Every fault the
reference's loader refuses at a verify level (tampered bytes, array set,
shape, dtype, row-digest count, schema version, config hash) the port
refuses at that level, with ``ArtifactError``. The store commits numbered
generations, and two racing ``put`` calls commit two. The port's modules
and ``chip_smoke.py`` must not import JAX or anything of ``repro``.
"""
import ast
import json
import os
import subprocess
import sys
import threading
import zipfile

import jax
import numpy as np
import pytest

from _torch_mutable import port_grid
from _torch_parity import port_config, to_port
from repro import rt as jrt
from repro.build import store as jstore
from repro.build.store import save_index
from repro.core import JunoConfig, build
from repro.data import TTI_LIKE, make_dataset
from repro_torch.build import (ArtifactError, ArtifactStore, config_hash,
                               load_index, verify_artifact)
from repro_torch.build import save_index as port_save_index

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    pts, _ = make_dataset(TTI_LIKE, 2000, 4, key=jax.random.PRNGKey(9))
    cfg = JunoConfig(n_clusters=8, n_entries=16, metric="ip",
                     calib_queries=16, kmeans_iters=3)
    data = build(pts, cfg, jax.random.PRNGKey(1))
    path = str(tmp_path_factory.mktemp("art") / "idx")
    save_index(path, data, cfg, extra={"note": "port hand-off"})
    return path, cfg


def _flat(loaded):
    d = loaded.data
    out = {}
    for group, obj in (("ivf", d.ivf), ("codebook", d.codebook),
                       ("density", d.density)):
        for f in type(obj)._fields:
            out[f"{group}.{f}"] = getattr(obj, f)
    for f in ("codes", "cluster_codes", "points_sq"):
        out[f] = getattr(d, f)
    return out


def test_every_array_crosses_bit_equal(artifact):
    path, cfg = artifact
    loaded = load_index(path, device="cpu")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        saved = {k: z[k] for k in z.files}
    got = _flat(loaded)
    assert set(got) == set(saved)
    for name, t in got.items():
        a = t.numpy()
        assert a.dtype == saved[name].dtype, name
        np.testing.assert_array_equal(a, saved[name], err_msg=name)
    assert loaded.config.n_clusters == cfg.n_clusters
    assert loaded.config.metric == "ip" and loaded.rt_grid is None
    assert loaded.manifest["extra"] == {"note": "port hand-off"}


def _rewrite(path, arrays=None, manifest=None):
    if arrays is not None:
        np.savez(os.path.join(path, "arrays.npz"), **arrays)
    if manifest is not None:
        with open(os.path.join(path, "manifest.json"), "w") as fh:
            json.dump(manifest, fh)


@pytest.mark.parametrize("fault", ["tampered_value", "extra_array",
                                   "shape", "dtype", "schema", "config"])
def test_corrupt_artifacts_fail_closed(artifact, tmp_path, fault):
    src, _ = artifact
    path = str(tmp_path / "bad")
    os.makedirs(path)
    with np.load(os.path.join(src, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(src, "manifest.json")) as fh:
        manifest = json.load(fh)
    meta = manifest["arrays"]["ivf.centroids"]
    if fault == "tampered_value":
        arrays["ivf.centroids"] = arrays["ivf.centroids"].copy()
        arrays["ivf.centroids"][0, 0] += 1.0
    elif fault == "extra_array":
        arrays["stray"] = np.zeros(3)
    elif fault == "shape":
        meta["shape"] = [meta["shape"][0] + 1] + meta["shape"][1:]
    elif fault == "dtype":
        meta["dtype"] = "float64"
    elif fault == "schema":
        manifest["schema_version"] = 99
    else:
        manifest["config"]["n_entries"] += 1
    _rewrite(path, arrays, manifest)
    with pytest.raises(ArtifactError):
        load_index(path, device="cpu")


@pytest.fixture(scope="module")
def with_grid(tmp_path_factory):
    """A reference index, its rt grid and both packages' artifacts of it
    (the port's written from the index and grid carried across)."""
    pts, _ = make_dataset(TTI_LIKE, 2000, 4, key=jax.random.PRNGKey(9))
    cfg = JunoConfig(n_clusters=8, n_entries=16, metric="ip",
                     calib_queries=16, kmeans_iters=3)
    data = build(pts, cfg, jax.random.PRNGKey(1))
    grid = jrt.build_grid(data, metric="ip", calib_queries=8)
    root = tmp_path_factory.mktemp("grid_art")
    ref_path, port_path = str(root / "ref"), str(root / "port")
    save_index(ref_path, data, cfg, rt_grid=grid, extra={"shard": 3})
    port_save_index(port_path, to_port(data), port_config(cfg),
                    rt_grid=port_grid(grid), extra={"shard": 3})
    return data, grid, cfg, ref_path, port_path


def _bundle(path):
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def test_port_artifact_loads_in_the_reference(with_grid):
    data, grid, cfg, ref_path, port_path = with_grid
    with open(os.path.join(ref_path, "manifest.json")) as fh:
        ref_manifest = json.load(fh)
    with open(os.path.join(port_path, "manifest.json")) as fh:
        assert json.load(fh) == ref_manifest
    assert jstore.verify_artifact(port_path) == ref_manifest
    loaded = jstore.load_index(port_path, expect_config=cfg, verify="full")
    want = jstore._flatten_index(data)
    got = jstore._flatten_index(loaded.data)
    assert set(got) == set(want)
    for name, a in got.items():
        assert a.dtype == want[name].dtype, name
        np.testing.assert_array_equal(a, want[name], err_msg=name)
    for f in grid._fields:
        np.testing.assert_array_equal(np.asarray(getattr(loaded.rt_grid, f)),
                                      np.asarray(getattr(grid, f)), err_msg=f)
    ref_bundle, port_bundle = _bundle(ref_path), _bundle(port_path)
    assert set(ref_bundle) == set(port_bundle)
    for name, a in port_bundle.items():
        assert a.dtype == ref_bundle[name].dtype, name
        np.testing.assert_array_equal(a, ref_bundle[name], err_msg=name)
    with zipfile.ZipFile(os.path.join(port_path, "arrays.npz")) as zf:
        assert {i.compress_type for i in zf.infolist()} == {zipfile.ZIP_STORED}


@pytest.mark.parametrize("mmap", [False, True])
def test_reference_artifact_loads_in_the_port(with_grid, mmap):
    data, grid, cfg, ref_path, _ = with_grid
    loaded = load_index(ref_path, expect_config=port_config(cfg),
                        mmap_mode="r" if mmap else None, device="cpu")
    assert config_hash(loaded.config) == jstore.config_hash(cfg)
    want = jstore._flatten_index(data)
    leaves = {**{f"ivf.{f}": getattr(loaded.data.ivf, f)
                 for f in loaded.data.ivf._fields},
              **{f"codebook.{f}": getattr(loaded.data.codebook, f)
                 for f in loaded.data.codebook._fields},
              **{f"density.{f}": getattr(loaded.data.density, f)
                 for f in loaded.data.density._fields},
              **{f: getattr(loaded.data, f)
                 for f in ("codes", "cluster_codes", "points_sq")}}
    assert set(leaves) == set(want)
    for name, a in leaves.items():
        a = a if mmap else a.numpy()
        assert isinstance(a, np.memmap) == mmap, name
        assert a.dtype == want[name].dtype, name
        np.testing.assert_array_equal(a, want[name], err_msg=name)
    for f in grid._fields:
        got = getattr(loaded.rt_grid, f)
        got = got if mmap else got.numpy()
        assert got.dtype == np.asarray(getattr(grid, f)).dtype, f
        np.testing.assert_array_equal(got, np.asarray(getattr(grid, f)),
                                      err_msg=f)
    assert verify_artifact(ref_path) == loaded.manifest


def _raised(fn):
    try:
        fn()
    except Exception as e:      # noqa: BLE001 — the outcome is compared
        return type(e).__name__
    return None


FAULTS = ["tampered_codes", "tampered_grid", "missing_array", "extra_array",
          "shape", "dtype", "row_digests", "schema", "config",
          "expect_config"]


@pytest.mark.parametrize("mmap", [False, True])
@pytest.mark.parametrize("level", ["full", "manifest", "never"])
@pytest.mark.parametrize("fault", FAULTS)
def test_faults_fail_closed_as_in_the_reference(with_grid, tmp_path, fault,
                                                level, mmap):
    """At every verify level, with and without ``mmap_mode``, the port's
    loader refuses exactly what the reference's refuses, always with
    ``ArtifactError`` (where the reference fails on a missing array with a
    ``KeyError`` at level "never", the port names it)."""
    _, _, cfg, src, _ = with_grid
    path = str(tmp_path / "bad")
    os.makedirs(path)
    arrays = {k: v.copy() for k, v in _bundle(src).items()}
    with open(os.path.join(src, "manifest.json")) as fh:
        manifest = json.load(fh)
    meta = manifest["arrays"]["ivf.centroids"]
    expect = cfg
    if fault == "tampered_codes":
        arrays["cluster_codes"][1, 0, 0] ^= 1
    elif fault == "tampered_grid":
        arrays["rt_grid.slot_reach"].reshape(-1)[0] += 1.0
    elif fault == "missing_array":
        del arrays["points_sq"]
    elif fault == "extra_array":
        arrays["stray"] = np.zeros(3)
    elif fault == "shape":
        meta["shape"] = [meta["shape"][0] + 1] + meta["shape"][1:]
    elif fault == "dtype":
        meta["dtype"] = "float64"
    elif fault == "row_digests":
        rows = manifest["arrays"]["cluster_codes"]["sha256_rows"]
        manifest["arrays"]["cluster_codes"]["sha256_rows"] = rows[:-1]
    elif fault == "schema":
        manifest["schema_version"] = 99
    elif fault == "config":
        manifest["config"]["n_entries"] += 1
    else:
        expect = JunoConfig(n_clusters=cfg.n_clusters + 1)
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    kw = dict(verify=level, mmap_mode="r" if mmap else None)
    ref = _raised(lambda: jstore.load_index(path, expect_config=expect, **kw))
    port = _raised(lambda: load_index(path, expect_config=port_config(expect),
                                      device="cpu", **kw))
    assert (port is None) == (ref is None), (ref, port)
    assert port in (None, "ArtifactError"), port


def test_verify_levels_refuse_bad_input(with_grid):
    _, _, _, path, _ = with_grid
    with pytest.raises(ValueError, match="verify"):
        load_index(path, verify="paranoid", device="cpu")
    with pytest.raises(ValueError, match="mmap_mode"):
        load_index(path, mmap_mode="w", device="cpu")
    for v in (True, False, None):           # the boolean aliases load
        assert load_index(path, verify=v, device="cpu").rt_grid is not None


def test_artifact_store_versions(with_grid, tmp_path):
    data, _, cfg, _, _ = with_grid
    port, pcfg = to_port(data), port_config(cfg)
    store = ArtifactStore(str(tmp_path / "store"))
    assert store.latest("main") is None and store.versions("main") == []
    with pytest.raises(ArtifactError):
        store.get("main", device="cpu")
    assert [store.put("main", port, pcfg) for _ in range(2)] == [1, 2]
    assert store.versions("main") == [1, 2] and store.latest("main") == 2
    loaded = store.get("main", expect_config=pcfg, device="cpu")
    np.testing.assert_array_equal(loaded.data.codes.numpy(),
                                  np.asarray(data.codes))
    assert store.verify("main", 1)["config_hash"] == config_hash(pcfg)
    # the reference's store reads the port's generations
    assert jstore.ArtifactStore(store.root).versions("main") == [1, 2]


def test_put_retries_past_a_concurrent_commit(with_grid, tmp_path,
                                              monkeypatch):
    data, _, cfg, _, _ = with_grid
    store = ArtifactStore(str(tmp_path / "store"))
    assert store.put("main", to_port(data), port_config(cfg)) == 1
    real_rename, raced = os.rename, []

    def racing_rename(src, dst):
        if os.path.basename(src).startswith(".tmp-") and not raced:
            raced.append(dst)          # another writer commits dst first
            os.makedirs(dst)
            with open(os.path.join(dst, "manifest.json"), "w") as fh:
                fh.write("{}")
        return real_rename(src, dst)

    monkeypatch.setattr(os, "rename", racing_rename)
    v = store.put("main", to_port(data), port_config(cfg))
    monkeypatch.undo()
    assert raced and v == 3 and store.versions("main") == [1, 2, 3]
    verify_artifact(store.path("main", 3))


def test_racing_puts_commit_distinct_generations(with_grid, tmp_path):
    data, _, cfg, _, _ = with_grid
    port, pcfg = to_port(data), port_config(cfg)
    store = ArtifactStore(str(tmp_path / "store"))
    barrier, got = threading.Barrier(4), []

    def put():
        barrier.wait()
        got.append(store.put("main", port, pcfg))

    threads = [threading.Thread(target=put) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert sorted(got) == [1, 2, 3, 4] == store.versions("main")
    assert sorted(os.listdir(os.path.join(store.root, "main"))) == [
        f"v{i:04d}" for i in (1, 2, 3, 4)]          # no temp debris left
    for v in got:
        verify_artifact(store.path("main", v))


def test_put_crash_at_rename_leaves_no_generation(with_grid, tmp_path,
                                                  monkeypatch):
    import errno
    data, _, cfg, _, _ = with_grid
    store = ArtifactStore(str(tmp_path / "store"))
    assert store.put("main", to_port(data), port_config(cfg)) == 1

    def crash(src, dst):
        raise OSError(errno.EIO, "simulated crash at rename")

    monkeypatch.setattr(os, "rename", crash)
    with pytest.raises(OSError):
        store.put("main", to_port(data), port_config(cfg))
    monkeypatch.undo()
    assert os.listdir(os.path.join(store.root, "main")) == ["v0001"]
    assert store.put("main", to_port(data), port_config(cfg)) == 2


def test_missing_manifest_fails_closed(tmp_path):
    with pytest.raises(ArtifactError):
        load_index(str(tmp_path), device="cpu")


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "walked = {n for n in sys.modules if n.startswith('repro_torch')}\n"
        "assert {'repro_torch.obs', 'repro_torch.obs.recall',\n"
        "        'repro_torch.build.pipeline',\n"
        "        'repro_torch.dist.distributed_index',\n"
        "        'repro_torch.serve.fleet', 'repro_torch.kernels.autotune',\n"
        "        'repro_torch.core.metrics', 'repro_torch.core.scan',\n"
        "        'repro_torch.models.juno_attention',\n"
        "        'repro_torch.models.transformer', 'repro_torch.models.api',\n"
        "        'repro_torch.models.moe', 'repro_torch.models.mla',\n"
        "        'repro_torch.models.mamba2', 'repro_torch.models.whisper',\n"
        "        'repro_torch.serve.engine', 'repro_torch.configs',\n"
        "        'repro_torch.data.tokens', 'repro_torch.train.optimizer',\n"
        "        'repro_torch.train.steps', 'repro_torch.dist.checkpoint',\n"
        "        'repro_torch.dist.fault_tolerance',\n"
        "        'repro_torch.dist.compression',\n"
        "        'repro_torch.launch.train', 'repro_torch.launch.mesh',\n"
        "        'repro_torch.launch.shapes', 'repro_torch.launch.analytic',\n"
        "        'repro_torch.launch.comm_analysis',\n"
        "        'repro_torch.launch.dryrun',\n"
        "        'repro_torch.dist.sharding'} <= walked, walked\n"
        "print(len(walked))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15   # every module of the port imported


def test_card_test_helpers_import_no_jax():
    """The card's machine has no JAX: its test file
    (``tests/test_torch_kernels_gpu.py``, run there with ``--noconftest``)
    and the helpers it imports must import neither ``jax`` nor ``repro``."""
    code = (
        "import sys\n"
        "import _torch_lut_views, _torch_rt_grids, test_torch_kernels_gpu\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), os.path.join(REPO, "tests")]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_imports_neither_jax_nor_repro():
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "repro"}, names


def test_device_default_is_cuda_and_fails_closed():
    from repro_torch import resolve_device
    import torch
    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
