"""Artifact hand-off (``repro`` writes, ``repro_torch`` reads) and the
port's import boundary.

Every array must cross bit-equal in value and dtype; a tampered array, a
manifest that disagrees with the bundle, or a foreign schema version must
raise ``ArtifactError``. The port's modules and ``chip_smoke.py`` must not
import JAX or anything of ``repro``.
"""
import ast
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.build.store import save_index
from repro.core import JunoConfig, build
from repro.data import TTI_LIKE, make_dataset
from repro_torch.build import ArtifactError, load_index

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
    assert loaded.config.metric == "ip" and loaded.rt_arrays == {}
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
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15   # every module of the port imported


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
