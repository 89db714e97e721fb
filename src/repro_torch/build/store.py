"""Reader of the index artifact that ``repro.build.store.save_index`` writes.

An artifact is a directory with ``arrays.npz`` (every index array under a
dotted key such as ``ivf.centroids``, plus an optional ``rt_grid.*``
group) and ``manifest.json`` (schema version, the build config and its
hash, and a per-array shape/dtype/sha256 table). This module reads it
with numpy alone, checks it, and fails closed with :class:`ArtifactError`
— the port of ``repro/build/store.py:200-313,328-403`` without the
writer. :func:`index_from_arrays` turns the arrays into an index on a
torch device; the ``rt_grid.*`` arrays are kept aside for the RT slice.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import NamedTuple

import numpy as np
import torch

from ..core.density import DensityModel
from ..core.ivf import IVFIndex
from ..core.juno import JunoConfig, JunoIndexData
from ..core.pq import PQCodebook
from ..device import resolve_device

#: the artifact layout this reader understands
SCHEMA_VERSION = 1

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"
_RT_PREFIX = "rt_grid."


class ArtifactError(RuntimeError):
    """A persisted index failed validation (version, config hash, integrity)."""


class LoadedIndex(NamedTuple):
    """What :func:`load_index` returns."""

    data: JunoIndexData
    config: JunoConfig
    manifest: dict
    rt_arrays: dict   # the ``rt_grid.*`` arrays (numpy), for a later slice


def _config_hash(config: dict) -> str:
    """sha256 of the config's sorted JSON (the writer's ``config_hash``)."""
    return hashlib.sha256(json.dumps(config, sort_keys=True).encode()
                          ).hexdigest()


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def read_artifact(path: str) -> tuple[dict, dict[str, np.ndarray]]:
    """Read and fully verify an artifact.

    Checks the schema version, that the manifest's config matches its
    hash, that ``arrays.npz`` holds exactly the listed arrays, and each
    array's shape, dtype, per-row digest count and sha256.

    Parameters
    ----------
    path : str
        Artifact directory.

    Returns
    -------
    tuple
        ``(manifest, arrays)`` with ``arrays`` a dict of numpy arrays.

    Raises
    ------
    ArtifactError
        On any missing file, version mismatch or integrity failure.
    """
    mpath = os.path.join(path, _MANIFEST)
    apath = os.path.join(path, _ARRAYS)
    for p in (mpath, apath):
        if not os.path.exists(p):
            raise ArtifactError(f"missing {p}")
    with open(mpath) as fh:
        manifest = json.load(fh)
    ver = manifest.get("schema_version")
    if ver != SCHEMA_VERSION:
        raise ArtifactError(f"schema version mismatch: artifact v{ver}, "
                            f"reader v{SCHEMA_VERSION} ({path})")
    if manifest.get("config_hash") != _config_hash(manifest.get("config", {})):
        raise ArtifactError(f"manifest config_hash does not match its own "
                            f"config ({path})")
    with np.load(apath) as z:
        arrays = {k: z[k] for k in z.files}
    listed = set(manifest["arrays"])
    if set(arrays) != listed:
        raise ArtifactError(
            f"array set mismatch: bundle-only {sorted(set(arrays) - listed)}, "
            f"manifest-only {sorted(listed - set(arrays))} ({path})")
    for name, meta in manifest["arrays"].items():
        a = arrays[name]
        if list(a.shape) != meta["shape"] or str(a.dtype) != meta["dtype"]:
            raise ArtifactError(
                f"{name}: stored {a.shape}/{a.dtype} != manifest "
                f"{meta['shape']}/{meta['dtype']} ({path})")
        rows = meta.get("sha256_rows")
        if rows is not None and len(rows) != meta["shape"][0]:
            raise ArtifactError(f"{name}: {len(rows)} per-row digests for "
                                f"{meta['shape'][0]} rows ({path})")
        if _digest(a) != meta["sha256"]:
            raise ArtifactError(f"{name}: checksum mismatch ({path})")
    return manifest, arrays


def index_from_arrays(arrays: dict[str, np.ndarray],
                      device=None) -> JunoIndexData:
    """Build an index on ``device`` from the artifact's flat arrays.

    Parameters
    ----------
    arrays : dict
        Keyed as the writer flattens an index: ``ivf.*``, ``codebook.*``,
        ``density.*``, ``codes``, ``cluster_codes``, ``points_sq``
        (``rt_grid.*`` keys are ignored). Values keep their dtype.
    device : str or torch.device, optional
        ``None`` = ``cuda``; ``"cpu"`` for the CPU.

    Returns
    -------
    JunoIndexData
        The index, every array bit-equal to its source.
    """
    dev = resolve_device(device)

    def t(key):
        if key not in arrays:
            raise ArtifactError(f"missing array {key!r}")
        return torch.from_numpy(np.require(arrays[key],
                                           requirements=["C", "W"])).to(dev)

    def group(name, cls):
        return cls(*(t(f"{name}.{f}") for f in cls._fields))

    return JunoIndexData(
        ivf=group("ivf", IVFIndex), codebook=group("codebook", PQCodebook),
        codes=t("codes"), cluster_codes=t("cluster_codes"),
        density=group("density", DensityModel), points_sq=t("points_sq"))


def load_index(path: str, *, device=None) -> LoadedIndex:
    """Read, verify and load an artifact onto ``device``.

    Parameters
    ----------
    path : str
        Artifact directory written by ``repro.build.store.save_index``.
    device : str or torch.device, optional
        ``None`` = ``cuda``; ``"cpu"`` for the CPU.

    Returns
    -------
    LoadedIndex
        ``(data, config, manifest, rt_arrays)``.

    Raises
    ------
    ArtifactError
        See :func:`read_artifact`.
    """
    manifest, arrays = read_artifact(path)
    fields = {f.name for f in dataclasses.fields(JunoConfig)}
    if set(manifest["config"]) != fields:
        raise ArtifactError(f"config fields {sorted(manifest['config'])} do "
                            f"not match JunoConfig ({path})")
    rt = {k: v for k, v in arrays.items() if k.startswith(_RT_PREFIX)}
    return LoadedIndex(data=index_from_arrays(arrays, device),
                       config=JunoConfig(**manifest["config"]),
                       manifest=manifest, rt_arrays=rt)
