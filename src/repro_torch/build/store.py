"""Versioned on-disk index artifacts: writer, reader and store.

Port of ``repro/build/store.py``. One artifact is a directory holding
``arrays.npz`` (every index array under a dotted key such as
``ivf.centroids``, plus the RT centroid grid under ``rt_grid.*`` when one
is attached, so an index and its calibrated filter travel together) and
``manifest.json`` (schema version, the build config and its hash, the
metric, an N/D/C/P/S/E summary and a per-array shape/dtype/sha256 table,
with one digest a row of ``cluster_codes``). The bytes on disk are the
reference's: an artifact written by either package loads in the other.

Loads fail closed at three levels (:func:`load_index`'s ``verify``):
``"full"`` re-digests every array, ``"manifest"`` checks the array set,
shapes and dtypes without reading data (the default of a memory-mapped
load, whose rows the paged tier verifies on first touch, see
``serve/paged.py``), and ``"never"`` checks only the schema version and
the config hash. :class:`ArtifactStore` keeps numbered generations of a
name; a ``put`` writes a temp directory, fsyncs it and renames it onto
the next free generation, so a reader never sees a half-written one.
"""
from __future__ import annotations

import dataclasses
import errno
import hashlib
import json
import os
import shutil
import time
import uuid
import zipfile
from typing import NamedTuple

import numpy as np
import torch

from ..core.density import DensityModel
from ..core.ivf import IVFIndex
from ..core.juno import JunoConfig, JunoIndexData
from ..core.pq import PQCodebook
from ..device import resolve_device
from ..rt.grid import CentroidGrid, grid_from_arrays

#: the on-disk layout this package writes and reads
SCHEMA_VERSION = 1

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"
_RT_PREFIX = "rt_grid."


class ArtifactError(RuntimeError):
    """A persisted index failed validation (version, config hash, integrity)."""


class LoadedIndex(NamedTuple):
    """What :func:`load_index` returns.

    ``data`` holds tensors on the load's device, or read-only numpy
    memmaps for ``mmap_mode="r"``; ``rt_grid`` is the artifact's
    :class:`~repro_torch.rt.CentroidGrid` (numpy memmaps too under
    ``mmap_mode="r"``), or ``None`` when none was saved.
    """

    data: JunoIndexData
    config: JunoConfig
    manifest: dict
    rt_grid: CentroidGrid | None


def config_hash(config: JunoConfig) -> str:
    """sha256 of the config's sorted JSON; equal iff every field is."""
    return _dict_hash(dataclasses.asdict(config))


def _dict_hash(config: dict) -> str:
    return hashlib.sha256(json.dumps(config, sort_keys=True).encode()
                          ).hexdigest()


def _array_digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _flatten_index(data: JunoIndexData) -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for group, obj in (("ivf", data.ivf), ("codebook", data.codebook),
                       ("density", data.density)):
        for f in type(obj)._fields:
            out[f"{group}.{f}"] = _host(getattr(obj, f))
    for f in ("codes", "cluster_codes", "points_sq"):
        out[f] = _host(getattr(data, f))
    return out


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_files(path: str) -> None:
    """Force every file of a directory, then its entry, to disk."""
    for fname in os.listdir(path):
        with open(os.path.join(path, fname), "rb") as fh:
            os.fsync(fh.fileno())
    _fsync_dir(path)


def save_index(path: str, data: JunoIndexData, config: JunoConfig, *,
               rt_grid: CentroidGrid | None = None,
               extra: dict | None = None) -> dict:
    """Write an index (and optionally its rt grid) as one artifact.

    The tensors are brought to the host and stored uncompressed
    (``np.savez``), so a memory-mapped load can address every member.

    Parameters
    ----------
    path : str
        Target directory (created; existing files are overwritten).
    data : JunoIndexData
        The index, on any device.
    config : JunoConfig
        The config it was built with (hashed into the manifest).
    rt_grid : CentroidGrid, optional
        A calibrated grid to fold into the same artifact.
    extra : dict, optional
        Caller metadata recorded verbatim in the manifest.

    Returns
    -------
    dict
        The manifest that was written.
    """
    arrays = _flatten_index(data)
    if rt_grid is not None:
        for f in CentroidGrid._fields:
            arrays[_RT_PREFIX + f] = _host(getattr(rt_grid, f))
    n, s = arrays["codes"].shape
    c, p = arrays["ivf.point_ids"].shape
    manifest = {
        "schema_version": SCHEMA_VERSION,
        "config": dataclasses.asdict(config),
        "config_hash": config_hash(config),
        "metric": config.metric,
        "shapes": {"n": int(n), "d": int(arrays["ivf.centroids"].shape[1]),
                   "c": int(c), "p": int(p), "s": int(s),
                   "e": int(arrays["codebook.entries"].shape[1])},
        "rt_grid": rt_grid is not None,
        "extra": dict(extra or {}),
        "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype),
                       "sha256": _array_digest(v)}
                   for k, v in arrays.items()},
    }
    # one digest a cluster row: the paged tier verifies a row on first touch
    manifest["arrays"]["cluster_codes"]["sha256_rows"] = [
        _array_digest(row) for row in arrays["cluster_codes"]]
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, _ARRAYS), **arrays)
    with open(os.path.join(path, _MANIFEST), "w") as fh:
        json.dump(manifest, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return manifest


def _read_manifest(path: str) -> dict:
    mpath = os.path.join(path, _MANIFEST)
    if not os.path.exists(mpath):
        raise ArtifactError(f"no manifest at {mpath}")
    with open(mpath) as fh:
        manifest = json.load(fh)
    ver = manifest.get("schema_version")
    if ver != SCHEMA_VERSION:
        raise ArtifactError(f"schema version mismatch: artifact v{ver}, "
                            f"reader v{SCHEMA_VERSION} ({path})")
    return manifest


def _load_arrays(path: str) -> dict[str, np.ndarray]:
    apath = os.path.join(path, _ARRAYS)
    if not os.path.exists(apath):
        raise ArtifactError(f"no array bundle at {apath}")
    try:
        with np.load(apath) as z:
            return {k: z[k] for k in z.files}
    except (zipfile.BadZipFile, ValueError) as e:
        # bit rot inside a member fails the zip's own CRC before the digests
        raise ArtifactError(f"unreadable array bundle {apath}: {e}") from e


def _mmap_arrays(path: str) -> dict[str, np.ndarray]:
    """Memory-map every member of ``arrays.npz`` without reading its data.

    Each uncompressed (``ZIP_STORED``) member is a contiguous byte range of
    the archive: the zip local file header gives the offset of the
    embedded ``.npy``, whose own header gives shape, dtype and order, and
    ``np.memmap`` maps the payload. A compressed or object-dtype member
    raises :class:`ArtifactError` (:func:`save_index` writes neither).
    """
    apath = os.path.join(path, _ARRAYS)
    if not os.path.exists(apath):
        raise ArtifactError(f"no array bundle at {apath}")
    out: dict[str, np.ndarray] = {}
    with zipfile.ZipFile(apath) as zf, open(apath, "rb") as fh:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ArtifactError(f"{info.filename}: compressed member "
                                    f"cannot be memory-mapped ({apath})")
            fh.seek(info.header_offset)
            hdr = fh.read(30)      # the fixed part of the local file header
            n_name = int.from_bytes(hdr[26:28], "little")
            n_extra = int.from_bytes(hdr[28:30], "little")
            fh.seek(info.header_offset + 30 + n_name + n_extra)
            version = np.lib.format.read_magic(fh)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(fh)
            if dtype.hasobject:
                raise ArtifactError(f"{info.filename}: object dtype cannot "
                                    f"be memory-mapped ({apath})")
            name = info.filename.removesuffix(".npy")
            out[name] = np.memmap(apath, dtype=dtype, mode="r",
                                  offset=fh.tell(), shape=shape,
                                  order="F" if fortran else "C")
    return out


def _check_arrays(manifest: dict, arrays: dict[str, np.ndarray], path: str,
                  *, digests: bool = True) -> None:
    names, listed = set(arrays), set(manifest["arrays"])
    if names != listed:
        raise ArtifactError(
            f"array set mismatch: bundle-only {sorted(names - listed)}, "
            f"manifest-only {sorted(listed - names)} ({path})")
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
        if digests and _array_digest(a) != meta["sha256"]:
            raise ArtifactError(f"{name}: checksum mismatch ({path})")


def verify_artifact(path: str) -> dict:
    """Check an artifact on disk against its manifest; return the manifest.

    Every listed array must be in ``arrays.npz`` (and no other) with the
    recorded shape, dtype, per-row digest count and sha256.

    Raises
    ------
    ArtifactError
        On a missing file, a version mismatch or an integrity failure.
    """
    manifest = _read_manifest(path)
    _check_arrays(manifest, _load_arrays(path), path)
    return manifest


def _normalize_verify(verify, mmap_mode) -> str:
    if verify is None:
        return "manifest" if mmap_mode else "full"
    if verify is True:
        return "full"
    if verify is False:
        return "manifest"
    if verify in ("full", "manifest", "never"):
        return verify
    raise ValueError(f"verify must be 'full', 'manifest' or 'never', "
                     f"got {verify!r}")


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A tensor on ``dev`` holding ``a``'s bits (memmaps are copied)."""
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _unflatten(arrays: dict[str, np.ndarray], convert) -> JunoIndexData:
    """The index from its flat arrays, each through ``convert``; a missing
    array raises :class:`ArtifactError`."""
    def t(key):
        if key not in arrays:
            raise ArtifactError(f"missing array {key!r}")
        return convert(arrays[key])

    def group(name, cls):
        return cls(*(t(f"{name}.{f}") for f in cls._fields))

    return JunoIndexData(
        ivf=group("ivf", IVFIndex), codebook=group("codebook", PQCodebook),
        codes=t("codes"), cluster_codes=t("cluster_codes"),
        density=group("density", DensityModel), points_sq=t("points_sq"))


def index_from_arrays(arrays: dict[str, np.ndarray],
                      device=None) -> JunoIndexData:
    """Build an index on ``device`` from the artifact's flat arrays.

    Parameters
    ----------
    arrays : dict
        Keyed as :func:`save_index` flattens an index: ``ivf.*``,
        ``codebook.*``, ``density.*``, ``codes``, ``cluster_codes``,
        ``points_sq`` (``rt_grid.*`` keys are ignored). Values keep their
        dtype.
    device : str or torch.device, optional
        ``None`` = ``cuda``; ``"cpu"`` for the CPU.

    Returns
    -------
    JunoIndexData
        The index, every array bit-equal to its source.
    """
    dev = resolve_device(device)
    return _unflatten(arrays, lambda a: _tensor(a, dev))


def load_index(path: str, *, expect_config: JunoConfig | None = None,
               verify: bool | str | None = None,
               mmap_mode: str | None = None, device=None) -> LoadedIndex:
    """Load an artifact, fail-closed.

    Parameters
    ----------
    path : str
        Artifact directory written by :func:`save_index` (or by
        ``repro.build.store.save_index``: the format is the same).
    expect_config : JunoConfig, optional
        When given, the artifact's config hash must equal this config's.
    verify : {"full", "manifest", "never"} or bool, optional
        ``"full"`` (the default of a resident load; ``True``) re-digests
        every array; ``"manifest"`` (the default under ``mmap_mode``;
        ``False``) checks the array set, shapes and dtypes without reading
        data; ``"never"`` checks only the schema version and config hash.
    mmap_mode : {"r"}, optional
        ``"r"`` returns read-only ``np.memmap`` views into ``arrays.npz``
        (no tensor, no device, no array data read at load time): the
        paged tier promotes the small arrays and pages the rest.
    device : str or torch.device, optional
        Where a resident load puts its tensors (``None`` = ``cuda``).

    Returns
    -------
    LoadedIndex
        ``(data, config, manifest, rt_grid)``.

    Raises
    ------
    ArtifactError
        On a version, config-hash or integrity mismatch.
    """
    if mmap_mode not in (None, "r"):
        raise ValueError(f"mmap_mode must be None or 'r', got {mmap_mode!r}")
    mode = _normalize_verify(verify, mmap_mode)
    manifest = _read_manifest(path)
    fields = {f.name for f in dataclasses.fields(JunoConfig)}
    if set(manifest.get("config", {})) != fields:
        raise ArtifactError(f"config fields "
                            f"{sorted(manifest.get('config', {}))} do not "
                            f"match JunoConfig ({path})")
    if manifest.get("config_hash") != _dict_hash(manifest["config"]):
        raise ArtifactError(f"manifest config_hash does not match its own "
                            f"config ({path})")
    config = JunoConfig(**manifest["config"])
    if expect_config is not None and \
            config_hash(expect_config) != manifest["config_hash"]:
        raise ArtifactError(
            f"config hash mismatch: expected {config_hash(expect_config)}, "
            f"artifact has {manifest['config_hash']} ({path})")
    arrays = _mmap_arrays(path) if mmap_mode == "r" else _load_arrays(path)
    if mode != "never":
        _check_arrays(manifest, arrays, path, digests=mode == "full")
    grid_arrays = {k: arrays.pop(k) for k in list(arrays)
                   if k.startswith(_RT_PREFIX)}
    rt_grid = None
    if mmap_mode == "r":
        if manifest.get("rt_grid"):
            rt_grid = CentroidGrid(**{f: grid_arrays[_RT_PREFIX + f]
                                      for f in CentroidGrid._fields})
        return LoadedIndex(data=_unflatten(arrays, lambda a: a),
                           config=config,
                           manifest=manifest, rt_grid=rt_grid)
    dev = resolve_device(device)
    if manifest.get("rt_grid"):
        rt_grid = grid_from_arrays(grid_arrays, dev)
    return LoadedIndex(data=index_from_arrays(arrays, dev), config=config,
                       manifest=manifest, rt_grid=rt_grid)


def _commit(root: str, name: str, write, latest, path_of,
            max_attempts: int) -> str:
    """Write a generation of ``name`` under ``root`` through ``write(tmp)``
    into a unique temp directory, fsync it, and rename it onto the next
    free generation (``latest() + 1``, retried when a concurrent writer
    took that number). Returns the committed directory."""
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}")
    try:
        write(tmp)
        _fsync_files(tmp)
        for _ in range(max_attempts):
            final = path_of((latest() or 0) + 1)
            try:
                os.rename(tmp, final)
            except OSError as e:
                if e.errno not in (errno.EEXIST, errno.ENOTEMPTY,
                                   errno.ENOTDIR, errno.EISDIR):
                    raise
                continue            # lost the race for this generation
            _fsync_dir(d)
            return final
        raise ArtifactError(f"could not commit a generation of {name!r} "
                            f"after {max_attempts} contended attempts")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class ArtifactStore:
    """Directory of named, versioned artifacts.

    Layout: ``<root>/<name>/v0001``, ``v0002``, … — one artifact a
    generation. Writes land in a temp directory and are renamed into
    place, so :meth:`latest`/:meth:`get` never see a half-written one.
    """

    def __init__(self, root: str, *, registry=None):
        """Open (creating if needed) the store rooted at ``root``.

        ``registry`` (an ``obs.MetricsRegistry``, optional) receives the
        ``juno_store_*`` series: ``juno_store_op_seconds`` and
        ``juno_store_ops_total`` by ``op`` (put, load, verify).
        """
        self.root = root
        self.registry = registry
        os.makedirs(root, exist_ok=True)

    def _observe(self, op: str, t0: float) -> None:
        """Record one store operation begun at ``t0`` when a registry is
        bound."""
        if self.registry is not None:
            self.registry.histogram("juno_store_op_seconds", op=op).add(
                time.perf_counter() - t0)
            self.registry.counter("juno_store_ops_total", op=op).inc()

    def path(self, name: str, version: int) -> str:
        """Directory of generation ``version`` (1-based) of ``name``."""
        return os.path.join(self.root, name, f"v{version:04d}")

    def versions(self, name: str) -> list[int]:
        """Committed generations of ``name``, ascending (empty if none)."""
        d = os.path.join(self.root, name)
        if not os.path.isdir(d):
            return []
        return sorted(int(e[1:]) for e in os.listdir(d)
                      if e.startswith("v") and e[1:].isdigit()
                      and os.path.exists(os.path.join(d, e, _MANIFEST)))

    def latest(self, name: str) -> int | None:
        """Newest committed generation of ``name`` (``None`` when absent)."""
        vs = self.versions(name)
        return vs[-1] if vs else None

    def put(self, name: str, data: JunoIndexData, config: JunoConfig, *,
            rt_grid: CentroidGrid | None = None, extra: dict | None = None,
            max_attempts: int = 32) -> int:
        """Commit a new generation of ``name`` atomically and durably.

        :func:`save_index` writes a unique temp directory, whose files and
        entry are fsynced; it is then renamed onto the next free
        generation. A rename onto a generation another writer committed
        fails, and the put retries with the next number, so two racing
        writers commit two generations. The parent is fsynced after the
        rename.

        Returns
        -------
        int
            The committed generation.

        Raises
        ------
        ArtifactError
            When ``max_attempts`` generations were contended.
        """
        t0 = time.perf_counter()
        final = _commit(self.root, name,
                        lambda tmp: save_index(tmp, data, config,
                                               rt_grid=rt_grid, extra=extra),
                        lambda: self.latest(name),
                        lambda v: self.path(name, v), max_attempts)
        self._observe("put", t0)
        return int(os.path.basename(final)[1:])

    def _version(self, name: str, version: int | None) -> int:
        if version is None:
            version = self.latest(name)
            if version is None:
                raise ArtifactError(f"no artifact named {name!r} in "
                                    f"{self.root}")
        return version

    def get(self, name: str, version: int | None = None, **kw
            ) -> LoadedIndex:
        """Load one generation of ``name`` (default: the latest); ``kw``
        goes to :func:`load_index`."""
        path = self.path(name, self._version(name, version))
        t0 = time.perf_counter()
        loaded = load_index(path, **kw)
        self._observe("load", t0)
        return loaded

    def verify(self, name: str, version: int | None = None) -> dict:
        """:func:`verify_artifact` of one generation (default: the
        latest); returns its manifest, raises ``ArtifactError``. The time
        is recorded whether it passes or fails."""
        path = self.path(name, self._version(name, version))
        t0 = time.perf_counter()
        try:
            return verify_artifact(path)
        finally:
            self._observe("verify", t0)
