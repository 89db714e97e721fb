"""Step-numbered tree checkpoints with atomic commit.

Port of ``repro/dist/checkpoint.py``, with its on-disk layout, so that
either package reads the other's checkpoints: ``<dir>/step_00000123/``
holds one raw-bytes blob per leaf (``leaf_00000.bin``, ...) and a
``manifest.json`` with each leaf's numpy dtype name (``"bfloat16"``
included) and shape. A checkpoint is written under a temporary name and
``os.replace``d into place, so a reader never sees a partial checkpoint
and a crash mid-save leaves the previous one intact.

Leaves are taken in the reference's ``jax.tree.leaves`` order: a dict's
values by sorted key, a tuple's (a ``NamedTuple``'s: ``TrainState``,
``OptState``) in field order, ``None`` holding no leaf. A leaf is a
tensor, a DTensor, a numpy array or a Python scalar.

Under a mesh the layout on disk is the same: :func:`save` of a tree of
DTensors gathers each leaf whole (every rank calls it, in the same
order), rank 0 writes, and the others wait for the commit on a barrier.
:func:`restore` rebuilds the tree against a reference tree ``like`` and
places the leaves on ``device``, or with ``shardings`` onto a mesh's
placements, whatever mesh wrote them (the elastic reshard): each rank
reads the whole leaf and keeps its own slice.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from ..device import resolve_device

_PREFIX = "step_"
_MANIFEST = "manifest.json"
# numpy dtype names of the manifest <-> torch dtypes
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
           "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"{_PREFIX}{step:08d}")


def _list_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith(_PREFIX) and os.path.isfile(
                os.path.join(directory, name, _MANIFEST)):
            try:
                steps.append(int(name[len(_PREFIX):]))
            except ValueError:
                continue
    return sorted(steps)


def latest_step(directory: str) -> int | None:
    """Highest committed step in ``directory``, or None."""
    steps = _list_steps(directory)
    return steps[-1] if steps else None


def tree_flatten(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_flatten(t)]
    return [tree]


def tree_unflatten(like, leaves):
    """``like``'s structure with ``leaves`` (an iterator) in its leaves'
    places."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: tree_unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(tree_unflatten(t, leaves) for t in like))
    if isinstance(like, (tuple, list)):
        return type(like)(tree_unflatten(t, leaves) for t in like)
    return next(leaves)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _bytes(leaf) -> tuple[bytes, str, list]:
    """A leaf's raw bytes (C order), numpy dtype name and shape."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise TypeError(f"checkpoint: no manifest name for {t.dtype}")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        return raw, _NAMES[t.dtype], list(t.shape)
    arr = np.asarray(leaf)
    return arr.tobytes(), str(arr.dtype), list(arr.shape)


def save(directory: str, step: int, tree, *, keep: int | None = None) -> str:
    """Write ``tree`` as checkpoint ``step``; returns the committed path.

    ``keep=N`` prunes to the N newest checkpoints after the commit. A
    tree with DTensor leaves is saved by every rank of their process
    group together: each leaf gathered whole, rank 0 writing.
    """
    leaves = tree_flatten(tree)
    if any(_is_dtensor(x) for x in leaves):
        import torch.distributed as dist
        full = [x.full_tensor() if _is_dtensor(x) else x for x in leaves]
        path = _step_dir(directory, step)
        if dist.get_rank() == 0:
            path = _write(directory, step, full, keep)
        dist.barrier()
        return path
    return _write(directory, step, leaves, keep)


def _write(directory: str, step: int, leaves: list, keep) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory,
                       f".tmp_{_PREFIX}{step:08d}.{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for i, leaf in enumerate(leaves):
        raw, dtype, shape = _bytes(leaf)
        fname = f"leaf_{i:05d}.bin"
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(raw)
        manifest["leaves"].append({"file": fname, "dtype": dtype,
                                   "shape": shape})
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    final = _step_dir(directory, step)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)

    if keep is not None:
        for old in _list_steps(directory)[:-keep]:
            shutil.rmtree(_step_dir(directory, old), ignore_errors=True)
    return final


def restore(directory: str, like, *, step: int | None = None, device=None,
            shardings=None):
    """Load checkpoint ``step`` (default: latest) shaped like ``like``.

    Returns ``(tree, step)``: ``like``'s structure with tensors on
    ``device`` (``None`` = ``cuda``) for its leaves, in the manifest's
    dtypes and shapes. ``shardings``: optional tree matching ``like``
    whose leaves are :class:`repro_torch.launch.mesh.Sharding` (e.g.
    ``models.params.shardings(schema, mesh)``) or ``None``; a leaf with a
    sharding becomes a DTensor with its placements on its mesh (on the
    mesh's device type), on whichever mesh saved it.
    """
    dev = resolve_device(device) if shardings is None or device is not None \
        else None
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory!r}")
    path = _step_dir(directory, step)
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)

    n_like = len(tree_flatten(like))
    entries = manifest["leaves"]
    if len(entries) != n_like:
        raise ValueError(
            f"checkpoint has {len(entries)} leaves, reference tree has "
            f"{n_like}")
    leaves = []
    for entry in entries:
        with open(os.path.join(path, entry["file"]), "rb") as f:
            raw = bytearray(f.read())
        dt = _DTYPES[entry["dtype"]]
        t = (torch.frombuffer(raw, dtype=dt) if raw
             else torch.empty(0, dtype=dt))
        leaves.append(t.reshape(entry["shape"]))
    lays = ([None] * len(leaves) if shardings is None
            else _layouts(shardings, like))
    out = [_place(t, sh, dev) for t, sh in zip(leaves, lays)]
    return tree_unflatten(like, iter(out)), manifest["step"]


def _layouts(shardings, like) -> list:
    """``shardings``' leaves in ``like``'s leaf order (a Sharding, a
    NamedTuple itself, counts as a leaf; so does None where ``like`` holds
    a leaf)."""
    from ..launch.mesh import Sharding
    out = []

    def walk(sh, lk):
        if lk is None:
            return
        if isinstance(lk, dict):
            for k in sorted(lk):
                walk(None if sh is None else sh[k], lk[k])
        elif isinstance(lk, (tuple, list)) and not isinstance(sh, Sharding):
            for i, t in enumerate(lk):
                walk(None if sh is None else sh[i], t)
        else:
            out.append(sh)
    walk(shardings, like)
    return out


def _place(t: torch.Tensor, sh, dev):
    if sh is None:
        return t.to(dev if dev is not None else resolve_device(None))
    from torch.distributed.tensor import DTensor
    from ..models.params import local_shard
    t = t.to(sh.mesh.device_type)
    return DTensor.from_local(local_shard(t, sh.mesh, sh.placements),
                              sh.mesh, sh.placements, run_check=False,
                              shape=t.shape, stride=t.stride())
