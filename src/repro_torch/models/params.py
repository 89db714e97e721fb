"""Declarative parameter schemas.

Port of ``repro/models/params.py``. A schema is a tree of dicts whose
leaves are ``Spec(shape, init, dtype, pspec)``. The same schema serves
three consumers:

* :func:`init_params` makes real tensors from it;
* :func:`pspecs` / :func:`shardings` give each leaf's layout on a mesh
  (``pspec``: the reference's ``PartitionSpec`` as a tuple of per-dim
  entries, :func:`P`), and :func:`distribute` places a parameter tree
  onto a ``DeviceMesh`` as DTensors by it;
* ``n_params`` counts it.

Stacked layers: :func:`stack` prepends a layer axis (never sharded) to
every leaf, the layout the reference's ``lax.scan`` consumes; the port's
layer loop slices it.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from ..device import resolve_device


def P(*entries) -> tuple:
    """A pspec: one entry a dim, ``None`` (replicated), a mesh axis name
    or a tuple of names (the reference's ``PartitionSpec(*entries)``)."""
    return tuple(entries)


class Spec(NamedTuple):
    """One parameter (or cache) leaf, fields in this order: its shape, its
    init, its dtype (a ``torch.dtype`` or a dtype name such as
    ``"bfloat16"``) and its pspec (:func:`P`; replicated by default). The
    pspec comes last so that ``Spec(shape, init, dtype)`` stays valid."""

    shape: tuple
    init: str = "normal"     # "normal" | "zeros" | "ones" | "neg" | "embed"
    dtype: Any = torch.float32
    pspec: tuple = ()


def as_dtype(dtype) -> torch.dtype:
    """``"bfloat16"`` / ``torch.bfloat16`` -> ``torch.bfloat16``."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def tree_map(fn: Callable, tree, is_leaf: Optional[Callable] = None):
    """Apply ``fn`` to every leaf of a tree of dicts, keeping its shape."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts in sorted-key order (``jax.tree``'s)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like: dict, leaves) -> dict:
    """``like``'s tree of dicts with ``leaves`` (an iterable in
    :func:`tree_leaves` order) in its leaves' places."""
    return _fill(like, iter(leaves))


def _fill(tree: dict, it) -> dict:
    # a module-level function, not a closure over the iterator: a
    # recursive closure is a reference cycle, which would keep the leaves
    # (a step's gradients) alive until the garbage collector runs
    return {k: _fill(tree[k], it) if isinstance(tree[k], dict) else next(it)
            for k in sorted(tree)}


def stack(schema, n: int):
    """Prepend a stacked-layer axis of size n (never sharded) to every
    leaf."""
    return tree_map(lambda s: Spec((n,) + s.shape, s.init, s.dtype,
                                   (None,) + tuple(s.pspec)), schema)


def pspecs(schema):
    """The schema's tree of pspecs."""
    return tree_map(lambda s: s.pspec, schema, is_spec)


def shardings(schema, mesh):
    """The schema's tree of :class:`repro_torch.launch.mesh.Sharding` on
    ``mesh`` (a ``DeviceMesh``): each leaf's pspec normalised to the mesh
    and its shape (``launch.mesh.normalize_pspec``), as placements."""
    from ..launch.mesh import named_sharding
    return tree_map(lambda s: named_sharding(mesh, s.pspec, s.shape),
                    schema, is_spec)


def local_shard(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's part of a full tensor ``t`` laid out by ``placements``
    on ``mesh`` (sizes even, as normalised pspecs make them): a view of
    ``t``, made contiguous only where the mesh splits it."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    part = t
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard) and mesh.size(i) > 1:
            size = part.shape[pl.dim] // mesh.size(i)
            part = part.narrow(pl.dim, coord[i] * size, size)
    return part if part.is_contiguous() else part.contiguous()


def distribute(params, schema, mesh):
    """Place a tree of tensors onto ``mesh`` by ``schema``'s layouts.

    Every rank holds the same full tree (the same seed, or a checkpoint);
    each keeps its own slice of each leaf (no collective). Returns the
    tree of DTensors, each a leaf of its own (``requires_grad`` off). A
    leaf the mesh does not split (all of them on a one-rank mesh) keeps
    the input's storage, so that a state which fills the card is not
    copied: the train step's in-place update then writes ``params`` too
    (pass a copy to keep them)."""
    from torch.distributed.tensor import DTensor
    lay = shardings(schema, mesh)

    def fill(p, sh):
        if isinstance(p, dict):
            return {k: fill(p[k], sh[k]) for k in p}
        p = p.detach()
        return DTensor.from_local(local_shard(p, mesh, sh.placements), mesh,
                                  sh.placements, run_check=False,
                                  shape=p.shape, stride=p.stride())
    return fill(params, lay)


def _one(s: Spec, gen: Optional[torch.Generator], dev: torch.device,
         dtype: Optional[torch.dtype]) -> torch.Tensor:
    dt = as_dtype(s.dtype)
    if dtype is not None and dt.is_floating_point:
        dt = dtype
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dt, device=dev)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dt, device=dev)
    if s.init == "neg":
        return torch.full(s.shape, -1, dtype=dt, device=dev)
    if gen is None:
        raise ValueError(f"a {s.init!r} leaf of shape {s.shape} needs a "
                         f"generator")
    fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
    scale = 0.02 if s.init == "embed" else fan_in ** -0.5
    out = torch.empty(s.shape, dtype=dt, device=dev)
    # a stacked leaf is drawn one slab of its leading (layer) axis at a
    # time, so that its f32 draw is never whole on the device
    for slab in (out if len(s.shape) >= 3 else (out,)):
        slab.copy_(torch.randn(slab.shape, generator=gen, device=dev,
                               dtype=torch.float32).mul_(scale))
    return out


def init_params(schema, generator: Optional[torch.Generator] = None, *,
                device=None, dtype=None):
    """Materialise a schema as tensors on ``device``.

    Parameters
    ----------
    schema : tree of dicts of :class:`Spec`
    generator : torch.Generator, optional
        Draws the ``normal`` and ``embed`` leaves, one after another in
        sorted-key order; it must live on ``device``. Only a schema with
        none of them (a decode cache) may go without one.
    device : str or torch.device, optional
        ``None`` = ``cuda``; ``"cpu"`` for the CPU.
    dtype : torch.dtype or str, optional
        Store every float leaf in this dtype instead of its Spec's (the
        compute dtype, so that a model's weights are held once, as
        :func:`cast_floats` would make them at each use).

    Returns
    -------
    The same tree with tensors for leaves. Inits are the reference's: a
    standard normal drawn in f32 times ``fan_in ** -0.5`` (``fan_in`` the
    second-to-last dim), ``embed`` 0.02, ``zeros``, ``ones`` and ``neg``
    (-1), then cast to the leaf's dtype; a leaf of three or more dims is
    drawn slab by slab along its first. The reference draws from
    ``jax.random``, so the values differ; carry its parameters across
    with :func:`repro_torch.models.api.params_from_reference`.
    """
    dev = resolve_device(device)
    dt = None if dtype is None else as_dtype(dtype)
    out: dict = {}

    def fill(sch, dst):
        for k in sorted(sch):
            if is_spec(sch[k]):
                dst[k] = _one(sch[k], generator, dev, dt)
            else:
                dst[k] = {}
                fill(sch[k], dst[k])
    if is_spec(schema):
        return _one(schema, generator, dev, dt)
    fill(schema, out)
    return out


def cast_floats(tree, dtype):
    """Cast float leaves to the compute dtype (the reference applies it per
    block, at each use). A leaf already in ``dtype`` is returned as is."""
    dt = as_dtype(dtype)

    def one(x):
        if isinstance(x, torch.Tensor) and x.dtype.is_floating_point:
            return x.to(dt)
        return x
    return tree_map(one, tree)


def n_params(schema) -> int:
    """The number of elements the schema's leaves hold."""
    total = 0
    for s in tree_leaves(schema):
        n = 1
        for d in s.shape:
            n *= d
        total += n
    return total
