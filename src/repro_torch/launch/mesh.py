"""Production mesh construction and pspec normalisation.

Port of ``repro/launch/mesh.py``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims, built by a
FUNCTION from the process group that exists (never at import). A pspec
is a tuple of per-dim entries (``None``, an axis name, or a tuple of
axis names, major first), the reference's ``PartitionSpec`` as a plain
tuple; :func:`named_sharding` turns one into DTensor placements.
"""
from __future__ import annotations

from typing import NamedTuple


class Sharding(NamedTuple):
    """A leaf's layout on a mesh: the reference's ``NamedSharding``."""

    mesh: object                 # DeviceMesh
    placements: tuple            # one Placement a mesh dim


def init_fake_world(n: int) -> None:
    """Start a fake process group of ``n`` ranks in this one process (as
    rank 0): collectives are issued and recorded but move nothing,
    so a mesh of 256 or 512 GPUs is built with no GPU (the dry run,
    ``launch/dryrun.py``). A function, never run at import; a no-op when
    a fake group of that size exists already."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        raise RuntimeError(f"a {dist.get_backend()} process group of "
                           f"{dist.get_world_size()} ranks exists already")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``, over the initialised default process
    group, which must hold exactly that many ranks (a real one, or the
    fake world of :func:`init_fake_world`, on which ``"cuda"`` meshes
    need no card)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        raise ValueError(f"the production mesh {shape} needs a process "
                         f"group of {n} ranks; this one has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, or of any object with the
    reference mesh's ``axis_names`` and ``devices.shape``."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def batch_axes(mesh) -> tuple:
    """The data-parallel axes of this mesh ("pod" composes with "data")."""
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


def normalize_pspec(spec, mesh, shape: tuple | None = None) -> tuple:
    """Adapt a canonical pspec to a concrete mesh, by the reference's rules:

    * drop axis names the mesh doesn't have (e.g. "pod" on the single-pod
      mesh);
    * with ``shape``, drop trailing axes of an entry until their product
      divides the dim (e.g. a batch=1 cell can't shard its batch dim).
    """
    sizes = axis_sizes(mesh)
    out = []
    for i, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (
            () if entry is None else (entry,))
        names = tuple(n for n in names if n in sizes)
        if shape is not None and names:
            while names:
                total = 1
                for n in names:
                    total *= sizes[n]
                if shape[i] % total == 0:
                    break
                names = names[:-1]
        out.append(names if len(names) != 1 else names[0])
        if out[-1] == ():
            out[-1] = None
    return tuple(out)


def placements(mesh, spec) -> tuple:
    """DTensor placements of a normalised pspec on ``mesh``: ``Shard(d)``
    on each mesh dim that tensor dim ``d`` names, ``Replicate()`` on the
    others. A dim sharded over several axes must name them in the mesh's
    order (DTensor splits over the mesh dims major first)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (
            () if entry is None else (entry,))
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"pspec {spec}: dim {d} names {axes} out of "
                             f"the mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"pspec {spec}: mesh axis {names[i]!r} "
                                 f"shards two dims")
            out[i] = Shard(d)
    return tuple(out)


def named_sharding(mesh, spec, shape: tuple | None = None) -> Sharding:
    """The layout of a ``shape`` leaf under ``spec`` on ``mesh``."""
    return Sharding(mesh, placements(mesh, normalize_pspec(spec, mesh,
                                                             shape)))
