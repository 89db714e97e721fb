"""Collective accounting and roofline terms of a fake pass.

Counterpart of ``repro/launch/hlo_analysis.py``. The reference parses the
collectives out of the optimized HLO and scales each by the trip count of
the while loops around it. The port has no HLO: :class:`CollectiveRecorder`
records each collective as it is issued, in an eager pass that runs every
layer, so no trip multiplier is needed and ``parse_collectives`` and
``loop_correction_factor`` have no counterpart (the dry run records the
counted FLOPs over the analytic ones in their place).

Copied from the reference: :class:`CollectiveOp` with its ring arithmetic,
:func:`collective_summary` and :func:`roofline_terms` (which takes the
hardware's rates, ``hw``).

The default rates are an NVIDIA H100 SXM's data-sheet figures, at its
700 W limit ("NVIDIA H100 80GB HBM3, 700.00 W" by ``nvidia-smi``): 989e12
FLOP/s bf16 dense, 3.35e12 B/s HBM, NVLink 450e9 B/s each way. A group
whose ranks span more than one 8-GPU node (rank // 8, the mesh's
row-major order) moves its bytes at ``internode_bw``. That rate is an
ASSUMPTION: one 400 Gb/s NIC a GPU (50e9 B/s), as on an HGX H100 node.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

GPUS_PER_NODE = 8

# NVIDIA H100 80GB HBM3 (SXM) at its 700.00 W limit: data-sheet rates
H100_SXM = {
    "peak_flops_bf16": 989e12,     # FLOP/s a GPU, bf16 dense
    "hbm_bw": 3.35e12,             # B/s a GPU
    "link_bw": 450e9,              # B/s a GPU each way, NVLink (in a node)
    "internode_bw": 50e9,          # ASSUMED: one 400 Gb/s NIC a GPU
}


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    group_size: int
    multiplier: float = 1.0       # loop trip-count product (1: eager)
    crosses_nodes: bool = False   # the group spans more than one node

    @property
    def per_chip_link_bytes(self) -> float:
        """Ring-algorithm bytes each participating chip moves over links."""
        n, b = self.group_size, self.result_bytes * self.multiplier
        if n <= 1:
            return 0.0
        if self.kind == "all-gather":          # result = full gathered tensor
            return b * (n - 1) / n
        if self.kind == "reduce-scatter":      # result = 1/n of the input
            return b * (n - 1)
        if self.kind == "all-reduce":          # RS + AG
            return 2.0 * b * (n - 1) / n
        if self.kind == "all-to-all":
            return b * (n - 1) / n
        return float(b)                         # collective-permute


def collective_summary(ops: Iterable[CollectiveOp]) -> dict:
    out: dict = {}
    total = 0.0
    for op in ops:
        d = out.setdefault(op.kind, {"count": 0, "result_bytes": 0,
                                     "link_bytes_per_chip": 0.0})
        d["count"] += 1
        d["result_bytes"] += int(op.result_bytes * op.multiplier)
        d["link_bytes_per_chip"] += op.per_chip_link_bytes
        total += op.per_chip_link_bytes
    out["total_link_bytes_per_chip"] = total
    return out


def internode_link_bytes(ops: Iterable[CollectiveOp]) -> float:
    """The link bytes a chip moves in groups that cross nodes."""
    return sum(op.per_chip_link_bytes for op in ops if op.crosses_nodes)


def roofline_terms(flops_per_chip: float, hbm_bytes_per_chip: float,
                   coll_link_bytes_per_chip: float, n_chips: int,
                   hw: dict = H100_SXM,
                   internode_link_bytes_per_chip: float = 0.0) -> dict:
    """The three terms in seconds (whole step, per-chip quantities over
    per-chip rates). Of the link bytes, ``internode_link_bytes_per_chip``
    move at ``hw["internode_bw"]``, the rest at ``hw["link_bw"]``."""
    compute = flops_per_chip / hw["peak_flops_bf16"]
    memory = hbm_bytes_per_chip / hw["hbm_bw"]
    collective = (coll_link_bytes_per_chip
                  - internode_link_bytes_per_chip) / hw["link_bw"]
    if internode_link_bytes_per_chip:
        collective += internode_link_bytes_per_chip / hw["internode_bw"]
    dominant = max(("compute", compute), ("memory", memory),
                   ("collective", collective), key=lambda t: t[1])[0]
    bound = max(compute, memory, collective)
    return {"compute_s": compute, "memory_s": memory,
            "collective_s": collective, "dominant": dominant,
            "bound_s": bound,
            "roofline_fraction": compute / bound if bound else 0.0}


# --------------------------------------------------------------------------
# the recorder
# --------------------------------------------------------------------------

_KINDS = {"all_gather_into_tensor": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "all_reduce": "all-reduce",
          "all_to_all_single": "all-to-all",
          "permute": "collective-permute"}


def _collective_ops() -> dict:
    """{op overload: kind} of the functional collectives this torch has."""
    ns = torch.ops._c10d_functional
    out = {}
    for name, kind in _KINDS.items():
        try:
            out[getattr(ns, name).default] = kind
        except (AttributeError, RuntimeError):
            continue
    return out


def _group_of(name: str):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name)


def crosses_nodes(group) -> bool:
    """Whether a process group's ranks lie in more than one 8-GPU node."""
    import torch.distributed as dist
    ranks = dist.get_process_group_ranks(group)
    return len({r // GPUS_PER_NODE for r in ranks}) > 1


class CollectiveRecorder(TorchDispatchMode):
    """Records each functional collective issued while it is active (a
    DTensor's redistribute issues them on the local shards): its kind, the
    bytes of its result and the size of its group, and whether the group
    crosses nodes. ``ops``: the :class:`CollectiveOp` list, in order."""

    def __init__(self):
        super().__init__()
        self.ops: list[CollectiveOp] = []
        self._kinds = _collective_ops()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_dtensor_call(types):
            return NotImplemented      # DTensor runs it on local shards
        out = func(*args, **kwargs)
        kind = self._kinds.get(func)
        if kind is not None:
            group = _group_of(args[-1] if isinstance(args[-1], str)
                              else kwargs["group_name"])
            self.ops.append(CollectiveOp(
                kind, out.numel() * out.element_size(), group.size(),
                crosses_nodes=crosses_nodes(group)))
        return out

    def summary(self) -> dict:
        """:func:`collective_summary`, plus the part of the link bytes
        moved across nodes (``internode_link_bytes_per_chip``)."""
        out = collective_summary(self.ops)
        out["internode_link_bytes_per_chip"] = internode_link_bytes(self.ops)
        return out


def _is_dtensor_call(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


@contextlib.contextmanager
def hidden_propagation():
    """While active, DTensor's sharding propagation derives output shapes
    with every dispatch mode set aside: its fake run of each op at the
    GLOBAL shape then reaches no counter, recorder or memory tracker, which
    see the local computation only."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes
    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name)

    def quiet(self, op_schema):
        with _disable_current_modes():
            return orig(self, op_schema)
    setattr(ShardingPropagator, name, quiet)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)
