"""Multi-pod dry run of the port.

Counterpart of ``repro/launch/dryrun.py``. For every (architecture ×
input shape × mesh) cell, one FAKE pass of the step on the production
mesh, (16, 16) single-pod or (2, 16, 16) multi-pod, in a fake process
group of 256 or 512 ranks in this one process (``launch.mesh.
init_fake_world``), where the reference lowers and compiles. The state,
batch and cache are DTensors of fake local shards (``FakeTensorMode``):
no array is allocated and no GPU is needed; ``--device cuda`` (the
default) lays them on the card's device type, which fake tensors model
without a card. The step runs once, as this process's rank would run it,
under three recorders:

* :class:`LocalFlopCounter`: the FLOPs the rank runs (``FlopCounterMode``'s
  formulas, a DTensor op counted on its local shards);
* ``comm_analysis.CollectiveRecorder``: every collective issued, with its
  bytes and group;
* ``torch.distributed._tools.mem_tracker.MemTracker``: the peak of the
  rank's device memory.

Each cell records the reference's analytic fields (``launch/analytic.py``,
and :func:`total_bytes`, :func:`analytic_bytes_per_chip` and
:func:`_model_flops` as the reference computes them), the counted FLOPs
and their ratio to the analytic ones (``counted_over_analytic``, in place
of the reference's HLO loop correction), the collectives, the roofline on
an H100 (``comm_analysis.H100_SXM``) and the memory. A failing cell is
recorded loudly (``status: error``).

Usage:
  python -m repro_torch.launch.dryrun --arch phi4_mini_3_8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--outdir experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time
import traceback
import warnings

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCH_IDS, get_config
from ..dist import sharding as act_sharding
from ..models import get_model
from ..models.params import P, Spec, as_dtype, is_spec
from ..train import TrainConfig, TrainState, make_train_step
from ..train.optimizer import opt_state_schema
from . import analytic, comm_analysis
from .mesh import (axis_sizes, batch_axes, init_fake_world,
                   make_production_mesh, named_sharding, normalize_pspec)
from .shapes import SHAPES, ShapeSpec, applicable

# ---------------------------------------------------------------------------
# Spec trees (dicts and NamedTuples of Spec leaves)
# ---------------------------------------------------------------------------


def _spec_items(tree, path=()):
    """(path of keys, Spec) of every leaf, dict keys in sorted order."""
    if is_spec(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_items(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _spec_items(v, path + (i,))


def _map_specs(fn, tree):
    if is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_specs(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    return tree


def _tensor_leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensor_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _tensor_leaves(v)]
    return []


def _bytes_of(shape, dtype) -> int:
    n = 1
    for d in shape:
        n *= d
    return n * as_dtype(dtype).itemsize


def total_bytes(schema) -> int:
    return sum(_bytes_of(s.shape, s.dtype) for _, s in _spec_items(schema))


def analytic_bytes_per_chip(schema, mesh) -> int:
    """Exact per-chip residency of a Spec tree under its shardings."""
    total = 0
    sizes = axis_sizes(mesh)
    for _, s in _spec_items(schema):
        spec = normalize_pspec(s.pspec, mesh, s.shape)
        shards = 1
        for entry in spec:
            names = entry if isinstance(entry, tuple) else (
                () if entry is None else (entry,))
            for n in names:
                shards *= sizes[n]
        total += _bytes_of(s.shape, s.dtype) // shards
    return total


def _model_flops(cfg, schema, shape) -> float:
    """6·N·D (train) / 2·N·D (inference) with MoE active-expert scaling."""
    total, active = 0, 0
    for path, s in _spec_items(schema):
        n = 1
        for d in s.shape:
            n *= d
        total += n
        if cfg.moe and any(k in ("w_gate", "w_in", "w_out") for k in path) \
                and len(s.shape) >= 3 and s.shape[-3] == cfg.moe.n_experts:
            active += n * cfg.moe.top_k / cfg.moe.n_experts
        else:
            active += n
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        return 2.0 * active * shape.global_batch * shape.seq_len
    return 2.0 * active * shape.global_batch          # decode: 1 token


def _serving_schema(model, max_tp_resident_gb: float = 6.0):
    """Serving layout: params are bf16 (inference checkpoints); if the
    pure-TP residency (params/16) fits comfortably, the "data" axis is
    dropped from the weight shardings, so decode gathers no weights each
    step (they stay resident). Large models (mistral-123b, vision-90b)
    keep the 2D layout."""
    tp_resident = total_bytes(model.schema) / 4 * 2 / 16   # bf16 over TP=16
    drop_data = tp_resident <= max_tp_resident_gb * 1e9

    def one(s):
        dtype = (torch.bfloat16 if as_dtype(s.dtype) == torch.float32
                 else s.dtype)
        spec = s.pspec
        if drop_data:
            entries = []
            for e in spec:
                if e == "data":
                    entries.append(None)
                elif isinstance(e, tuple):
                    kept = tuple(a for a in e if a != "data")
                    entries.append(kept if kept else None)
                else:
                    entries.append(e)
            spec = P(*entries)
        return Spec(s.shape, s.init, dtype, spec)

    return _map_specs(one, model.schema)


# ---------------------------------------------------------------------------
# abstract inputs and the fake pass
# ---------------------------------------------------------------------------


def _abstract(schema, mesh, device):
    """A Spec tree as tensors of fake storage (inside a FakeTensorMode):
    DTensors of their local shards on ``mesh`` (each leaf laid out by its
    normalised pspec), or plain tensors of the global shape without one."""
    from torch.distributed.tensor import DTensor, Shard

    def one(s):
        dt = as_dtype(s.dtype)
        if mesh is None:
            return torch.empty(s.shape, dtype=dt, device=device)
        pl = named_sharding(mesh, s.pspec, s.shape).placements
        local = list(s.shape)
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                local[p.dim] //= mesh.size(i)
        t = torch.empty(local, dtype=dt, device=device)
        return DTensor.from_local(t, mesh, pl, run_check=False,
                                  shape=torch.Size(s.shape),
                                  stride=torch.empty(s.shape,
                                                     device="meta").stride())
    return _map_specs(one, schema)


class LocalFlopCounter(TorchDispatchMode):
    """The FLOPs one rank runs, by ``FlopCounterMode``'s formulas.

    ``FlopCounterMode`` counts an op on DTensors at its GLOBAL shape, and an
    op that ``sharding.local`` runs at its local one. This mode lets a
    DTensor op through to DTensor (which runs it on the local shards,
    where this mode counts it) and counts plain ops as ``FlopCounterMode``
    does (an op without a formula decomposed first): every op at the
    shape the rank runs it. ``total``: the count so far."""

    _SKIP = None

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self.registry = FlopCounterMode(display=False).flop_registry
        self.total = 0
        if LocalFlopCounter._SKIP is None:
            a = torch.ops.aten
            LocalFlopCounter._SKIP = {
                a.sym_is_contiguous.default, a.is_contiguous.default,
                a.is_contiguous.memory_format,
                a.is_strides_like_format.default,
                a.is_non_overlapping_and_dense.default, a.size.default,
                a.sym_size.default, a.stride.default, a.sym_stride.default,
                a.storage_offset.default, a.sym_storage_offset.default,
                a.numel.default, a.sym_numel.default, a.dim.default,
                torch.ops.prim.layout.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if comm_analysis._is_dtensor_call(types):
            return NotImplemented
        if func in self._SKIP:
            return NotImplemented
        packet = func._overloadpacket
        if packet not in self.registry and \
                func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        if packet in self.registry:
            self.total += int(self.registry[packet](*args, **kwargs,
                                                    out_val=out))
        return out


def fake_pass(build, device: str = "cuda") -> dict:
    """Run ``build()`` -> ``(fn, inputs, residency)`` inside a fresh
    FakeTensorMode (``inputs``: the tree of abstract tensors ``fn`` reads),
    then ``fn()`` once under the FLOP counter, the collective recorder
    and the memory tracker. Returns the counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, inputs, residency = build()
        leaves = _tensor_leaves(inputs)
        arg_bytes = sum(_local_bytes(t) for t in leaves)
        rec = comm_analysis.CollectiveRecorder()
        cnt = LocalFlopCounter()
        mt = MemTracker()
        mt.track_external(*leaves)
        t0 = time.time()
        with comm_analysis.hidden_propagation(), mt, rec, cnt:
            out = fn()
        elapsed = time.time() - t0
        peak = mt.get_tracker_snapshot("peak")
    dev = torch.device(device if ":" in device or device == "cpu"
                       else f"{device}:0")
    peak_total = max((v.get("Total", 0) for k, v in peak.items()
                      if torch.device(k) == dev), default=0)
    return {"counted_flops": cnt.total, "collectives": rec.ops,
            "summary": rec.summary(), "residency": residency,
            "argument_local_bytes": arg_bytes,
            "memtracker_peak_bytes": int(peak_total), "pass_s": elapsed,
            "out": out}


def _local_bytes(t) -> int:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t._local_tensor
    return t.numel() * t.element_size()


def _rows_spec(shape, dtype):
    return Spec(shape, "zeros", dtype, P(("pod", "data"), *(
        [None] * (len(shape) - 1))))


def _lower_train(model, shape, mesh, device):
    state_schema = TrainState(params=model.schema,
                              opt=opt_state_schema(model.schema))
    batch_schema = model.batch_schema(shape.global_batch, shape.seq_len)
    grad_pspecs = None
    if mesh is not None:
        grad_pspecs = _map_specs(
            lambda s: normalize_pspec(s.pspec, mesh, s.shape), model.schema)
    tstep = make_train_step(model, TrainConfig(), grad_pspecs=grad_pspecs)
    state = _abstract(state_schema, mesh, device)
    batch = _abstract(batch_schema, mesh, device)
    residency = (analytic_bytes_per_chip(state_schema, mesh) if mesh
                 is not None else total_bytes(state_schema))
    return lambda: tstep(state, batch), (state, batch), residency


def _prefill_schemas(model, shape):
    cfg = model.cfg
    batch_schema = model.batch_schema(shape.global_batch, shape.seq_len)
    cache_schema = model.cache_schema(shape.global_batch, shape.seq_len)
    if cfg.encoder_decoder:
        # prefill_32k stresses the ENCODER: frames length = shape.seq_len
        batch_schema = dict(batch_schema)
        batch_schema["frames"] = Spec(
            (shape.global_batch, shape.seq_len, cfg.d_model), "normal",
            cfg.dtype, P(("pod", "data"), None, None))
        batch_schema["tokens"] = _rows_spec((shape.global_batch, 64),
                                            torch.int32)
        del batch_schema["targets"]
        cache_schema = model.cache_schema(shape.global_batch, 4096)
    else:
        batch_schema = {k: v for k, v in batch_schema.items()
                        if k != "targets"}
    return batch_schema, cache_schema


def _residency(schemas, mesh) -> int:
    if mesh is None:
        return sum(total_bytes(s) for s in schemas)
    return sum(analytic_bytes_per_chip(s, mesh) for s in schemas)


def _lower_prefill(model, shape, mesh, device):
    batch_schema, cache_schema = _prefill_schemas(model, shape)
    run_cache = cache_schema
    if model.cfg.encoder_decoder:
        # the port writes each layer's cross K/V into the cache in place,
        # so the cache holds the encoder's whole output (the reference's
        # prefill returns a cache whose cross K/V grew to it); the
        # residency stays the reference's, of its input cache
        from ..models import whisper
        run_cache = whisper.init_cache_schema(
            model.cfg, shape.global_batch, 4096, shape.seq_len)
    params = _abstract(model.schema, mesh, device)
    batch = _abstract(batch_schema, mesh, device)
    cache = _abstract(run_cache, mesh, device)
    return (lambda: model.prefill(params, batch, cache),
            (params, batch, cache),
            _residency((model.schema, cache_schema), mesh))


def _lower_decode(model, shape, mesh, device):
    serving_schema = _serving_schema(model)
    cache_schema = model.cache_schema(shape.global_batch, shape.seq_len)
    params = _abstract(serving_schema, mesh, device)
    cache = _abstract(cache_schema, mesh, device)
    token = _abstract(_rows_spec((shape.global_batch, 1), torch.int32),
                      mesh, device)
    pos = _abstract(_rows_spec((shape.global_batch,), torch.int32), mesh,
                    device)
    return (lambda: model.decode(params, cache, token, pos),
            (params, cache, token, pos),
            _residency((serving_schema, cache_schema), mesh))


def input_specs(arch: str, shape_name: str = "train_4k") -> dict:
    """``meta`` tensors standing in for every model input of a cell (the
    reference's ``ShapeDtypeStruct`` stand-ins)."""
    model = get_model(get_config(arch))
    shape = SHAPES[shape_name]

    def meta(s):
        return torch.empty(s.shape, dtype=as_dtype(s.dtype), device="meta")
    if shape.kind == "train":
        return _map_specs(meta, model.batch_schema(shape.global_batch,
                                                   shape.seq_len))
    if shape.kind == "prefill":
        b = model.batch_schema(shape.global_batch, shape.seq_len)
        return _map_specs(meta, {k: v for k, v in b.items()
                                 if k != "targets"})
    return {"token": torch.empty((shape.global_batch, 1), dtype=torch.int32,
                                 device="meta"),
            "pos": torch.empty((), dtype=torch.int32, device="meta")}


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def default_device() -> str:
    """"cuda" where torch is built with CUDA (fake CUDA tensors need no
    card, but their backward needs the build's CUDA support), else
    "cpu"."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _world(n: int) -> None:
    """The fake process group of ``n`` ranks (another size torn down)."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() != n and \
            dist.get_backend() == "fake":
        dist.destroy_process_group()
    init_fake_world(n)


def run_cell(cfg, shape: ShapeSpec, mesh, *, sp: bool = False,
             device: str = "cuda") -> dict:
    """One cell's fake pass and record on ``mesh`` (a ``DeviceMesh`` with
    named dims over the existing process group, or ``None``: one
    unsharded rank)."""
    model = get_model(cfg)
    n_chips = mesh.size() if mesh is not None else 1
    sp = sp and cfg.cross_attn_period == 0
    lower = {"train": _lower_train, "prefill": _lower_prefill}.get(
        shape.kind, _lower_decode)
    result = {"n_chips": n_chips, "status": "ok", "sp": sp}
    if mesh is not None:
        act_sharding.enable(batch_axes(mesh), sp=sp, mesh=mesh)
    t0 = time.time()
    try:
        run = fake_pass(lambda: lower(model, shape, mesh, device), device)
        sizes = axis_sizes(mesh) if mesh is not None else {}
        tp = sizes.get("model", 1)
        sch_bytes = total_bytes(model.schema)
        cache_bytes = 0
        if shape.kind != "train":
            cache_bytes = total_bytes(model.cache_schema(
                shape.global_batch, shape.seq_len))
        flops = analytic.step_flops_per_chip(cfg, shape, n_chips)
        hbm = analytic.step_bytes_per_chip(cfg, shape, n_chips, sch_bytes,
                                           cache_bytes, tp=tp)
        summary = run["summary"]
        terms = comm_analysis.roofline_terms(
            flops, hbm, summary["total_link_bytes_per_chip"], n_chips,
            internode_link_bytes_per_chip=summary[
                "internode_link_bytes_per_chip"])
        model_fl = _model_flops(cfg, model.schema, shape)
        result.update({
            "pass_s": round(run["pass_s"], 1),
            "wall_s": round(time.time() - t0, 1),
            "analytic_flops_per_chip": flops,
            "analytic_hbm_bytes_per_chip": hbm,
            "counted_flops_per_chip": run["counted_flops"],
            "counted_over_analytic": (run["counted_flops"] / flops
                                      if flops else 0.0),
            "collectives": summary,
            "roofline": terms,
            "model_flops_total": model_fl,
            "model_flops_per_chip": model_fl / n_chips,
            "useful_flop_ratio": (model_fl / n_chips) / flops if flops
            else 0,
            "analytic_state_bytes_per_chip": run["residency"],
            "memory_analysis": {
                "argument_local_bytes": run["argument_local_bytes"],
                "memtracker_peak_bytes": run["memtracker_peak_bytes"]},
        })
    except Exception as e:  # a failing cell is a bug: record it loudly
        result.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]})
    finally:
        act_sharding.disable()
    return result


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               juno_attention: bool = False, sp: bool = False,
               device: str = "cuda") -> dict:
    """One cell of the matrix on the production mesh, in a fake world of
    256 or 512 ranks (started here)."""
    if arch == "juno_ann":
        return lower_juno_cell(multi_pod, device=device)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    head = {"arch": arch, "shape": shape_name,
            "mesh": "multi" if multi_pod else "single"}
    if not ok and not juno_attention:
        return dict(head, status="skip", reason=why)
    _world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
    return dict(head, **run_cell(cfg, shape, mesh, sp=sp, device=device))


# the JUNO cell: the paper's own system at pod scale (deep-like: D 96,
# C 65,536, E 256, S 48), 100M points, P cap 6,144 (4x the mean cluster),
# Q 128, k 100, mode H2, 2 local probes
JUNO_100M = {"n": 100_000_000, "d": 96, "c": 65_536, "e": 256, "s": 48,
             "g": 64, "p_cap": 6144, "nq": 128, "k": 100, "nprobe": 2}


def _juno_shard(sz: dict, c_loc: int, device):
    """One shard's abstract index (its ``c_loc`` clusters) and queries."""
    from ..core.density import DensityModel
    from ..core.ivf import IVFIndex
    from ..core.juno import JunoIndexData
    from ..core.pq import PQCodebook
    f32, i32, u8 = torch.float32, torch.int32, torch.uint8

    def e(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=device)
    n, d, s = sz["n"], sz["d"], sz["s"]
    part = JunoIndexData(
        ivf=IVFIndex(centroids=e(c_loc, d), centroid_sq=e(c_loc),
                     point_ids=e(c_loc, sz["p_cap"], dtype=i32),
                     valid=e(c_loc, sz["p_cap"], dtype=torch.bool),
                     labels=e(n, dtype=i32)),
        codebook=PQCodebook(entries=e(s, sz["e"], 2),
                            entry_sq=e(s, sz["e"])),
        codes=e(1, s, dtype=u8),                 # unused at serve time
        cluster_codes=e(c_loc, sz["p_cap"], s, dtype=u8),
        density=DensityModel(grid=e(s, sz["g"], sz["g"]), lo=e(s, 2),
                             hi=e(s, 2), coeffs=e(3), tau_min=e(),
                             tau_max=e()),
        points_sq=e(1))
    return part, e(sz["nq"], d)


def juno_analytic(sz: dict, n_chips: int) -> tuple[float, float]:
    """The reference's analytic per-chip (flops, HBM bytes) of the cell:
    the filtering GEMM, the selective LUT, the int8 hit scan (÷4 MXU
    density) and the f32 rerank over the local shard's sizes."""
    c_loc, probes = sz["c"] / n_chips, sz["nprobe"]
    s, e, nq, d = sz["s"], sz["e"], sz["nq"], sz["d"]
    lut_fl = probes * s * e * 8 * nq
    scan_i8 = probes * sz["p_cap"] * s * 2 * nq / 4
    rerank_fl = 400 * s * 2 * nq
    filt_fl = 2 * c_loc * d * nq
    flops = filt_fl + lut_fl + scan_i8 + rerank_fl
    hbm = (c_loc * sz["p_cap"] * s          # local codes streamed once (u8)
           + c_loc * d * 4 + nq * d * 4)
    return flops, hbm


def lower_juno_cell(multi_pod: bool, device: str = "cuda", *, mesh=None,
                    sizes: dict | None = None) -> dict:
    """The distributed JUNO search at pod scale: the clusters sharded over
    every rank, each rank searching its C/n clusters (mode H2, the plain
    route named, as the reference's ``impl="ref"``:
    ``dist.distributed_index.search_shard``), the shards' (Q, k) scores
    and ids all-gathered and merged. ``mesh``/``sizes``: another mesh (on
    the existing process group) and other sizes than the production
    mesh's and :data:`JUNO_100M`."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from ..dist.distributed_index import merge_shards, search_shard
    sz = dict(JUNO_100M, **(sizes or {}))
    result = {"arch": "juno_ann_100m", "shape": "serve_q128",
              "mesh": "multi" if multi_pod else "single"}
    if mesh is None:
        _world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
    n_chips = mesh.size()
    result.update(n_chips=n_chips, status="ok")
    group = dist.group.WORLD
    t0 = time.time()
    try:
        def build():
            part, q = _juno_shard(sz, sz["c"] // n_chips, device)

            def fn():
                sc, ids = search_shard(part, q, 0, local_nprobe=sz["nprobe"],
                                       k=sz["k"], mode="H2", impl="ref")
                with warnings.catch_warnings():   # renamed in newer torch
                    warnings.simplefilter("ignore", FutureWarning)
                    sc, ids = (funcol.all_gather_tensor(t, 1, group)
                               for t in (sc, ids))
                return merge_shards([sc], [ids], sz["k"], False)
            return fn, (part, q), sum(_local_bytes(t) for t in
                                      _tensor_leaves(part))
        run = fake_pass(build, device)
        flops, hbm = juno_analytic(sz, n_chips)
        summary = run["summary"]
        terms = comm_analysis.roofline_terms(
            flops, hbm, summary["total_link_bytes_per_chip"], n_chips,
            internode_link_bytes_per_chip=summary[
                "internode_link_bytes_per_chip"])
        scores, ids = run["out"]
        result.update({
            "pass_s": round(run["pass_s"], 1),
            "wall_s": round(time.time() - t0, 1),
            "analytic_flops_per_chip": flops,
            "analytic_hbm_bytes_per_chip": hbm,
            "counted_flops_per_chip": run["counted_flops"],
            "counted_over_analytic": run["counted_flops"] / flops,
            "collectives": summary, "roofline": terms,
            "useful_flop_ratio": 1.0, "model_flops_per_chip": flops,
            "analytic_state_bytes_per_chip": run["residency"],
            "result_shapes": [list(scores.shape), list(ids.shape)],
            "memory_analysis": {
                "argument_local_bytes": run["argument_local_bytes"],
                "memtracker_peak_bytes": run["memtracker_peak_bytes"]},
        })
    except Exception as e:
        result.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]})
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS + ["juno_ann"])
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--outdir", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--sp", action="store_true",
                    help="sequence-parallel variant")
    ap.add_argument("--device", default=default_device(),
                    help="the device type the fake tensors model (default: "
                    "cuda where torch is built with CUDA, else cpu)")
    args = ap.parse_args(argv)
    # DTensor warns of each two-step reduction; the recorder counts them
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)

    os.makedirs(args.outdir, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    archs = ARCH_IDS if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    if args.arch == "juno_ann" and not args.all:
        shapes = ["serve_q128"]
    # every cell of one mesh, then every cell of the other: the fake
    # world is started once a mesh
    cells = [(a, s, m) for m in meshes for a in archs for s in shapes]

    n_bad = 0
    for arch, shape, multi in cells:
        tag = f"{arch}_{shape}_{'multi' if multi else 'single'}"
        path = os.path.join(args.outdir, tag + ".json")
        if os.path.exists(path) and not args.force:
            with open(path) as f:
                prev = json.load(f)
            print(f"[cache] {tag}: {prev['status']}")
            n_bad += prev["status"] == "error"
            continue
        t0 = time.time()
        if arch == "juno_ann":
            res = lower_juno_cell(multi, device=args.device)
        else:
            res = lower_cell(arch, shape, multi, sp=args.sp,
                             device=args.device)
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        n_bad += res["status"] == "error"
        extra = ""
        if res["status"] == "ok":
            r = res["roofline"]
            extra = (f" dominant={r['dominant']}"
                     f" c/m/coll={r['compute_s']:.2e}/{r['memory_s']:.2e}"
                     f"/{r['collective_s']:.2e}s"
                     f" counted/analytic={res['counted_over_analytic']:.3f}"
                     f" useful={res['useful_flop_ratio']:.2f}")
        elif res["status"] == "error":
            extra = " " + res["error"][:160]
        print(f"[{res['status']}] {tag} ({time.time() - t0:.0f}s){extra}",
              flush=True)
    print(f"done; {n_bad} errors")
    return 1 if n_bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
