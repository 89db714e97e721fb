"""The port's dry run (``repro_torch.launch.shapes``, ``analytic``,
``comm_analysis``, ``dryrun``) and ``train.optimizer.opt_state_schema``
against the reference's.

* The reference side runs in ONE subprocess, which imports
  ``repro.launch.dryrun`` (it pins ``XLA_FLAGS`` to 512 host devices at
  import, which must not reach this process) and dumps JSON: per FULL
  config its ``total_bytes``, ``_serving_schema`` and
  ``opt_state_schema`` leaves, per cell its ``_model_flops``,
  ``analytic_bytes_per_chip`` of the cell's state on both production
  meshes, and ``lower_juno_cell``'s analytic terms (its lowering stubbed:
  on jax 0.9 the production mesh's Explicit axes make it fail, ROADMAP
  queue 3).
* The port's fake world runs in ONE other subprocess (a fake process group
  of 8 ranks, never in a pytest worker): the collective recorder on known
  collectives, phi4-mini SMOKE train, prefill and decode cells and a small
  JUNO cell on a (2, 4) mesh, the same steps unsharded against
  ``FlopCounterMode`` over real CPU passes, and the CLI's cache.
* ``applicable``, ``step_flops_per_chip``, ``step_bytes_per_chip``, the
  ring arithmetic, ``collective_summary`` and ``roofline_terms`` (pure
  Python in both packages) are compared in this process.

Tolerances: the analytic numbers within 1e-12 relative; the schemas leaf
for leaf; the recorded bytes and the counted FLOPs exact.
"""
import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from repro import configs as RC
from repro.launch import analytic as r_analytic
from repro.launch import hlo_analysis as r_hlo
from repro.launch import shapes as r_shapes
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch import analytic, comm_analysis, dryrun, shapes
from repro_torch.models import get_model
from repro_torch.models.params import as_dtype, is_spec
from repro_torch.train import TrainState
from repro_torch.train.optimizer import opt_state_schema

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TIMEOUT = 300
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _stand_in(shape, names):
    """An object with the reference mesh's ``axis_names`` and
    ``devices.shape`` (what both packages' pspec functions read)."""
    return SimpleNamespace(axis_names=names,
                           devices=SimpleNamespace(shape=shape))


REFERENCE = r"""
import json, sys
from types import SimpleNamespace
import repro.launch.dryrun as D       # pins XLA_FLAGS to 512 host devices
import jax, jax.numpy as jnp
from repro.configs import ARCH_IDS, get_config
from repro.launch.shapes import SHAPES
from repro.models import get_model
from repro.models.params import Spec
from repro.train import TrainState
from repro.train.optimizer import opt_state_schema

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}

def stand_in(shape, names):
    return SimpleNamespace(axis_names=names,
                           devices=SimpleNamespace(shape=shape))

def leaves(tree):
    out = []
    for path, s in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, Spec))[0]:
        keys = [str(getattr(k, "key", getattr(k, "name", None)))
                for k in path]
        out.append(["/".join(keys), list(s.shape), list(s.pspec),
                    jnp.dtype(s.dtype).name])
    return out

out = {"archs": {}}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    model = get_model(cfg)
    serving = D._serving_schema(model)
    state = TrainState(params=model.schema,
                       opt=opt_state_schema(model.schema))
    rec = {"schema_bytes": D.total_bytes(model.schema),
           "serving": leaves(serving),
           "opt": leaves(opt_state_schema(model.schema)), "shapes": {}}
    for name, shape in SHAPES.items():
        b, t = shape.global_batch, shape.seq_len
        cache = model.cache_schema(b, t)
        cells = {"model_flops": D._model_flops(cfg, model.schema, shape),
                 "cache_bytes": (D.total_bytes(cache)
                                 if shape.kind != "train" else 0)}
        if shape.kind == "train":
            parts = [state]
        elif shape.kind == "prefill":
            parts = [model.schema, model.cache_schema(b, 4096)
                     if cfg.encoder_decoder else cache]
        else:
            parts = [serving, cache]
        for mname, (mshape, names) in MESHES.items():
            mesh = stand_in(mshape, names)
            cells[mname] = sum(D.analytic_bytes_per_chip(p, mesh)
                               for p in parts)
        rec["shapes"][name] = cells
    out["archs"][arch] = rec

# lower_juno_cell's analytic terms, its lowering stubbed
import repro.dist.distributed_index as di
class Stub:
    def lower(self, *a):
        return self
    def compile(self):
        return self
    def memory_analysis(self):
        return SimpleNamespace()
    def cost_analysis(self):
        return {}
    def as_text(self):
        return ""
di.make_distributed_search = lambda *a, **k: Stub()
out["juno"] = {}
for multi in (False, True):
    r = D.lower_juno_cell(multi_pod=multi)
    assert r["status"] == "ok", r
    out["juno"]["multi" if multi else "single"] = {
        k: r[k] for k in ("n_chips", "analytic_flops_per_chip",
                          "analytic_hbm_bytes_per_chip",
                          "model_flops_per_chip", "useful_flop_ratio")}
json.dump(out, open(sys.argv[1], "w"))
"""

WORLD = r"""
import contextlib, io, json, logging, os, sys, tempfile
import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import init_device_mesh
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import get_smoke_config
from repro_torch.data.tokens import make_batch
from repro_torch.launch import comm_analysis as ca, dryrun as D, mesh as M
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models import get_model
from repro_torch.models.params import init_params
from repro_torch.train import TrainConfig, init_train_state, make_train_step
logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
torch.set_num_threads(1)
dev = D.default_device()
out = {"device": dev}
M.init_fake_world(8)
mesh = init_device_mesh(dev, (2, 4), mesh_dim_names=("data", "model"))

# the recorder on collectives of known sizes
with FakeTensorMode():
    rec = ca.CollectiveRecorder()
    with rec:
        funcol.all_gather_tensor(torch.empty(3, 5, device=dev), 0,
                                 (mesh, 1))
        funcol.reduce_scatter_tensor(torch.empty(8, 5, device=dev), "sum",
                                     0, (mesh, 1))
        funcol.all_reduce(torch.empty(3, 5, device=dev), "sum", (mesh, 0))
out["recorded"] = [[o.kind, o.result_bytes, o.group_size, o.crosses_nodes]
                   for o in rec.ops]

# phi4-mini SMOKE cells on (2, 4) and on one unsharded rank
cfg = get_smoke_config("phi4_mini_3_8b")
B, T = 8, 32
keep = ("status", "error", "traceback", "counted_flops_per_chip",
        "collectives", "roofline", "memory_analysis",
        "analytic_state_bytes_per_chip", "n_chips")
for kind, sp in (("train", False), ("prefill", True), ("decode", False)):
    shape = ShapeSpec("smoke_" + kind, kind, T, B)
    r = D.run_cell(cfg, shape, mesh, sp=sp, device=dev)
    one = D.run_cell(cfg, shape, None, device=dev)
    out[kind] = {k: r.get(k) for k in keep}
    out[kind]["one_rank"] = {k: one.get(k) for k in keep}
out["juno"] = D.lower_juno_cell(False, device=dev, mesh=mesh, sizes={
    "n": 4096, "c": 64, "p_cap": 128, "nq": 8, "k": 10})
out["juno"].pop("traceback", None)

# the same steps on real CPU tensors under FlopCounterMode
model = get_model(cfg)
state = init_train_state(model, torch.Generator().manual_seed(0),
                         device="cpu")
batch = make_batch(cfg, batch=B, seq=T, step=0, device="cpu")
with FlopCounterMode(display=False) as fc:
    make_train_step(model, TrainConfig())(state, batch)
out["real_train"] = fc.get_total_flops()
params = init_params(D._serving_schema(model),
                     torch.Generator().manual_seed(0), device="cpu")
cache = init_params(model.cache_schema(B, T), device="cpu")
with FlopCounterMode(display=False) as fc:
    model.prefill(init_params(model.schema, torch.Generator().manual_seed(0),
                              device="cpu"), {"tokens": batch["tokens"]},
                  init_params(model.cache_schema(B, T), device="cpu"))
out["real_prefill"] = fc.get_total_flops()
with FlopCounterMode(display=False) as fc:
    model.decode(params, cache, batch["tokens"][:, :1],
                 torch.zeros(B, dtype=torch.int32))
out["real_decode"] = fc.get_total_flops()

# the CLI: a cell written, then read from its cache, then redone (--force)
outdir = tempfile.mkdtemp()
args = ["--arch", "phi4_mini_3_8b", "--shape", "long_500k", "--mesh",
        "single", "--outdir", outdir]
out["cli"] = []
for extra in ([], [], ["--force"]):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = D.main(args + extra)
    path = os.path.join(outdir, "phi4_mini_3_8b_long_500k_single.json")
    out["cli"].append([rc, buf.getvalue(), os.stat(path).st_mtime_ns,
                       json.load(open(path))])
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """The reference's subprocess and the port's fake world, run at once."""
    tmp = tmp_path_factory.mktemp("dryrun")
    paths = {"ref": str(tmp / "ref.json"), "port": str(tmp / "port.json")}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), HERE]), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = {}
    for side, code in (("ref", REFERENCE), ("port", WORLD)):
        procs[side] = subprocess.Popen(
            [sys.executable, "-c", code, paths[side]], env=env, cwd=REPO,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    deadline = time.monotonic() + TIMEOUT
    errs = {}
    try:
        for side, p in procs.items():
            _, errs[side] = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    for side, p in procs.items():
        assert p.returncode == 0, f"{side}: {errs[side][-3000:]}"
    return SimpleNamespace(**{k: json.load(open(v))
                              for k, v in paths.items()})


def _close(a, b) -> bool:
    return math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_applicable_matches_reference(arch):
    rc = RC.get_config(arch)
    pc = get_config(arch)
    for name in r_shapes.SHAPES:
        assert shapes.SHAPES[name] == shapes.ShapeSpec(
            *(getattr(r_shapes.SHAPES[name], f) for f in
              ("name", "kind", "seq_len", "global_batch")))
        assert shapes.applicable(pc, shapes.SHAPES[name]) == \
            r_shapes.applicable(rc, r_shapes.SHAPES[name]), name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_matches_reference(sides, arch):
    """Per cell (4 shapes x 2 meshes): ``total_bytes`` of the schema and
    cache, ``step_flops_per_chip``, ``step_bytes_per_chip``,
    ``_model_flops``, ``useful_flop_ratio`` and the state's
    ``analytic_bytes_per_chip``, the reference's live functions' values."""
    ref = sides.ref["archs"][arch]
    rc, pc = RC.get_config(arch), get_config(arch)
    model = get_model(pc)
    sch_b = dryrun.total_bytes(model.schema)
    assert sch_b == ref["schema_bytes"]
    state = TrainState(params=model.schema,
                       opt=opt_state_schema(model.schema))
    serving = dryrun._serving_schema(model)
    for name, shape in shapes.SHAPES.items():
        cell = ref["shapes"][name]
        b, t = shape.global_batch, shape.seq_len
        cache = model.cache_schema(b, t)
        cache_b = dryrun.total_bytes(cache) if shape.kind != "train" else 0
        assert cache_b == cell["cache_bytes"], name
        model_fl = dryrun._model_flops(pc, model.schema, shape)
        assert _close(model_fl, cell["model_flops"]), name
        if shape.kind == "train":
            parts = [state]
        elif shape.kind == "prefill":
            parts = [model.schema, dryrun._prefill_schemas(model, shape)[1]]
        else:
            parts = [serving, cache]
        rs = r_shapes.SHAPES[name]
        for mname, (mshape, names) in MESHES.items():
            n = math.prod(mshape)
            mesh = _stand_in(mshape, names)
            assert sum(dryrun.analytic_bytes_per_chip(p, mesh)
                       for p in parts) == cell[mname], (name, mname)
            flops = analytic.step_flops_per_chip(pc, shape, n)
            assert _close(flops, r_analytic.step_flops_per_chip(rc, rs, n))
            assert _close(analytic.step_bytes_per_chip(
                pc, shape, n, sch_b, cache_b, tp=16),
                r_analytic.step_bytes_per_chip(
                    rc, rs, n, ref["schema_bytes"], cell["cache_bytes"],
                    tp=16)), (name, mname)
            assert _close((model_fl / n) / flops,
                          (cell["model_flops"] / n) / flops)


def test_card_step_flops():
    """phi4-mini FULL at B 2 x T 1024 on one card: 61.9796 TFLOP, the
    62.67 ms at 989 TFLOP/s of the train phase's bound."""
    fl = analytic.step_flops_per_chip(
        get_config("phi4_mini_3_8b"),
        shapes.ShapeSpec("card", "train", 1024, 2), 1)
    assert round(fl / 1e12, 4) == 61.9796
    terms = comm_analysis.roofline_terms(fl, 0.0, 0.0, 1)
    assert round(terms["compute_s"] * 1e3, 2) == 62.67


def test_juno_analytic_matches_reference(sides):
    for mname, ref in sides.ref["juno"].items():
        flops, hbm = dryrun.juno_analytic(dryrun.JUNO_100M, ref["n_chips"])
        assert _close(flops, ref["analytic_flops_per_chip"]), mname
        assert _close(hbm, ref["analytic_hbm_bytes_per_chip"]), mname
        assert ref["useful_flop_ratio"] == 1.0
        assert _close(flops, ref["model_flops_per_chip"])


def _walk(tree, path=()):
    """(path, Spec) in ``jax.tree``'s order: dict keys sorted, a
    NamedTuple's fields in their order."""
    if is_spec(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        for f in tree._fields:
            yield from _walk(getattr(tree, f), path + (f,))


def _leaves(tree) -> list:
    return [["/".join(path), list(s.shape),
             json.loads(json.dumps(list(s.pspec))),
             str(as_dtype(s.dtype)).split(".")[1]]
            for path, s in _walk(tree)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_schemas_match_reference(sides, arch):
    """``opt_state_schema`` (m, v zero-init like the parameters, a ()
    int32 step) and ``_serving_schema`` (bf16; "data" dropped where the TP
    residency fits) leaf for leaf: path, shape, pspec and dtype."""
    model = get_model(get_config(arch))
    ref = sides.ref["archs"][arch]
    opt = opt_state_schema(model.schema)
    assert _leaves(opt) == ref["opt"]
    assert opt.step.init == "zeros" and all(
        s.init == "zeros" for _, s in dryrun._spec_items(opt.m))
    assert _leaves(dryrun._serving_schema(model)) == ref["serving"]


KINDS = ["all-gather", "reduce-scatter", "all-reduce", "all-to-all",
         "collective-permute"]


def test_ring_summary_and_roofline_match_reference():
    """``CollectiveOp``'s ring bytes, ``collective_summary`` and
    ``roofline_terms`` at the reference's TPU rates (``hw=TPU_V5E``, the
    reference's own dict: the port holds no TPU rate) on the same inputs."""
    cases = [(k, b, n, m) for k in KINDS for b in (0, 1, 4096, 3 * 2 ** 20)
             for n in (1, 2, 16, 512) for m in (1.0, 2.5)]
    p_ops = [comm_analysis.CollectiveOp(*c) for c in cases]
    r_ops = [r_hlo.CollectiveOp(*c) for c in cases]
    for p, r in zip(p_ops, r_ops):
        assert p.per_chip_link_bytes == r.per_chip_link_bytes
    assert comm_analysis.collective_summary(p_ops) == \
        r_hlo.collective_summary(r_ops)
    for args in ((1e15, 3e10, 5e11, 256), (0.0, 0.0, 0.0, 1),
                 (2e12, 8e11, 0.0, 512), (1e9, 1e12, 1e9, 16)):
        assert comm_analysis.roofline_terms(*args, hw=r_hlo.TPU_V5E) == \
            r_hlo.roofline_terms(*args)
    # the H100 default: NVLink in a node, the assumed NIC rate across
    t = comm_analysis.roofline_terms(0.0, 0.0, 9e11, 256,
                                     internode_link_bytes_per_chip=5e11)
    hw = comm_analysis.H100_SXM
    assert t["collective_s"] == 4e11 / hw["link_bw"] + 5e11 / hw[
        "internode_bw"]
    assert hw["peak_flops_bf16"] == 989e12 and hw["hbm_bw"] == 3.35e12


def test_recorder_counts_known_collectives(sides):
    """On the fake (2, 4) world: an all-gather of (3, 5) f32 over "model"
    (4 ranks: a (12, 5) result), a reduce-scatter of (8, 5) over "model"
    ((2, 5)) and an all-reduce of (3, 5) over "data" (2 ranks); no group
    of 8 ranks crosses an 8-GPU node."""
    assert sides.port["recorded"] == [["all-gather", 240, 4, False],
                                      ["reduce-scatter", 40, 4, False],
                                      ["all-reduce", 60, 2, False]]


def _head_flops(cfg, b, t) -> int:
    """The LM head's train FLOPs: logits and their two backward
    products."""
    return 3 * 2 * b * t * cfg.d_model * cfg.vocab_size


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_fake_cells_on_the_mesh(sides, kind):
    """phi4-mini SMOKE (B 8 x T 32) on the fake (2, 4) world: the cell is
    ok, and the per-rank counted FLOPs x 8 equal the one-rank count plus
    what the mesh repeats on its 4 "model" ranks: in training the LM head
    (``lm_logits`` gathers the head whole on every rank of a batch shard,
    forward and backward); prefill and decode keep the head
    column-parallel and split every product, so nothing is repeated."""
    cell = sides.port[kind]
    assert cell["status"] == "ok", (cell["error"], cell["traceback"])
    one = cell["one_rank"]
    assert one["status"] == "ok", (one["error"], one["traceback"])
    cfg = get_smoke_config("phi4_mini_3_8b")
    repeated = {"lm head": _head_flops(cfg, 8, 32)} if kind == "train" \
        else {}
    assert 8 * cell["counted_flops_per_chip"] == \
        one["counted_flops_per_chip"] + 3 * sum(repeated.values())
    assert cell["n_chips"] == 8 and one["n_chips"] == 1
    assert cell["collectives"]["total_link_bytes_per_chip"] > 0
    assert cell["roofline"]["dominant"] in ("compute", "memory",
                                            "collective")
    mem = cell["memory_analysis"]
    assert 0 < mem["argument_local_bytes"] <= mem["memtracker_peak_bytes"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_unsharded_fake_pass_counts_the_real_step(sides, kind):
    """The unsharded fake pass counts the FLOPs ``FlopCounterMode`` counts
    over a real CPU pass of the same SMOKE step."""
    assert sides.port[kind]["one_rank"]["counted_flops_per_chip"] == \
        sides.port[f"real_{kind}"]


def test_juno_cell_on_the_mesh(sides):
    """A JUNO cell (64 clusters, 8 per rank; Q 8, k 10) through the plain
    route on the fake (2, 4) world: ok, the merge's gather of the shards'
    scores and ids recorded, (Q, k) results."""
    r = sides.port["juno"]
    assert r["status"] == "ok", r.get("error")
    assert r["collectives"]["all-gather"]["count"] == 2
    assert r["result_shapes"] == [[8, 10], [8, 10]]
    assert r["counted_flops_per_chip"] > 0


def test_cli_cache_and_force(sides):
    """The CLI writes a cell, reads it back from the cache on the next run
    (``[cache]``, the file untouched) and redoes it with ``--force``."""
    (rc1, out1, t1, r1), (rc2, out2, t2, r2), (rc3, out3, t3, r3) = \
        sides.port["cli"]
    assert rc1 == rc2 == rc3 == 0
    assert "[skip] phi4_mini_3_8b_long_500k_single" in out1
    assert "[cache] phi4_mini_3_8b_long_500k_single: skip" in out2
    assert t2 == t1 and t3 > t1
    assert "[skip]" in out3
    assert r1 == r3 and r1["status"] == "skip"
    assert "full-attention" in r1["reason"]


def test_input_specs_are_meta():
    specs = dryrun.input_specs("phi4_mini_3_8b", "train_4k")
    assert tuple(specs["tokens"].shape) == (256, 4096)
    assert specs["tokens"].device.type == "meta"
    dec = dryrun.input_specs("phi4_mini_3_8b", "decode_32k")
    assert tuple(dec["token"].shape) == (128, 1)


def test_dryrun_torch_artifacts_exist_and_complete():
    """The committed sweep (``python -m repro_torch.launch.dryrun --all
    --mesh both``) covers every (arch x shape x mesh) cell with ok or
    skip, and skips exactly the reference's cells, for its reasons."""
    from repro_torch.launch.shapes import SHAPES
    missing, bad = [], []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            for mesh in ("single", "multi"):
                tag = f"{arch}_{shape}_{mesh}.json"
                p = os.path.join(REPO, "experiments", "dryrun_torch", tag)
                if not os.path.exists(p):
                    missing.append(tag)
                    continue
                with open(p) as fh:
                    r = json.load(fh)
                if r["status"] not in ("ok", "skip"):
                    bad.append((tag, r.get("error", "")[:80]))
                    continue
                with open(os.path.join(REPO, "experiments", "dryrun",
                                       tag)) as fh:
                    ref = json.load(fh)
                assert (r["status"] == "skip") == (ref["status"] == "skip"), \
                    tag
                if r["status"] == "skip":
                    assert r["reason"] == ref["reason"], tag
    assert not missing, missing
    assert not bad, bad


def _random_shard(seed: int = 0):
    """A small random index (8 clusters of 32 slots, S 8, E 16, D 16) and
    8 queries: values without meaning, the same on every call."""
    import torch
    from repro_torch.core.density import DensityModel
    from repro_torch.core.ivf import IVFIndex
    from repro_torch.core.juno import JunoIndexData
    from repro_torch.core.pq import PQCodebook
    g = torch.Generator().manual_seed(seed)
    c, p, s, e, d = 8, 32, 8, 16, 16
    cent = torch.randn(c, d, generator=g)
    entries = torch.randn(s, e, 2, generator=g)
    part = JunoIndexData(
        ivf=IVFIndex(centroids=cent, centroid_sq=(cent * cent).sum(-1),
                     point_ids=torch.arange(c * p, dtype=torch.int32
                                            ).reshape(c, p),
                     valid=torch.rand(c, p, generator=g) < 0.8,
                     labels=torch.arange(c * p, dtype=torch.int32) // p),
        codebook=PQCodebook(entries=entries,
                            entry_sq=(entries * entries).sum(-1)),
        codes=torch.zeros(1, s, dtype=torch.uint8),
        cluster_codes=torch.randint(0, e, (c, p, s), generator=g,
                                    dtype=torch.uint8),
        density=DensityModel(grid=torch.rand(s, 8, 8, generator=g),
                             lo=-torch.ones(s, 2) * 3, hi=torch.ones(s, 2) * 3,
                             coeffs=torch.tensor([0.0, 0.1, 1.0]),
                             tau_min=torch.tensor(0.5),
                             tau_max=torch.tensor(4.0)),
        points_sq=torch.zeros(1))
    return part, torch.randn(8, d, generator=g)


@pytest.mark.parametrize("mode", ["H", "H2", "M"])
def test_plain_route_reaches_no_wrapper(monkeypatch, mode):
    """``search_shard(impl="ref")`` (the JUNO cell's route) calls the
    kernels' plain versions by name: with every wrapper it would reach
    replaced by one that raises, a shard's search still runs and returns
    what the wrappers return on CPU tensors; the default route raises."""
    import torch
    from repro_torch.dist.distributed_index import search_shard
    from repro_torch.kernels import ops
    part, q = _random_shard()
    kw = dict(local_nprobe=2, k=5, mode=mode)
    want = search_shard(part, q, 0, **kw)

    def refuse(*a, **k):
        raise AssertionError("a wrapper was called")
    for name in ("filter_topk", "build_selective_lut", "masked_adc_topk_scan",
                 "hit_count_topk_scan"):
        monkeypatch.setattr(ops, name, refuse)
    got = search_shard(part, q, 0, impl="ref", **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(AssertionError, match="wrapper"):
        search_shard(part, q, 0, **kw)
    with pytest.raises(ValueError, match="plain route"):
        search_shard(part, q, 0, impl="ref", fused=True, **kw)
