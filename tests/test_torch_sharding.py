"""The port's sharded train step (``repro_torch.dist.sharding``, the
schemas' pspecs, ``launch.mesh``, the sharded optimizer state and the
elastic checkpoint restore) against ``repro``'s.

* ``normalize_pspec`` / ``_norm_entry`` and every schema leaf's pspec
  (model, cache and batch schemas of the ten SMOKE configs) are exactly
  the reference's.
* The reference's parameters and batches are made here once; one
  subprocess with 8 host devices runs the reference's sharded runs
  on a (2, 4) ("data", "model") mesh with Auto axes (``jax.make_mesh``'s
  Explicit axes make the reference's own tests fail on jax 0.9):
  phi4-mini SMOKE f32 under SP with ``grad_pspecs`` (B 4 x T 32: the loss
  and gradients of ``jax.value_and_grad(model.loss)`` and one
  ``make_train_step`` step) and deepseek-v2-lite SMOKE under EP
  (capacity 8, B 4 x T 16); then the jitted prefill (B 4 x T 16) and 4
  decode ticks of phi4-mini, deepseek-v2-lite and hymba SMOKE f32 with
  ``in_shardings`` from the parameter and cache schemas.
* One spawned gloo world of 8 processes on a (2, 4) mesh
  (``_torch_shard_worker.py``, which imports no JAX) runs the port's
  counterparts on the same parameters and batches, at the same time.

Tolerances: the loss within 1e-5 relative, gradients within 1e-5 of the
tree's largest, the parameters after the step as ``test_torch_train.py``
holds a step (99.9 % within 1e-6, all within 2 x the learning rate), the
EP loss within 1e-5 relative; every SMOKE config's loss under the mesh
within 1e-5 relative of the port's unsharded loss (the MoE families' on
(8, 1)); the SP pair and the restores exact; the sharded prefill's and
decode's logits and caches within 1e-5 of each array's largest value,
against the reference's sharded runs and, for every SMOKE config, the
port's unsharded run.
"""
import dataclasses
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_parity import port_model_config
from repro import configs as RC
from repro.dist import checkpoint as r_ckpt
from repro.dist import sharding as r_sh
from repro.launch import mesh as r_mesh
from repro.models import get_model as r_get_model
from repro.models import params as RPm
from repro_torch.configs import ARCH_IDS
from repro_torch.dist import sharding as p_sh
from repro_torch.launch import mesh as p_mesh
from repro_torch.models import get_model
from repro_torch.models.params import is_spec

WORLD = 8
TIMEOUT = 300


def _stand_in(shape, names):
    """An object with the reference mesh's ``axis_names`` and
    ``devices.shape`` (what its pspec functions read)."""
    return SimpleNamespace(axis_names=names,
                           devices=SimpleNamespace(shape=shape))


MESHES = [((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")), ((1, 1), ("data", "model"))]
SPECS = [(("data", "model"), (64, 64)), (("model", "data"), (64, 6)),
         ((("pod", "data"), None), (8, 3)), ((("pod", "data"), None), (2, 3)),
         ((("pod", "data"), None), (1, 3)), ((None, "model", None), (5, 6, 7)),
         (("model",), (6,)), ((None,), (7,)), ((), ()),
         ((("data", "model"), None), (8, 4)),
         ((("data", "model"), None), (2, 4)), (("pod", "model"), (4, 4))]


@pytest.mark.parametrize("shape,names", MESHES)
def test_normalize_pspec_matches_reference(shape, names):
    mesh = _stand_in(shape, names)
    sizes = dict(zip(names, shape))
    for spec, dims in SPECS:
        assert p_mesh.normalize_pspec(spec, mesh, dims) == tuple(
            r_mesh.normalize_pspec(r_mesh.P(*spec), mesh, dims)), spec
        assert p_mesh.normalize_pspec(spec, mesh) == tuple(
            r_mesh.normalize_pspec(r_mesh.P(*spec), mesh)), spec
        for entry, dim in zip(spec, dims):
            assert p_sh._norm_entry(entry, dim, sizes) == \
                r_sh._norm_entry(entry, dim, sizes), (entry, dim)
    assert p_mesh.batch_axes(mesh) == r_mesh.batch_axes(mesh)


def _spec_tree(tree, reference: bool) -> dict:
    out = {}

    def walk(t, path):
        if (RPm.is_spec(t) if reference else is_spec(t)):
            out[path] = (tuple(t.shape), tuple(t.pspec))
            return
        for k in sorted(t):
            walk(t[k], f"{path}/{k}")
    walk(tree, "")
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_schema_pspecs_match_reference(arch):
    """Every leaf of the model, cache and batch schemas carries the
    reference's shape and pspec."""
    rc = RC.get_smoke_config(arch)
    rm, pm = r_get_model(rc), get_model(port_model_config(rc))
    pairs = [(rm.schema, pm.schema),
             (rm.cache_schema(2, 16), pm.cache_schema(2, 16)),
             (rm.batch_schema(2, 16), pm.batch_schema(2, 16))]
    for r, p in pairs:
        assert _spec_tree(p, False) == _spec_tree(r, True)


def test_helpers_are_identities_while_disabled():
    x = torch.randn(2, 4, 8)
    p_sh.disable()
    assert p_sh.mesh() is None and p_sh.model_axis() == 1
    for fn in (p_sh.constrain_act, p_sh.seq_all_gather, p_sh.constrain_heads,
               p_sh.sp_gather, p_sh.sp_scatter):
        assert fn(x) is x
    assert p_sh.constrain_batch(x, None, None) is x
    w = torch.randn(8, 6)
    assert torch.equal(p_sh.row_parallel(x, w), x @ w)


def test_production_mesh_needs_its_world():
    """The (16, 16) mesh is built from the process group that exists, and
    refuses one of another size (here: none)."""
    with pytest.raises(ValueError, match="256 ranks"):
        p_mesh.make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        p_mesh.make_production_mesh(multi_pod=True, device_type="cpu")


def test_worker_imports_no_jax():
    """The spawned ranks import the worker module: it and the port must
    import neither ``jax`` nor ``repro``."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys, _torch_shard_worker, repro_torch.dist.sharding, "
            "repro_torch.launch.mesh\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(here, "..", "src"), here]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


# --------------------------------------------------------------------------
# the reference's sharded runs and the port's, once each for the module
# --------------------------------------------------------------------------

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.dist import sharding as shmod
from repro.launch.mesh import normalize_pspec
from repro.models import get_model
from repro.models.params import tree_map_specs
from repro.train import TrainConfig, TrainState, make_train_step
from repro.train.optimizer import init_opt_state

inputs = np.load(sys.argv[1])
out = {}

def tree(prefix):
    t = {}
    for key in inputs.files:
        if key.startswith(prefix + "/"):
            node = t
            *path, leaf = key[len(prefix) + 1:].split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = jax.numpy.asarray(inputs[key])
    return t

def put(prefix, t):
    for k, v in t.items():
        if isinstance(v, dict):
            put(f"{prefix}/{k}", v)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)

# Auto axes (jax.make_mesh would make Explicit ones)
mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
rep = lambda t: jax.tree.map(
    lambda x: jax.device_put(x, NamedSharding(mesh, P())), t)

cfg = dataclasses.replace(get_smoke_config("phi4_mini_3_8b"),
                          dtype="float32")
model = get_model(cfg)
params, batch = tree("sp/params"), tree("sp/batch")
shmod.enable(("data",), sp=True, model_axis=4, mesh=mesh)
gp = tree_map_specs(lambda s: normalize_pspec(s.pspec, mesh, s.shape),
                    model.schema)
with mesh:
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(rep(params), batch)
    state = rep(TrainState(params, init_opt_state(params)))
    new, met = jax.jit(make_train_step(model, TrainConfig(),
                                       grad_pspecs=gp))(state, batch)
shmod.disable()
out["sp/loss"] = np.asarray(loss)
put("sp/grads", grads)
out["sp/step_loss"] = np.asarray(met["loss"])
out["sp/grad_norm"] = np.asarray(met["grad_norm"])
out["sp/lr"] = np.asarray(met["lr"])
put("sp/new_params", new.params)

base = get_smoke_config("deepseek_v2_lite_16b")
cfg = dataclasses.replace(base, dtype="float32", moe=dataclasses.replace(
    base.moe, capacity_factor=8.0))
model = get_model(cfg)
shmod.enable(("data",), sp=False, model_axis=4, mesh=mesh)
with mesh:
    out["ep/loss"] = np.asarray(jax.jit(model.loss)(
        rep(tree("ep/params")), tree("ep/batch")))
shmod.disable()

# sharded prefill and decode: parameters and cache laid out by their
# schemas' pspecs, tokens and positions batch-sharded
from concurrent.futures import ThreadPoolExecutor
from repro.models.params import init_params
tokens = jax.numpy.asarray(inputs["serve/tokens"])
nxt = inputs["serve/next"]
b, t = tokens.shape

def serve(name, arch, cap):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    if cap:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cap))
    model = get_model(cfg)
    csch = model.cache_schema(b, SERVE_SEQ)
    lay = lambda sch: tree_map_specs(lambda s: NamedSharding(
        mesh, normalize_pspec(s.pspec, mesh, s.shape)), sch)
    rows = NamedSharding(mesh, P("data", None))
    with mesh:
        pre = jax.jit(model.prefill, in_shardings=(
            lay(model.schema), {"tokens": rows}, lay(csch)),
            out_shardings=(None, lay(csch)))
        dec = jax.jit(model.decode, in_shardings=(
            lay(model.schema), lay(csch), rows,
            NamedSharding(mesh, P("data"))), out_shardings=(None, lay(csch)))
        params = tree(f"{name}/params")
        logits, cache = pre(params, {"tokens": tokens},
                            init_params(csch, jax.random.PRNGKey(0)))
        out[f"serve/{name}/logits0"] = np.asarray(logits)
        for i in range(nxt.shape[1]):
            logits, cache = dec(params, cache, nxt[:, i:i + 1],
                                np.full((b,), t + i, np.int32))
            out[f"serve/{name}/logits{i + 1}"] = np.asarray(logits)
    put(f"serve/{name}/cache", cache)

# the three models traced and compiled at once (XLA compiles outside the
# GIL); the registry is process-global and the same for all three
shmod.enable(("data",), sp=False, model_axis=4, mesh=mesh)
with ThreadPoolExecutor(3) as pool:
    for f in [pool.submit(serve, *a) for a in (
            ("sp", "phi4_mini_3_8b", None),
            ("ep", "deepseek_v2_lite_16b", 8.0),
            ("hy", "hymba_1_5b", None))]:
        f.result()
shmod.disable()
np.savez(sys.argv[2], **out)
"""

SERVE_SEQ = 32                 # the decode cache's length
REFERENCE = REFERENCE.replace("SERVE_SEQ", str(SERVE_SEQ))


def _inputs(path: str) -> None:
    """The reference's SMOKE parameters (PRNGKey 0) and batches of both
    runs, for both packages: phi4-mini f32 (B 4 x T 32) and deepseek-v2-lite
    f32 with capacity 8 (B 4 x T 16)."""
    import jax
    from repro.data.tokens import make_batch
    out = {}

    def put(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                put(f"{prefix}/{k}", v)
            else:
                out[f"{prefix}/{k}"] = np.asarray(v)
    base = RC.get_smoke_config("deepseek_v2_lite_16b")
    put("hy/params", RPm.init_params(r_get_model(dataclasses.replace(
        RC.get_smoke_config("hymba_1_5b"), dtype="float32")).schema,
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    out["serve/tokens"] = rng.integers(0, 512, (4, 16)).astype(np.int32)
    out["serve/next"] = rng.integers(0, 512, (4, 4)).astype(np.int32)
    for name, cfg, seq in (
            ("sp", dataclasses.replace(RC.get_smoke_config(
                "phi4_mini_3_8b"), dtype="float32"), 32),
            ("ep", dataclasses.replace(
                base, dtype="float32", moe=dataclasses.replace(
                    base.moe, capacity_factor=8.0)), 16)):
        put(f"{name}/params", RPm.init_params(r_get_model(cfg).schema,
                                              jax.random.PRNGKey(0)))
        put(f"{name}/batch", make_batch(cfg, batch=4, seq=seq, step=0))
    np.savez(path, **out)


def _wait(proc, what: str, deadline: float) -> None:
    try:
        proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        proc.kill()
        raise TimeoutError(f"{what} ran past {TIMEOUT} s")


def _runs(tmp, in_path: str, ref_path: str, out_path: str) -> None:
    """The reference's subprocess and the port's 8-rank gloo world, run at
    once, each joined with a timeout (killed past it)."""
    import torch.multiprocessing as mp
    import _torch_shard_worker as worker
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    deadline = time.monotonic() + TIMEOUT
    err = open(tmp / "reference.err", "w+")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, in_path,
                            ref_path], env=env, stdout=subprocess.DEVNULL,
                           stderr=err)
    try:
        ctx = mp.start_processes(
            worker.run, args=(WORLD, str(tmp / "store"), in_path, out_path,
                              str(tmp / "ckpt")),
            nprocs=WORLD, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the gloo world ran past {TIMEOUT} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        _wait(ref, "the reference's run", deadline)
    finally:
        if ref.poll() is None:
            ref.kill()
    err.seek(0)
    assert ref.returncode == 0, err.read()[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharding")
    paths = [str(tmp / f) for f in ("inputs.npz", "ref.npz", "port.npz")]
    _inputs(paths[0])
    _runs(tmp, *paths)
    return SimpleNamespace(ref=dict(np.load(paths[1])),
                           port=dict(np.load(paths[2])), ckpt=tmp / "ckpt")


def _leaves(d: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in d.items()
            if k.startswith(prefix)}


def test_sp_loss_and_grads_match_reference_sharded(runs):
    """phi4-mini SMOKE f32, SP on (2, 4): the port's loss and gradients
    against the reference's sharded ``value_and_grad``."""
    ref, port = runs.ref, runs.port
    np.testing.assert_allclose(port["sp/loss"], ref["sp/loss"], rtol=1e-5)
    rg, pg = _leaves(ref, "sp/grads/"), _leaves(port, "sp/grads/")
    assert set(rg) == set(pg) and rg
    top = max(np.abs(g).max() for g in rg.values())
    for k in rg:
        np.testing.assert_allclose(pg[k], rg[k], rtol=0, atol=1e-5 * top,
                                   err_msg=k)
    assert bool(port["sp/grad_layouts"])


def test_sp_train_step_matches_reference_sharded(runs):
    """One ``make_train_step(..., grad_pspecs=...)`` step from the same
    state: loss and grad norm within 1e-5 relative, the parameters at
    ``test_torch_train.py``'s step tolerance; m and v in the parameters'
    layout."""
    ref, port = runs.ref, runs.port
    np.testing.assert_allclose(port["sp/step_loss"], ref["sp/step_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(port["sp/grad_norm"], ref["sp/grad_norm"],
                               rtol=1e-5)
    rp, pp = _leaves(ref, "sp/new_params/"), _leaves(port, "sp/new_params/")
    assert set(rp) == set(pp)
    diffs = np.concatenate([np.abs(pp[k] - rp[k]).ravel() for k in rp])
    assert diffs.max() <= 2 * float(ref["sp/lr"]), diffs.max()
    assert np.quantile(diffs, 0.999) <= 1e-6
    assert bool(port["sp/moment_layouts"])


def test_ep_loss_matches_reference_sharded(runs):
    """deepseek-v2-lite SMOKE under expert parallelism on (2, 4)."""
    np.testing.assert_allclose(runs.port["ep/loss"], runs.ref["ep/loss"],
                               rtol=1e-5)


def test_sp_pair_is_the_identity(runs):
    port = runs.port
    assert bool(port["pair/gather_layout"])
    assert bool(port["pair/scatter_layout"])
    assert bool(port["pair/grad_layout"])
    assert float(port["pair/fwd_err"]) == 0.0
    assert float(port["pair/roundtrip_grad_err"]) == 0.0
    assert float(port["pair/bwd_err"]) <= 1e-5


def test_enable_disable_leaves_single_device_path_bit_equal(runs):
    assert bool(runs.port["plain/bit_equal"])
    assert bool(runs.port["plain/identity"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_loss_under_the_mesh(runs, arch):
    """Each SMOKE config (f32, B 8 x T 16) under SP on (2, 4), against the
    port's unsharded loss; the MoE families there expert-parallel, and on
    (8, 1) on the dense path."""
    port = runs.port
    plain = port[f"arch/{arch}/plain"]
    if arch in ("deepseek_v2_lite_16b", "llama4_scout_17b_a16e"):
        # EP's capacity is each shard's: only the (8, 1) mesh keeps the
        # dense path's drops
        assert np.isfinite(port[f"arch/{arch}/2x4"])
        np.testing.assert_allclose(port[f"arch/{arch}/8x1"], plain,
                                   rtol=1e-5)
    else:
        np.testing.assert_allclose(port[f"arch/{arch}/2x4"], plain,
                                   rtol=1e-5)


def test_elastic_restore(runs):
    """A checkpoint saved on (2, 4) restores onto (4, 2) and onto no mesh
    bit-equal, and the reference's ``restore`` reads it."""
    port = runs.port
    assert int(port["ckpt/step"]) == 1
    assert bool(port["ckpt/onto_4x2"])
    assert bool(port["ckpt/4x2_layouts"])
    assert bool(port["ckpt/onto_none"])
    rc = dataclasses.replace(RC.get_smoke_config("phi4_mini_3_8b"),
                             dtype="float32")
    from repro.train import TrainState, init_opt_state
    import jax
    rp = RPm.init_params(r_get_model(rc).schema, jax.random.PRNGKey(0))
    got, step = r_ckpt.restore(str(runs.ckpt), TrainState(
        rp, init_opt_state(rp)))
    assert step == 1
    flat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}" if path else k)
        else:
            flat[path] = np.asarray(t)
    walk(got.params, "")
    want = _leaves(port, "sp/new_params/")
    assert set(flat) == set(want)
    for k in want:
        assert np.array_equal(flat[k], want[k]), k


@pytest.mark.parametrize("name", ["sp", "ep", "hy"])
def test_serve_matches_reference_sharded(runs, name):
    """Sharded prefill (B 4 x T 16) and 4 decode ticks on (2, 4), the
    cache laid out by its schema: phi4-mini ("sp", the sequence of a full
    attention cache split over "model"), deepseek-v2-lite ("ep", MLA's
    latent cache and the expert-parallel MoE, capacity 8) and hymba ("hy",
    the SSM state split by heads and channels, a sliding window), against
    the reference's jitted prefill and decode on its (2, 4) mesh: every
    step's logits and the gathered cache within 1e-5 relative (of each
    array's largest value)."""
    ref, port = runs.ref, runs.port
    keys = [k for k in ref if k.startswith(f"serve/{name}/")]
    assert len([k for k in keys if "/logits" in k]) == 5
    for k in keys:
        r, p = ref[k], port[k]
        assert r.shape == p.shape, k
        np.testing.assert_allclose(p, r, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(r).max(), 1e-30),
                                   err_msg=k)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_serves_under_the_mesh(runs, arch):
    """Each SMOKE config's prefill (B 8 x T 16) and 2 decode ticks under SP
    on (2, 4) against the port's unsharded run (the MoE families at
    capacity 8: the expert-parallel capacity is each shard's, and no slot
    drops on either path): logits and every cache leaf within 1e-5 of
    their largest value, the int leaves equal."""
    port = runs.port
    assert float(port[f"serve_all/{arch}/logits_err"]) <= 1e-5
    assert float(port[f"serve_all/{arch}/cache_err"]) <= 1e-5
    assert bool(port[f"serve_all/{arch}/int_leaves_equal"])
