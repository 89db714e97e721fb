"""The rank body of ``tests/test_torch_sharding.py``'s gloo world.

Imports no JAX (the spawned ranks must not): the reference's parameters
and batches reach it as an npz. Every rank runs
:func:`run`; rank 0 writes what the test checks to ``out`` (an npz).
"""
import dataclasses
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

def _tree(npz, prefix: str) -> dict:
    """The tree of tensors stored under ``prefix/`` (paths joined by /)."""
    out: dict = {}
    for key in npz.files:
        if not key.startswith(prefix + "/"):
            continue
        node = out
        *path, leaf = key[len(prefix) + 1:].split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = torch.from_numpy(np.array(npz[key]))
    return out


def _put(out: dict, prefix: str, tree) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _put(out, f"{prefix}/{k}", v)
        else:
            out[f"{prefix}/{k}"] = _full(v).detach().numpy()


def _full(x):
    from repro_torch.dist.sharding import is_dtensor
    return x.full_tensor() if is_dtensor(x) else x


def _loss_and_grads(model, params, batch):
    from repro_torch.models.params import tree_leaves, tree_unflatten
    xs = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = model.loss(tree_unflatten(params, xs), batch)
    gs = torch.autograd.grad(loss, xs, materialize_grads=True)
    return loss.detach(), tree_unflatten(params, gs)


def _sp_pair(mesh, out: dict) -> None:
    """sp_gather/sp_scatter against the identity: values, layouts and the
    backward of a column-parallel product through the pair."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.dist import sharding as sh
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 8, 6, generator=g)
    w = torch.randn(6, 8, generator=g)
    sh.enable(("data",), sp=True, mesh=mesh)
    try:
        xd = distribute_tensor(x, mesh, [Shard(0), Shard(1)]
                               ).requires_grad_()
        y = sh.sp_gather(xd)
        back = sh.sp_scatter(y)
        out["pair/gather_layout"] = np.array(
            tuple(y.placements) == (Shard(0), Replicate()))
        out["pair/scatter_layout"] = np.array(
            tuple(back.placements) == (Shard(0), Shard(1)))
        out["pair/fwd_err"] = np.array(max(
            float((y.full_tensor() - x).abs().max()),
            float((back.full_tensor() - x).abs().max())))
        z = sh.col_parallel(y, distribute_tensor(w, mesh, [Shard(0),
                                                           Shard(1)]))
        torch.sum(z.to_local()).backward()
        want = torch.ones(4, 8, 8) @ w.T
        out["pair/grad_layout"] = np.array(
            tuple(xd.grad.placements) == (Shard(0), Shard(1)))
        out["pair/bwd_err"] = np.array(float(
            (xd.grad.full_tensor() - want).abs().max()))
        # the identity: a gather then a scatter carries the gradient back
        # unchanged
        xd.grad = None
        torch.sum(sh.sp_scatter(sh.sp_gather(xd)).to_local() * 2.0
                  ).backward()
        out["pair/roundtrip_grad_err"] = np.array(float(
            (xd.grad.full_tensor() - 2.0).abs().max()))
    finally:
        sh.disable()


SERVE_SEQ = 32                 # the decode cache's length


def _serve_run(model, params, batch, nxt, mesh=None) -> tuple:
    """Prefill ``batch`` (its ``tokens``, a VLM's ``context``, Whisper's
    ``frames``) into a cache of ``SERVE_SEQ``, then one decode
    tick a column of ``nxt``: every step's logits and the cache's leaves,
    whole. With ``mesh`` (registered already) the parameters and the cache
    are placed by their schemas."""
    from repro_torch.models.params import distribute, init_params
    b, t = batch["tokens"].shape
    csch = model.cache_schema(b, SERVE_SEQ)
    cache = init_params(csch, device="cpu")
    if mesh is not None:
        params = distribute(params, model.schema, mesh)
        cache = distribute(cache, csch, mesh)
    logits, cache = model.prefill(params, batch, cache)
    steps = [_full(logits)]
    for i in range(nxt.shape[1]):
        logits, cache = model.decode(params, cache, nxt[:, i:i + 1], t + i)
        steps.append(_full(logits))
    return steps, cache


def _serve(rank: int, ref, mesh, out: dict) -> None:
    """Sharded prefill and decode on (2, 4): phi4-mini (a context-parallel
    cache), deepseek-v2-lite (MLA and the expert-parallel MoE, capacity 8)
    and hymba (the SSM state and a sliding window) on the reference's
    parameters and tokens; then every SMOKE config's prefill and 2 decode
    ticks against the port's unsharded run (the MoE families at capacity
    8, so that no slot drops on either path), SP on; only rank 0, which
    writes the results, runs the unsharded one."""
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.data.tokens import make_batch
    from repro_torch.dist import sharding as sh
    from repro_torch.models import get_model
    from repro_torch.models.params import init_params

    def config(arch):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        if cfg.moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=8.0))
        return cfg
    tokens = torch.from_numpy(np.array(ref["serve/tokens"]))
    nxt = torch.from_numpy(np.array(ref["serve/next"]))
    for name, arch in (("sp", "phi4_mini_3_8b"),
                       ("ep", "deepseek_v2_lite_16b"), ("hy", "hymba_1_5b")):
        model = get_model(config(arch))
        sh.enable(("data",), sp=False, model_axis=4, mesh=mesh)
        try:
            steps, cache = _serve_run(model, _tree(ref, f"{name}/params"),
                                      {"tokens": tokens}, nxt, mesh)
        finally:
            sh.disable()
        for i, lg in enumerate(steps):
            out[f"serve/{name}/logits{i}"] = lg.numpy()
        _put(out, f"serve/{name}/cache", cache)
    for arch in ARCH_IDS:
        cfg = config(arch)
        model = get_model(cfg)
        params = init_params(model.schema, torch.Generator().manual_seed(0),
                             device="cpu")
        batch = make_batch(cfg, batch=8, seq=16, step=0, device="cpu")
        batch.pop("targets")
        nxt = batch["tokens"][:, :2]
        sh.enable(("data",), sp=True, mesh=mesh)
        try:
            got, got_cache = _serve_run(model, params, batch, nxt, mesh)
        finally:
            sh.disable()
        flat = {}
        _put(flat, "c", got_cache)             # a gather: every rank
        if rank != 0:
            continue
        want, want_cache = _serve_run(model, params, batch, nxt)
        out[f"serve_all/{arch}/logits_err"] = np.array(max(
            float((a - w).abs().max() / w.abs().max())
            for a, w in zip(got, want)))
        ref_flat = {}
        _put(ref_flat, "c", want_cache)
        out[f"serve_all/{arch}/cache_err"] = np.array(max(
            float(np.abs(flat[k].astype(np.float64) - ref_flat[k]).max()
                  / max(np.abs(ref_flat[k]).max(), 1e-30))
            for k in ref_flat))
        out[f"serve_all/{arch}/int_leaves_equal"] = np.array(all(
            np.array_equal(flat[k], ref_flat[k]) for k in ref_flat
            if ref_flat[k].dtype.kind == "i"))


def run(rank: int, world: int, store_path: str, in_path: str, out_path: str,
        ckpt_dir: str) -> None:
    torch.set_num_threads(1)
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        _run(rank, in_path, out_path, ckpt_dir)
    finally:
        dist.destroy_process_group()


def _run(rank, in_path, out_path, ckpt_dir) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.data.tokens import make_batch
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import normalize_pspec
    from repro_torch.models import get_model
    from repro_torch.models.params import (distribute, init_params, is_spec,
                                           shardings, tree_leaves, tree_map)
    from repro_torch.train import (OptState, TrainConfig, TrainState,
                                   init_opt_state, make_train_step)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    ref = np.load(in_path)
    out: dict = {}
    _sp_pair(mesh, out)

    # phi4-mini SMOKE f32 under SP with grad_pspecs, on the reference's
    # parameters and batch
    cfg = dataclasses.replace(get_smoke_config("phi4_mini_3_8b"),
                              dtype="float32")
    model = get_model(cfg)
    params = _tree(ref, "sp/params")
    batch = _tree(ref, "sp/batch")
    l_plain, g_plain = _loss_and_grads(model, params, batch)
    sh.enable(("data",), sp=True, model_axis=4, mesh=mesh)
    try:
        dparams = distribute(tree_map(torch.clone, params), model.schema,
                             mesh)
        loss, grads = _loss_and_grads(model, dparams, batch)
        out["sp/loss"] = loss.numpy()
        _put(out, "sp/grads", grads)
        gp = tree_map(lambda s: normalize_pspec(s.pspec, mesh, s.shape),
                      model.schema, is_spec)
        lay = shardings(model.schema, mesh)
        out["sp/grad_layouts"] = np.array(all(
            tuple(g.placements) == tuple(s.placements)
            for g, s in zip(tree_leaves(grads), tree_leaves(lay))))
        state = TrainState(dparams, init_opt_state(dparams))
        out["sp/moment_layouts"] = np.array(all(
            tuple(m.placements) == tuple(p.placements) and
            tuple(v.placements) == tuple(p.placements)
            for p, m, v in zip(*map(tree_leaves, (dparams, state.opt.m,
                                                  state.opt.v)))))
        state, met = make_train_step(model, TrainConfig(),
                                     grad_pspecs=gp)(state, batch)
        out["sp/step_loss"] = met["loss"].numpy()
        out["sp/grad_norm"] = met["grad_norm"].numpy()
        _put(out, "sp/new_params", state.params)

        # the elastic restore: saved from (2, 4), restored onto (4, 2) and
        # onto no mesh
        ckpt.save(ckpt_dir, 1, state)
        mesh42 = init_device_mesh("cpu", (4, 2),
                                  mesh_dim_names=("data", "model"))
        lay42 = TrainState(shardings(model.schema, mesh42), OptState(
            shardings(model.schema, mesh42),
            shardings(model.schema, mesh42), None))
        saved = [_full(x) for x in ckpt.tree_flatten(state)]
        on42, step = ckpt.restore(ckpt_dir, state, shardings=lay42,
                                  device="cpu")
        leaves42 = ckpt.tree_flatten(on42)
        out["ckpt/step"] = np.array(step)
        out["ckpt/onto_4x2"] = np.array(all(
            torch.equal(_full(a), b) for a, b in zip(leaves42, saved)))
        out["ckpt/4x2_layouts"] = np.array(all(
            tuple(a.placements) == tuple(s.placements) for a, s in zip(
                tree_leaves(on42.params), tree_leaves(lay42.params))))
        plain, _ = ckpt.restore(ckpt_dir, state, device="cpu")
        out["ckpt/onto_none"] = np.array(all(
            torch.equal(a, b) for a, b in zip(ckpt.tree_flatten(plain),
                                             saved)))
    finally:
        sh.disable()

    # enable/disable leaves the single-device path as it was, bit for bit
    l_again, g_again = _loss_and_grads(model, params, batch)
    out["plain/bit_equal"] = np.array(torch.equal(l_plain, l_again) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(g_plain),
                                          tree_leaves(g_again))))
    out["plain/identity"] = np.array(
        sh.constrain_act(batch["tokens"]) is batch["tokens"] and
        sh.sp_gather(batch["tokens"]) is batch["tokens"])

    # deepseek-v2-lite SMOKE under expert parallelism (capacity 8: no
    # drops), on the reference's parameters and batch
    base = get_smoke_config("deepseek_v2_lite_16b")
    cfg = dataclasses.replace(base, dtype="float32", moe=dataclasses.replace(
        base.moe, capacity_factor=8.0))
    model = get_model(cfg)
    params, batch = _tree(ref, "ep/params"), _tree(ref, "ep/batch")
    sh.enable(("data",), sp=False, model_axis=4, mesh=mesh)
    try:
        with torch.no_grad():
            out["ep/loss"] = model.loss(distribute(
                params, model.schema, mesh), batch).numpy()
    finally:
        sh.disable()

    # every SMOKE config's loss under SP on (2, 4), and the MoE families'
    # on (8, 1) (the dense path under a mesh), against the unsharded loss
    mesh81 = init_device_mesh("cpu", (8, 1), mesh_dim_names=("data",
                                                             "model"))
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        model = get_model(cfg)
        params = init_params(model.schema, torch.Generator().manual_seed(0),
                             device="cpu")
        batch = make_batch(cfg, batch=8, seq=16, step=0, device="cpu")
        with torch.no_grad():
            out[f"arch/{arch}/plain"] = model.loss(params, batch).numpy()
            meshes = [("2x4", mesh)] + ([("8x1", mesh81)] if cfg.moe
                                        else [])
            for name, m in meshes:
                sh.enable(("data",), sp=True, mesh=m)
                try:
                    out[f"arch/{arch}/{name}"] = model.loss(distribute(
                        params, model.schema, m), batch).numpy()
                finally:
                    sh.disable()
    _serve(rank, ref, mesh, out)
    if rank == 0:
        tmp = out_path + ".tmp.npz"
        np.savez(tmp, **out)
        os.replace(tmp, out_path)
