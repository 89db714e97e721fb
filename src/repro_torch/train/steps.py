"""Training step factory: loss -> gradients (optionally micro-batched) ->
AdamW.

Port of ``repro/train/steps.py``. Gradients come from autograd over
``model.loss`` (the reference takes ``jax.value_and_grad``); the model's
forward checkpoints each block (``cfg.remat``), so the backward recomputes
a block's activations from its saved input.

* ``grad_dtype="bfloat16"``: the float parameters are cast to bf16 leaves
  and the gradient is taken with respect to those (the backward runs in
  bf16), then cast to f32 for the optimizer.
* ``accum_steps = a > 1``: the batch is split into ``a`` micro-batches
  along its first axis; their losses and f32 gradients are summed in
  order from zero, then divided by ``a``.

The step updates its :class:`TrainState` in place (the optimizer's
in-place form, :func:`repro_torch.train.optimizer.adamw_update_`) and
returns it: a model whose parameters and moments fill the card has no
room for a second copy.

Under a mesh (``repro_torch.dist.sharding.enable``) the state's leaves are
DTensors (``models.params.distribute``; the moments take the parameters'
placements) and every rank passes the same global batch: the model shards
it, and the step's loss and metrics are the global ones on every rank.
``grad_pspecs`` (a tree of pspecs like the parameters, e.g. the schema's
``normalize_pspec``-ed) redistributes each gradient to that layout before
AdamW: from a partial sum over the batch axes that is a reduce-scatter,
each rank receiving only its shard.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..device import resolve_device
from ..dist import sharding as shmod
from ..models.api import ModelAPI
from ..models.params import init_params, tree_leaves, tree_unflatten
from .optimizer import AdamWConfig, OptState, adamw_update_, init_opt_state


class TrainState(NamedTuple):
    params: Any
    opt: OptState


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    accum_steps: int = 1
    grad_dtype: str = "float32"       # "bfloat16": the backward in bf16


def make_train_step(model: ModelAPI, tcfg: TrainConfig,
                    grad_pspecs=None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``state`` is updated in place and returned; ``metrics`` holds
    ``loss`` (f32, the mean over micro-batches), ``grad_norm`` and ``lr``
    (0-dim tensors). ``grad_pspecs``: the gradients' layout on the
    registered mesh (a tree of pspecs matching the parameters); it needs
    a mesh, and raises without one.
    """
    if grad_pspecs is not None and shmod.mesh() is None:
        raise ValueError("grad_pspecs lays the gradients out on a mesh: "
                         "register one (repro_torch.dist.sharding.enable)")
    if tcfg.grad_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"grad_dtype {tcfg.grad_dtype!r}: float32 or "
                         f"bfloat16")

    def grads_of(params, batch):
        """(loss, f32 gradients in ``tree_leaves`` order) of one
        (micro-)batch."""
        xs = [x.detach() for x in tree_leaves(params)]
        if tcfg.grad_dtype == "bfloat16":
            xs = [x.to(torch.bfloat16) if x.dtype == torch.float32 else x
                  for x in xs]
        for x in xs:
            x.requires_grad_()
        with torch.enable_grad():
            loss = model.loss(tree_unflatten(params, xs), batch)
            gs = torch.autograd.grad(loss, xs, materialize_grads=True)
        return loss.detach(), [g.float() for g in gs]

    def train_step(state: TrainState, batch):
        a = tcfg.accum_steps
        if a > 1:
            micro = {k: v.reshape((a, v.shape[0] // a) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=micro["tokens"].device)
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in tree_leaves(state.params)]
            for i in range(a):
                li, gi = grads_of(state.params, {k: v[i] for k, v in
                                                 micro.items()})
                loss = loss + li
                for g, x in zip(grads, gi):
                    g.add_(x)
                del gi
            loss = loss / a
            for g in grads:
                g.div_(a)
        else:
            loss, grads = grads_of(state.params, batch)
        if grad_pspecs is not None:
            grads = [shmod.constrain(g, *spec) for g, spec in
                     zip(grads, tree_leaves(grad_pspecs))]
        metrics = adamw_update_(tcfg.optimizer, state.params,
                                tree_unflatten(state.params, grads),
                                state.opt)
        metrics["loss"] = loss
        return state, metrics

    return train_step


def init_train_state(model: ModelAPI,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> TrainState:
    """Parameters drawn from the model's schema (in their schema dtype,
    f32 master weights) and zero optimizer state, on ``device`` (``None`` =
    ``cuda``). ``generator`` (on that device) draws them; ``None`` seeds
    one with 0."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    params = init_params(model.schema, generator, device=dev)
    return TrainState(params=params, opt=init_opt_state(params))
