"""Family-dispatch API: one entry point per model kind.

Port of ``repro/models/api.py``: ``get_model(cfg)`` returns a
:class:`ModelAPI` whose callables hide the family differences
(decoder-only, cross-attention VLM, encoder-decoder) from the serving
loop (``serve/engine.py``) and the trainer (``train/steps.py``). ``loss``
is differentiable (autograd records it unless the caller turns it off);
``prefill`` and ``decode`` run under ``torch.inference_mode`` (under a
mesh ``torch.no_grad``). Under a
mesh (``repro_torch.dist.sharding.enable``) ``loss`` takes parameters
placed by ``params.distribute`` and the global batch, and returns the
global loss on every rank; ``prefill`` and ``decode`` take parameters so
placed (the training layout or a serving one), a cache placed by the
cache schema's layouts (``params.distribute`` of ``init_params`` of it)
and the global tokens, write the cache in place in its layout and return
the logits (B, V), batch-sharded.

Weights, caches and a training state carry across from the reference as
numpy trees (:func:`params_from_reference`, :func:`cache_from_reference`,
:func:`train_state_from_reference`), so the CPU tests hold the port to
``repro`` on the same parameters.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..dist import sharding as shmod
from . import transformer, whisper
from .config import ModelConfig
from .params import P, Spec, is_spec, tree_map


class ModelAPI(NamedTuple):
    """A model family's callables over one config."""

    cfg: ModelConfig
    schema: dict                       # param Spec tree
    cache_schema: Callable             # (batch, max_seq) -> Spec tree
    batch_schema: Callable             # (batch, seq) -> Spec tree (inputs)
    loss: Callable                     # (params, batch) -> scalar loss
    prefill: Callable                  # (params, batch, cache) -> (logits, cache)
    decode: Callable                   # (params, cache, token, pos) -> (logits, cache)


def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy. logits (B, T, V) f32, targets (B, T).
    For DTensor logits (batch-sharded, under a mesh) the mean of the
    shards' means, a plain 0-dim tensor on every rank."""
    if shmod.is_dtensor(logits):
        return shmod.batch_mean(_xent, logits,
                                shmod.constrain_batch(targets, None))
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets.long()[..., None],
                                dim=-1)[..., 0]
    return torch.mean(lse - gold)


def _serving():
    """Prefill's and decode's autograd mode: ``inference_mode``; under a
    mesh ``no_grad`` (a DTensor's views cannot be made of inference
    tensors)."""
    return torch.no_grad() if shmod.mesh() is not None else \
        torch.inference_mode()


def _token_batch_schema(cfg: ModelConfig):
    def make(batch: int, seq: int) -> dict:
        rows = P(("pod", "data"), None)
        sch = {"tokens": Spec((batch, seq), "zeros", torch.int32, rows),
               "targets": Spec((batch, seq), "zeros", torch.int32, rows)}
        ctx = (batch, cfg.n_context_tokens, cfg.d_model)
        ctx_p = P(("pod", "data"), None, None)
        if cfg.encoder_decoder:
            sch["frames"] = Spec(ctx, "normal", cfg.dtype, ctx_p)
        elif cfg.cross_attn_period:
            sch["context"] = Spec(ctx, "normal", cfg.dtype, ctx_p)
        return sch
    return make


def get_model(cfg: ModelConfig) -> ModelAPI:
    """The API of ``cfg``'s family: encoder-decoder (Whisper) or
    decoder-only (every other, a VLM's batches carrying ``context``)."""
    if cfg.encoder_decoder:
        return _whisper_api(cfg)
    return _decoder_api(cfg)


def _decoder_api(cfg: ModelConfig) -> ModelAPI:
    schema = transformer.model_schema(cfg)

    def loss(params, batch):
        x = transformer.forward(cfg, params, batch["tokens"],
                                context=batch.get("context"))
        logits = transformer.lm_logits(cfg, params, x)
        return _xent(logits, batch["targets"])

    def prefill_fn(params, batch, cache):
        with _serving():
            return transformer.prefill(cfg, params, batch["tokens"], cache,
                                       context=batch.get("context"))

    def decode_fn(params, cache, token, pos):
        with _serving():
            return transformer.decode(cfg, params, cache, token, pos)

    return ModelAPI(
        cfg=cfg, schema=schema,
        cache_schema=lambda b, s: transformer.init_cache_schema(cfg, b, s),
        batch_schema=_token_batch_schema(cfg),
        loss=loss, prefill=prefill_fn, decode=decode_fn)


def _whisper_api(cfg: ModelConfig) -> ModelAPI:
    schema = whisper.model_schema(cfg)

    def loss(params, batch):
        enc = whisper.encode(cfg, params, batch["frames"])
        x = whisper.decoder_forward(cfg, params, batch["tokens"], enc)
        logits = transformer.lm_logits(cfg, params, x)
        return _xent(logits, batch["targets"])

    def prefill_fn(params, batch, cache):
        with _serving():
            return whisper.prefill(cfg, params, batch["frames"],
                                   batch["tokens"], cache)

    def decode_fn(params, cache, token, pos):
        with _serving():
            return whisper.decode(cfg, params, cache, token, pos)

    return ModelAPI(
        cfg=cfg, schema=schema,
        cache_schema=lambda b, s: whisper.init_cache_schema(
            cfg, b, s, cfg.n_context_tokens),
        batch_schema=_token_batch_schema(cfg),
        loss=loss, prefill=prefill_fn, decode=decode_fn)


# --------------------------------------------------------------------------
# weights and state carried across from the reference
# --------------------------------------------------------------------------


def _tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":            # ml_dtypes: no numpy view
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(dev)


def _from_tree(tree, schema, dev, what: str):
    def check(path, sch, sub):
        if is_spec(sch):
            shape = tuple(np.shape(sub))
            if shape != tuple(sch.shape):
                raise ValueError(f"{what}: {path} has shape {shape}, the "
                                 f"schema {tuple(sch.shape)}")
            return
        if not isinstance(sub, dict) or set(sub) != set(sch):
            raise ValueError(f"{what}: {path or 'the tree'} has keys "
                             f"{sorted(sub) if isinstance(sub, dict) else sub!r}"
                             f", the schema {sorted(sch)}")
        for k in sch:
            check(f"{path}/{k}", sch[k], sub[k])
    check("", schema, tree)
    return tree_map(lambda a: _tensor(a, dev), tree)


def params_from_reference(tree, cfg: ModelConfig, device=None) -> dict:
    """The reference's parameter pytree as the port's parameters.

    Parameters
    ----------
    tree : nested dict of numpy arrays
        ``repro``'s params (``jax.tree.map(np.asarray, params)``), with
        the stacked leaves as the port keeps them: ``blocks`` (L, ...), a
        VLM's ``blocks`` (groups, self blocks, ...) and ``cross_blocks``
        (groups, ...), Whisper's ``enc_blocks``/``dec_blocks``. Checked
        leaf by leaf against the family's schema.
    cfg : ModelConfig
    device : str or torch.device, optional
        ``None`` = ``cuda``.

    Returns
    -------
    dict
        The same tree of tensors, values bit-equal to the source.
    """
    return _from_tree(tree, get_model(cfg).schema, resolve_device(device),
                      "params")


def cache_from_reference(tree, cfg: ModelConfig, device=None) -> dict:
    """The reference's decode cache as the port's, so that decode can go
    on from a cache the reference filled: ``{"blocks": ...}`` with the
    family's leaves (``k``/``v``[/``kpos``], ``ckv``/``kr``,
    ``conv``/``ssm``, Whisper's ``xk``/``xv``) stacked (L, B, ...), or a
    VLM's (groups, self blocks, B, ...) beside ``cross_k``/``cross_v``
    (groups, B, ...). Checked against the family's cache schema at the
    tree's own batch and length."""
    blocks = tree["blocks"]
    lead = 2 if cfg.cross_attn_period else 1
    if "k" in blocks or "ckv" in blocks:
        shape = np.shape(blocks["k" if "k" in blocks else "ckv"])
        batch, seq = shape[lead], shape[lead + 1]
    else:                                   # an SSM's state has no length
        batch, seq = np.shape(blocks["conv"])[lead], 1
    schema = get_model(cfg).cache_schema(batch, seq)
    return _from_tree(tree, schema, resolve_device(device), "cache")


def train_state_from_reference(tree, cfg: ModelConfig, device=None):
    """The reference's ``TrainState`` as the port's
    (:class:`repro_torch.train.TrainState`), so that both packages step
    from the same state.

    Parameters
    ----------
    tree : (params, (m, v, step)) of numpy arrays
        ``jax.tree.map(np.asarray, state)`` of a ``repro.train``
        ``TrainState`` (its NamedTuples unpack as such pairs): ``params``,
        ``m`` and ``v`` checked leaf by leaf against the family's schema
        (as :func:`params_from_reference`), ``step`` a 0-dim int32.
    cfg : ModelConfig
    device : str or torch.device, optional
        ``None`` = ``cuda``.

    Returns
    -------
    TrainState
        Values bit-equal to the source.
    """
    from ..train import OptState, TrainState
    params, (m, v, step) = tree
    dev = resolve_device(device)
    schema = get_model(cfg).schema
    if np.shape(step) != ():
        raise ValueError(f"opt/step has shape {np.shape(step)}, want ()")
    return TrainState(
        params=_from_tree(params, schema, dev, "params"),
        opt=OptState(m=_from_tree(m, schema, dev, "opt/m"),
                     v=_from_tree(v, schema, dev, "opt/v"),
                     step=_tensor(np.asarray(step, np.int32), dev)))
