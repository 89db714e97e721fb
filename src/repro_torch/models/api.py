"""Family-dispatch API: one entry point per model kind.

Port of ``repro/models/api.py`` for the decoder-only dense family:
``get_model(cfg)`` returns a :class:`ModelAPI` whose callables the
serving loop (``serve/engine.py``) drives. ``loss`` runs without autograd
(training is ROADMAP queue 1 item 2.3); an encoder-decoder or
cross-attention config is refused (item 2.2).

Weights and caches carry across from the reference as numpy trees
(:func:`params_from_reference`, :func:`cache_from_reference`), so the
CPU tests hold the port to ``repro`` on the same parameters.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from . import transformer
from .config import ModelConfig
from .params import Spec, is_spec, tree_map


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
    """Mean next-token cross-entropy. logits (B, T, V) f32, targets (B, T)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets.long()[..., None],
                                dim=-1)[..., 0]
    return torch.mean(lse - gold)


def _token_batch_schema(cfg: ModelConfig):
    def make(batch: int, seq: int) -> dict:
        return {"tokens": Spec((batch, seq), "zeros", torch.int32),
                "targets": Spec((batch, seq), "zeros", torch.int32)}
    return make


def get_model(cfg: ModelConfig) -> ModelAPI:
    """The API of a decoder-only dense config (other families raise
    ``NotImplementedError``)."""
    transformer.check_dense(cfg)
    schema = transformer.model_schema(cfg)

    def loss(params, batch):
        with torch.inference_mode():
            x = transformer.forward(cfg, params, batch["tokens"])
            logits = transformer.lm_logits(cfg, params, x)
            return _xent(logits, batch["targets"])

    def prefill_fn(params, batch, cache):
        with torch.inference_mode():
            return transformer.prefill(cfg, params, batch["tokens"], cache)

    def decode_fn(params, cache, token, pos):
        with torch.inference_mode():
            return transformer.decode(cfg, params, cache, token, pos)

    return ModelAPI(
        cfg=cfg, schema=schema,
        cache_schema=lambda b, s: transformer.init_cache_schema(cfg, b, s),
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
        the stacked ``blocks`` leaves of shape (L, ...), as the port keeps
        them. Checked leaf by leaf against ``model_schema(cfg)``.
    cfg : ModelConfig
    device : str or torch.device, optional
        ``None`` = ``cuda``.

    Returns
    -------
    dict
        The same tree of tensors, values bit-equal to the source.
    """
    return _from_tree(tree, transformer.model_schema(cfg),
                      resolve_device(device), "params")


def cache_from_reference(tree, cfg: ModelConfig, device=None) -> dict:
    """The reference's decode cache (``{"blocks": {"k", "v"[, "kpos"]}}``,
    leaves (L, B, S, ...)) as the port's, so that decode can go on from a
    cache the reference filled. Checked against ``init_cache_schema`` at
    the tree's own batch and length."""
    k = tree["blocks"]["k"]
    batch, seq = np.shape(k)[1], np.shape(k)[2]
    schema = transformer.init_cache_schema(cfg, batch, seq)
    return _from_tree(tree, schema, resolve_device(device), "cache")
