"""Deterministic synthetic token pipeline.

Port of ``repro/data/tokens.py``. Batches are pure functions of (seed,
step, shard): restart-exact replay with no pipeline state. The marginal
is Zipf-like over the vocab (a squared uniform), and every 4th token
repeats the one two back, so an LM's loss can fall.

The draws come from CPU ``torch.Generator``s seeded from (seed, step,
shard), so a batch is the same on every device: the uniforms of the
tokens, and for an encoder-decoder's ``frames`` or a VLM's ``context``
N(0, 1) draws in f32 from a generator of their own (the reference folds
1 and 2 into the batch's key), cast to the compute dtype. ``jax.random``'s
draws differ, so a test that needs the reference's batch passes its draws
as ``u`` and ``normal``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device


def batch_seed(seed: int, step: int, shard: int, *fold: int) -> int:
    """The generator seed of batch (seed, step, shard) (with ``fold``, of
    one of its extra streams)."""
    return int(np.random.SeedSequence((seed, step, shard) + fold
                                      ).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def _as_f32(a, shape: tuple, dev, name: str) -> torch.Tensor:
    a = (a if isinstance(a, torch.Tensor)
         else torch.tensor(np.asarray(a))).to(device=dev, dtype=torch.float32)
    if tuple(a.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(a.shape)}, want {shape}")
    return a


def make_batch(cfg, *, batch: int, seq: int, step: int, seed: int = 0,
               shard: int = 0, u: Optional[torch.Tensor] = None,
               normal: Optional[torch.Tensor] = None, device=None) -> dict:
    """One (batch, seq) batch of ``tokens`` and next-token ``targets``.

    Parameters
    ----------
    cfg : ModelConfig
        Its ``vocab_size`` bounds the ids; an encoder-decoder's batch also
        carries ``frames``, a cross-attention model's ``context``.
    batch, seq, step, seed, shard : int
        The batch is a pure function of (seed, step, shard) (the
        reference's ``n_shards`` picks nothing, so the port has none).
    u : torch.Tensor, optional
        The (batch, seq + 1) f32 uniform draws to use instead of the
        generator's (a test replays ``jax.random``'s here).
    normal : torch.Tensor, optional
        The (batch, n_context_tokens, d_model) f32 N(0, 1) draws of
        ``frames``/``context`` to use instead of the generator's.
    device : str or torch.device, optional
        ``None`` = ``cuda``.

    Returns
    -------
    dict
        ``tokens`` and ``targets`` (batch, seq) int32 on ``device``, and
        ``frames`` or ``context`` (batch, n_context_tokens, d_model) in
        the compute dtype.
    """
    dev = resolve_device(device)
    v = cfg.vocab_size
    if u is None:
        gen = torch.Generator().manual_seed(batch_seed(seed, step, shard))
        u = torch.rand((batch, seq + 1), generator=gen, dtype=torch.float32)
    u = _as_f32(u, (batch, seq + 1), dev, "u")
    toks = torch.clamp((u * u * v).to(torch.int32), max=v - 1)
    # copy structure: every 4th token repeats t-2 (a learnable signal)
    idx = torch.arange(seq + 1, device=dev)
    toks = torch.where((idx % 4 == 0) & (idx >= 2),
                       torch.roll(toks, 2, dims=1), toks)
    out = {"tokens": toks[:, :seq], "targets": toks[:, 1:]}
    if cfg.encoder_decoder or cfg.cross_attn_period:
        name, fold = (("frames", 1) if cfg.encoder_decoder
                      else ("context", 2))
        shape = (batch, cfg.n_context_tokens, cfg.d_model)
        if normal is None:
            gen = torch.Generator().manual_seed(
                batch_seed(seed, step, shard, fold))
            normal = torch.randn(shape, generator=gen, dtype=torch.float32)
        out[name] = _as_f32(normal, shape, dev, "normal").to(
            getattr(torch, cfg.dtype))
    return out
