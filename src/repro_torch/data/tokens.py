"""Deterministic synthetic token pipeline.

Port of ``repro/data/tokens.py``. Batches are pure functions of (seed,
step, shard): restart-exact replay with no pipeline state. The marginal
is Zipf-like over the vocab (a squared uniform), and every 4th token
repeats the one two back, so an LM's loss can fall.

The uniform draws come from a CPU ``torch.Generator`` seeded from (seed,
step, shard), so a batch is the same on every device; ``jax.random``'s
draws differ, so a test that needs the reference's tokens passes its
draws as ``u``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device


def batch_seed(seed: int, step: int, shard: int) -> int:
    """The generator seed of batch (seed, step, shard)."""
    return int(np.random.SeedSequence((seed, step, shard)).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def make_batch(cfg, *, batch: int, seq: int, step: int, seed: int = 0,
               shard: int = 0, u: Optional[torch.Tensor] = None,
               device=None) -> dict:
    """One (batch, seq) batch of ``tokens`` and next-token ``targets``.

    Parameters
    ----------
    cfg : ModelConfig
        Its ``vocab_size`` bounds the ids. An encoder-decoder or
        cross-attention config (whose batches carry ``frames`` or
        ``context``) raises ``NotImplementedError``.
    batch, seq, step, seed, shard : int
        The batch is a pure function of (seed, step, shard) (the
        reference's ``n_shards`` picks nothing, so the port has none).
    u : torch.Tensor, optional
        The (batch, seq + 1) f32 uniform draws to use instead of the
        generator's (a test replays ``jax.random``'s here).
    device : str or torch.device, optional
        ``None`` = ``cuda``.

    Returns
    -------
    dict
        ``tokens`` and ``targets`` (batch, seq) int32 on ``device``.
    """
    if cfg.encoder_decoder or cfg.cross_attn_period:
        raise NotImplementedError(
            f"{cfg.name}: frames/context batches are not ported to "
            f"repro_torch yet; see ROADMAP queue 1 item 2.2")
    dev = resolve_device(device)
    v = cfg.vocab_size
    if u is None:
        gen = torch.Generator().manual_seed(batch_seed(seed, step, shard))
        u = torch.rand((batch, seq + 1), generator=gen, dtype=torch.float32)
    u = (u if isinstance(u, torch.Tensor)
         else torch.tensor(np.asarray(u))).to(device=dev, dtype=torch.float32)
    if u.shape != (batch, seq + 1):
        raise ValueError(f"u has shape {tuple(u.shape)}, want "
                         f"{(batch, seq + 1)}")
    toks = torch.clamp((u * u * v).to(torch.int32), max=v - 1)
    # copy structure: every 4th token repeats t-2 (a learnable signal)
    idx = torch.arange(seq + 1, device=dev)
    toks = torch.where((idx % 4 == 0) & (idx >= 2),
                       torch.roll(toks, 2, dims=1), toks)
    return {"tokens": toks[:, :seq], "targets": toks[:, 1:]}
