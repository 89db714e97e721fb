"""Mixture-of-Experts FFN with token-choice top-k routing.

Port of ``repro/models/moe.py``'s single-device path (``_moe_ffn_dense``,
the semantics of record). Dispatch avoids the GShard (T, E, C) one-hot
cube: positions-in-expert come from a cumsum over a (T·k, E) one-hot,
tokens are written into per-expert capacity buffers (E, C, D) and
gathered back. Expert weights are stacked (E, ...); the expert products
are batched matmuls, as the reference's are einsums outside any kernel.
Shared experts (DeepSeek-style) run as one fused dense SwiGLU.

Every shape here follows from the token count alone (``cap`` included),
so the path has no host sync and no data-dependent shape: it is captured
whole in the serving engine's CUDA graph. The reference's
expert-parallel ``_moe_ffn_ep`` and its mesh constraints run only under a
mesh (ROADMAP queue 1 item 2.4); the port runs on one device.

Numerics mirrored from the reference:

* the router logits are the product of x's dtype operands kept in f32,
  as the reference's jitted model computes ``(tokens @ router).astype(
  f32)`` (XLA folds the cast into the product; run op by op, the
  reference would round the logits to x's dtype first);
* ``lax.top_k`` orders by (value desc, index asc): a stable descending
  sort, not ``torch.topk``;
* the gate is renormalised by ``max(sum, 1e-9)``;
* the combine is a scatter-add in x's dtype: a token's k slot outputs
  are added to zero in order j = 0..k-1, each add rounded (``index_add_``
  on CUDA adds in no fixed order, so the port adds k slices in turn).
"""
from __future__ import annotations

import torch

from .config import MoEConfig
from .layers import silu, swiglu
from .params import Spec


def moe_schema(d_model: int, moe: MoEConfig) -> dict:
    e, f = moe.n_experts, moe.d_ff_expert
    sch = {"router": Spec((d_model, e)),
           "w_gate": Spec((e, d_model, f)),
           "w_in": Spec((e, d_model, f)),
           "w_out": Spec((e, f, d_model))}
    if moe.n_shared:
        fs = f * moe.n_shared
        sch.update({"sh_gate": Spec((d_model, fs)),
                    "sh_in": Spec((d_model, fs)),
                    "sh_out": Spec((fs, d_model))})
    return sch


def capacity(n: int, moe: MoEConfig) -> int:
    """Slots an expert holds for n tokens: ``max(8, int(cf·n·k/E))``
    rounded up to a multiple of 8 (the reference's truncation first)."""
    cap = max(8, int(moe.capacity_factor * n * moe.top_k / moe.n_experts))
    return -(-cap // 8) * 8


def route(tokens: torch.Tensor, router: torch.Tensor, moe: MoEConfig):
    """Token-choice routing of tokens (N, D).

    Returns ``(flat_e, flat_g, pos, keep, cap)``: each of the N·k slots'
    expert (int64) and renormalised gate (f32), in token-major, then-k
    order; its position within its expert (the count of earlier slots
    routed there); whether it fits the capacity; and the capacity.
    """
    n = tokens.shape[0]
    k, e = moe.top_k, moe.n_experts
    cap = capacity(n, moe)
    logits = tokens.float() @ router.to(tokens.dtype).float()
    probs = torch.softmax(logits, dim=-1)                      # (N, E)
    gate, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
    gate, expert_idx = gate[:, :k], expert_idx[:, :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat_e = expert_idx.reshape(-1)                            # (N·k,)
    flat_g = gate.reshape(-1)
    oh = (flat_e[:, None] == torch.arange(e, device=tokens.device)
          ).to(torch.int32)                                    # (N·k, E)
    pos = ((torch.cumsum(oh, dim=0) - 1) * oh).sum(-1)         # (N·k,)
    return flat_e, flat_g, pos, pos < cap, cap


def combine(weighted: torch.Tensor, k: int) -> torch.Tensor:
    """(N·k, D) weighted slot outputs, token-major -> (N, D): each token's
    k slots added to zero in order j = 0..k-1, each add rounded in their
    dtype (the reference's scatter-add, bit for bit)."""
    sw = weighted.view(-1, k, weighted.shape[-1])
    y = torch.zeros_like(sw[:, 0])
    for j in range(k):
        y = y + sw[:, j]
    return y


def moe_ffn(x: torch.Tensor, p: dict, moe: MoEConfig) -> torch.Tensor:
    """x (B, T, D) -> (B, T, D). Token-choice top-k with capacity drop:
    a slot past its expert's capacity contributes zero."""
    b, t, d = x.shape
    n, k, e = b * t, moe.top_k, moe.n_experts
    dt = x.dtype
    tokens = x.reshape(n, d)
    flat_e, flat_g, pos, keep, cap = route(tokens, p["router"], moe)
    token_of_slot = torch.arange(n * k, device=x.device) // k

    # scatter tokens into the expert buffers: the kept (expert, position)
    # pairs are distinct, so a plain write is the reference's add to zero;
    # a dropped slot goes to a spare row C, cut off after
    buf = torch.zeros((e, cap + 1, d), dtype=dt, device=x.device)
    buf[flat_e, torch.where(keep, pos, cap)] = tokens[token_of_slot]
    buf = buf[:, :cap]                                         # (E, C, D)

    h = silu(torch.bmm(buf, p["w_gate"].to(dt))) * torch.bmm(
        buf, p["w_in"].to(dt))
    out = torch.bmm(h, p["w_out"].to(dt))                      # (E, C, D)

    # gather back + weighted combine
    slot_out = out[flat_e, torch.clamp(pos, max=cap - 1)]      # (N·k, D)
    w = (flat_g * keep).to(dt)[:, None]
    y = combine(slot_out * w, k)
    if moe.n_shared:
        y = y + swiglu(tokens, p["sh_gate"].to(dt), p["sh_in"].to(dt),
                       p["sh_out"].to(dt))
    return y.reshape(b, t, d)
