"""Mixture-of-Experts FFN with token-choice top-k routing.

Port of ``repro/models/moe.py``: the single-device path
(``_moe_ffn_dense``, the semantics of record) and, under a mesh, the
expert-parallel path. Dispatch avoids the GShard (T, E, C) one-hot
cube: positions-in-expert come from a cumsum over a (T·k, E) one-hot,
tokens are written into per-expert capacity buffers (E, C, D) and
gathered back. Expert weights are stacked (E, ...); the expert products
are batched matmuls, as the reference's are einsums outside any kernel.
Shared experts (DeepSeek-style) run as one fused dense SwiGLU.

Every shape here follows from the token count alone (``cap`` included),
so the path has no host sync and no data-dependent shape: it is captured
whole in the serving engine's CUDA graph.

Under a mesh (DTensor activations, ``repro_torch.dist.sharding``) with a
"model" axis m > 1 that divides the expert count, :func:`moe_ffn` takes
the expert-parallel path (:func:`_moe_ffn_ep`, the reference's
``shard_map``): tokens batch-sharded and replicated over "model", each
model rank routes its batch shard, dispatches only to its E/m experts
with a capacity of its own shard's tokens, and adds a partial combine;
one all-reduce over "model" finishes the layer, the shared experts'
column/row-parallel partial sums with it. Any other mesh runs the
dense path on the whole batch gathered (its capacity and positions are
the global batch's, as the reference's partitioned program computes
them), the experts gathered whole.

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

from ..dist import sharding as shmod
from .config import MoEConfig
from .layers import silu, swiglu
from .params import P, Spec


def moe_schema(d_model: int, moe: MoEConfig) -> dict:
    e, f = moe.n_experts, moe.d_ff_expert
    sch = {"router": Spec((d_model, e), pspec=P("data", None)),
           "w_gate": Spec((e, d_model, f), pspec=P("model", "data", None)),
           "w_in": Spec((e, d_model, f), pspec=P("model", "data", None)),
           "w_out": Spec((e, f, d_model), pspec=P("model", None, "data"))}
    if moe.n_shared:
        fs = f * moe.n_shared
        sch.update({"sh_gate": Spec((d_model, fs), pspec=P("data", "model")),
                    "sh_in": Spec((d_model, fs), pspec=P("data", "model")),
                    "sh_out": Spec((fs, d_model), pspec=P("model", "data"))})
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
    a slot past its expert's capacity contributes zero. A DTensor x takes
    the expert-parallel path where the mesh allows it, else the dense
    path on the gathered batch."""
    if shmod.is_dtensor(x):
        if shmod.batch_axes() is not None and shmod.model_axis() > 1 \
                and moe.n_experts % shmod.model_axis() == 0:
            return _moe_ffn_ep(x, p, moe)
        whole = shmod.constrain(x, None, None, None)
        return shmod.local(lambda xl, pl: _moe_ffn_dense(xl, pl, moe),
                           whole, shmod.replicated(p))
    return _moe_ffn_dense(x, p, moe)


def _moe_ffn_ep(x, p: dict, moe: MoEConfig):
    """Expert-parallel: x batch-sharded and replicated over "model"; each
    model rank dispatches its shard's slots routed to its own E/m experts
    (local ids, a capacity of the shard's tokens), computes them and
    combines them partially; the shared experts run column- then
    row-parallel on every rank's shard (their weights split over "model",
    gathered over the data axes only if the layout splits them there);
    one all-reduce over "model" sums both partial results."""
    from torch.distributed.tensor import Partial
    mesh = shmod.mesh()
    n_local = moe.n_experts // shmod.model_axis()
    lo = mesh.get_local_rank("model") * n_local
    xg = shmod.constrain_batch(x, None, None)
    w = {"router": shmod.replicated(p["router"])}
    w.update({k: shmod.constrain(p[k], "model", None, None)
              for k in ("w_gate", "w_in", "w_out")})
    out = list(xg.placements)
    out[mesh.mesh_dim_names.index("model")] = Partial()

    def run(xl, wl):
        b, t, d = xl.shape
        tokens = xl.reshape(b * t, d)
        flat_e, flat_g, pos, keep, cap = route(tokens, wl["router"], moe)
        le = flat_e - lo                                    # local ids
        mine = (le >= 0) & (le < n_local)
        return _experts(tokens, wl, moe, torch.clamp(le, 0, n_local - 1),
                        flat_g, pos, keep & mine, cap, n_local
                        ).reshape(b, t, d)
    y = shmod.local(run, xg, w, out=tuple(out))
    if moe.n_shared:
        # the shared experts column- then row-parallel: their weights stay
        # split over "model", their partial sums join the routed ones'
        h = shmod._col(xg, p["sh_gate"], p["sh_in"],
                       fn=lambda g, u: silu(g) * u)
        y = y + shmod._row(h, p["sh_out"])
    return shmod.constrain_batch(y, None, None)              # the psum


def _experts(tokens, p: dict, moe: MoEConfig, flat_e, flat_g, pos, keep,
             cap: int, n_experts: int) -> torch.Tensor:
    """The routed slots through ``n_experts`` experts' capacity buffers
    and the weighted combine: tokens (N, D) -> (N, D)."""
    n, d = tokens.shape
    k, dt = moe.top_k, tokens.dtype
    token_of_slot = torch.arange(n * k, device=tokens.device) // k

    # scatter tokens into the expert buffers: the kept (expert, position)
    # pairs are distinct, so a plain write is the reference's add to zero;
    # a dropped slot goes to a spare row C, cut off after
    buf = torch.zeros((n_experts, cap + 1, d), dtype=dt,
                      device=tokens.device)
    buf[flat_e, torch.where(keep, pos, cap)] = tokens[token_of_slot]
    buf = buf[:, :cap]                                         # (E, C, D)

    h = silu(torch.bmm(buf, p["w_gate"].to(dt))) * torch.bmm(
        buf, p["w_in"].to(dt))
    out = torch.bmm(h, p["w_out"].to(dt))                      # (E, C, D)

    # gather back + weighted combine
    slot_out = out[flat_e, torch.clamp(pos, max=cap - 1)]      # (N·k, D)
    w = (flat_g * keep).to(dt)[:, None]
    return combine(slot_out * w, k)


def _shared(x, p: dict) -> torch.Tensor:
    """The shared experts: one SwiGLU over x's (B·T, D) rows."""
    b, t, d = x.shape
    dt = x.dtype
    return swiglu(x.reshape(b * t, d), p["sh_gate"].to(dt),
                  p["sh_in"].to(dt), p["sh_out"].to(dt)).reshape(b, t, d)


def _moe_ffn_dense(x: torch.Tensor, p: dict, moe: MoEConfig) -> torch.Tensor:
    """The single-device path (semantics of record)."""
    b, t, d = x.shape
    tokens = x.reshape(b * t, d)
    flat_e, flat_g, pos, keep, cap = route(tokens, p["router"], moe)
    y = _experts(tokens, p, moe, flat_e, flat_g, pos, keep, cap,
                 moe.n_experts).reshape(b, t, d)
    if moe.n_shared:
        y = y + _shared(x, p)
    return y
