"""Shared neural building blocks (plain PyTorch, functional).

Port of ``repro/models/layers.py``. The reference reaches no Pallas kernel
here: its attention is flash-style (double-blocked online softmax) in
``lax.scan``/``lax.map``, so the port is plain tensor code with the
reference's numerics:

* scores are f32 from the operands' values (``preferred_element_type``):
  q and k are upcast before the product, so bf16 operands give exact f32
  products and no bf16 rounding of the scores;
* ``NEG_INF`` is finite (-1e30): a wholly masked flash block gives
  ``exp(0)`` terms that the next block's correction zeroes (``-inf``
  would give NaN);
* the decode and direct paths cast the probabilities to ``v``'s dtype
  before the PV product; the flash path keeps them f32 and casts the
  output to ``q``'s dtype;
* RoPE rotates halves (not interleaved pairs) in f32; ``rms_norm`` casts
  the normalised f32 rows to the input's dtype before the weight.

Given DTensors (the sharded path, ``repro_torch.dist.sharding``)
``rms_norm``, :func:`gqa_qkv`, :func:`attend` and :func:`attn_out` run on
local shards: the projections column-parallel with heads over "model",
the output projection row-parallel. Plain tensors take the plain path,
also inside a function that ``sharding.local`` runs on local shards.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F

from ..dist import sharding as shmod

NEG_INF = -1e30
FAR = 2 ** 30            # the position of a masked-out or padded key


# --------------------------------------------------------------------------
# norms / activations / rope
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """x (..., D) -> RMS-normalised in f32, cast to x's dtype, times weight
    (on local shards for a DTensor x: the rows are independent)."""
    if shmod.is_dtensor(x):
        return shmod.local(rms_norm, x, weight, eps)
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * weight.to(dt)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * (1 / (1 + exp(-x)))``, each step rounded to x's dtype, as
    ``jax.nn.silu`` lowers (``F.silu`` rounds once: another bf16 function)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def swiglu(x, w_gate, w_in, w_out):
    """SwiGLU MLP: (silu(x @ w_gate) * (x @ w_in)) @ w_out."""
    h = silu(x @ w_gate) * (x @ w_in)
    return h @ w_out


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) f32 inverse frequencies ``1 / theta^(2i/hd)``."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def rope_table(positions: torch.Tensor, head_dim: int, theta: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of positions (..., T) x the frequencies, (..., T, 1,
    hd/2) f32: what :func:`apply_rope` rotates by, computed once for every
    layer's q and k."""
    inv = rope_freqs(head_dim, theta, positions.device)   # (hd/2,)
    ang = positions[..., None].float() * inv              # (..., T, hd/2)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4, table=None) -> torch.Tensor:
    """x (..., T, H, hd), positions (..., T) int -> same shape, rotated
    (the two halves of each head, in f32, cast back to x's dtype);
    ``table`` is :func:`rope_table`'s (cos, sin) for these positions."""
    cos, sin = table or rope_table(positions, x.shape[-1], theta)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention — double-blocked online softmax
# --------------------------------------------------------------------------


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, t, h, d = k.shape
    return k[:, :, :, None, :].expand(b, t, h, n_rep, d).reshape(
        b, t, h * n_rep, d)


def _block_mask(q_pos, k_pos, *, causal: bool, window: Optional[int]):
    """(B, Tq, Tk) bool validity mask from (B, Tq)/(B, Tk) positions."""
    m = torch.ones(q_pos.shape + (k_pos.shape[-1],), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        m &= k_pos[..., None, :] > q_pos[..., :, None] - window
    return m


def _valid(q_pos, k_pos, kv_len, *, causal: bool, window: Optional[int]):
    """:func:`_block_mask`, and with ``kv_len`` (B,) only keys below it."""
    m = _block_mask(q_pos, k_pos, causal=causal, window=window)
    if kv_len is not None:
        m &= (k_pos < kv_len[:, None])[:, None, :]
    return m


def _positions(b: int, tq: int, tk: int, q_offset, kv_offset,
               k_positions, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(q_pos (B, Tq), k_pos (B, Tk)) int64: ``q_offset`` scalar or (B,);
    ``k_positions`` (Tk,) or (B, Tk), entries < 0 moved to ``FAR``."""
    q_off = torch.as_tensor(q_offset, device=device).long()
    q_pos = ((q_off[..., None] if q_off.ndim else q_off)
             + torch.arange(tq, device=device))
    q_pos = q_pos.expand(b, tq)
    if k_positions is not None:
        kp = k_positions.long()
        kp = torch.where(kp < 0, FAR, kp)
        k_pos = (kp if kp.ndim == 2 else kp[None]).expand(b, tk)
    else:
        k_pos = (kv_offset + torch.arange(tk, device=device))[None].expand(
            b, tk)
    return q_pos, k_pos


def decode_mask(pos: torch.Tensor, tk: int) -> torch.Tensor:
    """The (B, 1, Tk) mask of one causal decode step at per-row positions
    pos (B,) against a preallocated cache of Tk slots valid up to pos
    (``attention(..., q_offset=pos, kv_len=pos + 1)``'s): the same for
    every layer of a tick, so made once."""
    q_pos, k_pos = _positions(pos.shape[0], 1, tk, pos, 0, None, pos.device)
    return _valid(q_pos, k_pos, pos.long() + 1, causal=True, window=None)


def update_index(pos: torch.Tensor, s: int, t: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows (B, 1), cols (B, T)) of a T-token write at per-batch start pos
    into S slots, placed as ``lax.dynamic_update_slice`` places it: a
    negative start counts from the end, and the start is clamped to
    [0, S - T]."""
    start = pos.long()
    start = torch.where(start < 0, start + s, start).clamp(0, s - t)
    rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
    return rows, start[:, None] + torch.arange(t, device=pos.device)


def split_update(arr: torch.Tensor, vals: torch.Tensor, pos: torch.Tensor,
                 s_total: int, lo: int) -> None:
    """The decode write of vals (B, 1, ...) at per-row pos into this rank's
    part arr (B, S_loc, ...) of a cache of ``s_total`` slots whose slots
    ``lo .. lo + S_loc - 1`` it holds (inside a function that
    ``sharding.local`` runs): the slot placed as :func:`update_index`
    places it in the whole cache, and written only on the rank that holds
    it."""
    rows, cols = update_index(pos, s_total, vals.shape[1])
    n = arr.shape[1]
    slot = cols - lo
    mine = (slot >= 0) & (slot < n)
    slot = slot.clamp(0, n - 1)
    mine = mine.view(mine.shape + (1,) * (vals.ndim - 2))
    arr[rows, slot] = torch.where(mine, vals.to(arr.dtype), arr[rows, slot])


def grouped_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: torch.Tensor, seq_split: bool = False
                      ) -> torch.Tensor:
    """:func:`attention`'s decode path (Tq <= 4) under its (B, Tq, Tk)
    validity mask: the G = H // KVH query heads of a KV head contract
    against the unrepeated K/V in one product, (B, KVH, G·Tq, hd) f32
    against (B, KVH, Tk, hd) f32, and the probabilities, cast to v's dtype,
    against V. Returns (B, Tq, H, hd_v).

    ``seq_split``: k, v and the mask are this rank's part of a cache whose
    sequence is split over "model" (inside a function that
    ``sharding.local`` runs): the softmax combines the parts' max and sum
    of exponentials, and the weighted V is summed over "model", so every
    rank returns the attention over the whole cache."""
    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    g = h // kvh
    qg = q.reshape(b, tq, kvh, g, hd).permute(0, 2, 3, 1, 4).reshape(
        b, kvh, g * tq, hd).float()
    kf = k.transpose(1, 2).to(torch.float32,
                              memory_format=torch.contiguous_format)
    s = torch.matmul(qg, kf.transpose(-1, -2)).view(
        b, kvh, g, tq, tk) * (1.0 / (hd ** 0.5))
    s = torch.where(mask[:, None, None], s, NEG_INF)
    if seq_split:
        p = shmod.split_softmax(s).to(v.dtype)
    else:
        p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.matmul(p.view(b, kvh, g * tq, tk), v.transpose(1, 2))
    if seq_split:
        o = shmod.model_reduce(o)
    return o.view(b, kvh, g, tq, hd_v).permute(0, 3, 1, 2, 4).reshape(
        b, tq, h, hd_v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset=0, kv_offset: int = 0,
              kv_len: Optional[torch.Tensor] = None,
              k_positions: Optional[torch.Tensor] = None,
              chunk: int = 1024) -> torch.Tensor:
    """q (B, Tq, H, hd); k/v (B, Tk, KVH, hd) -> (B, Tq, H, hd_v).

    - GQA: the KVH heads serve H // KVH query heads each.
    - ``q_offset``/``kv_offset``: absolute positions (decode: q_offset=pos,
      a scalar or per-batch (B,) tensor).
    - ``kv_len``: optional (B,) or scalar valid length of k/v (decode
      against a preallocated cache, which is masked whole, not sliced).
    - ``k_positions``: explicit absolute position per KV slot (ring-buffer
      SWA caches); entries < 0 are masked out.

    Three paths, as the reference's: Tq <= 4 contracts grouped query heads
    against the unrepeated K/V (decode); Tk <= 2*chunk computes the whole
    score matrix (direct); otherwise sequential q-blocks over kv-blocks of
    ``chunk`` with an online max and denominator (flash).
    """
    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    scale = 1.0 / (hd ** 0.5)
    dev = q.device
    q_pos, k_pos = _positions(b, tq, tk, q_offset, kv_offset, k_positions,
                              dev)
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=dev).long().expand(b)

    if tq <= 4:
        return grouped_attention(q, k, v, _valid(
            q_pos, k_pos, kv_len, causal=causal, window=window))

    k = _repeat_kv(k, h // kvh)
    v = _repeat_kv(v, h // kvh)
    qf = q.transpose(1, 2).float()                        # (B, H, Tq, hd)
    kf = k.transpose(1, 2).float()                        # (B, H, Tk, hd)

    if tk <= 2 * chunk:   # direct path
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale   # (B, H, Tq, Tk)
        m = _valid(q_pos, k_pos, kv_len, causal=causal, window=window)
        s = torch.where(m[:, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        return torch.matmul(p, v.transpose(1, 2)).transpose(1, 2)

    # ---- flash path: kv blocks of ``chunk``, q blocks of min(chunk, Tq);
    # the padded keys sit at FAR (masked by causality), the padded query
    # rows are dropped at the end
    vf = v.transpose(1, 2).float()                        # (B, H, Tk, hd_v)
    qc = min(chunk, tq)
    out = torch.empty((b, h, tq, hd_v), dtype=torch.float32, device=dev)
    for q0 in range(0, tq, qc):
        qb = qf[:, :, q0:q0 + qc]
        n_q = qb.shape[2]
        qpb = q_pos[:, q0:q0 + qc]
        if n_q < qc:                                      # the padded rows
            qb = F.pad(qb, (0, 0, 0, qc - n_q))
            qpb = F.pad(qpb, (0, qc - n_q), value=FAR)
        m_run = torch.full((b, h, qc), NEG_INF, dtype=torch.float32,
                           device=dev)
        l_run = torch.zeros((b, h, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, qc, hd_v), dtype=torch.float32, device=dev)
        for k0 in range(0, tk, chunk):
            kb, vb = kf[:, :, k0:k0 + chunk], vf[:, :, k0:k0 + chunk]
            kpb = k_pos[:, k0:k0 + chunk]
            if kb.shape[2] < chunk:                       # the padded keys
                pad = chunk - kb.shape[2]
                kb = F.pad(kb, (0, 0, 0, pad))
                vb = F.pad(vb, (0, 0, 0, pad))
                kpb = F.pad(kpb, (0, pad), value=FAR)
            s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
            msk = _valid(qpb, kpb, kv_len, causal=causal, window=window)
            s = torch.where(msk[:, None], s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(-1))      # (B, H, qc)
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.matmul(p, vb)
            m_run = m_new
        o = acc / torch.clamp(l_run, min=1e-30)[..., None]
        out[:, :, q0:q0 + n_q] = o[:, :, :n_q]
    return out.transpose(1, 2).to(q.dtype)


# --------------------------------------------------------------------------
# standard projections
# --------------------------------------------------------------------------


def gqa_qkv(x, p, cfg, positions, table=None):
    """x (B, T, D) -> q (B, T, H, hd), k/v (B, T, KVH, hd), rope applied
    (``table``: :func:`rope_table` of ``positions``, if made already).
    Under a mesh: the projections of the whole sequence, column-parallel
    (:func:`sharded_heads`)."""
    if shmod.is_dtensor(x):
        xg = shmod.seq_all_gather(x)
        return sharded_heads(*(shmod.col_parallel(xg, p[w]) for w in
                               ("wq", "wk", "wv")), cfg, positions, table)
    b, t, _ = x.shape
    q = (x @ p["wq"]).reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    table = table or rope_table(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, positions, cfg.rope_theta, table)
    k = apply_rope(k, positions, cfg.rope_theta, table)
    return q, k, v


def sharded_heads(q2, k2, v2, cfg, positions, table=None):
    """The column-parallel projections (B, T, heads·hd) as rotated heads
    (B, T, heads, hd) with heads over "model" (``constrain_heads``; KV
    heads fewer than the model axis stay replicated)."""
    table = table or rope_table(positions, cfg.head_dim, cfg.rope_theta)

    def rope(t):
        return apply_rope(t, positions, cfg.rope_theta, table)

    def heads(x2, n, rotate):
        return shmod.constrain_heads(shmod.split_heads(
            x2, n, cfg.head_dim, rope if rotate else None))
    return (heads(q2, cfg.n_heads, True), heads(k2, cfg.n_kv_heads, True),
            heads(v2, cfg.n_kv_heads, False))


def attend(q, k, v, **kw):
    """:func:`attention`; on DTensors, on each rank's heads
    (``sharding.head_attention``)."""
    if shmod.is_dtensor(q):
        return shmod.head_attention(partial(attention, **kw), q, k, v)
    return attention(q, k, v, **kw)


def attn_out(o, p):
    """o (B, T, H, hd) -> (B, T, D) through ``wo`` (row-parallel under a
    mesh, the output in the activation layout)."""
    if shmod.is_dtensor(o):
        return shmod.row_parallel(shmod.merge_heads(o), p["wo"])
    b, t, h, hd = o.shape
    return o.reshape(b, t, h * hd) @ p["wo"]
