"""Multi-head Latent Attention (DeepSeek-V2), with the compressed-latent
KV cache and the absorbed-projection decode path (scores computed in
latent space, so a step costs O(S·lora), not O(S·H·hd)).

Port of ``repro/models/mla.py``. Two paths with different numerics, as
the reference's:

* prefill/forward (:func:`mla_attention`) decompresses each token's K/V
  and runs ``layers.attention`` (f32 scores from the operands' values),
  the shared RoPE key broadcast to every head;
* decode (:func:`mla_decode`) absorbs ``w_uk`` into the query. Its two
  score products give outputs in x's dtype (in bf16 each is rounded to
  bf16, unlike ``layers.attention``'s f32 scores), which are added in f32,
  as the reference's jitted decode computes ``(e1 + e2).astype(f32)``
  (XLA drops the rounding of the sum); the probabilities are cast to x's
  dtype before the ``ckv`` product. The mask is ``arange(S) <= pos`` over
  the whole cache, with -1e30.
"""
from __future__ import annotations

import torch

from ..dist import sharding as shmod
from .config import ModelConfig
from .layers import (NEG_INF, apply_rope, attention, decode_mask,
                     split_update, update_index)
from .params import P, Spec


def mla_schema(cfg: ModelConfig) -> dict:
    m = cfg.mla
    h = cfg.n_heads
    return {"wq": Spec((cfg.d_model, h * (m.qk_nope_dim + m.qk_rope_dim)),
                       pspec=P("data", "model")),
            "w_dkv": Spec((cfg.d_model, m.kv_lora_rank),
                          pspec=P("data", None)),
            "w_krope": Spec((cfg.d_model, m.qk_rope_dim),
                            pspec=P("data", None)),
            "w_uk": Spec((m.kv_lora_rank, h, m.qk_nope_dim),
                         pspec=P(None, "model", None)),
            "w_uv": Spec((m.kv_lora_rank, h, m.v_head_dim),
                         pspec=P(None, "model", None)),
            "wo": Spec((h * m.v_head_dim, cfg.d_model),
                       pspec=P("model", "data"))}


def _project_q(x, p, cfg, positions, table=None):
    m = cfg.mla
    b, t, _ = x.shape
    q = (x @ p["wq"]).reshape(b, t, cfg.n_heads, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta, table)


def _latent_kv(x, p, cfg, positions, table=None):
    """x (B, T, D) -> (ckv (B, T, lora), kr (B, T, rope)), kr rotated."""
    ckv = x @ p["w_dkv"]
    kr = (x @ p["w_krope"])[:, :, None, :]
    kr = apply_rope(kr, positions, cfg.rope_theta, table)[:, :, 0]
    return ckv, kr


def mla_attention(x, p, cfg: ModelConfig, positions, *, causal=True,
                  table=None):
    """Full (prefill/forward) path: decompress per-token K/V and run
    attention. x (B, T, D) -> (B, T, D); ``table``: the RoPE table of
    ``positions`` at ``qk_rope_dim``, if made already."""
    m = cfg.mla
    b, t, _ = x.shape
    q_nope, q_rope = _project_q(x, p, cfg, positions, table)
    ckv, kr = _latent_kv(x, p, cfg, positions, table)
    dt = x.dtype
    k_nope = torch.einsum("btl,lhn->bthn", ckv, p["w_uk"].to(dt))
    v = torch.einsum("btl,lhv->bthv", ckv, p["w_uv"].to(dt))
    k = torch.cat([k_nope, kr[:, :, None].expand(b, t, cfg.n_heads,
                                                 m.qk_rope_dim)], -1)
    q = torch.cat([q_nope, q_rope], -1)
    o = attention(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    return o.reshape(b, t, -1) @ p["wo"]


def _latent_scores(q_lat, q_rope, ckv, kr, mask, cfg: ModelConfig, dt,
                   seq_split: bool = False):
    """The absorbed path's attention in latent space: q_lat (B, 1, H,
    lora) and q_rope (B, 1, H, rope) against ckv (B, S, lora) and kr (B, S,
    rope) under mask (B, 1, S) -> o_lat (B, H, lora). ``seq_split``: the
    cache is this rank's part of one split over "model"; the softmax and
    the weighted sum are combined over "model"."""
    m = cfg.mla
    scores = (torch.einsum("bohl,bsl->bhs", q_lat, ckv).float()
              + torch.einsum("bohr,bsr->bhs", q_rope, kr).float())
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    scores = torch.where(mask, scores * scale, NEG_INF)
    if seq_split:
        w = shmod.split_softmax(scores).to(dt)
        return shmod.model_reduce(torch.einsum("bhs,bsl->bhl", w, ckv))
    w = torch.softmax(scores, dim=-1).to(dt)
    return torch.einsum("bhs,bsl->bhl", w, ckv)


def mla_decode(x, p, cfg: ModelConfig, ckv_cache, krope_cache, pos, *,
               index=None, mask=None, table=None):
    """Absorbed decode: one new token a row against the latent cache.

    x (B, 1, D); ckv_cache (B, S, lora); krope_cache (B, S, rope), both
    updated in place at per-row positions pos (B,) (``index``:
    ``layers.update_index(pos, S, 1)``, if made already); ``mask``:
    ``layers.decode_mask(pos, S)`` (B, 1, S), ``arange(S) <= pos``;
    ``table``: the RoPE table at pos. Returns
    (out (B, 1, D), ckv_cache, krope_cache).
    """
    b = x.shape[0]
    dt = x.dtype
    positions = pos[:, None]
    q_nope, q_rope = _project_q(x, p, cfg, positions, table)   # (B,1,H,·)
    ckv_new, kr_new = _latent_kv(x, p, cfg, positions, table)
    rows, cols = index or update_index(pos, ckv_cache.shape[1], 1)
    ckv_cache[rows, cols] = ckv_new.to(ckv_cache.dtype)
    krope_cache[rows, cols] = kr_new.to(krope_cache.dtype)
    ckv, kr = ckv_cache, krope_cache
    if mask is None:
        mask = decode_mask(pos, ckv.shape[1])

    # absorb W_uk into q: score in latent space
    q_lat = torch.einsum("bohn,lhn->bohl", q_nope, p["w_uk"].to(dt))
    o_lat = _latent_scores(q_lat, q_rope, ckv, kr, mask, cfg, dt)
    o = torch.einsum("bhl,lhv->bhv", o_lat, p["w_uv"].to(dt))
    return o.reshape(b, 1, -1) @ p["wo"], ckv, kr


def mla_decode_sharded(x, p, cfg: ModelConfig, ckv_cache, kr_cache, pos,
                       tick) -> torch.Tensor:
    """:func:`mla_decode` under a mesh: x (B, 1, D) and the parameters
    DTensors, the latent cache laid out by its schema (the sequence split
    over "model"), ``tick``: ``transformer.tick_constants``'s. Returns the
    block's attention output (B, 1, D) in the activation layout.

    The query is projected column-parallel and absorbed on each rank's
    heads (``w_uk`` split like ``wq`` by heads over "model"), then q_lat
    and q_rope are gathered over "model" (one token: small); the new
    latent K/V is made on local rows (``w_dkv``/``w_krope`` whole on every
    "model" rank) and written on the rank whose part holds the slot; each
    rank scores its part of the cache, combined over "model"; ``w_uv``
    runs on each rank's heads, and ``wo`` row-parallel."""
    dt = x.dtype
    hsplit = shmod.shard_range(p["w_uk"], 1)[1] < p["w_uk"].shape[1]
    q2 = shmod.constrain_batch(shmod.col_parallel(x, p["wq"]), None,
                               "model" if hsplit else None)
    cos, sin = (shmod.rows(t) for t in tick["rope"])
    m = cfg.mla

    def absorb(q, w_uk, co, si):
        q = q.reshape(q.shape[0], 1, -1, m.qk_nope_dim + m.qk_rope_dim)
        q_nope, q_rope = torch.split(q, [m.qk_nope_dim, m.qk_rope_dim], -1)
        q_rope = apply_rope(q_rope, None, cfg.rope_theta, (co, si))
        return (torch.einsum("bohn,lhn->bohl", q_nope, w_uk.to(dt)),
                q_rope)
    q_lat, q_rope = (shmod.rows(t) for t in shmod.local(
        absorb, q2, p["w_uk"], cos, sin))
    lat = shmod.local(lambda h, w, co, si: _latent_kv(h, w, cfg, None,
                                                      (co, si)),
                      shmod.rows(x), shmod.replicated(
                          {k: p[k] for k in ("w_dkv", "w_krope")}), cos, sin)
    lo, n = shmod.shard_range(ckv_cache, 1)
    s_total = ckv_cache.shape[1]
    split = n < s_total
    mask = shmod.constrain(tick["mask"], shmod.batch_axes(), None,
                           "model" if split else None)

    def attend(ql, qr, new, ck, kc, ml, pl):
        if split:
            split_update(ck, new[0], pl, s_total, lo)
            split_update(kc, new[1], pl, s_total, lo)
        else:
            rows, cols = update_index(pl, s_total, 1)
            ck[rows, cols] = new[0].to(ck.dtype)
            kc[rows, cols] = new[1].to(kc.dtype)
        return _latent_scores(ql, qr, ck, kc, ml, cfg, dt, seq_split=split)
    o_lat = shmod.local(attend, q_lat, q_rope, lat, ckv_cache, kr_cache,
                        mask, shmod.rows(pos))
    h_lo, h_n = shmod.shard_range(p["w_uv"], 1)

    def up(ol, w_uv):
        o = torch.einsum("bhl,lhv->bhv", ol[:, h_lo:h_lo + h_n], w_uv.to(dt))
        return o.reshape(o.shape[0], 1, -1)
    o = shmod.local(up, o_lat, p["w_uv"], out=q2.placements)
    return shmod.row_parallel(o, p["wo"])
