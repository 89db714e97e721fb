"""Encoder-decoder backbone (Whisper-large-v3).

Port of ``repro/models/whisper.py``. The conv/mel frontend is a stub, as
in the reference: the batch carries precomputed frame embeddings
``frames`` (B, T_enc, D). The encoder is not causal; each decoder layer
projects its cross K/V from the encoder's output. Positional encoding is
RoPE throughout (the reference's recorded deviation from Whisper's learned
embeddings, ``configs/whisper_large_v3.py``).

The decode cache is updated in place, as ``transformer``'s. The encoder
and the teacher-forcing decoder take each stacked leaf apart once and
checkpoint each block while autograd records (``cfg.remat``), as
:func:`transformer.forward` does.

Under a mesh (``repro_torch.dist.sharding``) the encoder and the
teacher-forcing decoder run the reference's sharded schedule: the frames
and the embedded tokens batch-sharded (``constrain_batch``), every
block's output in the activation layout (``constrain_act``), self-attention
with heads over "model" (``layers.gqa_qkv``) and a row-parallel output,
the MLP through ``fused_mlp``, the decoder's cross-attention on the whole
sequence with its weights gathered, on local shards. Prefill and decode
run under a mesh as ``transformer``'s do: the self cache's sequence split
over "model", the cross K/V batch-sharded and whole on every "model"
rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers
from .config import ModelConfig
from .params import P, Spec, as_dtype, cast_floats, stack
from ..dist import sharding as shmod
from .transformer import (_decode_self_attn, _norm_spec, _store_prefix,
                          _whole, attn_schema, cross_attend, layer, mlp_schema,
                          remat, serve_embed, serve_logits,
                          tick_constants, unstack)


def enc_block_schema(cfg: ModelConfig) -> dict:
    return {"ln1": _norm_spec(cfg), "attn": attn_schema(cfg),
            "ln2": _norm_spec(cfg), "mlp": mlp_schema(cfg)}


def dec_block_schema(cfg: ModelConfig) -> dict:
    return {"ln1": _norm_spec(cfg), "attn": attn_schema(cfg),
            "lnx": _norm_spec(cfg), "xattn": attn_schema(cfg),
            "ln2": _norm_spec(cfg), "mlp": mlp_schema(cfg)}


def model_schema(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    return {"embed": Spec((v, d), "embed", pspec=P("model", "data")),
            "enc_blocks": stack(enc_block_schema(cfg), cfg.n_encoder_layers),
            "enc_norm": _norm_spec(cfg),
            "dec_blocks": stack(dec_block_schema(cfg), cfg.n_layers),
            "final_norm": _norm_spec(cfg),
            "lm_head": Spec((d, v), pspec=P("data", "model"))}


def _proj_kv(ctx, p, cfg):
    b, tc, _ = ctx.shape
    k = (ctx @ p["wk"]).reshape(b, tc, cfg.n_kv_heads, cfg.head_dim)
    v = (ctx @ p["wv"]).reshape(b, tc, cfg.n_kv_heads, cfg.head_dim)
    return k, v


def _mlp(x, p):
    return shmod.fused_mlp(x, p["w_gate"], p["w_in"], p["w_out"])


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames (B, T_enc, D) stub embeddings -> encoder states (B, T_enc, D)."""
    x = shmod.constrain_batch(frames.to(as_dtype(cfg.dtype)), None, None)
    positions = torch.arange(frames.shape[1], device=x.device)
    table = layers.rope_table(positions, cfg.head_dim, cfg.rope_theta)

    def block(p, x):
        p = cast_floats(p, cfg.dtype)
        x = shmod.constrain_act(x)
        h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = layers.gqa_qkv(h, p["attn"], cfg, positions, table)
        o = layers.attend(q, k, v, causal=False, chunk=cfg.attn_chunk)
        x = x + layers.attn_out(o, p["attn"])
        h2 = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        return shmod.constrain_act(x + _mlp(h2, p["mlp"]))
    block = remat(cfg, block)
    for p in unstack(params["enc_blocks"]):
        x = block(p, x)
    return layers.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_block(cfg, p, x, positions, table, enc_out, cache=None):
    """One decoder block over a full sequence; with ``cache`` (this
    layer's), its self K/V and cross K/V are written there."""
    p = cast_floats(p, cfg.dtype)
    x = shmod.constrain_act(x)
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = layers.gqa_qkv(h, p["attn"], cfg, positions, table)
    xcache = None
    if cache is not None:
        _store_prefix(cache["k"], k.to(cache["k"].dtype))
        _store_prefix(cache["v"], v.to(cache["v"].dtype))
        xcache = {"xk": cache["xk"], "xv": cache["xv"]}
    o = layers.attend(q, k, v, causal=True, chunk=cfg.attn_chunk)
    x = x + layers.attn_out(o, p["attn"])
    x = _whole(lambda xx, pp, enc, xc: _cross(cfg, pp, xx, enc, xc), x,
               {"lnx": p["lnx"], "xattn": p["xattn"]}, enc_out, xcache)
    h2 = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    return shmod.constrain_act(x + _mlp(h2, p["mlp"]))


def _cross(cfg, p, x, enc_out, cache=None):
    """x plus the cross-attention of its ``lnx`` rows over the encoder's
    output; with ``cache``, the cross K/V are written there."""
    hx = layers.rms_norm(x, p["lnx"], cfg.norm_eps)
    qx = (hx @ p["xattn"]["wq"]).reshape(hx.shape[0], hx.shape[1],
                                         cfg.n_heads, cfg.head_dim)
    kx, vx = _proj_kv(enc_out, p["xattn"], cfg)
    if cache is not None:
        cache["xk"].copy_(kx)
        cache["xv"].copy_(vx)
    ox = layers.attention(qx, kx, vx, causal=False, chunk=cfg.attn_chunk)
    return x + layers.attn_out(ox, p["xattn"])


def _embed(cfg, params, tokens):
    dt = as_dtype(cfg.dtype)
    if shmod.mesh() is None:
        return F.embedding(tokens.long(), params["embed"]).to(dt)
    return shmod.local(lambda t, e: F.embedding(t.long(), e).to(dt),
                       shmod.constrain_batch(tokens, None),
                       shmod.replicated(params["embed"]))


def decoder_forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                    enc_out: torch.Tensor) -> torch.Tensor:
    """Teacher-forcing decoder pass -> hidden states (B, T, D), normed."""
    x = shmod.constrain_batch(_embed(cfg, params, tokens), None, None)
    enc_out = shmod.seq_all_gather(enc_out)
    positions = torch.arange(tokens.shape[1], device=x.device)
    table = layers.rope_table(positions, cfg.head_dim, cfg.rope_theta)
    block = remat(cfg, lambda p, h: _dec_block(cfg, p, h, positions, table,
                                               enc_out))
    for p in unstack(params["dec_blocks"]):
        x = block(p, x)
    return layers.rms_norm(x, params["final_norm"], cfg.norm_eps)


def init_cache_schema(cfg: ModelConfig, batch: int, max_seq: int,
                      enc_len: int) -> dict:
    """Per decoder layer: the self ``k``/``v`` (B, max_seq, KVH, hd) and
    the cross ``xk``/``xv`` (B, enc_len, KVH, hd), in the compute dtype."""
    kv = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    ckv = (batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
    rows = ("pod", "data")
    blk = {"k": Spec(kv, "zeros", cfg.dtype, P(rows, "model", None, None)),
           "v": Spec(kv, "zeros", cfg.dtype, P(rows, "model", None, None)),
           "xk": Spec(ckv, "zeros", cfg.dtype, P(rows, None, None, None)),
           "xv": Spec(ckv, "zeros", cfg.dtype, P(rows, None, None, None))}
    return {"blocks": stack(blk, cfg.n_layers)}


def prefill(cfg: ModelConfig, params: dict, frames: torch.Tensor,
            tokens: torch.Tensor, cache: dict):
    """Encode the frames, project each layer's cross K/V, run the prompt
    through the decoder filling the self cache (all in place). Returns
    (last logits (B, V) f32, cache)."""
    enc_out = shmod.seq_all_gather(encode(cfg, params, frames))
    x = serve_embed(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    table = layers.rope_table(positions, cfg.head_dim, cfg.rope_theta)
    for i in range(cfg.n_layers):
        x = _dec_block(cfg, layer(params["dec_blocks"], i), x, positions,
                       table, enc_out, layer(cache["blocks"], i))
    x = layers.rms_norm(shmod.seq_all_gather(x)[:, -1:], params["final_norm"],
                        cfg.norm_eps)
    return serve_logits(cfg, params, x)[:, 0], cache


def decode(cfg: ModelConfig, params: dict, cache: dict, token: torch.Tensor,
           pos):
    """One decoder token a row against the self cache and the cross K/V
    prefill projected: token (B, 1), pos scalar or (B,) -> (logits (B, V)
    f32, the cache, updated in place)."""
    x = serve_embed(cfg, params, token)
    if shmod.is_dtensor(pos):
        pos = pos.full_tensor()
    pos = torch.as_tensor(pos, device=x.device).to(torch.int32).expand(
        token.shape[0])
    tick = tick_constants(cfg, cache["blocks"], pos)
    for i in range(cfg.n_layers):
        p = cast_floats(layer(params["dec_blocks"], i), cfg.dtype)
        cb = layer(cache["blocks"], i)
        h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
        x = x + _decode_self_attn(h, p["attn"], cfg, cb, pos, tick)
        hx = layers.rms_norm(x, p["lnx"], cfg.norm_eps)
        x = x + cross_attend(cfg, hx, p["xattn"], cb["xk"], cb["xv"])
        h2 = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + _mlp(h2, p["mlp"])
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return serve_logits(cfg, params, x)[:, 0], cache
