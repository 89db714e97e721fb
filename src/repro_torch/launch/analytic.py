"""Analytic per-chip FLOP and HBM-byte models for the roofline terms.

Port of ``repro/launch/analytic.py``: the same closed forms on the port's
``ModelConfig``, pure Python. The dry run (``launch/dryrun.py``) records
them beside the FLOPs it counts in a fake pass and the collectives it
records (``launch/comm_analysis.py``); compute and memory come from this
closed-form matmul accounting, the standard MFU methodology. Every
component is listed so the model is auditable.

Conventions:
  * matmul flops = 2·M·N·K; causal attention context = (S+1)/2, window-capped
  * train flops = fwd × (3 + remat) on blocks, fwd × 3 on the LM head
  * bytes: f32 params, bf16 activations; FSDP means each chip reads the
    TP-shard (not the FSDP shard) of every layer's weights each pass —
    the all-gathered copy has to stream through HBM.
"""
from __future__ import annotations

from ..models.config import ModelConfig
from .shapes import ShapeSpec


def _attn_flops_per_tok(cfg: ModelConfig, ctx: float) -> float:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    proj = 2 * d * (h * hd) * 2 + 2 * d * (kv * hd) * 2
    sdpa = 2 * h * hd * ctx * 2
    return proj + sdpa


def _mla_flops_per_tok(cfg: ModelConfig, ctx: float, decode: bool) -> float:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    down = 2 * d * (m.kv_lora_rank + m.qk_rope_dim)
    q = 2 * d * h * (m.qk_nope_dim + m.qk_rope_dim)
    out = 2 * h * m.v_head_dim * d
    if decode:  # absorbed path: scores in latent space
        absorb = 2 * h * m.qk_nope_dim * m.kv_lora_rank \
            + 2 * h * m.kv_lora_rank * m.v_head_dim
        sdpa = 2 * h * (m.kv_lora_rank + m.qk_rope_dim) * ctx \
            + 2 * h * m.kv_lora_rank * ctx
        return q + down + absorb + sdpa + out
    up = 2 * m.kv_lora_rank * h * (m.qk_nope_dim + m.v_head_dim)
    sdpa = 2 * h * (m.qk_nope_dim + m.qk_rope_dim) * ctx \
        + 2 * h * m.v_head_dim * ctx
    return q + down + up + sdpa + out


def _mlp_flops_per_tok(cfg: ModelConfig) -> float:
    if cfg.moe:
        mo = cfg.moe
        return (2 * cfg.d_model * mo.n_experts                 # router
                + 6 * cfg.d_model * mo.d_ff_expert
                * (mo.top_k + mo.n_shared))
    return 6 * cfg.d_model * cfg.d_ff


def _ssm_flops_per_tok(cfg: ModelConfig, decode: bool) -> float:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    nh = d_in // s.head_dim
    gn = s.n_groups * s.d_state
    proj = 2 * d * (2 * d_in + 2 * gn + nh) + 2 * d_in * d
    conv = 2 * s.conv_width * (d_in + 2 * gn)
    n, p, lc = s.d_state, s.head_dim, s.chunk
    if decode:
        ssd = 4 * nh * p * n
    else:
        ssd = 2 * nh * (n * lc + p * lc + 2 * n * p)
    return proj + conv + ssd


def _block_flops_per_tok(cfg: ModelConfig, ctx: float, decode: bool) -> float:
    fl = 0.0
    if cfg.mixer_kind in ("attn", "hybrid"):
        if cfg.attn_kind == "mla":
            fl += _mla_flops_per_tok(cfg, ctx, decode)
        else:
            fl += _attn_flops_per_tok(cfg, ctx)
    if cfg.mixer_kind in ("ssm", "hybrid"):
        fl += _ssm_flops_per_tok(cfg, decode)
    if cfg.mixer_kind != "ssm":
        fl += _mlp_flops_per_tok(cfg)
    return fl


def _ctx(cfg: ModelConfig, shape: ShapeSpec) -> float:
    if shape.kind == "decode":
        c = shape.seq_len
    else:
        c = (shape.seq_len + 1) / 2
    if cfg.sliding_window:
        c = min(c, cfg.sliding_window)
    return float(c)


def fwd_flops_total(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Whole-job forward flops for one step of this shape."""
    decode = shape.kind == "decode"
    n_tok = shape.global_batch * (1 if decode else shape.seq_len)
    ctx = _ctx(cfg, shape)

    per_tok = _block_flops_per_tok(cfg, ctx, decode)
    total = per_tok * cfg.n_layers * n_tok

    if cfg.cross_attn_period:
        n_cross = cfg.n_layers // cfg.cross_attn_period
        # replace n_cross self blocks' attn with cross-attn over n_ctx
        self_attn = _attn_flops_per_tok(cfg, ctx)
        cross_attn = (2 * cfg.d_model * cfg.n_heads * cfg.head_dim * 2
                      + 2 * cfg.n_heads * cfg.head_dim * cfg.n_context_tokens
                      * 2)
        total += n_cross * n_tok * (cross_attn - self_attn)
        # context K/V projection, once per sequence
        total += (n_cross * shape.global_batch * cfg.n_context_tokens
                  * 2 * cfg.d_model * 2 * cfg.n_kv_heads * cfg.head_dim)

    if cfg.encoder_decoder:
        t_enc = shape.seq_len if shape.kind == "prefill" \
            else cfg.n_context_tokens
        if not decode:
            # encoder pass over frames (bidirectional ctx = T_enc) — decode
            # attends cached cross K/V, the encoder does NOT re-run
            enc_tok = shape.global_batch * t_enc
            enc_per_tok = _attn_flops_per_tok(cfg, t_enc) \
                + _mlp_flops_per_tok(cfg)
            total += enc_per_tok * cfg.n_encoder_layers * enc_tok
            # cross K/V projections once per sequence
            total += (cfg.n_layers * shape.global_batch * t_enc
                      * 2 * cfg.d_model * 2 * cfg.n_kv_heads * cfg.head_dim)
        # decoder cross-attention to T_enc per decoded token
        cross = (2 * cfg.d_model * cfg.n_heads * cfg.head_dim * 2
                 + 2 * cfg.n_heads * cfg.head_dim * t_enc * 2)
        total += cross * cfg.n_layers * n_tok

    total += 2 * cfg.d_model * cfg.vocab_size * (
        shape.global_batch if decode or shape.kind == "prefill"
        else n_tok)                                     # lm head
    return total


def step_flops_per_chip(cfg: ModelConfig, shape: ShapeSpec,
                        n_chips: int) -> float:
    fwd = fwd_flops_total(cfg, shape)
    if shape.kind == "train":
        head = 2 * cfg.d_model * cfg.vocab_size * shape.global_batch \
            * shape.seq_len
        body = fwd - head
        mult = 4.0 if cfg.remat else 3.0
        return (body * mult + head * 3.0) / n_chips
    return fwd / n_chips


# --- HBM bytes -------------------------------------------------------------


def step_bytes_per_chip(cfg: ModelConfig, shape: ShapeSpec, n_chips: int,
                        schema_bytes_total: int, cache_bytes_total: int,
                        tp: int = 16) -> float:
    """Documented HBM-traffic model (per chip, per step):

    train:   weights: 3 passes (fwd, remat-fwd, bwd) over the TP shard of
             every layer (the FSDP-gathered copy streams through HBM) at
             bf16, + 7 f32 passes over the FSDP-local shard for the
             optimizer (read p,m,v,g; write p,m,v)
             activations: 2·L·B_loc·S·D·2B (checkpoint write + bwd read)
             logits: 3·B_loc·S·V/tp·4B
    prefill: weights 1 bf16 pass over TP shard; activations 1 write+read;
             cache write; flash K/V re-reads ≈ (S/2048)·KV_bytes
    decode:  weights 1 bf16 pass over TP shard; full local cache read +
             1-token write (the canonical decode bound)
    """
    d, v = cfg.d_model, cfg.vocab_size
    b_loc = max(shape.global_batch / (n_chips / tp), 1.0)
    w_tp_bf16 = schema_bytes_total / 4 / tp * 2         # f32 count → bf16
    w_local_f32 = schema_bytes_total / n_chips

    if shape.kind == "train":
        weights = 3 * w_tp_bf16 + 7 * w_local_f32
        acts = 2 * cfg.n_layers * b_loc * shape.seq_len * d * 2
        logits = 3 * b_loc * shape.seq_len * v / tp * 4
        return weights + acts + logits

    if shape.kind == "prefill":
        weights = w_tp_bf16
        acts = 2 * cfg.n_layers * b_loc * shape.seq_len * d * 2
        cache = cache_bytes_total / n_chips
        flash_reread = (shape.seq_len / 2048) * cache
        return weights + acts + cache + flash_reread

    cache_local = cache_bytes_total / n_chips
    return w_tp_bf16 + cache_local
