"""The unified decoder-only transformer: dense/GQA, sliding-window, MLA,
MoE, SSM (Mamba-2), hybrid (attention and SSM in parallel) and
interleaved cross-attention (VLM) families, one block stack parameterised
entirely by ModelConfig.

Port of ``repro/models/transformer.py``. The layout is the reference's:
block weights are stacked on a leading layer axis (``params["blocks"]``
leaves (L, ...)), and for a VLM on two, (groups, self blocks a group,
...), beside its ``cross_blocks`` (groups, ...); the decode cache is
stacked the same way. The port loops over the layers: :func:`forward`
takes each stacked leaf apart once (:func:`unstack`), so that autograd
writes each leaf's gradient into one stacked buffer; prefill and decode
slice layer by layer (:func:`layer`). Activations are (B, T, D).

Remat: while autograd records, :func:`forward` checkpoints each block
(and each VLM group) when ``cfg.remat`` is set, as the reference's
``jax.checkpoint`` does: the backward recomputes a block's activations
from its saved input. Forward values do not change.

The decode cache is updated IN PLACE (the reference returns a new cache
from a jitted function that donates the old one); :func:`decode` and
:func:`prefill` return the cache they were given.

Under a mesh (``repro_torch.dist.sharding.enable``; parameters placed by
``params.distribute``) :func:`forward` runs the reference's sharded
schedule on DTensors: activations (B, T, D) batch-sharded, and under SP
seq-sharded over "model" between blocks (``constrain_act`` on the
embedding, on every block's output and every cross group's); attention
column-parallel into heads over "model" and row-parallel out; the MLP
through ``fused_mlp``; the MoE expert-parallel (``moe.moe_ffn``); MLA, the
SSM, the hybrid's mixers and cross-attention on the whole sequence
(``seq_all_gather``) with their weights gathered, on local shards.

Prefill and decode under a mesh take parameters placed by
``params.distribute`` (the training layout, or a serving one), a cache
laid out by :func:`init_cache_schema`'s pspecs and batch-sharded tokens.
Prefill runs :func:`block_apply`'s sharded path and writes each cache
leaf in its own layout. Decode keeps the one-token activations
batch-sharded, gathers q, k and v over "model" after the column-parallel
projections, and attends against a full-attention cache whose sequence
is split over "model" (context parallelism): the token is written on the
rank whose part holds its slot, each rank scores its part, and the parts'
max, sum of exponentials and weighted V are combined over "model"
(``layers.grouped_attention(seq_split=True)``). A sliding-window cache is
whole on every "model" rank. The embedding and the LM head stay split by
vocabulary over "model" (:func:`serve_embed`, :func:`serve_logits`).

Two faults of the reference are copied for parity (ROADMAP queue 3):
a sliding-window prefill stores the prompt's last ``w`` tokens at slots
0.., which decode's ``pos mod w`` does not continue when the prompt is
longer than the window and not a multiple of it; and a VLM's prefill
projects the cached cross-attention K/V from the raw context, without
``lnc`` and in the parameters' dtype, while :func:`cross_block_apply`
normalises it, so decode differs from :func:`forward`.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..dist import sharding as shmod
from . import layers, mamba2, mla as mla_lib, moe as moe_lib
from .config import ModelConfig
from .params import (P, Spec, as_dtype, cast_floats, stack, tree_leaves,
                     tree_map)


# --------------------------------------------------------------------------
# schemas
# --------------------------------------------------------------------------


def attn_schema(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": Spec((d, h * hd), pspec=P("data", "model")),
            "wk": Spec((d, kv * hd), pspec=P("data", "model")),
            "wv": Spec((d, kv * hd), pspec=P("data", "model")),
            "wo": Spec((h * hd, d), pspec=P("model", "data"))}


def mlp_schema(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": Spec((d, f), pspec=P("data", "model")),
            "w_in": Spec((d, f), pspec=P("data", "model")),
            "w_out": Spec((f, d), pspec=P("model", "data"))}


def _norm_spec(cfg: ModelConfig) -> Spec:
    """A (D,) norm weight, ones, replicated."""
    return Spec((cfg.d_model,), "ones", pspec=P(None))


def _mixer_schema(cfg: ModelConfig) -> dict:
    sch: dict = {"ln1": _norm_spec(cfg)}
    if cfg.mixer_kind in ("attn", "hybrid"):
        sch["attn"] = (mla_lib.mla_schema(cfg) if cfg.attn_kind == "mla"
                       else attn_schema(cfg))
    if cfg.mixer_kind in ("ssm", "hybrid"):
        sch["ssm"] = mamba2.mamba_schema(cfg)
    if cfg.mixer_kind == "hybrid":
        sch["attn_bn"] = _norm_spec(cfg)
        sch["ssm_bn"] = _norm_spec(cfg)
    return sch


def _ffn_schema(cfg: ModelConfig) -> dict:
    return (moe_lib.moe_schema(cfg.d_model, cfg.moe) if cfg.moe
            else mlp_schema(cfg))


def block_schema(cfg: ModelConfig) -> dict:
    sch = _mixer_schema(cfg)
    if cfg.mixer_kind != "ssm":                 # mamba2 blocks: mixer only
        sch["ln2"] = _norm_spec(cfg)
        sch["mlp"] = _ffn_schema(cfg)
    return sch


def cross_block_schema(cfg: ModelConfig) -> dict:
    return {"ln1": _norm_spec(cfg), "lnc": _norm_spec(cfg),
            "attn": attn_schema(cfg), "ln2": _norm_spec(cfg),
            "mlp": _ffn_schema(cfg)}


def groups(cfg: ModelConfig) -> tuple[int, int]:
    """(groups, self blocks a group): a VLM's groups of ``period - 1``
    self blocks, each followed by one cross block; otherwise one group of
    every layer."""
    if cfg.cross_attn_period:
        return (cfg.n_layers // cfg.cross_attn_period,
                cfg.cross_attn_period - 1)
    return 1, cfg.n_layers


def model_schema(cfg: ModelConfig) -> dict:
    """The parameter schema: ``embed``, the stacked ``blocks`` (and a
    VLM's ``cross_blocks``), ``final_norm`` and (untied) ``lm_head``."""
    d, v = cfg.d_model, cfg.vocab_size
    sch: dict = {"embed": Spec((v, d), "embed", pspec=P("model", "data"))}
    if cfg.cross_attn_period:
        n_groups, per = groups(cfg)
        sch["blocks"] = stack(stack(block_schema(cfg), per), n_groups)
        sch["cross_blocks"] = stack(cross_block_schema(cfg), n_groups)
    else:
        sch["blocks"] = stack(block_schema(cfg), cfg.n_layers)
    sch["final_norm"] = _norm_spec(cfg)
    if not cfg.tie_embeddings:
        sch["lm_head"] = Spec((d, v), pspec=P("data", "model"))
    return sch


def layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree: views of every leaf's slice."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def unstack(tree: dict, lead: int = 1) -> list[dict]:
    """Every layer of a stacked tree, each leaf taken apart once: its
    ``lead`` leading (layer) axes flattened into one, then one ``unbind``.
    Autograd's backward of the ``unbind`` stacks the layers' gradients into
    one buffer, where slicing layer by layer (:func:`layer`) would make a
    zero tensor the size of the whole leaf for each layer."""
    parts = tree_map(lambda v: _unbind(v, lead), tree)
    n = len(tree_leaves(parts)[0])
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


def _unbind(v, lead: int):
    if not shmod.is_dtensor(v):
        return v.flatten(0, lead - 1).unbind(0)
    # a DTensor's layer axes are never sharded: unbind the local shard
    from torch.distributed.tensor import Shard
    out = tuple(Shard(p.dim - lead) if isinstance(p, Shard) else p
                for p in v.placements)
    return shmod.local(lambda t: t.flatten(0, lead - 1).unbind(0), v,
                       out=out)


def remat(cfg: ModelConfig, fn: Callable) -> Callable:
    """``fn`` checkpointed (its activations recomputed in the backward
    from its inputs) when ``cfg.remat`` is set and autograd records;
    otherwise ``fn``."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def self_layer(cfg: ModelConfig, tree: dict, g: int, j: int) -> dict:
    """Self block ``j`` of group ``g`` of a stacked ``blocks`` tree."""
    return layer(layer(tree, g), j) if cfg.cross_attn_period else layer(
        tree, j)


def rope_table(cfg: ModelConfig, positions: torch.Tensor):
    """The RoPE table the blocks' attention rotates by at ``positions``
    (at ``qk_rope_dim`` for MLA, ``head_dim`` otherwise; None for an
    attention-free model), made once a pass."""
    if cfg.mixer_kind == "ssm":
        return None
    dim = cfg.mla.qk_rope_dim if cfg.attn_kind == "mla" else cfg.head_dim
    return layers.rope_table(positions, dim, cfg.rope_theta)


# --------------------------------------------------------------------------
# block application (full sequence: forward / prefill)
# --------------------------------------------------------------------------


def _mlp(x, p, cfg):
    if cfg.moe:
        return shmod.constrain_act(moe_lib.moe_ffn(x, p, cfg.moe))
    return shmod.fused_mlp(x, p["w_gate"], p["w_in"], p["w_out"])


def _whole(fn, h, p, *args):
    """``fn(h, p, *args)`` for a mixer that needs the whole sequence and
    has no tensor-parallel schedule (MLA, the SSM, cross-attention): under
    a mesh, on local shards of the gathered sequence with its weights
    gathered, the output back in the activation layout. Returns what
    ``fn`` returns (the first output constrained)."""
    if not shmod.is_dtensor(h):
        return fn(h, p, *args)
    out = shmod.local(fn, shmod.seq_all_gather(h), shmod.replicated(p),
                      *args)
    if isinstance(out, tuple):
        return (shmod.constrain_act(out[0]),) + out[1:]
    return shmod.constrain_act(out)


def _write_prefix(cache_arr: torch.Tensor, vals: torch.Tensor) -> None:
    """Prefill's cache write of T tokens at slots 0..T-1."""
    t = vals.shape[1]
    if t > cache_arr.shape[1]:
        raise ValueError(f"a prompt of {t} tokens does not fit a cache of "
                         f"{cache_arr.shape[1]}")
    cache_arr[:, :t] = vals


def _store(arr, vals) -> None:
    """A cache leaf's whole value written in place; a DTensor leaf takes
    vals laid out as it is (each rank copies its part)."""
    if shmod.is_dtensor(arr):
        arr.to_local().copy_(shmod.relayout(vals, arr.placements).to_local())
    else:
        arr.copy_(vals)


def _store_prefix(arr, vals) -> None:
    """:func:`_write_prefix` into a cache leaf; a DTensor leaf (its
    sequence maybe split over "model") takes vals laid out as it is when
    they fill it, else each rank writes the prompt's slots it holds."""
    if not shmod.is_dtensor(arr):
        _write_prefix(arr, vals)
        return
    if tuple(vals.shape) == tuple(arr.shape):
        _store(arr, vals)
        return
    t = vals.shape[1]
    if t > arr.shape[1]:
        raise ValueError(f"a prompt of {t} tokens does not fit a cache of "
                         f"{arr.shape[1]}")
    lo, n = shmod.shard_range(arr, 1)
    k = max(0, min(t - lo, n))

    def run(a, v):
        a[:, :k] = v[:, lo:lo + k]
    shmod.local(run, arr, shmod.rows(vals))


def _write_kv(cfg, cache_block: dict, k, v) -> None:
    """Prefill's K/V write at slot 0 on. With a sliding window, the last
    ``keep = min(w, T)`` tokens go to slots 0..keep-1 (the reference's
    layout: decode then writes position p at slot p mod w, so a prompt
    longer than the window and not a multiple of it overwrites a slot that
    is not the oldest; ROADMAP queue 3)."""
    if shmod.is_dtensor(cache_block["k"]):
        if cfg.sliding_window:                  # whole on "model" ranks
            shmod.local(lambda c, kk, vv: _write_kv(cfg, c, kk, vv),
                        cache_block, shmod.rows(k), shmod.rows(v))
        else:
            _store_prefix(cache_block["k"], k)
            _store_prefix(cache_block["v"], v)
        return
    t = k.shape[1]
    if cfg.sliding_window:
        keep = min(cache_block["k"].shape[1], t)
        cache_block["k"][:, :keep] = k[:, t - keep:]
        cache_block["v"][:, :keep] = v[:, t - keep:]
        cache_block["kpos"][:, :keep] = torch.arange(
            t - keep, t, dtype=cache_block["kpos"].dtype, device=k.device)
    else:
        _write_prefix(cache_block["k"], k)
        _write_prefix(cache_block["v"], v)


def _latent_kv(cfg, h, p, positions, table):
    """MLA's latent (ckv, kr) of h (B, T, D); under a mesh on local rows of
    the whole sequence, batch-sharded and whole on every "model" rank."""
    def fn(hh, pp):
        return mla_lib._latent_kv(hh, pp, cfg, positions, table)
    if not shmod.is_dtensor(h):
        return fn(h, p)
    return shmod.local(fn, shmod.seq_all_gather(h), shmod.replicated(
        {k: p[k] for k in ("w_dkv", "w_krope")}))


def _write_state(cache_block: dict, conv, ssm) -> None:
    _store(cache_block["conv"], conv)
    _store(cache_block["ssm"], ssm)


def _self_attn(cfg, x, p, positions, table, cache=None):
    if shmod.is_dtensor(x):
        # x may be seq-sharded (SP): col_parallel_qkv gathers internally
        q2, k2, v2 = shmod.col_parallel_qkv(x, p["wq"], p["wk"], p["wv"])
        q, k, v = layers.sharded_heads(q2, k2, v2, cfg, positions, table)
    else:
        q, k, v = layers.gqa_qkv(x, p, cfg, positions, table)
    if cache is not None:
        _write_kv(cfg, cache, k, v)
    o = layers.attend(q, k, v, causal=True, window=cfg.sliding_window,
                      chunk=cfg.attn_chunk)
    return layers.attn_out(o, p)


def _hybrid_mix(cfg, p, ya, ys):
    return 0.5 * (layers.rms_norm(ya, p["attn_bn"], cfg.norm_eps)
                  + layers.rms_norm(ys, p["ssm_bn"], cfg.norm_eps))


def block_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor, table, cache=None) -> torch.Tensor:
    """One block over a full sequence: x (B, T, D) -> (B, T, D)
    (``table``: :func:`rope_table` of ``positions``). With ``cache``, this
    layer's decode cache, the mixer's state is written there (K/V, the
    latent ``ckv``/``kr``, or ``conv``/``ssm``), as prefill does."""
    p = cast_floats(p, cfg.dtype)
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mixer_kind == "attn" and cfg.attn_kind == "mla":
        if cache is not None:
            ckv, kr = _latent_kv(cfg, h, p["attn"], positions, table)
            _store_prefix(cache["ckv"], ckv.to(cache["ckv"].dtype))
            _store_prefix(cache["kr"], kr.to(cache["kr"].dtype))
        x = x + _whole(lambda hh, pp: mla_lib.mla_attention(
            hh, pp, cfg, positions, table=table), h, p["attn"])
    elif cfg.mixer_kind == "attn":
        x = x + _self_attn(cfg, h, p["attn"], positions, table, cache)
    elif cfg.mixer_kind == "ssm":
        y, (conv, ssm) = _whole(partial(mamba2.mamba_mixer, cfg=cfg), h,
                                p["ssm"])
        if cache is not None:
            _write_state(cache, conv, ssm)
        return x + y                                # mamba2: no MLP
    else:                                           # hybrid (hymba)
        h = shmod.seq_all_gather(h)
        ya = _self_attn(cfg, h, p["attn"], positions, table, cache)
        ys, (conv, ssm) = _whole(partial(mamba2.mamba_mixer, cfg=cfg), h,
                                 p["ssm"])
        if cache is not None:
            _write_state(cache, conv, ssm)
        x = x + _hybrid_mix(cfg, p, ya, ys)
    h2 = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _mlp(h2, p["mlp"], cfg)


def cross_block_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      context: torch.Tensor) -> torch.Tensor:
    """Cross-attention block (VLM): queries from x, K/V from the context
    embeddings normalised by ``lnc`` (no RoPE on cross-attention, as
    Llama-3.2-Vision)."""
    p = cast_floats(p, cfg.dtype)
    x = _whole(lambda xx, pp, cc: _cross_attn(cfg, pp, xx, cc), x,
               {k: p[k] for k in ("ln1", "lnc", "attn")}, context)
    h2 = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _mlp(h2, p["mlp"], cfg)


def _cross_attn(cfg: ModelConfig, p: dict, x, context):
    """x plus the cross-attention of its ``ln1`` rows over the
    ``lnc``-normed context."""
    b, t, _ = x.shape
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    ctx = layers.rms_norm(context, p["lnc"], cfg.norm_eps)
    tc = ctx.shape[1]
    q = (h @ p["attn"]["wq"]).reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = (ctx @ p["attn"]["wk"]).reshape(b, tc, cfg.n_kv_heads, cfg.head_dim)
    v = (ctx @ p["attn"]["wv"]).reshape(b, tc, cfg.n_kv_heads, cfg.head_dim)
    o = layers.attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    return x + layers.attn_out(o, p["attn"])


def embed_tokens(cfg, params, tokens):
    """tokens (B, T) -> (B, T, D) in the compute dtype; under a mesh the
    rows of each rank's batch shard from the gathered table, then the
    activation layout."""
    # F.embedding's backward sums each row's gradients in token order (an
    # indexing backward's accumulate runs in parallel, its order varying)
    dt = as_dtype(cfg.dtype)
    if shmod.mesh() is None:
        return F.embedding(tokens.long(), params["embed"]).to(dt)
    x = shmod.local(lambda t, e: F.embedding(t.long(), e).to(dt),
                    shmod.constrain_batch(tokens, None),
                    shmod.replicated(params["embed"]))
    return shmod.constrain_act(x)


def _context(cfg: ModelConfig, context) -> Optional[torch.Tensor]:
    if not cfg.cross_attn_period:
        return None
    if context is None:
        raise ValueError(f"{cfg.name} cross-attends: pass its context "
                         f"(B, {cfg.n_context_tokens}, {cfg.d_model})")
    return shmod.constrain_batch(context, None, None).to(as_dtype(cfg.dtype))


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            context: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, T) int -> final hidden states (B, T, D), normed. A VLM
    takes its ``context`` (B, n_context_tokens, D)."""
    ctx = _context(cfg, context)
    x = embed_tokens(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    table = rope_table(cfg, positions)
    n_groups, per = groups(cfg)
    blocks = unstack(params["blocks"], 2 if ctx is not None else 1)
    block = remat(cfg, lambda p, h: shmod.constrain_act(
        block_apply(cfg, p, h, positions, table)))
    if ctx is None:
        for p in blocks:
            x = block(p, x)
    else:
        def group(h, p_selfs, p_cross):
            for p in p_selfs:
                h = block(p, h)
            return shmod.constrain_act(cross_block_apply(cfg, p_cross, h,
                                                         ctx))
        cross = unstack(params["cross_blocks"])
        group = remat(cfg, group)
        for g in range(n_groups):
            x = group(x, blocks[g * per:(g + 1) * per], cross[g])
    return layers.rms_norm(x, params["final_norm"], cfg.norm_eps)


def lm_logits(cfg: ModelConfig, params: dict, x: torch.Tensor
              ) -> torch.Tensor:
    """x (..., D) -> logits (..., V) f32: the product in the compute dtype,
    then cast to f32."""
    dt = as_dtype(cfg.dtype)
    tie = cfg.tie_embeddings

    def logits(a, w):
        return (a.to(dt) @ (w.T if tie else w).to(dt)).float()
    w = params["embed"] if tie else params["lm_head"]
    if not shmod.is_dtensor(x):
        return logits(x, w)
    # the whole vocabulary on every rank of a batch shard
    return shmod.local(logits, shmod.seq_all_gather(x), shmod.replicated(w))


# --------------------------------------------------------------------------
# decode (one new token a row against a cache)
# --------------------------------------------------------------------------


def init_cache_schema(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """Schema of the decode cache, per layer:

    * GQA attention: ``k``/``v`` (B, S, KVH, hd) in the compute dtype, S =
      max_seq, or the window for sliding-window attention, which also
      keeps ``kpos`` (B, S) int32, the position each slot holds (-1: none);
    * MLA: the latent ``ckv`` (B, S, lora) and the rotated ``kr`` (B, S,
      rope);
    * SSM: ``conv`` (B, W-1, conv_dim) in the compute dtype and ``ssm``
      (B, H, P, N) in f32; a hybrid block keeps both GQA's and these.

    A VLM stacks the blocks' caches twice, (groups, self blocks, ...), and
    keeps each group's ``cross_k``/``cross_v`` (groups, B, n_context, KVH,
    hd). Each leaf carries the reference's pspec: the batch over
    ("pod", "data"), the sequence of a full (not sliding-window)
    attention or latent cache over "model" (context parallelism), an
    SSM's channels or heads over "model"."""
    rows = ("pod", "data")

    def layer_cache() -> dict:
        if cfg.attn_kind == "mla":
            m = cfg.mla
            return {"ckv": Spec((batch, max_seq, m.kv_lora_rank), "zeros",
                                cfg.dtype, P(rows, "model", None)),
                    "kr": Spec((batch, max_seq, m.qk_rope_dim), "zeros",
                               cfg.dtype, P(rows, "model", None))}
        c: dict = {}
        if cfg.mixer_kind in ("attn", "hybrid"):
            w = cfg.sliding_window
            s = min(w, max_seq) if w else max_seq
            kvshape = (batch, s, cfg.n_kv_heads, cfg.head_dim)
            kv_p = P(rows, None if w else "model", None, None)
            c["k"] = Spec(kvshape, "zeros", cfg.dtype, kv_p)
            c["v"] = Spec(kvshape, "zeros", cfg.dtype, kv_p)
            if w:
                c["kpos"] = Spec((batch, s), "neg", torch.int32,
                                 P(rows, None))
        if cfg.mixer_kind in ("ssm", "hybrid"):
            s_cfg = cfg.ssm
            _, nh, conv_dim = mamba2.ssm_dims(cfg)
            c["conv"] = Spec((batch, s_cfg.conv_width - 1, conv_dim),
                             "zeros", cfg.dtype, P(rows, None, "model"))
            c["ssm"] = Spec((batch, nh, s_cfg.head_dim, s_cfg.d_state),
                            "zeros", torch.float32,
                            P(rows, "model", None, None))
        return c

    if cfg.cross_attn_period:
        n_groups, per = groups(cfg)
        ctx_kv = (n_groups, batch, cfg.n_context_tokens, cfg.n_kv_heads,
                  cfg.head_dim)
        return {"blocks": stack(stack(layer_cache(), per), n_groups),
                "cross_k": Spec(ctx_kv, "zeros", cfg.dtype,
                                P(None, rows, None, None, None)),
                "cross_v": Spec(ctx_kv, "zeros", cfg.dtype,
                                P(None, rows, None, None, None))}
    return {"blocks": stack(layer_cache(), cfg.n_layers)}


def _batched_update(cache_arr: torch.Tensor, new_vals: torch.Tensor,
                    pos: torch.Tensor, index=None) -> torch.Tensor:
    """Write new_vals (B, T, ...) into cache (B, S, ...) at per-batch start
    ``pos`` (B,), in place (``index``: :func:`layers.update_index`'s, if
    made already for this pos)."""
    rows, cols = index or layers.update_index(pos, cache_arr.shape[1],
                                              new_vals.shape[1])
    cache_arr[rows, cols] = new_vals.to(cache_arr.dtype)
    return cache_arr


def _decode_qkv(x, p, cfg, tick):
    """q (B, 1, H, hd) and the new k, v (B, 1, KVH, hd) of one token a row,
    rotated. Under a mesh the column-parallel projections are gathered
    over "model" (one token: a small all-gather) and rotated on local
    rows, batch-sharded and whole on every "model" rank."""
    if not shmod.is_dtensor(x):
        return layers.gqa_qkv(x, p, cfg, None, tick["rope"])
    q2, k2, v2 = (shmod.rows(t) for t in shmod.col_parallel_qkv(
        x, p["wq"], p["wk"], p["wv"]))
    cos, sin = (shmod.rows(t) for t in tick["rope"])
    hd = cfg.head_dim

    def run(a, b, c, co, si):
        heads = [t.reshape(t.shape[0], t.shape[1], -1, hd) for t in (a, b, c)]
        return (layers.apply_rope(heads[0], None, cfg.rope_theta, (co, si)),
                layers.apply_rope(heads[1], None, cfg.rope_theta, (co, si)),
                heads[2])
    return shmod.local(run, q2, k2, v2, cos, sin)


def _decode_attend(cfg, q, k_new, v_new, cache, pos, tick):
    """The one-token attention against a layer's cache at per-row positions
    pos (B,), the new k, v written there in place first (plain tensors)."""
    b = q.shape[0]
    if cfg.sliding_window:
        w = cache["k"].shape[1]
        slot = torch.remainder(pos, w)
        k = _batched_update(cache["k"], k_new, slot)
        v = _batched_update(cache["v"], v_new, slot)
        cache["kpos"][torch.arange(b, device=q.device), slot.long()] = \
            pos.to(cache["kpos"].dtype)
        return layers.attention(q, k, v, causal=True,
                                window=cfg.sliding_window, q_offset=pos,
                                k_positions=cache["kpos"],
                                chunk=cfg.attn_chunk)
    # attention(q, k, v, causal=True, q_offset=pos, kv_len=pos + 1)
    # with the step's mask made once
    k = _batched_update(cache["k"], k_new, pos, tick.get("index"))
    v = _batched_update(cache["v"], v_new, pos, tick.get("index"))
    return layers.grouped_attention(q, k, v, tick["mask"])


def _decode_attend_sharded(cfg, q, k_new, v_new, cache, pos, tick):
    """:func:`_decode_attend` under a mesh, on local rows. A full-attention
    cache whose sequence is split over "model" is written on the rank
    whose part holds the slot and attended part by part, the parts
    combined over "model"; any other cache is whole on every "model"
    rank, and each rank runs the plain step on its rows."""
    kv = {k: cache[k] for k in ("k", "v", "kpos") if k in cache}
    pos_l = shmod.rows(pos)
    split = not cfg.sliding_window and \
        shmod.shard_range(cache["k"], 1)[1] < cache["k"].shape[1]
    if not split:
        mask = tick.get("mask")
        mask = None if mask is None else shmod.rows(mask)

        def run(ql, kl, vl, c, pl, ml):
            return _decode_attend(cfg, ql, kl, vl, c, pl, {"mask": ml})
        return shmod.local(run, q, k_new, v_new, kv, pos_l, mask)
    lo = shmod.shard_range(cache["k"], 1)[0]
    s_total = cache["k"].shape[1]
    mask = shmod.constrain(tick["mask"], shmod.batch_axes(), None, "model")

    def run_split(ql, kl, vl, c, pl, ml):
        layers.split_update(c["k"], kl, pl, s_total, lo)
        layers.split_update(c["v"], vl, pl, s_total, lo)
        return layers.grouped_attention(ql, c["k"], c["v"], ml,
                                        seq_split=True)
    return shmod.local(run_split, q, k_new, v_new, kv, pos_l, mask)


def _decode_self_attn(x, p, cfg, cache, pos, tick):
    """One-token self-attention against the cache at per-slot positions
    pos (B,); the cache's leaves are updated in place. ``tick`` holds what
    every layer of the step shares (:func:`tick_constants`)."""
    q, k_new, v_new = _decode_qkv(x, p, cfg, tick)
    attend = (_decode_attend_sharded if shmod.is_dtensor(q)
              else _decode_attend)
    return layers.attn_out(attend(cfg, q, k_new, v_new, cache, pos, tick),
                           p)


def _decode_ssm(h, p, cfg, cache):
    """The mixer's one-token recurrence; ``conv``/``ssm`` updated in place
    (under a mesh on each rank's channels and heads)."""
    if shmod.is_dtensor(h):
        return mamba2.mamba_decode_sharded(h, p["ssm"], cfg, cache["conv"],
                                           cache["ssm"])
    y, (conv, ssm) = mamba2.mamba_mixer(
        h, p["ssm"], cfg, conv_state=cache["conv"], ssm_state=cache["ssm"],
        single_step=True)
    _write_state(cache, conv, ssm)
    return y


def block_decode(cfg: ModelConfig, p: dict, x, cache: dict, pos, tick):
    """One block for one token a row: x (B, 1, D); ``cache`` is this
    layer's (views of the stacked cache), updated in place; ``tick``:
    :func:`tick_constants`."""
    p = cast_floats(p, cfg.dtype)
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mixer_kind == "attn" and cfg.attn_kind == "mla":
        if shmod.is_dtensor(h):
            out = mla_lib.mla_decode_sharded(h, p["attn"], cfg, cache["ckv"],
                                             cache["kr"], pos, tick)
        else:
            out, _, _ = mla_lib.mla_decode(
                h, p["attn"], cfg, cache["ckv"], cache["kr"], pos,
                index=tick["index"], mask=tick["mask"], table=tick["rope"])
        x = x + out
    elif cfg.mixer_kind == "attn":
        x = x + _decode_self_attn(h, p["attn"], cfg, cache, pos, tick)
    elif cfg.mixer_kind == "ssm":
        return x + _decode_ssm(h, p, cfg, cache)
    else:                                           # hybrid
        ya = _decode_self_attn(h, p["attn"], cfg, cache, pos, tick)
        ys = _decode_ssm(h, p, cfg, cache)
        x = x + _hybrid_mix(cfg, p, ya, ys)
    h2 = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _mlp(h2, p["mlp"], cfg)


def cross_attend(cfg, h, p, ck, cv):
    """One token a row's cross-attention through ``wo``: h (B, 1, D) normed,
    against cached context K/V ck, cv (B, n_context, KVH, hd); under a
    mesh q is gathered over "model" and each rank attends its rows."""
    def attend(q2, k, v):
        q = q2.reshape(q2.shape[0], 1, cfg.n_heads, cfg.head_dim)
        return layers.attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    if shmod.is_dtensor(h):
        o = shmod.local(attend, shmod.rows(shmod.col_parallel(h, p["wq"])),
                        ck, cv)
    else:
        o = attend(h @ p["wq"], ck, cv)
    return layers.attn_out(o, p)


def _cross_decode(cfg, p, x, ck, cv):
    """One token a row through a cross block against its cached context
    K/V (ck, cv (B, n_context, KVH, hd))."""
    p = cast_floats(p, cfg.dtype)
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + cross_attend(cfg, h, p["attn"], ck, cv)
    h2 = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _mlp(h2, p["mlp"], cfg)


def tick_constants(cfg: ModelConfig, blocks: dict, pos: torch.Tensor
                   ) -> dict:
    """What every layer of a decode step shares: the RoPE table at pos,
    and for a full (not sliding-window) attention or latent cache the
    write index and the mask. ``blocks``: the stacked block caches."""
    tick = {"rope": rope_table(cfg, pos[:, None])}
    if cfg.attn_kind == "mla":
        s = blocks["ckv"].shape[-2]                 # (..., B, S, lora)
    elif "k" in blocks and not cfg.sliding_window:
        s = blocks["k"].shape[-3]                   # (..., B, S, KVH, hd)
    else:
        return tick
    tick["index"] = layers.update_index(pos, s, 1)
    tick["mask"] = layers.decode_mask(pos, s)
    return tick


def serve_embed(cfg, params, tokens):
    """:func:`embed_tokens` for prefill and decode. Under a mesh the table
    stays split by vocabulary rows over "model" (gathered over the data
    axes only if the layout splits it there): each rank looks up the
    tokens its rows hold and gives zeros for the others, and the parts
    are summed over "model"."""
    if shmod.mesh() is None:
        return embed_tokens(cfg, params, tokens)
    from torch.distributed.tensor import Partial
    dt = as_dtype(cfg.dtype)
    e = shmod.constrain(params["embed"], "model", None)
    tok = shmod.constrain_batch(tokens, None)
    lo, n = shmod.shard_range(e, 0)
    if n == e.shape[0]:
        return shmod.constrain_act(shmod.local(
            lambda t, el: F.embedding(t.long(), el).to(dt), tok, e))

    def run(t, el):
        r = t.long() - lo
        ok = (r >= 0) & (r < n)
        return (F.embedding(r.clamp(0, n - 1), el) * ok[..., None]).to(dt)
    out = list(tok.placements)
    out[shmod.mesh().mesh_dim_names.index("model")] = Partial()
    return shmod.constrain_act(shmod.local(run, tok, e, out=tuple(out)))


def serve_logits(cfg: ModelConfig, params: dict, x: torch.Tensor
                 ) -> torch.Tensor:
    """:func:`lm_logits` for prefill and decode. Under a mesh the head stays
    split by vocabulary columns over "model" (column-parallel) and the
    logits are gathered."""
    if not shmod.is_dtensor(x):
        return lm_logits(cfg, params, x)
    dt = as_dtype(cfg.dtype)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return shmod.rows(shmod.col_parallel(x.to(dt), w.to(dt)).float())


def decode(cfg: ModelConfig, params: dict, cache: dict, token: torch.Tensor,
           pos) -> tuple[torch.Tensor, dict]:
    """token (B, 1) int, pos scalar or (B,) per-slot positions (continuous
    batching) -> (logits (B, V) f32, the cache, updated in place)."""
    x = serve_embed(cfg, params, token)
    if shmod.is_dtensor(pos):
        pos = pos.full_tensor()
    pos = torch.as_tensor(pos, device=x.device).to(torch.int32).expand(
        token.shape[0])
    tick = tick_constants(cfg, cache["blocks"], pos)
    n_groups, per = groups(cfg)
    for g in range(n_groups):
        for j in range(per):
            x = block_decode(cfg, self_layer(cfg, params["blocks"], g, j), x,
                             self_layer(cfg, cache["blocks"], g, j), pos,
                             tick)
        if cfg.cross_attn_period:
            x = _cross_decode(cfg, layer(params["cross_blocks"], g), x,
                              cache["cross_k"][g], cache["cross_v"][g])
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return serve_logits(cfg, params, x)[:, 0], cache


def _cross_kv(cfg, p, ctx, dst: dict) -> None:
    """A group's context K/V for decode, written into ``dst`` (its
    ``cross_k``/``cross_v`` leaves), as the reference's prefill projects
    them: from the raw context (no ``lnc``) times the parameters in their
    own dtype (a bf16 context against f32 weights promotes to f32), then
    cast to the cache's dtype (ROADMAP queue 3). Under a mesh on local
    rows, ``wk``/``wv`` gathered."""
    if shmod.is_dtensor(ctx):
        shmod.local(lambda c, w, d: _cross_kv(cfg, {"attn": w}, c, d), ctx,
                    shmod.replicated({k: p["attn"][k] for k in ("wk", "wv")}),
                    dst)
        return
    b, tc, _ = ctx.shape
    for name, w in (("cross_k", p["attn"]["wk"]), ("cross_v",
                                                   p["attn"]["wv"])):
        dt = torch.promote_types(ctx.dtype, w.dtype)
        kv = (ctx.to(dt) @ w.to(dt)).reshape(b, tc, cfg.n_kv_heads,
                                             cfg.head_dim)
        dst[name].copy_(kv.to(dst[name].dtype))


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            cache: dict, *, context: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, dict]:
    """Run the whole prompt tokens (B, T), fill the cache (in place) and
    return the last position's logits (B, V) f32 and the cache. A VLM's
    context K/V are projected here, once a group."""
    ctx = _context(cfg, context)
    x = serve_embed(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    table = rope_table(cfg, positions)
    n_groups, per = groups(cfg)
    for g in range(n_groups):
        for j in range(per):
            x = block_apply(cfg, self_layer(cfg, params["blocks"], g, j), x,
                            positions, table,
                            self_layer(cfg, cache["blocks"], g, j))
            x = shmod.constrain_act(x)
        if ctx is not None:
            p_cross = layer(params["cross_blocks"], g)
            _cross_kv(cfg, p_cross, ctx, {n: cache[n][g] for n in (
                "cross_k", "cross_v")})
            x = shmod.constrain_act(cross_block_apply(cfg, p_cross, x, ctx))
    x = layers.rms_norm(shmod.seq_all_gather(x)[:, -1:], params["final_norm"],
                        cfg.norm_eps)
    return serve_logits(cfg, params, x)[:, 0], cache
