"""The decoder-only transformer, dense family: GQA attention (full or
sliding-window) and a SwiGLU MLP in every block.

Port of the dense part of ``repro/models/transformer.py``. The layout is
the reference's: block weights are stacked on a leading layer axis
(``params["blocks"][...]`` of shape (L, ...)) and the decode cache the
same way (``cache["blocks"]["k"]`` (L, B, S, KVH, hd)); the port loops
over the layers and slices them. Activations are (B, T, D).

A configuration of another family (MoE, MLA, SSM, hybrid, cross-attention
or encoder-decoder) is refused with ``NotImplementedError``: those blocks
are ROADMAP queue 1 item 2.2.

The decode cache is updated IN PLACE (the reference returns a new cache
from a jitted function that donates the old one); :func:`decode` and
:func:`prefill` return the cache they were given.
"""
from __future__ import annotations

import torch

from . import layers
from .config import ModelConfig
from .params import Spec, as_dtype, cast_floats, stack

NOT_PORTED = "ROADMAP queue 1 item 2.2 (MoE, MLA, Mamba2, Whisper, cross-attention)"


def check_dense(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is a dense decoder-only
    GQA model, the family the port runs so far."""
    other = [name for name, on in (
        ("moe", cfg.moe is not None), ("attn_kind=mla", cfg.attn_kind == "mla"),
        (f"mixer_kind={cfg.mixer_kind}", cfg.mixer_kind != "attn"),
        ("cross_attn_period", bool(cfg.cross_attn_period)),
        ("encoder_decoder", cfg.encoder_decoder)) if on]
    if other or cfg.attn_kind != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(other) or cfg.attn_kind} is not ported "
            f"to repro_torch yet; see {NOT_PORTED}")


# --------------------------------------------------------------------------
# schemas
# --------------------------------------------------------------------------


def attn_schema(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": Spec((d, h * hd)), "wk": Spec((d, kv * hd)),
            "wv": Spec((d, kv * hd)), "wo": Spec((h * hd, d))}


def mlp_schema(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": Spec((d, f)), "w_in": Spec((d, f)),
            "w_out": Spec((f, d))}


def block_schema(cfg: ModelConfig) -> dict:
    return {"ln1": Spec((cfg.d_model,), "ones"), "attn": attn_schema(cfg),
            "ln2": Spec((cfg.d_model,), "ones"), "mlp": mlp_schema(cfg)}


def model_schema(cfg: ModelConfig) -> dict:
    """The parameter schema: ``embed``, the stacked ``blocks``,
    ``final_norm`` and (untied) ``lm_head``."""
    check_dense(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    sch: dict = {"embed": Spec((v, d), "embed"),
                 "blocks": stack(block_schema(cfg), cfg.n_layers),
                 "final_norm": Spec((d,), "ones")}
    if not cfg.tie_embeddings:
        sch["lm_head"] = Spec((d, v))
    return sch


def layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree: views of every leaf's slice."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# --------------------------------------------------------------------------
# block application (full sequence: forward / prefill)
# --------------------------------------------------------------------------


def _mlp(x, p):
    return layers.swiglu(x, p["w_gate"], p["w_in"], p["w_out"])


def block_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor, table, cache=None) -> torch.Tensor:
    """One block over a full sequence: x (B, T, D) -> (B, T, D)
    (``table``: the RoPE table of ``positions``, made once a pass). With
    ``cache``, this layer's decode cache, its K/V are written there, as
    prefill does."""
    p = cast_floats(p, cfg.dtype)
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = layers.gqa_qkv(h, p["attn"], cfg, positions, table)
    if cache is not None:
        _write_kv(cfg, cache, k, v)
    o = layers.attention(q, k, v, causal=True, window=cfg.sliding_window,
                         chunk=cfg.attn_chunk)
    x = x + layers.attn_out(o, p["attn"])
    h2 = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _mlp(h2, p["mlp"])


def embed_tokens(cfg, params, tokens):
    return params["embed"][tokens.long()].to(as_dtype(cfg.dtype))


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor
            ) -> torch.Tensor:
    """tokens (B, T) int -> final hidden states (B, T, D), normed."""
    check_dense(cfg)
    x = embed_tokens(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    table = layers.rope_table(positions, cfg.head_dim, cfg.rope_theta)
    for i in range(cfg.n_layers):
        x = block_apply(cfg, layer(params["blocks"], i), x, positions, table)
    return layers.rms_norm(x, params["final_norm"], cfg.norm_eps)


def lm_logits(cfg: ModelConfig, params: dict, x: torch.Tensor
              ) -> torch.Tensor:
    """x (..., D) -> logits (..., V) f32: the product in the compute dtype,
    then cast to f32."""
    dt = as_dtype(cfg.dtype)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x.to(dt) @ head.to(dt)).float()


# --------------------------------------------------------------------------
# decode (one new token a row against a cache)
# --------------------------------------------------------------------------


def init_cache_schema(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """Schema of the decode cache: per layer ``k``/``v`` (B, S, KVH, hd) in
    the compute dtype, S = max_seq, or the window for sliding-window
    attention, which also keeps ``kpos`` (B, S) int32, the position each
    slot holds (-1: none)."""
    check_dense(cfg)
    w = cfg.sliding_window
    s = min(w, max_seq) if w else max_seq
    kvshape = (batch, s, cfg.n_kv_heads, cfg.head_dim)
    c = {"k": Spec(kvshape, "zeros", cfg.dtype),
         "v": Spec(kvshape, "zeros", cfg.dtype)}
    if w:
        c["kpos"] = Spec((batch, s), "neg", torch.int32)
    return {"blocks": stack(c, cfg.n_layers)}


def _update_index(pos: torch.Tensor, s: int, t: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows (B, 1), cols (B, T)) of a T-token write at per-batch start pos
    into S slots, placed as ``lax.dynamic_update_slice`` places it: a
    negative start counts from the end, and the start is clamped to
    [0, S - T]."""
    start = pos.long()
    start = torch.where(start < 0, start + s, start).clamp(0, s - t)
    rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
    return rows, start[:, None] + torch.arange(t, device=pos.device)


def _batched_update(cache_arr: torch.Tensor, new_vals: torch.Tensor,
                    pos: torch.Tensor, index=None) -> torch.Tensor:
    """Write new_vals (B, T, ...) into cache (B, S, ...) at per-batch start
    ``pos`` (B,), in place (``index``: :func:`_update_index`'s, if made
    already for this pos)."""
    rows, cols = index or _update_index(pos, cache_arr.shape[1],
                                        new_vals.shape[1])
    cache_arr[rows, cols] = new_vals.to(cache_arr.dtype)
    return cache_arr


def _decode_self_attn(x, p, cfg, cache, pos, tick):
    """One-token self-attention against the cache at per-slot positions
    pos (B,); the cache's leaves are updated in place. ``tick`` holds what
    every layer of the step shares (:func:`_tick_constants`)."""
    b = x.shape[0]
    q, k_new, v_new = layers.gqa_qkv(x, p, cfg, pos[:, None], tick["rope"])
    if cfg.sliding_window:
        w = cache["k"].shape[1]
        slot = torch.remainder(pos, w)
        k = _batched_update(cache["k"], k_new, slot)
        v = _batched_update(cache["v"], v_new, slot)
        cache["kpos"][torch.arange(b, device=x.device), slot.long()] = \
            pos.to(cache["kpos"].dtype)
        o = layers.attention(q, k, v, causal=True, window=cfg.sliding_window,
                             q_offset=pos, k_positions=cache["kpos"],
                             chunk=cfg.attn_chunk)
    else:
        # attention(q, k, v, causal=True, q_offset=pos, kv_len=pos + 1)
        # with the step's mask made once
        k = _batched_update(cache["k"], k_new, pos, tick["index"])
        v = _batched_update(cache["v"], v_new, pos, tick["index"])
        o = layers.grouped_attention(q, k, v, tick["mask"])
    return layers.attn_out(o, p)


def block_decode(cfg: ModelConfig, p: dict, x, cache: dict, pos, tick):
    """One block for one token a row: x (B, 1, D); ``cache`` is this
    layer's (views of the stacked cache), updated in place; ``tick``:
    :func:`_tick_constants`."""
    p = cast_floats(p, cfg.dtype)
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + _decode_self_attn(h, p["attn"], cfg, cache, pos, tick)
    h2 = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _mlp(h2, p["mlp"])


def _tick_constants(cfg: ModelConfig, s: int, pos: torch.Tensor) -> dict:
    """What every layer of a decode step shares: the RoPE table at pos,
    and for a full cache of S slots the write index and the mask."""
    tick = {"rope": layers.rope_table(pos[:, None], cfg.head_dim,
                                      cfg.rope_theta)}
    if not cfg.sliding_window:
        tick["index"] = _update_index(pos, s, 1)
        tick["mask"] = layers.decode_mask(pos, s)
    return tick


def decode(cfg: ModelConfig, params: dict, cache: dict, token: torch.Tensor,
           pos) -> tuple[torch.Tensor, dict]:
    """token (B, 1) int, pos scalar or (B,) per-slot positions (continuous
    batching) -> (logits (B, V) f32, the cache, updated in place)."""
    check_dense(cfg)
    x = embed_tokens(cfg, params, token)
    pos = torch.as_tensor(pos, device=x.device).to(torch.int32).expand(
        token.shape[0])
    tick = _tick_constants(cfg, cache["blocks"]["k"].shape[2], pos)
    for i in range(cfg.n_layers):
        x = block_decode(cfg, layer(params["blocks"], i), x,
                         layer(cache["blocks"], i), pos, tick)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(cfg, params, x)[:, 0], cache


def _write_kv(cfg, cache_block: dict, k, v) -> None:
    """Prefill's cache write at slot 0 on. With a sliding window, the last
    ``keep = min(w, T)`` tokens go to slots 0..keep-1 (the reference's
    layout: decode then writes position p at slot p mod w, so a prompt
    longer than the window and not a multiple of it overwrites a slot that
    is not the oldest; ROADMAP queue 3)."""
    t = k.shape[1]
    if cfg.sliding_window:
        keep = min(cache_block["k"].shape[1], t)
        cache_block["k"][:, :keep] = k[:, t - keep:]
        cache_block["v"][:, :keep] = v[:, t - keep:]
        cache_block["kpos"][:, :keep] = torch.arange(
            t - keep, t, dtype=cache_block["kpos"].dtype, device=k.device)
    else:
        if t > cache_block["k"].shape[1]:
            raise ValueError(f"a prompt of {t} tokens does not fit a cache "
                             f"of {cache_block['k'].shape[1]}")
        cache_block["k"][:, :t] = k
        cache_block["v"][:, :t] = v


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            cache: dict) -> tuple[torch.Tensor, dict]:
    """Run the whole prompt tokens (B, T), fill the cache (in place) and
    return the last position's logits (B, V) f32 and the cache."""
    check_dense(cfg)
    x = embed_tokens(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    table = layers.rope_table(positions, cfg.head_dim, cfg.rope_theta)
    for i in range(cfg.n_layers):
        x = block_apply(cfg, layer(params["blocks"], i), x, positions, table,
                        layer(cache["blocks"], i))
    x = layers.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return lm_logits(cfg, params, x)[:, 0], cache
