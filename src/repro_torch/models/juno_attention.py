"""JUNO-attention: the paper's ANN machinery applied to decode-time
attention (beyond the paper; motivated by its own §6.5 Llama experiment).

Port of ``repro/models/juno_attention.py``. Attention IS maximum
inner-product search: query vectors search the cached keys. The keys are
PQ-encoded per KV head (2-D subspaces, the paper's geometry), every
position is scored with the IP-LUT scan (reading S·(hd/2) uint8 code bytes
instead of S·hd·2 bf16 key bytes), then attention runs EXACTLY over the
top-C positions: the H2 two-stage idea (approximate scan, static top-C,
exact rerank) transplanted into the KV cache. Quality knob: C.

The reference reaches no Pallas kernel here: this is plain PyTorch, with
the reference's numerics. The caches are bf16 and the q·k product is cast
to f32 after the contraction; ``lax.top_k`` becomes a stable descending
sort, so tied scores come out by position; invalid positions are -inf
before the top-C and -1e30 after it. Randomness is injected: the k-means
init draws are an argument, so a test can replay the reference's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.kmeans import kmeans
from ..core.pq import split_subspaces
from ..device import resolve_device

ENCODE_CHUNK = 1024   # positions a step of _encode: (B, H, chunk, S_sub, E, 2) f32


class KVIndex(NamedTuple):
    """A per-KV-head PQ index over the cached keys."""

    entries: torch.Tensor   # (H, S_sub, E, 2) f32: per-head codebooks
    codes: torch.Tensor     # (B, H, S, S_sub) uint8: the encoded keys


def kv_index_from_arrays(entries: np.ndarray, codes: np.ndarray,
                         device=None) -> KVIndex:
    """Build a KV index on ``device`` from its two arrays.

    Parameters
    ----------
    entries : np.ndarray
        (H, S_sub, E, 2) f32 per-head codebooks.
    codes : np.ndarray
        (B, H, S, S_sub) uint8 encoded keys.
    device : str or torch.device, optional
        ``None`` = ``cuda``; ``"cpu"`` for the CPU.

    Returns
    -------
    KVIndex
        The index, both arrays bit-equal to their source (the reference's
        ``repro.models.juno_attention.KVIndex`` as numpy carries across).
    """
    dev = resolve_device(device)
    return KVIndex(
        entries=torch.from_numpy(np.array(entries, copy=True)).to(dev),
        codes=torch.from_numpy(np.array(codes, copy=True)).to(dev))


def draw_kv_init(n_heads: int, n_sub: int, n_points: int, n_entries: int,
                 *, seed: int = 0, device=None) -> torch.Tensor:
    """The k-means init draws of :func:`build_kv_index`: for each (head,
    subspace), ``n_entries`` point indices in [0, n_points), distinct
    unless there are fewer points than entries (the reference's
    ``jax.random.choice`` contract; another generator, so other indices).
    Returns (H, S_sub, E) int64 on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    weights = torch.ones((n_heads * n_sub, n_points), device=dev)
    idx = torch.multinomial(weights, n_entries,
                            replacement=n_points < n_entries, generator=gen)
    return idx.reshape(n_heads, n_sub, n_entries)


def build_kv_index(k_cache: torch.Tensor, *, n_entries: int = 16,
                   init_idx: torch.Tensor | None = None, seed: int = 0,
                   n_iters: int = 4) -> KVIndex:
    """k_cache (B, S, KVH, hd) -> the per-head PQ index over its keys.

    Built once at prefill; decode appends with :func:`encode_step`. Each
    head's B·S keys split into hd/2 subspaces of 2 dims, whose codebooks
    train as one batched k-means of H·hd/2 problems (the reference's
    ``vmap`` over heads and subspaces) from ``init_idx`` (H, S_sub, E)
    point indices, drawn by :func:`draw_kv_init` from ``seed`` when
    ``None``. Runs on ``k_cache``'s device.
    """
    b, s, h, hd = k_cache.shape
    n_sub, n = hd // 2, b * s
    if init_idx is None:
        init_idx = draw_kv_init(h, n_sub, n, n_entries, seed=seed,
                                device=k_cache.device)
    keys = k_cache.float().permute(2, 0, 1, 3).reshape(h * n, hd)
    sub = split_subspaces(keys, 2).reshape(h, n, n_sub, 2)
    sub = sub.transpose(1, 2).reshape(h * n_sub, n, 2)   # (H·S_sub, N, 2)
    state = kmeans(sub, init_idx.reshape(h * n_sub, n_entries),
                   n_iters=n_iters, chunk=min(4096, n))
    entries = state.centroids.reshape(h, n_sub, n_entries, 2)
    return KVIndex(entries=entries, codes=_encode(k_cache, entries))


def _encode(k_cache: torch.Tensor, entries: torch.Tensor) -> torch.Tensor:
    """k (B, S, H, hd), entries (H, S_sub, E, 2) -> codes (B, H, S, S_sub)
    uint8: each subspace's nearest entry (the first on a tie), over
    ``ENCODE_CHUNK`` positions at a time."""
    b, s, h, hd = k_cache.shape
    codes = torch.empty((b, h, s, hd // 2), dtype=torch.uint8,
                        device=k_cache.device)
    for lo in range(0, s, ENCODE_CHUNK):
        k = k_cache[:, lo:lo + ENCODE_CHUNK]
        sub = k.float().reshape(b, k.shape[1], h, hd // 2, 2)
        sub = sub.permute(0, 2, 1, 3, 4)                      # (B, H, c, S_sub, 2)
        d = torch.sum((sub[:, :, :, :, None, :]
                       - entries[None, :, None]) ** 2, dim=-1)   # (B, H, c, S_sub, E)
        codes[:, :, lo:lo + k.shape[1]] = torch.argmin(d, dim=-1).to(torch.uint8)
    return codes


def encode_step(index: KVIndex, k_new: torch.Tensor,
                pos: torch.Tensor) -> KVIndex:
    """Append one token's key codes at per-batch positions ``pos`` (B,).

    k_new (B, 1, H, hd). The codes are written IN PLACE (the reference
    returns a new array; a decode step here rewrites B·H rows instead of
    copying the whole (B, H, S, S_sub) code cache), and the index is
    returned. A position past the cache is clamped to its last slot, as
    ``lax.dynamic_update_slice`` clamps it.
    """
    new = _encode(k_new, index.entries)[:, :, 0]          # (B, H, S_sub)
    b, s = index.codes.shape[0], index.codes.shape[2]
    p = pos.to(device=index.codes.device, dtype=torch.int64).clamp(0, s - 1)
    index.codes[torch.arange(b, device=p.device), :, p] = new
    return index


def _approx_scores(qg: torch.Tensor, index: KVIndex, pos: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 1, the approximate inner products from the codes: qg
    (B, KVH, G, hd) grouped queries -> (approx (B, KVH, G, S) f32, -inf at
    invalid positions; valid (B, S) bool, positions 0..pos[b])."""
    b, h, g, hd = qg.shape
    s = index.codes.shape[2]
    dev = index.codes.device
    qsub = qg.float().reshape(b, h, g, hd // 2, 2)
    lut = torch.einsum("bhgsm,hsem->bhgse", qsub, index.entries)
    n_sub, e = lut.shape[-2:]
    idx = (torch.arange(n_sub, device=dev) * e
           + index.codes.to(torch.int64))                 # (B, H, S, S_sub)
    gathered = torch.gather(lut.reshape(b, h, g, n_sub * e), 3,
                            idx.reshape(b, h, 1, s * n_sub).expand(-1, -1, g, -1))
    approx = gathered.reshape(b, h, g, s, n_sub).sum(-1)
    valid = torch.arange(s, device=dev)[None, :] <= pos.to(dev)[:, None]
    return approx.masked_fill(~valid[:, None, None], float("-inf")), valid


def _top_positions(approx: torch.Tensor, top_c: int) -> torch.Tensor:
    """The top-``top_c`` positions of each row of ``approx`` by score, ties
    by position (``lax.top_k``'s order): a stable descending sort."""
    c = min(top_c, approx.shape[-1])
    return torch.sort(approx, dim=-1, descending=True,
                      stable=True).indices[..., :c]


def juno_decode_attention(q: torch.Tensor, index: KVIndex,
                          k_cache: torch.Tensor, v_cache: torch.Tensor,
                          pos: torch.Tensor, *, top_c: int = 128
                          ) -> torch.Tensor:
    """One decode step of JUNO-attention.

    q (B, 1, H, hd) (post-rope), caches (B, S, KVH, hd), pos (B,): the
    positions 0..pos[b] are valid. GQA: the H query heads group onto the
    KVH codebooks. Stage 1 scores every position approximately from the
    codes and the (q, entry) LUT; stage 2 attends exactly over each query
    head's top-``top_c`` positions. Returns (B, 1, H, hd) in the caches'
    dtype.
    """
    b, _, hq, hd = q.shape
    h = k_cache.shape[2]
    g = hq // h
    dev = k_cache.device
    qg = q[:, 0].reshape(b, h, g, hd)
    approx, valid = _approx_scores(qg, index, pos)

    # stage 2: exact attention over the per-head top-C positions
    top_idx = _top_positions(approx, top_c)               # (B, H, G, C)
    bi = torch.arange(b, device=dev)[:, None, None, None]
    hi = torch.arange(h, device=dev)[None, :, None, None]
    k_sel = k_cache.transpose(1, 2)[bi, hi, top_idx]      # (B, H, G, C, hd)
    v_sel = v_cache.transpose(1, 2)[bi, hi, top_idx]
    dt = torch.promote_types(qg.dtype, k_sel.dtype)
    scores = torch.einsum("bhgd,bhgcd->bhgc", qg.to(dt),
                          k_sel.to(dt)).float() / (hd ** 0.5)
    sel_valid = torch.gather(valid[:, None, None].expand(-1, h, g, -1), 3,
                             top_idx)
    scores = scores.masked_fill(~sel_valid, -1e30)
    w = torch.softmax(scores, dim=-1).to(v_sel.dtype)
    o = torch.einsum("bhgc,bhgcd->bhgd", w, v_sel)
    return o.reshape(b, 1, hq, hd)


def traffic_model(s: int, hd: int, top_c: int) -> dict:
    """Decode-attention HBM bytes per (head, step): exact vs JUNO."""
    exact = s * hd * 2 * 2                      # K and V, bf16
    juno = s * (hd // 2) + top_c * hd * 2 * 2   # uint8 codes + exact top-C
    return {"exact_bytes": exact, "juno_bytes": juno,
            "reduction_x": exact / juno}
