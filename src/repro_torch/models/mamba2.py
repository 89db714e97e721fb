"""Mamba-2 mixer via state-space duality (SSD, arXiv:2405.21060).

Port of ``repro/models/mamba2.py``. Prefill and forward use the chunked
SSD algorithm (quadratic within chunks, a linear recurrence across them,
here a loop over chunks); decode is the O(1) per-token recurrence on the
(H, P, N) state. The depthwise conv keeps a (W-1)-deep state for decode.

Numerics mirrored from the reference: ``dt = softplus(f32 + dt_bias)``
(``logaddexp(x, 0)``), ``a = -exp(A_log)``; ``_segsum`` masks with -inf
before the exp; the B·C score product runs in x's dtype, then f32, and
every other SSD product in f32 on f32 casts; the state is f32 in every
dtype; ``_causal_conv`` is a sum of W shifted products from 0, each add
rounded in x's dtype (not ``F.conv1d``, which accumulates in f32).
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import rms_norm, silu
from .params import P, Spec


def ssm_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return d_in, n_heads, conv_dim


def mamba_schema(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in, nh, conv_dim = ssm_dims(cfg)
    gn = s.n_groups * s.d_state
    return {"w_z": Spec((d, d_in), pspec=P("data", "model")),
            "w_x": Spec((d, d_in), pspec=P("data", "model")),
            "w_B": Spec((d, gn), pspec=P("data", None)),
            "w_C": Spec((d, gn), pspec=P("data", None)),
            "w_dt": Spec((d, nh), pspec=P("data", None)),
            "dt_bias": Spec((nh,), "zeros", pspec=P(None)),
            "A_log": Spec((nh,), "zeros", pspec=P(None)),
            "D": Spec((nh,), "ones", pspec=P(None)),
            "conv_w": Spec((s.conv_width, conv_dim), pspec=P(None, "model")),
            "norm_w": Spec((d_in,), "ones", pspec=P("model")),
            "w_out": Spec((d_in, d), pspec=P("model", "data"))}


def _repeat(x: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """``jnp.repeat(x, rep, axis=dim)``: each entry along ``dim`` ``rep``
    times in a row (an expand, no host sync)."""
    if rep == 1:
        return x
    shape = x.shape
    return x.unsqueeze(dim + 1).expand(
        *shape[:dim + 1], rep, *shape[dim + 1:]).reshape(
        *shape[:dim], shape[dim] * rep, *shape[dim + 1:])


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(-|x|)) (``F.softplus`` switches to x past a threshold)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., L) -> (..., L, L): sums over segments (j, i] for i >= j,
    -inf above the diagonal."""
    ll = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((ll, ll), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, seg, -torch.inf)


def ssd_chunked(x, dt, a, b, c, *, chunk: int, init_state=None):
    """SSD scan. x (B, T, H, P); dt (B, T, H) f32; a (H,) f32, negative;
    b, c (B, T, G, N). T is padded to a multiple of ``chunk``. Returns
    (y (B, T, H, P) in x's dtype, final_state (B, H, P, N) f32)."""
    bsz, t, h, pd = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    pad = (-t) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, 0, 0, pad))
        c = torch.nn.functional.pad(c, (0, 0, 0, 0, 0, pad))
    nc = (t + pad) // chunk
    f32 = torch.float32
    xc = x.reshape(bsz, nc, chunk, h, pd)
    dtc = dt.reshape(bsz, nc, chunk, h).to(f32)
    bh = _repeat(b.reshape(bsz, nc, chunk, g, n), rep, 3)
    ch = _repeat(c.reshape(bsz, nc, chunk, g, n), rep, 3)

    da = (dtc * a).to(f32)                                  # (B,nc,L,H)
    da_cs = torch.cumsum(da, dim=2)
    xf = xc.to(f32)

    # intra-chunk: (C·B in x's dtype) × decay × dt, against x
    ll = torch.exp(_segsum(da.transpose(2, 3)))             # (B,nc,H,L,L)
    scores = torch.einsum("bclhn,bcshn->bchls", ch, bh).to(f32)
    m = scores * ll * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_diag = torch.matmul(m, xf.permute(0, 1, 3, 2, 4)).permute(
        0, 1, 3, 2, 4)                                      # (B,nc,L,H,P)

    # chunk boundary states
    decay_states = torch.exp(da_cs[:, :, -1:, :] - da_cs)   # (B,nc,L,H)
    xw = xf * (decay_states * dtc)[..., None]               # (B,nc,L,H,P)
    states = torch.einsum("bclhp,bclhn->bchpn", xw, bh.to(f32))

    # inter-chunk recurrence
    chunk_decay = torch.exp(da_cs[:, :, -1, :])             # (B,nc,H)
    s_prev = (torch.zeros((bsz, h, pd, n), dtype=f32, device=x.device)
              if init_state is None else init_state.to(f32))
    prevs = []
    for i in range(nc):
        prevs.append(s_prev)
        s_prev = s_prev * chunk_decay[:, i, :, None, None] + states[:, i]
    s_prevs = torch.stack(prevs, dim=1)                     # (B,nc,H,P,N)

    # inter-chunk contribution
    out_decay = torch.exp(da_cs)                            # (B,nc,L,H)
    y_off = torch.einsum("bclhn,bchpn->bclhp", ch.to(f32),
                         s_prevs) * out_decay[..., None]

    y = (y_diag + y_off).reshape(bsz, nc * chunk, h, pd)[:, :t]
    return y.to(x.dtype), s_prev


def ssd_decode_step(state, x, dt, a, b, c):
    """One-token recurrence. state (B, H, P, N) f32; x (B, H, P); dt (B, H)
    f32; b, c (B, G, N) -> (y (B, H, P) in x's dtype, new_state f32)."""
    h = x.shape[1]
    rep = h // b.shape[1]
    f32 = torch.float32
    bh = _repeat(b, rep, 1)                                 # (B,H,N)
    ch = _repeat(c, rep, 1)
    da = torch.exp((dt * a[None, :]).to(f32))               # (B,H)
    upd = (dt.to(f32)[:, :, None, None] * x.to(f32)[..., None]
           * bh.to(f32)[:, :, None, :])
    new_state = state * da[:, :, None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, ch.to(f32))
    return y.to(x.dtype), new_state


def _causal_conv(xbc, conv_w, conv_state=None):
    """Depthwise causal conv of width W. xbc (B, T, C); conv_w (W, C).
    With conv_state (B, W-1, C), that history goes first (decode).
    Returns (silu(out) (B, T, C), the new state: the last W-1 rows)."""
    w = conv_w.shape[0]
    t = xbc.shape[1]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], w - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)                     # (B,T+W-1,C)
    out = 0
    for i in range(w):
        out = out + full[:, i:i + t] * conv_w[i][None, None]
    new_state = full[:, -(w - 1):] if w > 1 else pad
    return silu(out), new_state


def mamba_mixer(u, p, cfg: ModelConfig, *, conv_state=None, ssm_state=None,
                single_step=False):
    """u (B, T, D) -> (y (B, T, D), (conv_state, ssm_state)).

    ``single_step=True`` runs the O(1) decode recurrence (T must be 1)."""
    s = cfg.ssm
    d_in, nh, _ = ssm_dims(cfg)
    bsz, t, _ = u.shape
    z = u @ p["w_z"]
    xin = u @ p["w_x"]
    b = u @ p["w_B"]
    c = u @ p["w_C"]
    dt = softplus((u @ p["w_dt"]).float() + p["dt_bias"][None, None])

    xbc = torch.cat([xin, b, c], dim=-1)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"].to(u.dtype), conv_state)
    gn = s.n_groups * s.d_state
    xin, b, c = torch.split(xbc, [d_in, gn, gn], dim=-1)

    xh = xin.reshape(bsz, t, nh, s.head_dim)
    bg = b.reshape(bsz, t, s.n_groups, s.d_state)
    cg = c.reshape(bsz, t, s.n_groups, s.d_state)
    a = -torch.exp(p["A_log"].float())

    if single_step:
        y1, new_ssm = ssd_decode_step(ssm_state, xh[:, 0], dt[:, 0], a,
                                      bg[:, 0], cg[:, 0])
        y = y1[:, None]
    else:
        y, new_ssm = ssd_chunked(xh, dt, a, bg, cg, chunk=s.chunk,
                                 init_state=ssm_state)
    y = y + xh * p["D"].to(u.dtype)[None, None, :, None]
    y = y.reshape(bsz, t, d_in)
    y = rms_norm(y * silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["w_out"], (new_conv, new_ssm)


def mamba_decode_sharded(u, p, cfg: ModelConfig, conv_state, ssm_state):
    """The one-token recurrence under a mesh: u (B, 1, D) and the
    parameters DTensors; ``conv_state`` (B, W-1, conv_dim) split over
    "model" by channels and ``ssm_state`` (B, H, P, N) by heads (each as
    its schema's pspec allows), both updated in place. Returns the
    mixer's output (B, 1, D) in the activation layout.

    ``w_x`` is column-parallel and its output gathered over "model" (one
    token: small); each rank runs the depthwise conv on its channels
    (``conv_w`` split like the state) and the channels are gathered; the
    SSD step runs on each rank's heads, ``w_z``'s output split with them;
    the gated norm over the inner width sums its squares over "model";
    ``w_out`` is row-parallel."""
    from ..dist import sharding as shmod
    s = cfg.ssm
    d_in, nh, _ = ssm_dims(cfg)
    gn = s.n_groups * s.d_state
    h_lo, h_n = shmod.shard_range(ssm_state, 1)
    hsplit = h_n < nh
    c_lo, c_n = shmod.shard_range(conv_state, 2)
    z = shmod.constrain_batch(shmod.col_parallel(u, p["w_z"]), None,
                              "model" if hsplit else None)
    xin = shmod.rows(shmod.col_parallel(u, p["w_x"]))
    ur = shmod.rows(u)
    small = shmod.replicated({k: p[k] for k in (
        "w_B", "w_C", "w_dt", "dt_bias", "A_log", "D")})

    def conv(xl, ul, pl, cw, cs):
        xbc = torch.cat([xl, ul @ pl["w_B"], ul @ pl["w_C"]], dim=-1)
        out, new = _causal_conv(xbc[..., c_lo:c_lo + c_n], cw.to(ul.dtype),
                                cs)
        cs.copy_(new)
        return out
    xbc = shmod.rows(shmod.local(conv, xin, ur, small, p["conv_w"],
                                 conv_state, out=conv_state.placements))

    def ssd(xl, ul, pl, zl, nw, st):
        bsz = ul.shape[0]
        hs = slice(h_lo, h_lo + h_n)
        xi, b, c = torch.split(xl, [d_in, gn, gn], dim=-1)
        xh = xi.reshape(bsz, 1, nh, s.head_dim)[:, :, hs]
        rep = nh // s.n_groups
        bh = _repeat(b.reshape(bsz, s.n_groups, s.d_state), rep, 1)[:, hs]
        ch = _repeat(c.reshape(bsz, s.n_groups, s.d_state), rep, 1)[:, hs]
        dt = softplus((ul @ pl["w_dt"]).float() + pl["dt_bias"][None, None])
        a = -torch.exp(pl["A_log"].float())
        y1, new = ssd_decode_step(st, xh[:, 0], dt[:, 0, hs], a[hs], bh, ch)
        st.copy_(new)
        y = y1[:, None] + xh * pl["D"].to(ul.dtype)[None, None, hs, None]
        y = y.reshape(bsz, 1, h_n * s.head_dim) * silu(zl)
        if not hsplit:
            return rms_norm(y, nw, cfg.norm_eps)
        y32 = y.float()
        var = shmod.model_reduce(torch.sum(y32 * y32, -1, keepdim=True)) \
            / d_in
        return (y32 * torch.rsqrt(var + cfg.norm_eps)).to(y.dtype) * \
            nw.to(y.dtype)
    nw = shmod.constrain(p["norm_w"], "model" if hsplit else None)
    y = shmod.local(ssd, xbc, ur, small, z, nw, ssm_state, out=z.placements)
    return shmod.row_parallel(y, p["w_out"])
