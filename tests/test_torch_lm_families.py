"""The port's MoE, MLA, Mamba-2 (SSD), hybrid, cross-attention (VLM) and
Whisper encoder-decoder families against ``repro``'s, on the six SMOKE
configs of those families (deepseek-v2-lite, llama4-scout, mamba2,
hymba, llama-3.2-vision, whisper-large-v3). Parameters are the
reference's ``init_params`` draws carried across with
``params_from_reference``; inputs come from numpy seeds.

Tolerances:

* f32: rtol 1e-5 with an atol of 1e-5 times the reference's largest
  magnitude (the same sums in another order), unless a case states its
  own;
* bf16 model outputs: within 2^-5 of the reference's largest magnitude
  (``test_torch_lm.py``'s: the reference's jitted scans keep some f32
  intermediates, so bf16 outputs differ by a few ulps; measured
  0.5-1.8e-2 here). In the MoE families a token whose router
  probabilities are a near-tie (top-k margin below ``NEAR_TIE``) can go
  to another expert on such a difference, and under capacity drops that
  moves every later token's slot (token-major order), so a bf16 MoE
  model is held row by row up to the first row outside 2^-5, which must
  be such a near-tie in the port's routing (llama4's SMOKE prompt: token
  53 of row 0, margin 0.0012 at layer 0). Prefill's cache likewise, on
  the tokens before the first whose last-layer entry is outside 2^-5
  (again a near-tie of prefill's routing), and its logits and decode on
  the batch rows wholly before it. Decode from the reference's own cache
  carried across is compared whole;
* the SSD's four-operand einsums (``ssd_chunked``'s intra-chunk and
  boundary-state terms) contract in an order XLA chooses, the port's in
  its own: f32 within 1e-5 of the output's largest magnitude;
* the MoE combine (a scatter-add in the compute dtype) bit-equal in bf16;
  the routing (experts, positions in expert, drops) equal;
* ``_causal_conv`` bit-equal in bf16 to the reference run op by op (each
  of its W adds rounds in bf16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (family_batches, jax_normal_draws,
                           jax_token_draws, port_hidden, port_model_config,
                           ref_hidden, ref_smoke_params, to_numpy_tree)
from repro import configs as RC
from repro.data.tokens import make_batch as r_make_batch
from repro.models import api as RA
from repro.models import get_model as r_get_model
from repro.models import layers as RL
from repro.models import mamba2 as RS
from repro.models import mla as RM
from repro.models import moe as RMoE
from repro.models import params as RPm
from repro.models import transformer as RT
from repro.models import whisper as RW
from repro_torch import configs as PC
from repro_torch.data.tokens import make_batch as p_make_batch
from repro_torch.models import (cache_from_reference, get_model,
                                params_from_reference)
from repro_torch.models import layers as PL
from repro_torch.models import mamba2 as PS
from repro_torch.models import mla as PM
from repro_torch.models import moe as PMoE
from repro_torch.models import params as PPm
from repro_torch.models import transformer as PT
from repro_torch.models import whisper as PW

FAMILIES = ["deepseek_v2_lite_16b", "llama4_scout_17b_a16e", "mamba2_1_3b",
            "hymba_1_5b", "llama_3_2_vision_90b", "whisper_large_v3"]
DTYPES = ["float32", "bfloat16"]
BF16_MODEL_TOL = 2.0 ** -5
NEAR_TIE = 2.0 ** -6     # a router top-k margin a bf16 ulp can flip
T_PROMPT = 72            # > 2 * 32-token windows; 4.5 SSD chunks of 16
S_CACHE = 96


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_close(got, want, dtype: str, what: str, *, f32_rtol=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not want.size:
        return
    scale = float(np.abs(want).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=f32_rtol,
                                   atol=f32_rtol * scale, err_msg=what)
    else:
        err = float(np.abs(got - want).max())
        assert err <= BF16_MODEL_TOL * scale, f"{what}: {err} > {scale}/32"


def configs(arch: str, dtype: str):
    r = dataclasses.replace(RC.get_smoke_config(arch), dtype=dtype)
    return r, port_model_config(r)


_RUNS: dict = {}


def model_run(arch: str, dtype: str) -> dict:
    """Both packages' forward logits over T_PROMPT + 1 tokens, loss,
    prefill of T_PROMPT and decode of the next (and decode from the
    reference's own prefilled cache carried across), batch 2, on the same
    parameters; computed once a module."""
    if (arch, dtype) in _RUNS:
        return _RUNS[arch, dtype]
    rc, pc = configs(arch, dtype)
    rm, pm = r_get_model(rc), get_model(pc)
    rp = ref_smoke_params(arch)
    pp = params_from_reference(to_numpy_tree(rp), pc, "cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, rc.vocab_size, (2, T_PROMPT + 2)).astype(np.int32)
    ctx = rng.standard_normal((2, rc.n_context_tokens, rc.d_model)
                              ).astype(np.float32)
    full_r, full_p, _ = family_batches(rc, toks, T_PROMPT + 1, ctx)
    br, bp, _ = family_batches(rc, toks, T_PROMPT, ctx)
    nxt = toks[:, T_PROMPT:T_PROMPT + 1]
    out = {"ref": {}, "port": {}}
    rcache = RPm.init_params(rm.cache_schema(2, S_CACHE),
                             jax.random.PRNGKey(0))

    @jax.jit
    def ref_all(p, full, b, cache, nxt):
        # the reference's loss is _xent of these logits (api.py:67-71)
        logits = RT.lm_logits(rc, p, ref_hidden(rc, p, full))
        pre, cache = rm.prefill(p, b, cache)
        dec, cache2 = rm.decode(p, cache, nxt, T_PROMPT)
        return (logits, RA._xent(logits, full["targets"]), pre, cache, dec,
                cache2)
    (out["ref"]["logits"], out["ref"]["loss"], out["ref"]["prefill"],
     rcache, out["ref"]["decode"], out["ref"]["cache_after"]) = ref_all(
        rp, full_r, br, rcache, jnp.asarray(nxt))
    out["ref"]["cache"] = rcache
    with record_margins() as margins:
        out["port"]["logits"] = PT.lm_logits(pc, pp, port_hidden(
            pc, pp, full_p))
    out["port"]["margins"] = margins
    out["port"]["loss"] = pm.loss(pp, full_p)
    pcache = PPm.init_params(pm.cache_schema(2, S_CACHE), device="cpu")
    with record_margins() as margins:
        out["port"]["prefill"], pcache = pm.prefill(pp, bp, pcache)
    out["port"]["prefill_margins"] = margins
    out["port"]["cache"] = PPm.tree_map(torch.clone, pcache)  # decode: in place
    carried = cache_from_reference(to_numpy_tree(rcache), pc, "cpu")
    out["port"]["decode"], _ = pm.decode(pp, pcache, torch.from_numpy(nxt),
                                         T_PROMPT)
    out["port"]["decode_carried"], carried = pm.decode(
        pp, carried, torch.from_numpy(nxt), T_PROMPT)
    out["port"]["cache_after"] = carried
    _RUNS[arch, dtype] = out
    return out


class record_margins:
    """Within the block, each ``moe.route`` call's top-k margin a token
    (the k-th largest router probability less the (k+1)-th), (N,) f32, in
    call (layer) order."""

    def __enter__(self):
        self.orig, self.margins = PMoE.route, []

        def route(tokens, router, moe):
            probs = torch.softmax((tokens @ router.to(tokens.dtype)).float(),
                                  -1)
            top = torch.sort(probs, -1, descending=True).values
            self.margins.append((top[:, moe.top_k - 1]
                                 - top[:, moe.top_k]).numpy())
            return self.orig(tokens, router, moe)
        PMoE.route = route
        return self.margins

    def __exit__(self, *exc):
        PMoE.route = self.orig


def first_flip(run, dtype: str) -> int:
    """The token-major index (b·T + t) of the first forward-logit row
    outside the bf16 tolerance, after checking that every earlier row is
    inside it and that this token's routing was a near-tie in some MoE
    layer (f32, or no such row: past the last token)."""
    got, want = _np(run["port"]["logits"]), _np(run["ref"]["logits"])
    b, t, _ = want.shape
    if dtype == "float32" or not run["port"]["margins"]:
        return b * t
    rows = np.abs(got - want).max(-1).reshape(-1)
    bad = np.flatnonzero(rows > BF16_MODEL_TOL * np.abs(want).max())
    if not len(bad):
        return b * t
    margin = min(float(m[bad[0]]) for m in run["port"]["margins"])
    assert margin < NEAR_TIE, (
        f"row {bad[0]} differs by {rows[bad[0]]} with no routing near-tie "
        f"(top-k margin {margin})")
    return int(bad[0])


def _leaves(tree) -> dict:
    """Flat {path: leaf} of a cache tree (either package's)."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}")
        else:
            out[path] = t
    walk(tree, "")
    return out


def assert_cache_close(got, want, dtype: str, what: str, n_tokens=None):
    """Every leaf of two caches equal (ints) or close. With ``n_tokens``,
    a per-token leaf (B, S, ...) is compared on the first ``n_tokens`` of
    the prompt's (token-major: b·T_PROMPT + t) and the empty slots past
    the prompt. The batch axis follows the stacked layer axes: two for a
    VLM's blocks (groups, self blocks, B, ...)."""
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w), (sorted(g), sorted(w))
    for path in g:
        assert str(g[path].dtype).split(".")[-1] == str(w[path].dtype), path
        gw = g[path].float().numpy() if g[path].dtype.is_floating_point \
            else g[path].numpy()
        ww = np.asarray(w[path]).astype(gw.dtype)
        lead = 2 if "/cross_k" in g and path.startswith("/blocks/") else 1
        if n_tokens is not None and path.split("/")[-1] in (
                "k", "v", "kpos", "ckv", "kr"):
            b, s = gw.shape[lead:lead + 2]
            keep = ((np.arange(b)[:, None] * T_PROMPT + np.arange(s)
                     < n_tokens) | (np.arange(s) >= T_PROMPT)).reshape(-1)
            flat = lambda a: np.compress(keep, a.reshape(  # noqa: E731
                a.shape[:lead] + (b * s,) + a.shape[lead + 2:]), axis=lead)
            gw, ww = flat(gw), flat(ww)
        if not g[path].dtype.is_floating_point:          # kpos
            np.testing.assert_array_equal(gw, ww, err_msg=path)
        else:
            assert_close(gw, ww, dtype, f"{what} {path}")


def prefill_flip(run, dtype: str) -> int:
    """A bf16 MoE model's first prompt token (token-major) whose entry in
    the last layer's cache is outside the bf16 tolerance, after checking
    that it is a near-tie of prefill's own routing in some layer (all
    2·T_PROMPT tokens in f32, or when none is)."""
    p, r = run["port"], run["ref"]
    n = 2 * T_PROMPT
    if dtype == "float32" or not p["prefill_margins"]:
        return n
    leaf = "ckv" if "ckv" in p["cache"]["blocks"] else "k"
    got = _np(p["cache"]["blocks"][leaf][-1])[:, :T_PROMPT]
    want = _np(r["cache"]["blocks"][leaf][-1])[:, :T_PROMPT]
    err = np.abs(got - want).reshape(n, -1).max(-1)
    bad = np.flatnonzero(err > BF16_MODEL_TOL * np.abs(want).max())
    if not len(bad):
        return n
    margin = min(float(m[bad[0]]) for m in p["prefill_margins"])
    assert margin < NEAR_TIE, (
        f"prompt token {bad[0]}'s cache differs by {err[bad[0]]} with no "
        f"routing near-tie (top-k margin {margin})")
    return int(bad[0])


# --------------------------------------------------------------------------
# the model, both dtypes, the six SMOKE configs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_and_loss(arch, dtype):
    run = model_run(arch, dtype)
    flip = first_flip(run, dtype)
    t = run["ref"]["logits"].shape[1]
    got, want = run["port"]["logits"], run["ref"]["logits"]
    assert_close(got.reshape(-1, got.shape[-1])[:flip],
                 _np(want).reshape(-1, want.shape[-1])[:flip], dtype,
                 "forward logits")
    print(f"{arch} {dtype}: rows compared {min(flip, 2 * t)} of {2 * t}")
    got, want = float(run["port"]["loss"]), float(run["ref"]["loss"])
    assert np.isfinite(got)
    tol = 1e-5 if dtype == "float32" else 1e-3
    assert abs(got - want) <= tol * abs(want), (got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode(arch, dtype):
    run = model_run(arch, dtype)
    r, p = run["ref"], run["port"]
    # bf16 MoE: the tokens before prefill's first near-tie flip, and the
    # batch rows wholly before it
    tie = prefill_flip(run, dtype)
    n = min(tie // T_PROMPT, 2)
    print(f"{arch} {dtype}: prefill tokens compared {tie}, rows {n}")
    assert_close(p["prefill"][:n], _np(r["prefill"])[:n], dtype,
                 "prefill logits")
    assert_cache_close(p["cache"], r["cache"], dtype, "prefill cache", tie)
    assert_close(p["decode"][:n], _np(r["decode"])[:n], dtype,
                 "decode logits")
    assert_close(p["decode_carried"], r["decode"], dtype,
                 "decode from the carried cache")
    assert_cache_close(p["cache_after"], r["cache_after"], dtype,
                       "decode cache")


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------


def _layer0(arch: str, part: str, dtype: str):
    """Layer 0's ``part`` of the reference's SMOKE params of ``arch``, in
    ``dtype``: (the jax tree, the port's tree)."""
    sub = jax.tree.map(lambda a: a[0], ref_smoke_params(arch)["blocks"][part])
    r = RPm.cast_floats(sub, getattr(jnp, dtype))
    return r, PPm.tree_map(lambda a: torch.from_numpy(
        np.array(a, np.float32)).to(getattr(torch, dtype)),
        to_numpy_tree(r))


def _pair(a: np.ndarray, dtype: str):
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(getattr(torch,
                                                                 dtype))


def _ref_route(tokens, router, moe):
    """``repro/models/moe.py:131-146``'s routing, the reference's lines:
    (experts, gates, positions in expert) of the N·k slots."""
    e, k = moe.n_experts, moe.top_k
    logits = (tokens @ router.astype(tokens.dtype)).astype(jnp.float32)
    gate, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    gate = gate / jnp.maximum(jnp.sum(gate, -1, keepdims=True), 1e-9)
    flat_e = idx.reshape(-1)
    oh = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(oh, axis=0) - 1) * oh, axis=-1)
    return flat_e, gate.reshape(-1), pos


# (arch, capacity factor): deepseek's top-2 of 4 with a shared expert,
# llama4's top-1; 0.25 leaves 8 slots an expert for 96 slots: drops
MOE_CASES = {"deepseek": ("deepseek_v2_lite_16b", 1.25),
             "llama4": ("llama4_scout_17b_a16e", 1.25),
             "drops": ("deepseek_v2_lite_16b", 0.25)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_ffn(case, dtype):
    """``moe_ffn`` against ``_moe_ffn_dense`` on layer 0's weights and the
    same (2, 24, D) input: the routing (experts, positions in expert, the
    drop mask) equal, the gates within 1e-6, the output within the
    module's tolerance."""
    arch, cf = MOE_CASES[case]
    rc, pc = configs(arch, dtype)
    rmoe = dataclasses.replace(rc.moe, capacity_factor=cf)
    pmoe = dataclasses.replace(pc.moe, capacity_factor=cf)
    rp, pp = _layer0(arch, "mlp", dtype)
    rx, px = _pair(np.random.default_rng(5).standard_normal(
        (2, 24, rc.d_model)).astype(np.float32), dtype)
    want = jax.jit(lambda x, p: RMoE._moe_ffn_dense(x, p, rmoe))(rx, rp)
    got = PMoE.moe_ffn(px, pp, pmoe)
    assert got.dtype == px.dtype
    assert_close(got, want, dtype, "moe_ffn")
    r_e, r_g, r_pos = jax.jit(lambda t, w: _ref_route(t, w, rmoe))(
        rx.reshape(-1, rc.d_model), rp["router"])
    flat_e, flat_g, pos, keep, cap = PMoE.route(
        px.reshape(-1, pc.d_model), pp["router"], pmoe)
    np.testing.assert_array_equal(flat_e.numpy(), np.asarray(r_e))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(r_pos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(r_pos) < cap)
    np.testing.assert_allclose(flat_g.numpy(), np.asarray(r_g), atol=1e-6)
    assert cap == -(-max(8, int(cf * 48 * rmoe.top_k / rmoe.n_experts))
                    // 8) * 8
    assert bool((~keep).any()) == (case == "drops")


@pytest.mark.parametrize("k", [1, 2, 6])
def test_moe_combine_bit_equal_bf16(k):
    """The combine: the reference's ``zeros.at[token_of_slot].add`` in
    bf16 (each of a token's k adds rounded) against ``moe.combine``."""
    n, d = 40, 48
    vals = np.random.default_rng(k).standard_normal((n * k, d)).astype(
        np.float32)
    rv, pv = _pair(vals, "bfloat16")
    want = jax.jit(lambda v: jnp.zeros((n, d), jnp.bfloat16).at[
        jnp.repeat(jnp.arange(n), k)].add(v))(rv)
    np.testing.assert_array_equal(_np(PMoE.combine(pv, k)), _np(want))


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_attention_and_decode(dtype):
    """Layer 0's MLA on a (2, 20, D) input: the decompressed path against
    ``mla_attention``; the absorbed decode against ``mla_decode`` at
    per-row positions 20 and 13 of a 24-slot latent cache holding the
    reference's ``_latent_kv`` of the input, the new token written in
    place."""
    rc, pc = configs("deepseek_v2_lite_16b", dtype)
    rp, pp = _layer0("deepseek_v2_lite_16b", "attn", dtype)
    rng = np.random.default_rng(6)
    rx, px = _pair(rng.standard_normal((2, 20, rc.d_model)).astype(
        np.float32), dtype)
    want = jax.jit(lambda x, p: RM.mla_attention(x, p, rc, jnp.arange(20)))(
        rx, rp)
    assert_close(PM.mla_attention(px, pp, pc, torch.arange(20)), want,
                 dtype, "mla_attention")

    ckv, kr = jax.jit(lambda x, p: RM._latent_kv(x, p, rc, jnp.arange(20)))(
        rx, rp)
    m = rc.mla
    r_ckv = jnp.zeros((2, 24, m.kv_lora_rank), dtype).at[:, :20].set(ckv)
    r_kr = jnp.zeros((2, 24, m.qk_rope_dim), dtype).at[:, :20].set(kr)
    pos = np.array([20, 13], np.int32)
    rx1, px1 = _pair(rng.standard_normal((2, 1, rc.d_model)).astype(
        np.float32), dtype)
    want, w_ckv, w_kr = jax.jit(lambda *a: RM.mla_decode(
        a[0], a[1], rc, a[2], a[3], a[4]))(rx1, rp, r_ckv, r_kr,
                                           jnp.asarray(pos))
    p_ckv, p_kr = (torch.from_numpy(_np(a)).to(getattr(torch, dtype))
                   for a in (r_ckv, r_kr))
    got, g_ckv, g_kr = PM.mla_decode(px1, pp, pc, p_ckv, p_kr,
                                     torch.from_numpy(pos))
    assert g_ckv is p_ckv and g_kr is p_kr                  # in place
    assert_close(got, want, dtype, "mla_decode")
    assert_close(g_ckv, w_ckv, dtype, "mla_decode ckv")
    assert_close(g_kr, w_kr, dtype, "mla_decode kr")


# --------------------------------------------------------------------------
# Mamba-2
# --------------------------------------------------------------------------


def _ssd_inputs(dtype: str, t: int):
    """SSD inputs: B 2, T t, 4 heads of 8 on 2 groups of state 16."""
    rng = np.random.default_rng(7)
    b, h, p, g, n = 2, 4, 8, 2, 16
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    dt = np.log1p(np.exp(f(b, t, h)))                         # softplus
    a = -np.exp(f(h) * 0.5)
    x, bb, cc = f(b, t, h, p), f(b, t, g, n), f(b, t, g, n)
    state = f(b, h, p, n)
    jx, tx = zip(*(_pair(v, dtype) for v in (x, bb, cc)))
    jf, tf = zip(*(_pair(v, "float32") for v in (dt, a, state)))
    return jx + jf, tx + tf


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunked(init, dtype):
    """``ssd_chunked`` at T 37 (chunks of 16: padded), with and without an
    initial state, against the reference's; the final state f32 in both.
    f32 within 1e-5 of the largest magnitude (four-operand einsums in
    another contraction order)."""
    (rx, rb, rc_, rdt, ra, rs), (px, pb, pc_, pdt, pa, ps) = _ssd_inputs(
        dtype, 37)
    want_y, want_s = jax.jit(lambda *a: RS.ssd_chunked(
        *a[:5], chunk=16, init_state=a[5] if init else None))(
        rx, rdt, ra, rb, rc_, rs)
    got_y, got_s = PS.ssd_chunked(px, pdt, pa, pb, pc_, chunk=16,
                                  init_state=ps if init else None)
    assert got_y.dtype == px.dtype and got_s.dtype == torch.float32
    assert_close(got_y, want_y, dtype, "ssd y")
    assert_close(got_s, want_s, dtype, "ssd state")


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_decode_step(dtype):
    (rx, rb, rc_, rdt, ra, rs), (px, pb, pc_, pdt, pa, ps) = _ssd_inputs(
        dtype, 1)
    want_y, want_s = jax.jit(RS.ssd_decode_step)(
        rs, rx[:, 0], rdt[:, 0], ra, rb[:, 0], rc_[:, 0])
    got_y, got_s = PS.ssd_decode_step(ps, px[:, 0], pdt[:, 0], pa,
                                      pb[:, 0], pc_[:, 0])
    assert_close(got_y, want_y, dtype, "decode y")
    assert_close(got_s, want_s, dtype, "decode state")


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_bit_equal_bf16(with_state):
    """``_causal_conv`` in bf16 bit-equal to the reference's run op by op
    (its W shifted products summed from 0, each add rounded; then silu),
    the new state too."""
    rng = np.random.default_rng(8)
    xbc = rng.standard_normal((2, 9, 40)).astype(np.float32)
    w = rng.standard_normal((4, 40)).astype(np.float32) * 0.5
    st = rng.standard_normal((2, 3, 40)).astype(np.float32)
    (rx, px), (rw, pw), (rs, ps) = (_pair(a, "bfloat16") for a in (xbc, w,
                                                                     st))
    want = RS._causal_conv(rx, rw, rs if with_state else None)
    got = PS._causal_conv(px, pw, ps if with_state else None)
    for g, w_ in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(g), _np(w_))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("single_step", [False, True])
def test_mamba_mixer(single_step, dtype):
    """Layer 0's mixer of SMOKE mamba2: chunked over (2, 21, D) from no
    state, and one step from a random conv/SSM state; outputs and new
    states against the reference's."""
    rc, pc = configs("mamba2_1_3b", dtype)
    rp, pp = _layer0("mamba2_1_3b", "ssm", dtype)
    rng = np.random.default_rng(9)
    t = 1 if single_step else 21
    ru, pu = _pair(rng.standard_normal((2, t, rc.d_model)).astype(
        np.float32), dtype)
    kw_r, kw_p = {}, {}
    if single_step:
        _, nh, conv_dim = RS.ssm_dims(rc)
        s = rc.ssm
        kw_r["conv_state"], kw_p["conv_state"] = _pair(
            rng.standard_normal((2, s.conv_width - 1, conv_dim)).astype(
                np.float32), dtype)
        kw_r["ssm_state"], kw_p["ssm_state"] = _pair(
            rng.standard_normal((2, nh, s.head_dim, s.d_state)).astype(
                np.float32), "float32")
    want, (w_conv, w_ssm) = jax.jit(lambda u, p, kw: RS.mamba_mixer(
        u, p, rc, single_step=single_step, **kw))(ru, rp, kw_r)
    got, (g_conv, g_ssm) = PS.mamba_mixer(pu, pp, pc,
                                          single_step=single_step, **kw_p)
    assert_close(got, want, dtype, "mixer y")
    assert_close(g_conv, w_conv, dtype, "conv state")
    assert g_ssm.dtype == torch.float32
    assert_close(g_ssm, w_ssm, dtype, "ssm state")


# --------------------------------------------------------------------------
# Whisper, the token pipeline, configs and the weights' carry-across
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_whisper_encode(dtype):
    """The encoder (not causal) over SMOKE whisper's 24 frames."""
    rc, pc = configs("whisper_large_v3", dtype)
    rp = ref_smoke_params("whisper_large_v3")
    pp = params_from_reference(to_numpy_tree(rp), pc, "cpu")
    rf, pf = _pair(np.random.default_rng(10).standard_normal(
        (2, rc.n_context_tokens, rc.d_model)).astype(np.float32), dtype)
    want = jax.jit(lambda p, f: RW.encode(rc, p, f))(rp, rf)
    assert_close(PW.encode(pc, pp, pf), want, dtype, "encode")


@pytest.mark.parametrize("arch", ["whisper_large_v3",
                                  "llama_3_2_vision_90b"])
def test_make_batch_frames_and_context(arch):
    """Whisper's ``frames`` and the VLM's ``context`` with the reference's
    draws replayed (``_torch_parity.jax_normal_draws``): bit-equal, cast
    to the compute dtype; the port's own draws a pure function of (seed,
    step, shard)."""
    rc, pc = configs(arch, "bfloat16")
    name = "frames" if rc.encoder_decoder else "context"
    b, s, step, seed, shard = 2, 12, 3, 1, 2
    want = jax.jit(r_make_batch, static_argnums=0, static_argnames=(
        "batch", "seq"))(rc, batch=b, seq=s, step=step, seed=seed,
                         shard=shard)
    got = p_make_batch(pc, batch=b, seq=s, step=step, seed=seed, shard=shard,
                       u=jax_token_draws(b, s, step, seed, shard),
                       normal=jax_normal_draws(rc, b, step, seed, shard),
                       device="cpu")
    assert sorted(got) == sorted(want) == sorted(
        ["tokens", "targets", name])
    for k in ("tokens", "targets"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got[name].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got[name]), _np(want[name]))
    one = p_make_batch(pc, batch=b, seq=s, step=step, device="cpu")
    again = p_make_batch(pc, batch=b, seq=s, step=step, device="cpu")
    other = p_make_batch(pc, batch=b, seq=s, step=step + 1, device="cpu")
    assert torch.equal(one[name], again[name])
    assert not torch.equal(one[name], other[name])
    assert abs(float(one[name].float().std()) - 1) < 0.1
    with pytest.raises(ValueError, match="normal"):
        p_make_batch(pc, batch=b, seq=s, step=0, device="cpu",
                     normal=np.zeros((b, 3, pc.d_model), np.float32))


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_n_params_full_configs(arch):
    """All ten FULL configs carried over field for field, with the
    reference's analytic counts and schema sizes."""
    rc, pc = RC.get_config(arch), PC.get_config(arch)
    assert pc == port_model_config(rc)
    assert PC.get_smoke_config(arch) == port_model_config(
        RC.get_smoke_config(arch))
    assert pc.n_params() == rc.n_params()
    assert pc.n_active_params() == rc.n_active_params()
    assert PPm.n_params(get_model(pc).schema) == RPm.n_params(
        r_get_model(rc).schema)
    assert PC.get_config(arch.replace("_", "-")) is pc
    assert PC.ARCH_IDS == RC.ARCH_IDS


def test_carry_across_checks_nested_schemas():
    """``params_from_reference`` and ``cache_from_reference`` check the
    VLM's two stacked axes, its cross blocks and Whisper's trees."""
    rc, pc = configs("llama_3_2_vision_90b", "float32")
    tree = to_numpy_tree(ref_smoke_params("llama_3_2_vision_90b"))
    p = params_from_reference(tree, pc, "cpu")
    assert p["blocks"]["attn"]["wq"].shape[:2] == (2, 1)
    assert p["cross_blocks"]["lnc"].shape == (2, rc.d_model)
    bad = dict(tree, cross_blocks=dict(tree["cross_blocks"],
                                       lnc=tree["cross_blocks"]["lnc"][:1]))
    with pytest.raises(ValueError, match="cross_blocks/lnc"):
        params_from_reference(bad, pc, "cpu")
    flat = dict(tree, blocks=PPm.tree_map(lambda a: a[0], tree["blocks"]))
    with pytest.raises(ValueError, match="blocks"):
        params_from_reference(flat, pc, "cpu")
    rm = r_get_model(rc)
    cache = to_numpy_tree(RPm.init_params(rm.cache_schema(3, 10),
                                          jax.random.PRNGKey(0)))
    got = cache_from_reference(cache, pc, "cpu")
    assert got["blocks"]["k"].shape == (2, 1, 3, 10, rc.n_kv_heads,
                                        rc.head_dim)
    assert got["cross_k"].shape == (2, 3, rc.n_context_tokens,
                                    rc.n_kv_heads, rc.head_dim)
    wc = port_model_config(RC.get_smoke_config("whisper_large_v3"))
    wtree = to_numpy_tree(ref_smoke_params("whisper_large_v3"))
    del wtree["enc_norm"]
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(wtree, wc, "cpu")
    mc = port_model_config(RC.get_smoke_config("mamba2_1_3b"))
    mcache = to_numpy_tree(RPm.init_params(r_get_model(
        RC.get_smoke_config("mamba2_1_3b")).cache_schema(3, 10),
        jax.random.PRNGKey(0)))
    got = cache_from_reference(mcache, mc, "cpu")
    assert got["blocks"]["ssm"].dtype == torch.float32
    assert got["blocks"]["conv"].shape[1] == 3


def test_init_params_draws_stacked_leaves_by_slab():
    """A stacked leaf is drawn slab by slab of its first axis: the same
    values in f32 and in bf16 (cast), every init's scale kept."""
    _, pc = configs("deepseek_v2_lite_16b", "bfloat16")
    schema = get_model(pc).schema
    f32 = PPm.init_params(schema, torch.Generator().manual_seed(1),
                          device="cpu")
    bf = PPm.init_params(schema, torch.Generator().manual_seed(1),
                         device="cpu", dtype="bfloat16")
    for a, b in zip(PPm.tree_leaves(f32), PPm.tree_leaves(bf)):
        assert b.dtype == torch.bfloat16
        assert torch.equal(a.to(torch.bfloat16), b)
    w = f32["blocks"]["mlp"]["w_gate"]                   # (L, E, D, F)
    assert w.ndim == 4
    assert abs(float(w.std()) * pc.d_model ** 0.5 - 1) < 0.05
    assert not torch.equal(w[0], w[1])
