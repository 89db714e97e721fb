"""The port's dense LM path (``repro_torch.models``, ``configs``,
``data.tokens``) against ``repro``'s on the four dense SMOKE configs
(phi4-mini, h2o-danube with its 32-token sliding window, deepseek-coder,
mistral-large). Parameters are the reference's ``init_params`` draws,
carried across with ``params_from_reference``; token ids come from numpy
seeds.

Tolerances:

* f32: rtol 1e-5 with an atol of 1e-5 times the reference's largest
  magnitude (the same sums in another order; measured 1e-6);
* bf16 model outputs: within 2^-5 of the reference's largest magnitude,
  four bf16 ulps at its top (measured 1.0-1.3e-2). The port rounds every
  bf16 step as the reference's ops do eagerly, but the reference's jitted
  scans keep some f32 intermediates that XLA fuses (its ``block_apply``
  under ``jax.jit`` differs from itself run eagerly in 60% of the
  elements by up to 1 ulp), so bf16 outputs differ by a few ulps;
* attention: f32 within 1e-5 of the output's scale; bf16 within 2 bf16
  ulps of the output scale (2^-6 of its largest magnitude);
* ``rms_norm``/``apply_rope``/``swiglu`` in f32: ``rsqrt``, ``sin``,
  ``cos`` and ``exp`` differ by 1 ulp between the two libraries, and the
  mean over D sums in another order (2 ulps), so ``rms_norm`` is within 8
  ulps, ``apply_rope`` within 2 ulps of its terms' magnitude and
  ``swiglu`` within 1e-6 of its largest value; the RoPE frequencies
  within 1 ulp and ``rms_norm``/``silu`` in bf16 bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (jax_kv_draws, jax_token_draws, port_model_config,
                           to_numpy_tree)
from repro import configs as RC
from repro.data.tokens import make_batch as r_make_batch
from repro.models import get_model as r_get_model
from repro.models import juno_attention as RJ
from repro.models import layers as RL
from repro.models import params as RPm
from repro.models import transformer as RT
from repro_torch import configs as PC
from repro_torch.data.tokens import make_batch as p_make_batch
from repro_torch.models import (build_kv_index, cache_from_reference,
                                get_model, juno_decode_attention,
                                params_from_reference)
from repro_torch.models import layers as PL
from repro_torch.models import params as PPm
from repro_torch.models import transformer as PT

ARCHS = ["phi4_mini_3_8b", "h2o_danube_3_4b", "deepseek_coder_33b",
         "mistral_large_123b"]
DTYPES = ["float32", "bfloat16"]
BF16_MODEL_TOL = 2.0 ** -5
BF16_ATTN_TOL = 2.0 ** -6
T_PROMPT = 136            # > 2 * attn_chunk (64): the flash path
S_CACHE = 160


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_close(got, want, dtype: str, what: str, *, bf16_tol=None):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=what)
    else:
        err = float(np.abs(got - want).max())
        tol = (bf16_tol or BF16_MODEL_TOL) * scale
        assert err <= tol, f"{what}: {err} > {tol}"


def configs(arch: str, dtype: str):
    r = dataclasses.replace(RC.get_smoke_config(arch), dtype=dtype)
    p = dataclasses.replace(PC.get_smoke_config(arch), dtype=dtype)
    return r, p


_RUNS: dict = {}
_PARAMS: dict = {}


def ref_params(arch: str) -> dict:
    """The reference's SMOKE parameters of ``arch`` (f32, PRNGKey(0)), made
    once a module, in one jitted ``init_params``."""
    if arch not in _PARAMS:
        schema = r_get_model(RC.get_smoke_config(arch)).schema
        _PARAMS[arch] = jax.jit(lambda k: RPm.init_params(schema, k))(
            jax.random.PRNGKey(0))
    return _PARAMS[arch]


def model_run(arch: str, dtype: str) -> dict:
    """Both packages' forward logits, loss, prefill and decode (and the
    decode from the reference's own prefilled cache carried across) on the
    same parameters and a T_PROMPT-token batch of 2; computed once a
    module."""
    if (arch, dtype) in _RUNS:
        return _RUNS[arch, dtype]
    rc, pc = configs(arch, dtype)
    rm, pm = r_get_model(rc), get_model(pc)
    rp = ref_params(arch)
    pp = params_from_reference(to_numpy_tree(rp), pc, "cpu")
    toks = np.random.default_rng(1).integers(
        0, rc.vocab_size, (2, T_PROMPT + 1)).astype(np.int32)
    prompt, nxt = toks[:, :T_PROMPT], toks[:, T_PROMPT:]
    batch_r = {"tokens": jnp.asarray(prompt), "targets": jnp.asarray(
        toks[:, 1:])}
    batch_p = {"tokens": torch.from_numpy(prompt),
               "targets": torch.from_numpy(toks[:, 1:])}
    out = {"ref": {}, "port": {}}
    out["ref"]["logits"], out["ref"]["loss"] = jax.jit(lambda p, t, b: (
        RT.lm_logits(rc, p, RT.forward(rc, p, t)), rm.loss(p, b)))(
        rp, toks, batch_r)
    out["port"]["logits"] = PT.lm_logits(pc, pp, PT.forward(
        pc, pp, torch.from_numpy(toks)))
    out["port"]["loss"] = pm.loss(pp, batch_p)
    rcache = RPm.init_params(rm.cache_schema(2, S_CACHE),
                             jax.random.PRNGKey(0))
    pcache = PPm.init_params(pm.cache_schema(2, S_CACHE), device="cpu")
    out["ref"]["prefill"], rcache = jax.jit(rm.prefill)(rp, batch_r, rcache)
    out["port"]["prefill"], pcache = pm.prefill(pp, batch_p, pcache)
    out["ref"]["cache"] = rcache
    out["port"]["cache"] = PPm.tree_map(torch.clone, pcache)  # decode: in place
    carried = cache_from_reference(to_numpy_tree(rcache), pc, "cpu")
    out["ref"]["decode"], rcache2 = jax.jit(rm.decode)(
        rp, rcache, jnp.asarray(nxt), T_PROMPT)
    out["port"]["decode"], _ = pm.decode(pp, pcache, torch.from_numpy(nxt),
                                         T_PROMPT)
    out["port"]["decode_carried"], carried = pm.decode(
        pp, carried, torch.from_numpy(nxt), T_PROMPT)
    out["ref"]["cache_after"], out["port"]["cache_after"] = rcache2, carried
    _RUNS[arch, dtype] = out
    return out


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("hd", [16, 28, 32, 120, 128])
def test_rope_freqs_within_one_ulp(hd):
    want = np.asarray(RL.rope_freqs(hd, 1e4))
    assert _ulps(PL.rope_freqs(hd, 1e4).numpy(), want) <= 1


def test_rms_norm_rope_swiglu_f32():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 128)).astype(np.float32)
    w = rng.standard_normal(128).astype(np.float32)
    got = PL.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert _ulps(got, np.asarray(RL.rms_norm(jnp.asarray(x),
                                             jnp.asarray(w)))) <= 8

    x = rng.standard_normal((2, 50, 4, 32)).astype(np.float32)
    pos = np.arange(50) * 37                 # angles up to ~1800 rad
    got = PL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy()
    want = np.asarray(RL.apply_rope(jnp.asarray(x), jnp.asarray(pos)))
    x1, x2 = np.split(np.abs(x), 2, axis=-1)
    terms = np.concatenate([x1 + x2, x1 + x2], -1)
    assert (np.abs(got - want) <= 2 * 2.0 ** -23 * terms).all()

    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.1
          for s in ((64, 96), (64, 96), (96, 64))]
    got = PL.swiglu(*map(torch.from_numpy, (x, *ws))).numpy()
    want = np.asarray(RL.swiglu(*map(jnp.asarray, (x, *ws))))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_rms_norm_and_silu_bf16_bit_equal():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((100, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)            # noqa: E731
    np.testing.assert_array_equal(
        _np(PL.rms_norm(bf(x), bf(w))), _np(RL.rms_norm(jb(x), jb(w))))
    np.testing.assert_array_equal(_np(PL.silu(bf(x))),
                                  _np(jax.nn.silu(jb(x))))


# (B, Tq, Tk, H, KVH, hd, kwargs): decode (Tq <= 4), direct (Tk <= 2 chunk)
# and flash (Tk > 2 chunk, chunk 64), GQA groups of 2 and 4
_POS = np.array([5, 17], np.int32)
_KPOS = np.array([[34, 35, 32, 33] + [-1] * 28, list(range(32, 64))],
                 np.int32)
ATTN_CASES = {
    "decode_kv_len": (2, 1, 40, 4, 2, 32, dict(q_offset=_POS,
                                               kv_len=_POS + 1)),
    "decode_tq3_g4": (2, 3, 40, 8, 2, 16, dict(q_offset=_POS)),
    "decode_swa_kpos": (2, 1, 32, 4, 2, 32, dict(
        window=32, q_offset=np.array([35, 63], np.int32),
        k_positions=_KPOS)),
    "direct": (2, 20, 100, 4, 2, 32, {}),
    "direct_swa_g4": (2, 100, 100, 8, 2, 32, dict(window=32)),
    "flash": (2, 200, 200, 4, 2, 32, {}),
    "flash_kv_len": (2, 200, 200, 4, 2, 32,
                     dict(kv_len=np.array([150, 200], np.int32))),
    # blocks of 32 keys wholly outside the 40-token window
    "flash_swa_masked_blocks": (2, 150, 150, 4, 1, 16, dict(window=40,
                                                             chunk=32)),
    "flash_swa_g4": (2, 200, 200, 8, 2, 32, dict(window=32)),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_paths(case, dtype):
    b, tq, tk, h, kvh, hd, kw = ATTN_CASES[case]
    kw = dict(kw)
    chunk = kw.pop("chunk", 64)
    rng = np.random.default_rng(list(ATTN_CASES).index(case))
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((b, tq, h, hd), (b, tk, kvh, hd), (b, tk, kvh, hd)))
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    arrays = {n: a for n, a in kw.items() if isinstance(a, np.ndarray)}
    static = {n: a for n, a in kw.items() if n not in arrays}
    want = jax.jit(lambda q, k, v, arrays: RL.attention(
        q, k, v, chunk=chunk, **static, **arrays))(
        *(jnp.asarray(a, jd) for a in (q, k, v)), arrays)
    got = PL.attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                       chunk=chunk, **{n: (torch.from_numpy(a) if isinstance(
                           a, np.ndarray) else a) for n, a in kw.items()})
    assert got.dtype == td
    assert np.isfinite(_np(got)).all()
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(_np(want)).max()))
    else:
        assert_close(got, want, dtype, case, bf16_tol=BF16_ATTN_TOL)


def test_batched_update_clamps_like_dynamic_update_slice():
    cache = np.arange(2 * 6 * 3, dtype=np.float32).reshape(2, 6, 3)
    new = -np.ones((2, 1, 3), np.float32)
    for pos in ([0, 5], [3, 9], [7, -2]):
        want = np.asarray(RT._batched_update(jnp.asarray(cache),
                                             jnp.asarray(new),
                                             jnp.asarray(pos, jnp.int32)))
        got = PT._batched_update(torch.from_numpy(cache.copy()),
                                 torch.from_numpy(new),
                                 torch.tensor(pos, dtype=torch.int32))
        np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# the model, both dtypes, the four dense SMOKE configs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss(arch, dtype):
    run = model_run(arch, dtype)
    assert_close(run["port"]["logits"], run["ref"]["logits"], dtype,
                 "forward logits")
    got, want = float(run["port"]["loss"]), float(run["ref"]["loss"])
    assert np.isfinite(got)
    tol = 1e-5 if dtype == "float32" else 1e-3
    assert abs(got - want) <= tol * abs(want), (got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode(arch, dtype):
    run = model_run(arch, dtype)
    r, p = run["ref"], run["port"]
    assert_close(p["prefill"], r["prefill"], dtype, "prefill logits")
    for name in ("k", "v") + (("kpos",) if "kpos" in p["cache"]["blocks"]
                              else ()):
        got, want = p["cache"]["blocks"][name], r["cache"]["blocks"][name]
        if name == "kpos":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            assert_close(got, want, dtype, f"prefill cache {name}")
    assert_close(p["decode"], r["decode"], dtype, "decode logits")
    # decode from the reference's own prefilled cache, carried across
    assert_close(p["decode_carried"], r["decode"], dtype,
                 "decode from the carried cache")
    for name in ("k", "v"):
        assert_close(p["cache_after"]["blocks"][name],
                     r["cache_after"]["blocks"][name], dtype,
                     f"decode cache {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """``tests/test_arch_smoke.py::test_decode_matches_forward`` redone on
    the port: prefill 8 tokens and decode the 9th against a full forward
    pass, in f32, at the reference's rtol = atol = 2e-2."""
    _, cfg = configs(arch, "float32")
    model = get_model(cfg)
    params = PPm.init_params(model.schema, torch.Generator().manual_seed(4),
                             device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 9)).astype(np.int32))
    full = PT.lm_logits(cfg, params, PT.forward(cfg, params, tokens))
    cache = PPm.init_params(model.cache_schema(1, 32), device="cpu")
    pre, cache = model.prefill(params, {"tokens": tokens[:, :8]}, cache)
    np.testing.assert_allclose(pre.numpy(), full[:, 7].numpy(), rtol=2e-2,
                               atol=2e-2)
    dec, _ = model.decode(params, cache, tokens[:, 8:9], 8)
    np.testing.assert_allclose(dec.numpy(), full[:, 8].numpy(), rtol=2e-2,
                               atol=2e-2)


def test_swa_prefill_slot_fault_copied():
    """The reference's sliding-window fault, pinned: prefill stores the
    last ``w`` tokens of a 40-token prompt at slots 0..31 (positions
    8..39), but decode writes position 40 at slot 40 mod 32 = 8, which
    holds position 16, not the oldest (8, at slot 0). Position 16 is lost
    while it is still inside the window, so decode differs from the full
    forward pass; the port does the same, in the same place."""
    rc, pc = configs("h2o_danube_3_4b", "float32")
    rm, pm = r_get_model(rc), get_model(pc)
    rp = ref_params("h2o_danube_3_4b")
    pp = params_from_reference(to_numpy_tree(rp), pc, "cpu")
    toks = np.random.default_rng(2).integers(0, rc.vocab_size, (1, 41)
                                             ).astype(np.int32)
    rcache = RPm.init_params(rm.cache_schema(1, 64), jax.random.PRNGKey(0))
    pcache = PPm.init_params(pm.cache_schema(1, 64), device="cpu")
    _, rcache = rm.prefill(rp, {"tokens": jnp.asarray(toks[:, :40])}, rcache)
    _, pcache = pm.prefill(pp, {"tokens": torch.from_numpy(toks[:, :40])},
                           pcache)
    want_dec, rcache = rm.decode(rp, rcache, jnp.asarray(toks[:, 40:]), 40)
    got_dec, pcache = pm.decode(pp, pcache, torch.from_numpy(toks[:, 40:]),
                                40)
    kpos = pcache["blocks"]["kpos"].numpy()
    np.testing.assert_array_equal(kpos, np.asarray(rcache["blocks"]["kpos"]))
    expect = np.arange(8, 40)
    expect[8] = 40                          # slot 8: position 16 -> 40
    assert (kpos == expect).all(), kpos[0, 0]
    assert_close(got_dec, want_dec, "float32", "decode after the fault")
    full = PT.lm_logits(pc, pp, PT.forward(pc, pp, torch.from_numpy(toks)))
    assert float((got_dec - full[:, 40]).abs().max()) > 2e-2


def test_make_batch_replays_the_reference():
    for arch, (b, s, step, seed, shard) in zip(
            ARCHS, [(2, 16, 0, 0, 0), (3, 33, 5, 1, 0), (1, 64, 2, 7, 3),
                    (4, 8, 9, 0, 1)]):
        rc, pc = configs(arch, "bfloat16")
        want = jax.jit(r_make_batch, static_argnums=0, static_argnames=(
            "batch", "seq"))(rc, batch=b, seq=s, step=step, seed=seed,
                             shard=shard)
        got = p_make_batch(pc, batch=b, seq=s, step=step, seed=seed,
                           shard=shard, device="cpu",
                           u=jax_token_draws(b, s, step, seed, shard))
        for name in ("tokens", "targets"):
            assert got[name].dtype == torch.int32
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))
    # its own draws: a pure function of (seed, step, shard)
    one = p_make_batch(pc, batch=2, seq=16, step=3, device="cpu")
    again = p_make_batch(pc, batch=2, seq=16, step=3, device="cpu")
    other = p_make_batch(pc, batch=2, seq=16, step=4, device="cpu")
    assert torch.equal(one["tokens"], again["tokens"])
    assert not torch.equal(one["tokens"], other["tokens"])
    assert int(one["tokens"].max()) < pc.vocab_size
    np.testing.assert_array_equal(one["tokens"][:, 1:].numpy(),
                                  one["targets"][:, :-1].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_n_params_full_configs(arch):
    rc, pc = RC.get_config(arch), PC.get_config(arch)
    assert pc == port_model_config(rc)
    assert pc.n_params() == rc.n_params()
    assert pc.n_active_params() == rc.n_active_params()
    schema = get_model(pc).schema
    assert PPm.n_params(schema) == RPm.n_params(r_get_model(rc).schema)
    # the analytic count leaves out the final norm, in both packages
    assert PPm.n_params(schema) == pc.n_params() + pc.d_model
    assert PC.get_config(arch.replace("_", "-")) is pc


def test_init_params_inits_and_dtypes():
    _, cfg = configs("phi4_mini_3_8b", "bfloat16")
    schema = get_model(cfg).schema
    gen = torch.Generator().manual_seed(0)
    p = PPm.init_params(schema, gen, device="cpu")
    assert p["embed"].dtype == torch.float32
    assert abs(float(p["embed"].std()) - 0.02) < 0.002
    wq = p["blocks"]["attn"]["wq"]                    # (L, d, H·hd)
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert bool((p["blocks"]["ln1"] == 1).all())
    again = PPm.init_params(schema, torch.Generator().manual_seed(0),
                            device="cpu", dtype="bfloat16")
    assert again["embed"].dtype == torch.bfloat16
    assert torch.equal(again["embed"], p["embed"].to(torch.bfloat16))
    cache = PPm.init_params(get_model(configs("h2o_danube_3_4b",
                                              "bfloat16")[1]).cache_schema(
        2, 40), device="cpu")
    assert cache["blocks"]["k"].dtype == torch.bfloat16
    assert cache["blocks"]["k"].shape == (2, 2, 32, 2, 30)
    assert cache["blocks"]["kpos"].dtype == torch.int32
    assert bool((cache["blocks"]["kpos"] == -1).all())
    with pytest.raises(ValueError, match="generator"):
        PPm.init_params(schema, device="cpu")
    cast = PPm.cast_floats({"a": p["embed"], "i": cache["blocks"]["kpos"]},
                           "bfloat16")
    assert cast["a"].dtype == torch.bfloat16 and cast["i"].dtype == torch.int32


def test_params_from_reference_checks_the_schema():
    rc, pc = configs("phi4_mini_3_8b", "bfloat16")
    tree = to_numpy_tree(ref_params("phi4_mini_3_8b"))
    p = params_from_reference(tree, pc, "cpu")
    assert p["blocks"]["mlp"]["w_in"].dtype == torch.float32
    np.testing.assert_array_equal(p["embed"].numpy(), tree["embed"])
    bf = to_numpy_tree({"x": jnp.asarray(tree["embed"], jnp.bfloat16)})
    got = params_from_reference(dict(tree, embed=bf["x"]), pc,
                                "cpu")["embed"]            # bf16 leaves
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(bf["x"], np.float32))
    bad = dict(tree, embed=tree["embed"][:, :-1])
    with pytest.raises(ValueError, match="embed"):
        params_from_reference(bad, pc, "cpu")
    bad = dict(tree, blocks=dict(tree["blocks"], extra=tree["final_norm"]))
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(bad, pc, "cpu")


def test_juno_attention_lm_flow():
    """``examples/juno_attention_lm.py`` on the port beside the reference:
    prefill 96 tokens of SMOKE phi4-mini (batch 2, a 128-slot cache),
    index layer 0's K cache (16 entries a subspace, the reference's
    k-means draws replayed), and compare JUNO-attention at several top_c
    with exact ``layers.attention`` for a query ~ N(0, 1) * 0.5. Outputs
    within 2^-7 of the reference's (bf16; as
    ``test_torch_juno_attention.py``), the rel_err within 0.02 of it, and
    top_c = S within 4 bf16 ulps of exact attention."""
    rc, pc = configs("phi4_mini_3_8b", "bfloat16")
    rm, pm = r_get_model(rc), get_model(pc)
    rp = ref_params("phi4_mini_3_8b")
    pp = params_from_reference(to_numpy_tree(rp), pc, "cpu")
    b, s_max, t = 2, 128, 96
    toks = np.random.default_rng(3).integers(0, rc.vocab_size, (b, t)
                                             ).astype(np.int32)
    rcache = RPm.init_params(rm.cache_schema(b, s_max), jax.random.PRNGKey(2))
    _, rcache = jax.jit(rm.prefill)(rp, {"tokens": jnp.asarray(toks)},
                                    rcache)
    pcache = PPm.init_params(pm.cache_schema(b, s_max), device="cpu")
    _, pcache = pm.prefill(pp, {"tokens": torch.from_numpy(toks)}, pcache)
    rk, rv = rcache["blocks"]["k"][0], rcache["blocks"]["v"][0]
    pk, pv = pcache["blocks"]["k"][0], pcache["blocks"]["v"][0]
    q = (np.random.default_rng(4).standard_normal(
        (b, 1, rc.n_heads, rc.head_dim)) * 0.5).astype(np.float32)
    rq, pq = jnp.asarray(q, jnp.bfloat16), torch.from_numpy(q).to(
        torch.bfloat16)
    pos = np.full((b,), t, np.int32)
    rpos, ppos = jnp.asarray(pos), torch.from_numpy(pos)
    r_exact = jax.jit(lambda q, k, v, p: RL.attention(
        q, k, v, causal=True, q_offset=p, kv_len=p + 1, chunk=64))(
        rq, rk, rv, rpos)
    p_exact = PL.attention(pq, pk, pv, causal=True, q_offset=ppos,
                           kv_len=ppos + 1, chunk=64)
    assert_close(p_exact, r_exact, "bfloat16", "exact",
                 bf16_tol=BF16_ATTN_TOL)
    r_index = jax.jit(lambda k: RJ.build_kv_index(k, n_entries=16))(rk)
    init = jax_kv_draws(jax.random.PRNGKey(0), rc.n_kv_heads,
                        rc.head_dim // 2, b * s_max, 16)
    p_index = build_kv_index(pk, n_entries=16,
                             init_idx=torch.from_numpy(init).long())

    def rel(a, e):
        a, e = _np(a), _np(e)
        return float(np.linalg.norm(a - e) / np.linalg.norm(e))
    for top_c in (8, 24, 64, 96):
        r_out = jax.jit(lambda *a, c=top_c: RJ.juno_decode_attention(
            *a, top_c=c))(rq, r_index, rk, rv, rpos)
        p_out = juno_decode_attention(pq, p_index, pk, pv, ppos, top_c=top_c)
        assert np.abs(_np(p_out) - _np(r_out)).max() <= 2.0 ** -7
        assert abs(rel(p_out, p_exact) - rel(r_out, r_exact)) <= 0.02
    full = juno_decode_attention(pq, p_index, pk, pv, ppos, top_c=s_max)
    scale = max(1.0, float(p_exact.float().abs().max()))
    assert float((full.float() - p_exact.float()).abs().max()) <= \
        4 * 2.0 ** -8 * scale
