"""``repro_torch.models.juno_attention`` against
``repro.models.juno_attention`` on the reference's smoke widths (the
phi4-mini smoke config's attention: 4 query heads on 2 KV heads of 32
dims, a 128-slot cache of batch 2, 16 entries a subspace), and on a
GQA group of 3 as phi4-mini's full config has (24 on 8). Caches and
queries are made with numpy from a seed and rounded to bf16, the caches'
dtype; the reference's ``jax.random`` draws are replayed.

Tolerances:

* codes are argmins over the same f32 distances: equal;
* the codebooks from replayed draws: within 1e-6 (f32 k-means sums in
  another order; both sides' keys are the same bf16 values);
* the top-C positions: equal, except where two positions' approximate
  scores tie within 1e-5 of their magnitude (the LUT's f32 products and
  the sums over S_sub run in another order);
* attention outputs are bf16: within 2 of its ulps at 1 (2^-7 absolute
  and relative), the rounding of the output and of the softmax weights
  cast to bf16 by either side;
* at ``top_c = S`` the output is exact attention: it equals the
  reference's ``models.layers.attention`` (its decode path) within the
  same bf16 tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_kv_draws
from repro.models import juno_attention as R
from repro.models.layers import attention
from repro_torch.models import juno_attention as P

BF16_TOL = 2.0 ** -7
TIE_RTOL = 1e-5
# (B, S, H, KVH, hd): the smoke config; a group of 3 (phi4-mini's 24/8)
WIDTHS = {"smoke": (2, 128, 4, 2, 32), "gqa3": (2, 96, 6, 2, 16)}
E = 16


def _inputs(name, seed=0):
    b, s, h, kvh, hd = WIDTHS[name]
    rng = np.random.default_rng(seed)
    k, v = (torch.from_numpy(rng.standard_normal((b, s, kvh, hd))
                             .astype(np.float32)).bfloat16() for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((b, 1, h, hd))
                         .astype(np.float32)).bfloat16()
    pos = np.array([s - 32, s // 2 - 1])[:b]
    return q, k, v, pos


def _j(t):
    """A bf16 tensor as the same jnp bf16 array."""
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _ref_index(k):
    return R.build_kv_index(_j(k), n_entries=E)


def _port_index(ref):
    return P.kv_index_from_arrays(np.asarray(ref.entries),
                                  np.asarray(ref.codes), "cpu")


def _assert_bf16_close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("name", list(WIDTHS))
def test_encode_equals_reference(name):
    _, k, _, _ = _inputs(name, 1)
    ref = _ref_index(k)
    got = P._encode(k, torch.tensor(np.asarray(ref.entries)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(R._encode(_j(k), ref.entries)))


@pytest.mark.parametrize("name", list(WIDTHS))
def test_build_kv_index_with_replayed_draws(name):
    b, s, _, kvh, hd = WIDTHS[name]
    _, k, _, _ = _inputs(name, 2)
    key = jax.random.PRNGKey(0)                  # the reference's default
    ref = R.build_kv_index(_j(k), n_entries=E, key=key)
    draws = jax_kv_draws(key, kvh, hd // 2, b * s, E)
    got = P.build_kv_index(k, n_entries=E, init_idx=torch.from_numpy(draws))
    assert got.entries.shape == (kvh, hd // 2, E, 2)
    assert got.codes.shape == (b, kvh, s, hd // 2)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_allclose(got.entries.numpy(), np.asarray(ref.entries),
                               rtol=0, atol=1e-6)


def test_build_kv_index_draws_its_own_init():
    """Without replayed draws the port draws distinct init points from a
    seed: the same seed gives the same index."""
    _, k, _, _ = _inputs("smoke", 3)
    a = P.build_kv_index(k, n_entries=E, seed=5)
    b = P.build_kv_index(k, n_entries=E, seed=5)
    assert torch.equal(a.codes, b.codes) and torch.equal(a.entries, b.entries)
    init = P.draw_kv_init(2, 16, 256, E, seed=5, device="cpu")
    assert init.shape == (2, 16, E)
    assert all(len(set(row.tolist())) == E for row in init.reshape(-1, E))


@pytest.mark.parametrize("name", list(WIDTHS))
def test_encode_step_equals_reference(name):
    b, s, _, kvh, hd = WIDTHS[name]
    _, k, _, _ = _inputs(name, 4)
    ref = _ref_index(k)
    port = _port_index(ref)
    rng = np.random.default_rng(5)
    k_new = torch.from_numpy(rng.standard_normal((b, 1, kvh, hd))
                             .astype(np.float32)).bfloat16()
    # a position inside the cache, and one past it (clamped to the last)
    pos = np.array([3, s + 7])[:b]
    want = R.encode_step(ref, _j(k_new), jnp.asarray(pos))
    got = P.encode_step(port, k_new, torch.from_numpy(pos))
    assert got is port                           # written in place
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.entries.numpy(), np.asarray(ref.entries))


def _ref_top_positions(q, ref, pos, top_c):
    """The reference's stage 1 and top-C (juno_attention.py l.88-105)."""
    b, _, hq, hd = q.shape
    h = ref.entries.shape[0]
    qg = _j(q)[:, 0].reshape(b, h, hq // h, hd)
    qsub = qg.astype(jnp.float32).reshape(b, h, hq // h, hd // 2, 2)
    lut = jnp.einsum("bhgsm,hsem->bhgse", qsub, ref.entries)
    codes = ref.codes.astype(jnp.int32)
    approx = jnp.sum(jnp.take_along_axis(
        lut[:, :, :, None], codes[:, :, None, :, :, None], axis=-1)[..., 0], -1)
    s = codes.shape[2]
    valid = jnp.arange(s)[None, :] <= jnp.asarray(pos)[:, None]
    approx = jnp.where(valid[:, None, None], approx, -jnp.inf)
    return np.asarray(approx), np.asarray(jax.lax.top_k(approx,
                                                        min(top_c, s))[1])


@pytest.mark.parametrize("top_c", [1, 24, 64])
@pytest.mark.parametrize("name", list(WIDTHS))
def test_decode_attention_matches_reference(name, top_c):
    q, k, v, pos = _inputs(name, 6)
    ref = _ref_index(k)
    port = _port_index(ref)
    b, _, hq, hd = q.shape
    h = k.shape[2]
    approx, want_idx = _ref_top_positions(q, ref, pos, top_c)
    got_approx, _ = P._approx_scores(q[:, 0].reshape(b, h, hq // h, hd),
                                     port, torch.from_numpy(pos))
    fin = np.isfinite(approx)
    np.testing.assert_array_equal(np.isfinite(got_approx.numpy()), fin)
    np.testing.assert_allclose(got_approx.numpy()[fin], approx[fin],
                               rtol=TIE_RTOL, atol=1e-5)
    got_idx = P._top_positions(got_approx, top_c).numpy()
    moved = got_idx != want_idx
    # a position may differ only where the two scores it swaps tie
    a = np.take_along_axis(approx, got_idx, -1)[moved]
    w = np.take_along_axis(approx, want_idx, -1)[moved]
    assert (np.abs(a - w) <= TIE_RTOL * np.maximum(np.abs(w), 1.0)).all()
    want = R.juno_decode_attention(_j(q), ref, _j(k), _j(v), jnp.asarray(pos),
                                   top_c=top_c)
    got = P.juno_decode_attention(q, port, k, v, torch.from_numpy(pos),
                                  top_c=top_c)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    _assert_bf16_close(got, want)


@pytest.mark.parametrize("name", list(WIDTHS))
def test_full_top_c_is_exact_attention(name):
    """At top_c = S every valid position is attended: the reference's
    ``layers.attention`` (decode path, causal at q_offset = pos)."""
    q, k, v, pos = _inputs(name, 7)
    s = k.shape[1]
    port = _port_index(_ref_index(k))
    got = P.juno_decode_attention(q, port, k, v, torch.from_numpy(pos),
                                  top_c=s)
    p = jnp.asarray(pos)
    want = attention(_j(q), _j(k), _j(v), causal=True, q_offset=p,
                     kv_len=p + 1, chunk=64)
    _assert_bf16_close(got, want)


def test_kv_index_from_arrays_is_bit_exact():
    _, k, _, _ = _inputs("smoke", 8)
    ref = _ref_index(k)
    port = _port_index(ref)
    assert port.entries.dtype == torch.float32
    assert port.codes.dtype == torch.uint8
    np.testing.assert_array_equal(port.entries.numpy(), np.asarray(ref.entries))
    np.testing.assert_array_equal(port.codes.numpy(), np.asarray(ref.codes))


@pytest.mark.parametrize("s,hd,top_c", [(32_768, 128, 256),
                                        (32_768, 128, 1024), (128, 32, 24)])
def test_traffic_model_equals_reference(s, hd, top_c):
    assert P.traffic_model(s, hd, top_c) == R.traffic_model(s, hd, top_c)
