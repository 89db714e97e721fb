"""``repro_torch.core.metrics`` and ``repro_torch.core.scan`` against
``repro.core.metrics`` and ``repro.core.scan``, on the same inputs made
with numpy from a seed.

Tolerances:

* the recalls are means of 0/1 hits over the same ids: equal;
* hit counts are integers: equal, the invalid slots' -2^30 included;
* the ±inf placement of invalid ADC slots: equal;
* ADC sums run over S in another order in each package (and the one-hot
  form adds them in its contraction's order): within rtol 1e-5 of the sum
  of their terms' magnitudes, the rule of ``test_torch_scan.py``; a signed
  (ip-like) LUT can cancel a sum to near 0, where a bare rtol would not
  hold. Neither package's ``adc_scan`` and ``adc_scan_onehot`` agree to
  the bit (the reference's own test holds them to rtol 1e-5, atol 1e-5);
  the port's two forms are held to each other by that test's rule too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as jmetrics
from repro.core import scan as jscan
from repro_torch import core as pcore
from repro_torch.core import ref as pref
from repro_torch.core import scan as pscan
from repro_torch.kernels.ref import NEG

RTOL = 1e-5


def _ids(seed, q, k, n, pool):
    """Retrieved (Q, K) ids and a (Q, N) ground truth overlapping them."""
    rng = np.random.default_rng(seed)
    retrieved = np.stack([rng.choice(pool, k, replace=False)
                          for _ in range(q)])
    gt = np.stack([rng.choice(pool, n, replace=False) for _ in range(q)])
    return retrieved, gt


@pytest.mark.parametrize("q,k,n,pool", [(64, 10, 1, 40), (32, 100, 10, 300),
                                        (16, 1000, 100, 1500),
                                        (8, 5, 5, 6)])
def test_recalls_equal_reference(q, k, n, pool):
    retrieved, gt = _ids(q + k, q, k, n, pool)
    t = torch.from_numpy
    r1 = pcore.recall_1_at_k(t(retrieved), t(gt[:, 0]))
    rn = pcore.recall_n_at_k(t(retrieved), t(gt))
    assert isinstance(r1, float) and isinstance(rn, float)
    assert r1 == float(jmetrics.recall_1_at_k(jnp.asarray(retrieved),
                                              jnp.asarray(gt[:, 0])))
    assert rn == float(jmetrics.recall_n_at_k(jnp.asarray(retrieved),
                                              jnp.asarray(gt)))


def test_recall_edges():
    ids = torch.arange(12).reshape(3, 4)
    assert pcore.recall_1_at_k(ids, ids[:, 0]) == 1.0
    assert pcore.recall_1_at_k(ids, torch.full((3,), -7)) == 0.0
    assert pcore.recall_n_at_k(ids, ids[:, :2]) == 1.0
    assert pcore.recall_n_at_k(ids, ids[:, :2] + 100) == 0.0


def test_recall_n_at_k_keeps_its_imports():
    """``core.ref`` and ``core`` still export ``recall_n_at_k``: one
    function, now in ``metrics``."""
    from repro_torch.core.metrics import recall_n_at_k
    assert pref.recall_n_at_k is recall_n_at_k
    assert pcore.recall_n_at_k is recall_n_at_k


def _inputs(seed, p, s, e, valid_frac, signed):
    rng = np.random.default_rng(seed)
    if signed:
        lut = rng.standard_normal((s, e)).astype(np.float32)
    else:
        lut = (rng.random((s, e)) * 4).astype(np.float32)
    table = rng.integers(-1, 2, (s, e)).astype(np.int8)
    codes = rng.integers(0, e, (p, s)).astype(np.uint8)
    valid = rng.random(p) < valid_frac
    return lut, table, codes, valid


def _assert_sums(got, want, scale):
    """±inf placement equal; finite sums within RTOL of ``scale`` (the sum
    of the terms' magnitudes)."""
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    err = np.abs(got[fin] - want[fin])
    assert (err <= RTOL * np.asarray(scale)[fin]).all(), float(err.max())


# P = 300 with S = 48 and 100 at E = 256 (the engines' shapes); the
# reference test's (50, 6, 16); one slot; every slot valid or none
SHAPES = [(300, 48, 256), (200, 100, 256), (50, 6, 16), (1, 8, 16)]


@pytest.mark.parametrize("valid_frac", [0.8, 1.0, 0.0])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_adc_scans_match_reference(metric, shape, valid_frac):
    p, s, e = shape
    lut, _, codes, valid = _inputs(p + s, p, s, e, valid_frac,
                                   metric == "ip")
    t = torch.from_numpy
    j = tuple(map(jnp.asarray, (lut, codes, valid)))
    scale = pscan.adc_scan(t(np.abs(lut)), t(codes), t(valid)).numpy()
    got = pscan.adc_scan(t(lut), t(codes), t(valid), metric=metric)
    onehot = pscan.adc_scan_onehot(t(lut), t(codes), t(valid), metric=metric)
    assert got.shape == (p,) and got.dtype == torch.float32
    assert onehot.shape == (p,) and onehot.dtype == torch.float32
    for port in (got, onehot):
        for want in (jscan.adc_scan(*j, metric=metric),
                     jscan.adc_scan_onehot(*j, metric=metric)):
            _assert_sums(port.numpy(), want, scale)
    _assert_sums(onehot.numpy(), got.numpy(), scale)


@pytest.mark.parametrize("valid_frac", [0.8, 1.0, 0.0])
@pytest.mark.parametrize("shape", SHAPES)
def test_hit_count_scan_matches_reference(shape, valid_frac):
    p, s, e = shape
    _, table, codes, valid = _inputs(p + e, p, s, e, valid_frac, False)
    t = torch.from_numpy
    got = pscan.hit_count_scan(t(table), t(codes), t(valid))
    assert got.dtype == torch.int32
    assert (got.numpy()[~valid] == NEG).all()
    want = jscan.hit_count_scan(*map(jnp.asarray, (table, codes, valid)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scans_run_on_their_inputs_device():
    """No default device: the oracles run where their inputs are (here the
    CPU) and reject a metric they do not know."""
    lut, table, codes, valid = _inputs(3, 20, 8, 16, 0.5, False)
    t = torch.from_numpy
    assert pscan.adc_scan(t(lut), t(codes), t(valid)).device.type == "cpu"
    assert pscan.hit_count_scan(t(table), t(codes),
                                t(valid)).device.type == "cpu"
    with pytest.raises(ValueError):
        pscan.adc_scan(t(lut), t(codes), t(valid), metric="cos")
