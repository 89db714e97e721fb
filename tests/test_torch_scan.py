"""The tier-H and tier-M/L scans' plain versions against ``repro``.

``pq_scan_plain`` and ``hit_count_plain`` (the port's ``kernels/ref.py``
oracles, batched over (Q, np)) are held, per (q, probe), against the
reference's three forms of the same function: its oracles
(``repro.kernels.ref.pq_scan_ref``/``hit_count_ref``), its reference scan
path (``repro.core.scan.adc_scan``/``hit_count_scan``) and its Pallas
kernels in interpret mode. Tolerances:

* counts are integers and must be equal;
* the ±inf placement of invalid slots must be equal;
* sums may differ by 1e-5 of the sum of their terms' magnitudes (f32
  sums over S in another order differ by ~S ulps of that): rtol 1e-5 for
  the non-negative (l2-like) LUTs; for the signed (ip-like) N(0, 1) LUTs
  a sum of 48 terms can cancel to near 0, where a fixed atol would not
  hold (the same rule as ``chip_smoke.py``'s ``_assert_sums_close``).

The ``ops`` wrappers read the index through ``cids``; on the CPU they must
equal the plain versions over ``codes[cids]``. The CUDA kernels against
these plain versions are in ``test_torch_kernels_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scan as jscan
from repro.kernels import ref as jref
from repro.kernels.hit_count import hit_count as pallas_hit_count
from repro.kernels.pq_scan import pq_scan as pallas_pq_scan
from repro_torch.kernels import hit_count as phit
from repro_torch.kernels import ops
from repro_torch.kernels import pq_scan as ppq
from repro_torch.kernels.ref import NEG

RTOL = 1e-5

# P = 300 is no multiple of the Pallas kernel's 128-point block (it pads)
SHAPES = [(300, 8, 16), (300, 48, 256), (130, 8, 256), (300, 48, 16)]
VALID = {"mixed": 0.7, "all_valid": 1.0, "all_invalid": 0.0}


def _inputs(seed, p, s, e, valid_frac, *, q=2, n_probe=2, signed=False):
    rng = np.random.default_rng(seed)
    if signed:
        lut = rng.standard_normal((q, n_probe, s, e)).astype(np.float32)
    else:
        lut = (rng.random((q, n_probe, s, e)) * 4).astype(np.float32)
    table = rng.integers(-1, 2, (q, n_probe, s, e)).astype(np.int8)
    codes = rng.integers(0, e, (q, n_probe, p, s)).astype(np.uint8)
    valid = rng.random((q, n_probe, p)) < valid_frac
    return lut, table, codes, valid


def _assert_sums(got, want, scale):
    """±inf placement equal; finite sums within RTOL of ``scale`` (the sum
    of the terms' magnitudes)."""
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    err = np.abs(got[fin] - want[fin])
    assert (err <= RTOL * scale[fin]).all(), float(err.max())


@pytest.mark.parametrize("valid", list(VALID))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_pq_scan_plain_matches_reference(metric, shape, valid):
    p, s, e = shape
    signed = metric == "ip"
    lut, _, codes, vmask = _inputs(11, p, s, e, VALID[valid], signed=signed)
    got = ppq.pq_scan_plain(*map(torch.from_numpy, (lut, codes, vmask)),
                            metric=metric).numpy()
    assert got.shape == vmask.shape and got.dtype == np.float32
    scale = ppq.pq_scan_plain(*map(torch.from_numpy, (np.abs(lut), codes,
                                                      vmask))).numpy()
    for qi in range(lut.shape[0]):
        for pi in range(lut.shape[1]):
            args = tuple(map(jnp.asarray, (lut[qi, pi], codes[qi, pi],
                                           vmask[qi, pi])))
            for want in (jref.pq_scan_ref(*args, metric=metric),
                         jscan.adc_scan(*args, metric=metric),
                         pallas_pq_scan(*args, metric=metric, interpret=True)):
                _assert_sums(got[qi, pi], want, scale[qi, pi])


@pytest.mark.parametrize("valid", list(VALID))
@pytest.mark.parametrize("shape", SHAPES)
def test_hit_count_plain_matches_reference(shape, valid):
    p, s, e = shape
    _, table, codes, vmask = _inputs(12, p, s, e, VALID[valid])
    got = phit.hit_count_plain(*map(torch.from_numpy, (table, codes, vmask)))
    got = got.numpy()
    assert got.shape == vmask.shape and got.dtype == np.int32
    assert (got[~vmask] == NEG).all()
    for qi in range(table.shape[0]):
        for pi in range(table.shape[1]):
            args = tuple(map(jnp.asarray, (table[qi, pi], codes[qi, pi],
                                           vmask[qi, pi])))
            for want in (jref.hit_count_ref(*args),
                         jscan.hit_count_scan(*args),
                         pallas_hit_count(*args, interpret=True)):
                np.testing.assert_array_equal(got[qi, pi], np.asarray(want))


def _index_form(seed, p=40, s=8, e=16, n_clusters=10, q=3, n_probe=4):
    """A whole index (codes, valid) and probed cluster ids (with repeats)."""
    rng = np.random.default_rng(seed)
    lut = rng.standard_normal((q, n_probe, s, e)).astype(np.float32)
    table = rng.integers(-1, 2, (q, n_probe, s, e)).astype(np.int8)
    cl_codes = rng.integers(0, e, (n_clusters, p, s)).astype(np.uint8)
    cl_valid = rng.random((n_clusters, p)) < 0.7
    cids = rng.integers(0, n_clusters, (q, n_probe))
    return lut, table, cl_codes, cl_valid, cids


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ops_masked_adc_scan_reads_through_cids(metric):
    lut, _, cl_codes, cl_valid, cids = _index_form(13)
    t = torch.from_numpy
    got = ops.masked_adc_scan(t(lut), t(cl_codes), t(cl_valid), t(cids),
                              metric=metric)
    want = ppq.pq_scan_plain(t(lut), t(cl_codes[cids]), t(cl_valid[cids]),
                             metric=metric)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_ops_hit_count_scan_reads_through_cids():
    _, table, cl_codes, cl_valid, cids = _index_form(14)
    t = torch.from_numpy
    got = ops.hit_count_scan(t(table), t(cl_codes), t(cl_valid), t(cids))
    want = phit.hit_count_plain(t(table), t(cl_codes[cids]),
                                t(cl_valid[cids]))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_ops_scans_reject_mixed_devices():
    lut, table, cl_codes, cl_valid, cids = _index_form(15)
    t = torch.from_numpy
    with pytest.raises(ValueError):
        ops.masked_adc_scan(t(lut), t(cl_codes), t(cl_valid).to("meta"),
                            t(cids))
    with pytest.raises(ValueError):
        ops.hit_count_scan(t(table), t(cl_codes), t(cl_valid), t(cids).to("meta"))


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: no CPU fallback."""
    lut, table, cl_codes, cl_valid, cids = _index_form(16)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="CUDA"):
        ppq.pq_scan(t(lut), t(cl_codes), t(cl_valid), t(cids))
    with pytest.raises(ValueError, match="CUDA"):
        phit.hit_count(t(table), t(cl_codes), t(cl_valid), t(cids))
