"""Each hand-written CUDA kernel against its plain PyTorch version, on the
card. Marked ``gpu``: without a CUDA card every test here skips (a CUDA
kernel has no CPU mode). No JAX here, so the file runs on a machine that
has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

The LUT, the hit table, counts and candidates must be equal; ``cand_dist``
and ``dist`` agree within rtol 1e-5 (f32 sums over S in another order),
plus atol 1e-6: these LUTs hold N(0, 1) entries, so a sum of S <= 8 of them
can cancel to near 0, where a few ulps of the terms exceed rtol. The
``pq_scan`` sums run to S = 100, so they are held within 1e-5 of the sum of
their terms' magnitudes instead, with the ±inf placement equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops
from repro_torch.kernels import fused_two_stage as pfused
from repro_torch.kernels import hit_count as phit
from repro_torch.kernels import pq_scan as ppq
from repro_torch.kernels import selective_lut as pslut

RTOL = 1e-5
ATOL = 1e-6

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _lut_inputs(seed, b, s, e):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, s, 2)) * 2).astype(np.float32)
    ent = rng.standard_normal((s, e, 2)).astype(np.float32)
    esq = ent[..., 0] * ent[..., 0] + ent[..., 1] * ent[..., 1]
    tau = (np.abs(rng.standard_normal((b, s))) * 2).astype(np.float32)
    tau[0] = 0.0                         # a row that keeps nothing
    return (q[..., 0].copy(), q[..., 1].copy(), ent[..., 0].copy(),
            ent[..., 1].copy(), esq, tau)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("shape", [(64, 48, 256), (40, 100, 256), (9, 5, 20)])
def test_selective_lut_kernel_matches_plain(cuda, metric, shape):
    args = [torch.from_numpy(a).to(cuda) for a in _lut_inputs(7, *shape)]
    lut_k, hit_k = pslut.selective_lut(*args, metric=metric)
    lut_p, hit_p = pslut.selective_lut_plain(*args, metric=metric)
    torch.cuda.synchronize()
    assert torch.equal(hit_k, hit_p)
    assert torch.equal(lut_k, lut_p)


def _scan_inputs(seed, valid_frac, q=3, n_probe=4, p=40, s=8, e=16):
    rng = np.random.default_rng(seed)
    lut = rng.standard_normal((q, n_probe, s, e)).astype(np.float32)
    table = rng.integers(-1, 2, (q, n_probe, s, e)).astype(np.int8)
    codes = rng.integers(0, e, (q, n_probe, p, s)).astype(np.uint8)
    valid = rng.random((q, n_probe, p)) < valid_frac
    return lut, table, codes, valid


@pytest.mark.parametrize("valid_frac", [0.0, 0.05, 0.8, 1.0])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("s", [8, 6])
def test_fused_kernel_matches_plain(cuda, valid_frac, metric, s):
    lut, table, codes, valid = (torch.from_numpy(a).to(cuda) for a in
                                _scan_inputs(8, valid_frac, s=s))
    if valid_frac == 1.0:
        table[:] = -1                    # every entry pruned
    q, n_probe, p, _ = codes.shape
    cids = torch.arange(q * n_probe, device=cuda).reshape(q, n_probe)
    for cap_c in (1, 25, 160, 1000):
        got = ops.fused_two_stage_scan(
            lut, table, codes.reshape(q * n_probe, p, s),
            valid.reshape(q * n_probe, p), cids, cap_c=cap_c, metric=metric)
        want = pfused.fused_two_stage_plain(lut, table, codes, valid,
                                            cap_c=cap_c, metric=metric)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
        torch.testing.assert_close(got[3], want[3], rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(got[1], want[1], rtol=RTOL, atol=ATOL)


def test_fused_kernel_reads_codes_through_cids(cuda):
    rng = np.random.default_rng(9)
    lut, table, _, _ = _scan_inputs(9, 0.5)
    cl_codes = rng.integers(0, 16, (10, 40, 8)).astype(np.uint8)
    cl_valid = rng.random((10, 40)) < 0.7
    cids = rng.integers(0, 10, (3, 4))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    got = ops.fused_two_stage_scan(t(lut), t(table), t(cl_codes), t(cl_valid),
                                   t(cids), cap_c=30)
    want = pfused.fused_two_stage_plain(t(lut), t(table), t(cl_codes[cids]),
                                        t(cl_valid[cids]), cap_c=30)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    torch.testing.assert_close(got[3], want[3], rtol=RTOL, atol=ATOL)


def _index_form(seed, valid_frac, *, s, e=256, p=300, n_clusters=12, q=3,
                n_probe=4, signed=False):
    """A whole index (codes, valid), probed cluster ids and per-probe
    tables, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    lut = (torch.randn((q, n_probe, s, e), generator=g, device=dev) if signed
           else torch.rand((q, n_probe, s, e), generator=g, device=dev) * 4)
    table = torch.randint(-1, 2, (q, n_probe, s, e), generator=g, device=dev,
                          dtype=torch.int8)
    codes = torch.randint(0, e, (n_clusters, p, s), generator=g, device=dev,
                          dtype=torch.uint8)
    valid = torch.rand((n_clusters, p), generator=g, device=dev) < valid_frac
    cids = torch.randint(0, n_clusters, (q, n_probe), generator=g, device=dev)
    return lut, table, codes, valid, cids


SCAN_CASES = [(s, frac) for s in (8, 48, 100) for frac in (0.25, 1.0)]


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("s,valid_frac", SCAN_CASES)
def test_pq_scan_kernel_matches_plain(cuda, metric, s, valid_frac):
    lut, _, codes, valid, cids = _index_form(20 + s, valid_frac, s=s,
                                             signed=metric == "ip")
    got = ppq.pq_scan(lut, codes, valid, cids, metric=metric)
    want = ppq.pq_scan_plain(lut, codes[cids], valid[cids], metric=metric)
    scale = ppq.pq_scan_plain(lut.abs(), codes[cids], valid[cids])
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert torch.equal(got[~fin], want[~fin])
    assert ((got - want)[fin].abs() <= RTOL * scale[fin]).all()


@pytest.mark.parametrize("s,valid_frac", SCAN_CASES)
def test_hit_count_kernel_matches_plain(cuda, s, valid_frac):
    _, table, codes, valid, cids = _index_form(30 + s, valid_frac, s=s)
    got = phit.hit_count(table, codes, valid, cids)
    want = phit.hit_count_plain(table, codes[cids], valid[cids])
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_scans_read_codes_through_cids(cuda):
    """The ops wrappers on the card equal the plain versions over the
    gathered codes, for cids with repeats and an odd S (byte loads)."""
    lut, table, codes, valid, cids = _index_form(40, 0.5, s=6, e=20)
    got = ops.hit_count_scan(table, codes, valid, cids)
    assert torch.equal(got, phit.hit_count_plain(table, codes[cids],
                                                 valid[cids]))
    got = ops.masked_adc_scan(lut, codes, valid, cids, metric="l2")
    want = ppq.pq_scan_plain(lut, codes[cids], valid[cids])
    torch.testing.assert_close(got, want, rtol=RTOL, atol=0.0)


def test_launch_counts(cuda):
    _build.reset_launches()
    args = [torch.from_numpy(a).to(cuda) for a in _lut_inputs(1, 8, 4, 32)]
    pslut.selective_lut_plain(*args)           # the plain version: no count
    ops.build_selective_lut(torch.stack(args[:2], -1),
                            torch.stack(args[2:4], -1), args[4], args[5])
    lut, table, codes, valid, cids = _index_form(2, 0.5, s=8)
    ppq.pq_scan_plain(lut, codes[cids], valid[cids])
    phit.hit_count_plain(table, codes[cids], valid[cids])
    ops.masked_adc_scan(lut, codes, valid, cids)
    ops.hit_count_scan(table, codes, valid, cids)
    ops.hit_count_scan(table, codes, valid, cids)
    assert _build.LAUNCHES == {"selective_lut": 1, "fused_two_stage": 0,
                               "pq_scan": 1, "hit_count": 2}
