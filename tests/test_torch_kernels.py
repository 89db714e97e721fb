"""The ported kernels' plain versions against ``repro``'s kernels and
oracles.

* ``selective_lut_plain`` must equal ``repro.kernels.ref.selective_lut_ref``
  bit for bit (same IEEE operations in the same order), and the Pallas
  kernel in interpret mode plus its ip post-pass up to that kernel's own
  rounding (see the test); ``ops.build_selective_lut`` on the strided
  ``qsub`` views of stage B (sliced, and expanded over the probes) the
  same against the reference's ``build_selective_lut``, and bit for bit
  against the plain version on contiguous copies.
* ``fused_two_stage_plain`` must equal ``fused_two_stage_host``: counts and
  ``cand`` (order included) exactly; ``cand_dist``/``dist`` within rtol
  1e-5, because the f32 sum over S runs in another order (atol 1e-6: the
  N(0, 1) LUT entries of these inputs can cancel to near 0).
* Against the dense oracle ``ref.fused_two_stage_ref`` the candidate SET
  must match (the oracle orders it by count).
* ``ivf_filter_plain`` (and ``ops.filter_scores`` on the CPU) against the
  Pallas ``ivf_filter`` in interpret mode and ``ref.ivf_filter_ref``, at
  the reference test's shapes, within rtol 1e-5, atol 1e-4 (the products
  sum over D in another order).
* ``ivf_filter_topk_plain`` (and ``ops.filter_topk`` on the CPU) against
  the reference's ``repro.core.ivf.filter_clusters`` (a product, then
  ``lax.top_k``): ids exact, ties included (duplicated centroids come back
  index-ascending); scores within the same rtol 1e-5, atol 1e-4, since
  XLA's and PyTorch's CPU products sum over D in other orders at some
  shapes (they agree bit for bit at C = 1024).

The CUDA kernels against their plain versions are in
``test_torch_kernels_gpu.py`` (no JAX there: the card's machine has none).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ivf import IVFIndex as JaxIVFIndex
from repro.core.ivf import filter_clusters as jax_filter_clusters
from repro.core.lut import ip_pruned_fill
from repro.kernels import ref as jref
from repro.kernels.fused_two_stage import fused_two_stage_host
from repro.kernels.ivf_filter import ivf_filter as pallas_ivf_filter
from repro.kernels.ops import build_selective_lut as jax_build_selective_lut
from repro.kernels.selective_lut import selective_lut as pallas_selective_lut
from _torch_lut_views import FORMS, contiguous_planes, qsub_view
from repro_torch.kernels import fused_two_stage as pfused
from repro_torch.kernels import ivf_filter as pivf
from repro_torch.kernels import ops
from repro_torch.kernels import ref as pref
from repro_torch.kernels import selective_lut as pslut

RTOL = 1e-5  # f32 sums over S in a different order
ATOL = 1e-6


def _lut_inputs(seed, b=16, s=8, e=32):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, s, 2)) * 2).astype(np.float32)
    ent = rng.standard_normal((s, e, 2)).astype(np.float32)
    esq = (ent[..., 0] * ent[..., 0] + ent[..., 1] * ent[..., 1])
    tau = (np.abs(rng.standard_normal((b, s))) * 2).astype(np.float32)
    tau[0] = 0.0                         # a row that keeps nothing
    return (q[..., 0].copy(), q[..., 1].copy(), ent[..., 0].copy(),
            ent[..., 1].copy(), esq.astype(np.float32), tau)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("seed", [0, 1])
def test_selective_lut_plain_matches_reference_oracle(metric, seed):
    args = _lut_inputs(seed)
    lut_p, hit_p = pslut.selective_lut_plain(
        *map(torch.from_numpy, args), metric=metric)
    lut_r, hit_r = jref.selective_lut_ref(*map(jnp.asarray, args),
                                          metric=metric)
    np.testing.assert_array_equal(lut_p.numpy(), np.asarray(lut_r))
    np.testing.assert_array_equal(hit_p.numpy(), np.asarray(hit_r))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_selective_lut_plain_matches_pallas_interpret(metric):
    """The interpreted Pallas kernel rounds differently from its own oracle:
    its CPU backend fuses ``q0*e0 + q1*e1`` into ``fma(q0, e0, q1*e1)`` (and
    ``|r|^2`` likewise). So the LUT agrees to a few ulps (rtol 1e-5, atol
    1e-5 against terms of size ~10), and the hit table agrees exactly away
    from the τ² and τ²/4 boundaries, where an ulp may flip a compare."""
    args = _lut_inputs(2)
    lut_k, hit_k = pallas_selective_lut(*map(jnp.asarray, args),
                                        metric=metric, interpret=True)
    if metric == "ip":                   # the reference's ops.py post-pass
        lut_k = ip_pruned_fill(lut_k, hit_k >= 0)
    lut_p, hit_p = pslut.selective_lut_plain(
        *map(torch.from_numpy, args), metric=metric)
    near = _near_boundary(*args, metric=metric)
    hit_p, hit_k = hit_p.numpy(), np.asarray(hit_k)
    np.testing.assert_array_equal(hit_p[~near], hit_k[~near])
    np.testing.assert_allclose(lut_p.numpy(), np.asarray(lut_k), rtol=1e-5,
                               atol=1e-5)


def _near_boundary(q0, q1, e0, e1, esq, tau, *, metric):
    """(B, S, E) bool: entries whose distance lies within 1e-5 of τ² or
    τ²/4, where an ulp of rounding may flip the hit table's compare."""
    q0, q1, e0, e1, esq, tau = (np.asarray(a, np.float64)
                                for a in (q0, q1, e0, e1, esq, tau))
    dot = q0[:, :, None] * e0 + q1[:, :, None] * e1
    dist = (esq - 2 * dot) + (0 if metric == "ip"
                              else (q0 * q0 + q1 * q1)[:, :, None])
    tau_sq = (tau * tau)[:, :, None]
    return (np.abs(dist - tau_sq) <= 1e-5) | (np.abs(dist - tau_sq / 4) <= 1e-5)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_build_selective_lut_views_match_pallas_interpret(metric, form):
    """``ops.build_selective_lut`` on the strided ``qsub`` views that stage
    B hands it (sliced; ip's expanded over the probes) against
    ``repro.kernels.ops.build_selective_lut`` (Pallas in interpret mode,
    ip post-pass included) on the same values, at the tolerance of
    ``test_selective_lut_plain_matches_pallas_interpret``."""
    qsub, ent, esq, tau = qsub_view(5, form)
    lut_p, hit_p = ops.build_selective_lut(qsub, ent, esq, tau, metric=metric)
    lut_k, hit_k = jax_build_selective_lut(
        *(jnp.asarray(t.contiguous().numpy()) for t in (qsub, ent, esq, tau)),
        metric=metric)
    assert lut_p.shape == hit_p.shape == (*qsub.shape[:-1], ent.shape[1])
    q0, q1, e0, e1, tau2 = contiguous_planes(qsub, ent, tau)
    near = _near_boundary(q0, q1, e0, e1, esq, tau2,
                          metric=metric).reshape(hit_p.shape)
    hit_p, hit_k = hit_p.numpy(), np.asarray(hit_k)
    np.testing.assert_array_equal(hit_p[~near], hit_k[~near])
    np.testing.assert_allclose(lut_p.numpy(), np.asarray(lut_k), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_build_selective_lut_views_match_plain_on_copies(metric, form):
    """The same views against ``selective_lut_plain`` on contiguous copies:
    bit for bit."""
    qsub, ent, esq, tau = qsub_view(6, form)
    lut, hit = ops.build_selective_lut(qsub, ent, esq, tau, metric=metric)
    q0, q1, e0, e1, tau2 = contiguous_planes(qsub, ent, tau)
    lut_p, hit_p = pslut.selective_lut_plain(q0, q1, e0, e1, esq.contiguous(),
                                             tau2, metric=metric)
    assert torch.equal(lut.reshape(lut_p.shape), lut_p)
    assert torch.equal(hit.reshape(hit_p.shape), hit_p)


def _scan_inputs(seed, q=3, n_probe=4, p=40, s=8, e=16, valid_frac=0.8,
                 table_lo=-1):
    rng = np.random.default_rng(seed)
    lut = rng.standard_normal((q, n_probe, s, e)).astype(np.float32)
    table = rng.integers(table_lo, 2, (q, n_probe, s, e)).astype(np.int8)
    codes = rng.integers(0, e, (q, n_probe, p, s)).astype(np.uint8)
    valid = rng.random((q, n_probe, p)) < valid_frac
    return lut, table, codes, valid


CASES = {
    "mixed": dict(),
    "all_invalid": dict(valid_frac=0.0),
    "few_valid": dict(valid_frac=0.05),          # cap_c > valid count
    "all_pruned": dict(table_lo=-1, valid_frac=1.0),
}


def _case(name, seed):
    kw = dict(CASES[name])
    lut, table, codes, valid = _scan_inputs(seed, **kw)
    if name == "all_pruned":
        table[:] = -1
    return lut, table, codes, valid


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("cap_c", [1, 25, 160, 1000])
def test_fused_plain_matches_host_path(case, metric, cap_c):
    lut, table, codes, valid = _case(case, 3)
    got = pfused.fused_two_stage_plain(
        *map(torch.from_numpy, (lut, table, codes, valid)), cap_c=cap_c,
        metric=metric)
    want = fused_two_stage_host(*map(jnp.asarray, (lut, table, codes, valid)),
                                cap_c=cap_c, metric=metric)
    counts, dist, cand, cdist = (t.numpy() for t in got)
    np.testing.assert_array_equal(counts, np.asarray(want[0]))
    np.testing.assert_array_equal(cand, np.asarray(want[2]))
    assert cand.dtype == np.int32 and counts.dtype == np.int32
    np.testing.assert_allclose(cdist, np.asarray(want[3]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(dist, np.asarray(want[1]), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_fused_plain_candidate_set_matches_dense_oracle(case, metric):
    lut, table, codes, valid = _case(case, 4)
    for cap_c in (7, 160, 1000):
        _, _, cand, _ = pfused.fused_two_stage_plain(
            *map(torch.from_numpy, (lut, table, codes, valid)), cap_c=cap_c,
            metric=metric)
        counts_r, _, cand_r, _ = jref.fused_two_stage_ref(
            *map(jnp.asarray, (lut, table, codes, valid)), cap_c=cap_c,
            metric=metric)
        cand_r = np.asarray(cand_r)
        assert cand.shape == cand_r.shape
        for row, row_r in zip(cand.numpy(), cand_r):
            assert set(row.tolist()) == set(row_r.tolist())
        # the port's own dense oracle agrees with the reference's exactly
        counts_o, _, cand_o, _ = pref.fused_two_stage_ref(
            *map(torch.from_numpy, (lut, table, codes, valid)), cap_c=cap_c,
            metric=metric)
        np.testing.assert_array_equal(counts_o.numpy(), np.asarray(counts_r))
        np.testing.assert_array_equal(cand_o.numpy(), cand_r)



@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("cap_c", [50, 400, 1000, 1500])
def test_fused_plain_ties_straddle_probes_match_host_path(metric, cap_c):
    """A sparse table makes the counts tie in bulk, so the θ-ties a query
    takes start in one probe and run into the next: the order (index
    order across probes) that the card's per-probe select blocks must
    reproduce from the histograms of the probes before theirs."""
    lut, table, codes, valid = _scan_inputs(31, q=4, n_probe=6, p=700, s=4,
                                            valid_frac=0.5)
    rng = np.random.default_rng(32)
    table = (table * (rng.random(table.shape) < 0.03)).astype(np.int8)
    got = pfused.fused_two_stage_plain(
        *map(torch.from_numpy, (lut, table, codes, valid)), cap_c=cap_c,
        metric=metric)
    want = fused_two_stage_host(*map(jnp.asarray, (lut, table, codes, valid)),
                                cap_c=cap_c, metric=metric)
    counts, dist, cand, cdist = (t.numpy() for t in got)
    np.testing.assert_array_equal(counts, np.asarray(want[0]))
    np.testing.assert_array_equal(cand, np.asarray(want[2]))
    np.testing.assert_allclose(cdist, np.asarray(want[3]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(dist, np.asarray(want[1]), rtol=RTOL,
                               atol=ATOL)
    # the taken ties straddle a probe boundary, with ties left over
    flat = counts.reshape(4, -1)
    theta = np.sort(flat, axis=1)[:, -cap_c]
    straddle = False
    for row, th in zip(range(4), theta):
        tied = cand[row][flat[row, cand[row]] == th]
        left = int((flat[row] == th).sum()) - tied.size
        straddle |= np.unique(tied // 700).size > 1 and left > 0
    assert straddle

def _arange_cids(codes, valid):
    """Pre-gathered (Q, np, P, S) codes as a whole index read through
    ``cids = arange(Q·np)``: the wrapper's input form."""
    q, n_probe, p, s = codes.shape
    cids = torch.arange(q * n_probe).reshape(q, n_probe)
    return codes.reshape(q * n_probe, p, s), valid.reshape(q * n_probe, p), cids


def test_ops_cids_form_equals_gathered_form():
    """Reading the index through cids (what the search does) gives what
    the pre-gathered codes give."""
    lut, table, codes, valid = _scan_inputs(5)
    rng = np.random.default_rng(5)
    cl_codes = rng.integers(0, 16, (10, 40, 8)).astype(np.uint8)
    cl_valid = rng.random((10, 40)) < 0.7
    cids = rng.integers(0, 10, (3, 4))
    t = torch.from_numpy
    a = ops.fused_two_stage_scan(t(lut), t(table), t(cl_codes), t(cl_valid),
                                 t(cids), cap_c=30)
    b = ops.fused_two_stage_scan(
        t(lut), t(table), *_arange_cids(t(cl_codes[cids]), t(cl_valid[cids])),
        cap_c=30)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_ops_rejects_mixed_devices():
    lut, table, codes, valid = _scan_inputs(6)
    codes, valid, cids = _arange_cids(torch.from_numpy(codes),
                                      torch.from_numpy(valid))
    with pytest.raises(ValueError):
        ops.fused_two_stage_scan(torch.from_numpy(lut), torch.from_numpy(table),
                                 codes, valid.to("meta"), cids, cap_c=4)


@pytest.mark.parametrize("shape", [(64, 96, 128), (17, 40, 37),
                                   (128, 200, 300), (1, 8, 9)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ivf_filter_plain_matches_reference(shape, metric):
    nq, d, c = shape
    rng = np.random.default_rng(nq + d + c)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    cents = rng.standard_normal((c, d)).astype(np.float32)
    csq = np.sum(cents * cents, -1)
    got = pivf.ivf_filter_plain(torch.from_numpy(q), torch.from_numpy(cents),
                                torch.from_numpy(csq), metric=metric).numpy()
    via_ops = ops.filter_scores(torch.from_numpy(q), torch.from_numpy(cents),
                                torch.from_numpy(csq), metric=metric).numpy()
    np.testing.assert_array_equal(via_ops, got)
    args = (jnp.asarray(q), jnp.asarray(cents), jnp.asarray(csq))
    for want in (pallas_ivf_filter(*args, metric=metric, interpret=True),
                 jref.ivf_filter_ref(*args, metric=metric)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-4)


def test_ivf_filter_wrapper_refuses_cpu_and_bad_metric():
    """The kernel wrapper never falls back to the plain version."""
    x = torch.zeros((2, 4))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        pivf.ivf_filter(x, x, torch.zeros(2))
    with pytest.raises(ValueError, match="unknown metric"):
        ops.filter_scores(x, x, torch.zeros(2), metric="cos")


def _topk_case(q, c, d, nprobe, metric, dup=False):
    rng = np.random.default_rng(1000 * q + 10 * c + d)
    x = rng.standard_normal((q, d)).astype(np.float32)
    cents = rng.standard_normal((c, d)).astype(np.float32)
    if dup:     # every centroid twice or more: exact ties in every row
        cents = cents[rng.integers(0, c // 3, c)]
    csq = np.sum(cents * cents, -1)
    ivf = JaxIVFIndex(jnp.asarray(cents), jnp.asarray(csq),
                      jnp.zeros((c, 1), jnp.int32), jnp.zeros((c, 1), bool),
                      jnp.zeros((1,), jnp.int32))
    s_r, ids_r = jax_filter_clusters(jnp.asarray(x), ivf, nprobe=nprobe,
                                     metric=metric)
    args = (torch.from_numpy(x), torch.from_numpy(cents),
            torch.from_numpy(csq))
    s_p, ids_p = pivf.ivf_filter_topk_plain(*args, nprobe=nprobe,
                                            metric=metric)
    s_o, ids_o = ops.filter_topk(*args, nprobe=nprobe, metric=metric)
    assert torch.equal(s_o, s_p) and torch.equal(ids_o, ids_p)
    assert s_p.dtype == torch.float32 and ids_p.dtype == torch.int64
    np.testing.assert_array_equal(ids_p.numpy(), np.asarray(ids_r))
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_r), rtol=1e-5,
                               atol=1e-4)
    return ids_p.numpy(), s_p.numpy()


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("q,c,d,nprobe", [
    (1, 9, 8, 1), (1, 9, 8, 8), (1, 9, 8, 9),
    (17, 37, 40, 1), (17, 37, 40, 8), (17, 37, 40, 16), (17, 37, 40, 32),
    (17, 37, 40, 37),
    (128, 1024, 96, 1), (128, 1024, 96, 8), (128, 1024, 96, 16),
    (128, 1024, 96, 32), (128, 1024, 96, 1024),
    (17, 1024, 8, 16), (128, 37, 96, 32), (1, 1024, 40, 1024)])
def test_ivf_filter_topk_plain_matches_reference(q, c, d, nprobe, metric):
    _topk_case(q, c, d, nprobe, metric)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ivf_filter_topk_plain_ties_index_ascending(metric):
    ids, scores = _topk_case(17, 37, 40, 16, metric, dup=True)
    tied = scores[:, 1:] == scores[:, :-1]
    assert tied.any()
    assert (ids[:, 1:][tied] > ids[:, :-1][tied]).all()


def test_ivf_filter_topk_refuses_bad_input():
    """The kernel wrapper never falls back, and both versions refuse an
    nprobe outside [1, C] and an unknown metric."""
    x = torch.zeros((2, 4))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        pivf.ivf_filter_topk(x, x, torch.zeros(2), nprobe=1)
    for fn in (pivf.ivf_filter_topk_plain, ops.filter_topk):
        for bad in (0, 3):
            with pytest.raises(ValueError, match="nprobe"):
                fn(x, x, torch.zeros(2), nprobe=bad)
        with pytest.raises(ValueError, match="unknown metric"):
            fn(x, x, torch.zeros(2), nprobe=1, metric="cos")
    with pytest.raises(ValueError, match="unknown metric"):
        pivf.ivf_filter_topk(x, x, torch.zeros(2), nprobe=1, metric="cos")
