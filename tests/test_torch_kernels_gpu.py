"""Each hand-written CUDA kernel against its plain PyTorch version, on the
card. Marked ``gpu``: without a CUDA card every test here skips (a CUDA
kernel has no CPU mode). No JAX here, so the file runs on a machine that
has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

The LUT, the hit table, the sphere hits, ``probe_ok``, counts and
candidates must be equal; the IVF filter's scores lie within 1e-5 of
``Σ_d |q_d c_d|`` (twice that for l2) plus the ``csq`` term's ulp, and its
top-16 ids match except where the 16th and 17th scores lie within that
bound; its top-nprobe epilogue equals a stable sort of the kernel's own
matrix exactly (scores, ids and order), and the plain top-nprobe in ids
away from a tie at the nprobe-th place (exactly where centroids repeat);
``cand_dist``
and ``dist`` agree within rtol 1e-5 (f32 sums over S in another order),
plus atol 1e-6: these LUTs hold N(0, 1) entries, so a sum of S <= 8 of them
can cancel to near 0, where a few ulps of the terms exceed rtol. The
``pq_scan`` sums run to S = 100, so they are held within 1e-5 of the sum of
their terms' magnitudes instead, with the ±inf placement equal. The two
fused scans at every launch shape the autotuner may pick must equal the
default launch bit for bit (every output), and a shape off the lattice is
refused.
"""
import numpy as np
import pytest
import torch

from _torch_lut_views import FORMS, contiguous_planes, qsub_view
from _torch_rt_grids import probe_inputs, synth_grid
from repro_torch.kernels import _build, ops
from repro_torch.kernels import autotune as pat
from repro_torch.kernels import fused_three_stage as pf3
from repro_torch.kernels import fused_two_stage as pfused
from repro_torch.kernels import hit_count as phit
from repro_torch.kernels import ivf_filter as pivf
from repro_torch.kernels import pq_scan as ppq
from repro_torch.kernels import selective_lut as pslut
from repro_torch.kernels import sphere_hits as psph

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
    tau[-1] = 1e3                        # a row that keeps everything
    return (q[..., 0].copy(), q[..., 1].copy(), ent[..., 0].copy(),
            ent[..., 1].copy(), esq, tau)


# (B, S, E): the engine's E = 256 at S = 48 and 100; E = 20, 1 and 1024
# (masked lanes, one entry, 32 entries a lane); S = 1; B = 2053 and 3001,
# which no run length of rows divides (3001 at S = 100 also gives runs
# longer than 32 rows)
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("shape", [(64, 48, 256), (40, 100, 256), (9, 5, 20),
                                   (8, 4, 1024), (6, 3, 1), (5, 1, 256),
                                   (2053, 48, 256), (3001, 100, 256)])
def test_selective_lut_kernel_matches_plain(cuda, metric, shape):
    args = [torch.from_numpy(a).to(cuda) for a in _lut_inputs(7, *shape)]
    lut_k, hit_k = pslut.selective_lut(*args, metric=metric)
    lut_p, hit_p = pslut.selective_lut_plain(*args, metric=metric)
    torch.cuda.synchronize()
    assert torch.equal(hit_k, hit_p)
    assert torch.equal(lut_k, lut_p)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_selective_lut_kernel_reads_strided_views(cuda, metric, form):
    """``ops.build_selective_lut`` on views of a (Q, np, S, 2) ``qsub``
    (sliced; expanded over the probes) and of ``entries`` (S, E, 2) equals
    the kernel on contiguous planes, and the plain version, bit for bit."""
    qsub, ent, esq, tau = qsub_view(11, form, q=5, n_probe=16, s=48, e=256,
                                    device=cuda)
    lut, hit = ops.build_selective_lut(qsub, ent, esq, tau, metric=metric)
    planes = contiguous_planes(qsub, ent, tau)
    args = (*planes[:4], esq.contiguous(), planes[4])
    lut_c, hit_c = pslut.selective_lut(*args, metric=metric)
    lut_p, hit_p = pslut.selective_lut_plain(*args, metric=metric)
    torch.cuda.synchronize()
    assert lut.shape == (5, 16, 48, 256) and lut.is_contiguous()
    assert torch.equal(lut.reshape(lut_c.shape), lut_c)
    assert torch.equal(hit.reshape(hit_c.shape), hit_c)
    assert torch.equal(lut_c, lut_p) and torch.equal(hit_c, hit_p)


@pytest.mark.parametrize("form", FORMS)
def test_build_selective_lut_launches_one_kernel(cuda, form):
    """A stage B is one kernel on the card: no copy of ``qsub``, τ or
    ``entries`` rides along (profiler count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args = qsub_view(12, form, q=4, n_probe=8, s=100, e=256, device=cuda)
    ops.build_selective_lut(*args, metric="ip")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.build_selective_lut(*args, metric="ip")
        torch.cuda.synchronize()
    kernels = [(ev.key, ev.count) for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and kernels[0][1] == 1, kernels
    assert "selective_lut" in kernels[0][0]


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


# (Q, np, P, S, E): P below one warp step, P past eight warps' segments of
# 512; S 7 and 12 (byte-wise code reads; E = 20 byte-wise table staging),
# 48 and 100 (the compiled S); np 1, 8 and 16; Q 1, 8 and 128
_TOPK_SHAPES = {"P7": (8, 3, 7, 8, 16), "P4500": (2, 8, 4500, 48, 256),
                "S7": (1, 8, 200, 7, 32), "S12": (8, 16, 300, 12, 20),
                "S100": (8, 8, 1500, 100, 256), "np1": (8, 1, 3912, 48, 256),
                "Q128": (128, 8, 3912, 48, 256),
                "np16": (8, 16, 3912, 100, 256)}


@pytest.mark.parametrize("layout", ["scattered", "packed", "few"])
@pytest.mark.parametrize("shape", list(_TOPK_SHAPES))
def test_hit_count_topk_kernel_matches_plain(cuda, shape, layout):
    """The top-k route equal to its plain version (values and positions)
    and the counts-only kernel to its own, with the valid slots scattered,
    packed at the front of each cluster (empty to full) or few (fewer than
    k valid points: the sentinel's ties fill the quota in index order),
    for signed and all-zero tables (one tie run of every valid point),
    every probe kept or every probe but 0 pruned, k from 1 to np·P."""
    q, n_probe, p, s, e = _TOPK_SHAPES[shape]
    _, table, codes, _, cids = _index_form(60 + s + p, 0.0, s=s, e=e, p=p,
                                           n_clusters=20, q=q,
                                           n_probe=n_probe)
    g = torch.Generator(device="cuda").manual_seed(61 + p)
    if layout == "packed":
        fill = torch.randint(0, p + 1, (20, 1), generator=g, device=cuda)
        fill[:3, 0] = torch.tensor([0, 1, p], device=cuda)
        valid = torch.arange(p, device=cuda)[None, :] < fill
    else:
        frac = 0.25 if layout == "scattered" else 0.2 / p
        valid = torch.rand((20, p), generator=g, device=cuda) < frac
    probe0 = torch.zeros((q, n_probe), dtype=torch.bool, device=cuda)
    probe0[:, 0] = True
    w = n_probe * p
    for tab in (table, torch.zeros_like(table)):
        for pok in (None, probe0):
            masked = valid[cids] if pok is None else \
                valid[cids] & pok[..., None]
            got = phit.hit_count(tab, codes, valid, cids, probe_ok=pok)
            assert torch.equal(got, phit.hit_count_plain(tab, codes[cids],
                                                         masked))
            for k in sorted({1, 33, 100, w // 2 + 1, w} & set(range(1, w + 1))):
                got = ops.hit_count_topk_scan(tab, codes, valid, cids, k,
                                              probe_ok=pok)
                want = phit.hit_count_topk_plain(tab, codes[cids], masked, k)
                torch.cuda.synchronize()
                assert torch.equal(got[0], want[0]), (k, pok is None)
                assert torch.equal(got[1], want[1]), (k, pok is None)


def test_hit_count_launches_its_kernels_only(cuda):
    """A top-k call is the count kernel and then the top-k kernel, a
    counts-only call the count kernel alone: no sort, no zeroing, no copy
    (the nodes of the call captured into a CUDA graph)."""
    _, table, codes, valid, cids = _index_form(62, 0.5, s=48, q=8,
                                               n_probe=6)
    pok = torch.rand(cids.shape, device=cuda) < 0.5
    calls = {
        ("hit_count_kernel", "hit_topk_kernel"): lambda: ops.hit_count_topk_scan(
            table, codes, valid, cids, 40, probe_ok=pok),
        ("hit_count_kernel",): lambda: ops.hit_count_scan(table, codes, valid,
                                                          cids)}
    for want, call in calls.items():
        call()
        torch.cuda.synchronize()
        nodes = _captured_nodes(call)
        assert len(nodes) == len(want), nodes
        assert all(n in node for n, node in zip(want, nodes)), nodes


def _pq_topk_check(got, lut, codes, valid, cids, pok, base, k, metric):
    """The top-k route's (values, positions) against a stable sort of the
    scores-only kernel's own output plus ``base`` (bit-equal), and against
    the plain version: the ±inf places equal, each value within RTOL of
    the sum of its terms' magnitudes (plus |base|) of plain's value at the
    same place and of plain's score at its own position, so that positions
    differ from plain's only inside ties."""
    scores = ops.masked_adc_scan(lut, codes, valid, cids, metric=metric,
                                 probe_ok=pok)
    if base is not None:
        scores = scores + base[..., None]
    q = lut.shape[0]
    own = ppq._sorted_top(scores.reshape(q, -1), k, metric)
    torch.cuda.synchronize()
    assert torch.equal(got[0], own[0]) and torch.equal(got[1], own[1])
    assert torch.equal(torch.signbit(got[0]), torch.signbit(own[0]))
    masked = valid[cids] if pok is None else valid[cids] & pok[..., None]
    plain = ppq.pq_scan_plain(lut, codes[cids], masked, metric=metric)
    scale = ppq.pq_scan_plain(lut.abs(), codes[cids], masked)
    if base is not None:
        plain = plain + base[..., None]
        scale = scale + base.abs()[..., None]
    plain, scale = plain.reshape(q, -1), scale.reshape(q, -1)
    want = ppq._sorted_top(plain, k, metric)
    fin = torch.isfinite(want[0])
    assert torch.equal(torch.isfinite(got[0]), fin)
    assert torch.equal(got[0][~fin], want[0][~fin])
    assert torch.equal(got[1][~fin], want[1][~fin])
    tol = RTOL * torch.maximum(torch.gather(scale, 1, got[1]),
                               torch.gather(scale, 1, want[1]))
    assert ((got[0] - want[0])[fin].abs() <= tol[fin]).all()
    at_own = torch.gather(plain, 1, got[1])
    assert ((got[0] - at_own)[fin].abs() <= tol[fin]).all()


# (Q, np, P, S, E) as for hit_count's top-k: P below one warp step and
# past 4096 (16 scores a thread), S 7 and 12 (byte-wise code reads), 48
# and 100 (the compiled S), np 1, 8 and 16, Q 1, 8 and 128
_PQ_TOPK_SHAPES = dict(_TOPK_SHAPES, Q1=(1, 16, 3912, 48, 256))


@pytest.mark.parametrize("layout", ["scattered", "packed", "few"])
@pytest.mark.parametrize("shape", list(_PQ_TOPK_SHAPES))
def test_pq_scan_topk_kernel_matches_plain(cuda, shape, layout):
    """The top-k route bit-equal to a stable sort of the scores-only
    kernel's output plus ``probe_base`` and close to plain (ids up to
    ties), at l2 and at ip with an offset, every probe kept or every probe
    but 0 pruned, an integer-valued LUT (exact ties across probes), k from
    1 to K_MAX and past it (the scores kernel and a sort, counted apart)."""
    q, n_probe, p, s, e = _PQ_TOPK_SHAPES[shape]
    g = torch.Generator(device="cuda").manual_seed(70 + s + p)
    codes = torch.randint(0, e, (20, p, s), generator=g, device=cuda,
                          dtype=torch.uint8)
    cids = torch.randint(0, 20, (q, n_probe), generator=g, device=cuda)
    if layout == "packed":
        fill = torch.randint(0, p + 1, (20, 1), generator=g, device=cuda)
        fill[:3, 0] = torch.tensor([0, 1, p], device=cuda)
        valid = torch.arange(p, device=cuda)[None, :] < fill
    else:
        frac = 0.25 if layout == "scattered" else 0.2 / p
        valid = torch.rand((20, p), generator=g, device=cuda) < frac
    probe0 = torch.zeros((q, n_probe), dtype=torch.bool, device=cuda)
    probe0[:, 0] = True
    w = n_probe * p
    ks = {1, 33, 100, w // 2 + 1, w, ppq.K_MAX, ppq.K_MAX + 1}
    for metric in ("l2", "ip"):
        shp = (q, n_probe, s, e)
        luts = [torch.rand(shp, generator=g, device=cuda) * 4
                if metric == "l2" else torch.randn(shp, generator=g,
                                                   device=cuda),
                torch.randint(0, 3, shp, generator=g, device=cuda).float()]
        base = (torch.randn((q, n_probe), generator=g, device=cuda)
                if metric == "ip" else None)
        for lut in luts:
            for pok in (None, probe0):
                for k in sorted(ks & set(range(1, w + 1))):
                    _build.reset_launches()
                    got = ops.masked_adc_topk_scan(
                        lut, codes, valid, cids, k, metric=metric,
                        probe_ok=pok, probe_base=base)
                    sort = k > ppq.K_MAX or p > ppq.P_MAX
                    assert _build.LAUNCHES["pq_scan_sort"] == int(sort)
                    assert _build.LAUNCHES["pq_scan"] == int(not sort)
                    _pq_topk_check(got, lut, codes, valid, cids, pok, base,
                                   k, metric)


def test_pq_scan_launches_its_kernels_only(cuda):
    """A top-k call is the per-probe select kernel and then the merge
    kernel, a scores-only call the scan kernel alone: no sort, no zeroing,
    no copy (the nodes of the call captured into a CUDA graph)."""
    lut, _, codes, valid, cids = _index_form(63, 0.5, s=48, q=8, n_probe=6,
                                             signed=True)
    pok = torch.rand(cids.shape, device=cuda) < 0.5
    base = torch.randn(cids.shape, device=cuda)
    calls = {
        ("pq_topk_kernel", "pq_merge_kernel"): lambda: ops.masked_adc_topk_scan(
            lut, codes, valid, cids, 40, metric="ip", probe_ok=pok,
            probe_base=base),
        ("pq_scan_kernel",): lambda: ops.masked_adc_scan(lut, codes, valid,
                                                         cids)}
    for want, call in calls.items():
        call()
        torch.cuda.synchronize()
        nodes = _captured_nodes(call)
        assert len(nodes) == len(want), nodes
        assert all(n in node for n, node in zip(want, nodes)), nodes


def test_pq_scan_shape_guard_matches_the_kernels(cuda):
    """The largest LUT the shape guard lets through (S = 224, E = 256:
    224 KB beside the top-k kernel's static shared memory) launches both
    entries and is right; one subspace more is refused before a launch."""
    g = torch.Generator(device="cuda").manual_seed(71)
    q, n_probe, p, e = 2, 3, 40, 256
    for s, fits in ((224, True), (225, False)):
        lut = torch.rand((q, n_probe, s, e), generator=g, device=cuda)
        codes = torch.randint(0, e, (5, p, s), generator=g, device=cuda,
                              dtype=torch.uint8)
        valid = torch.rand((5, p), generator=g, device=cuda) < 0.5
        cids = torch.randint(0, 5, (q, n_probe), generator=g, device=cuda)
        assert (4 * s * e + ppq.TOPK_STATIC_SMEM <= ppq.SMEM_MAX) == fits
        if not fits:
            with pytest.raises(ValueError, match="unsupported shape"):
                ops.masked_adc_topk_scan(lut, codes, valid, cids, 10)
            with pytest.raises(ValueError, match="unsupported shape"):
                ops.masked_adc_scan(lut, codes, valid, cids)
            continue
        got = ops.masked_adc_topk_scan(lut, codes, valid, cids, 10)
        _pq_topk_check(got, lut, codes, valid, cids, None, None, 10, "l2")


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
    phit.hit_count_topk_plain(table, codes[cids], valid[cids], 5)
    ops.hit_count_topk_scan(table, codes, valid, cids, 5)
    grid = [torch.from_numpy(a).to(cuda) for a in synth_grid(3, 3, 8, 3, 4)]
    psph.sphere_hits_plain(*grid[:3], *grid[5:8])
    ops.rt_sphere_hits(*grid[:3], *grid[5:8])
    ops.fused_three_stage_scan(lut, table, codes, valid, cids, *grid[:3],
                               *grid[5:9], cap_c=10)
    probe = _probe_inputs(4, 3, 4, 6, 3, 8, cuda)
    psph.sphere_probe_plain(*probe)
    ops.rt_probe_mask(*probe[:-1], scale=probe[-1])
    x = torch.randn((5, 8), device=cuda)
    pivf.ivf_filter_plain(x, x, x[:, 0])
    ops.filter_scores(x, x, x[:, 0].contiguous(), metric="ip")
    assert _build.LAUNCHES == {"selective_lut": 1, "fused_two_stage": 0,
                               "pq_scan": 1, "hit_count": 3,
                               "sphere_hits": 1, "fused_three_stage": 1,
                               "ivf_filter": 1, "sphere_probe": 1,
                               "pq_scan_sort": 0}


@pytest.mark.parametrize("g,cap,q", [(16, 64, 128), (3, 8, 17), (3, 5, 9),
                                     (1, 8, 1)])
def test_sphere_hits_kernel_matches_plain(cuda, g, cap, q):
    """Empty and full cells, pad slots, radii 0, 1e6 and on a disc's
    boundary; (3, 5) has 45 slots, not a multiple of 4 (byte stores)."""
    q0, q1, r, _, _, c0, c1, reach, _ = (
        torch.from_numpy(a).to(cuda) for a in synth_grid(g * cap + q, g, cap, q))
    got = psph.sphere_hits(q0, q1, r, c0, c1, reach)
    want = psph.sphere_hits_plain(q0, q1, r, c0, c1, reach)
    torch.cuda.synchronize()
    assert got.shape == (q, g * g * cap) and got.dtype == torch.int8
    assert torch.equal(got, want)
    assert not got[:, ~torch.isfinite(reach.reshape(-1))].any()


def _probe_inputs(seed, q, n_probe, s, g, cap, device, *, scale=1.0,
                  boundary=False, cid_dtype=torch.int64):
    """``probe_inputs``' arrays on the card as the search passes them: q0,
    q1 the columns of a (Q, 2) tensor, τ the probe-0 row of a
    (Q, np + 1, S) tensor; then ``scale``."""
    qp, tau, cids, *rest = (torch.from_numpy(a).to(device) for a in
                            probe_inputs(seed, q, n_probe, s, g, cap,
                                         scale=scale, boundary=boundary))
    return (qp[:, 0], qp[:, 1], tau[:, 0], cids.to(cid_dtype), *rest, scale)


@pytest.mark.parametrize("s", [7, 48, 100, 200])
@pytest.mark.parametrize("n_probe", [1, 8, 16, 40])
@pytest.mark.parametrize("q", [1, 17, 128])
def test_sphere_probe_kernel_matches_plain(cuda, q, n_probe, s):
    """The probe entry bit-equal to its plain version in ``probe_ok``, the
    radius and the slots, and its verdicts equal to the dense kernel's
    table at that radius gathered at ``slot_of[cids]``: caps 16 and 5
    (not a multiple of 4), pads and an empty cell, ``scale`` 0 (the radius
    is the negative bias), 1 with boundary reaches and 1e6, τ as a strided
    probe-0 view, q0/q1 as a (Q, 2) tensor's columns, int64 and int32
    cids; np 40 loops past a warp, S 200 past the 128 τ values a warp
    loads in its first round."""
    for g, cap in ((4, 16), (3, 5)):
        for scale, boundary in ((0.0, False), (1.0, True), (1e6, False)):
            for dt in (torch.int64, torch.int32):
                args = _probe_inputs(q + n_probe + s + cap, q, n_probe, s, g,
                                     cap, cuda, scale=scale,
                                     boundary=boundary, cid_dtype=dt)
                assert q == 1 or not (args[0].is_contiguous()
                                      or args[2].is_contiguous())
                got = psph.sphere_probe(*args)
                want = psph.sphere_probe_plain(*args)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    assert a.dtype == b.dtype and torch.equal(a, b)
                dense = psph.sphere_hits(args[0].contiguous(),
                                         args[1].contiguous(), got[1],
                                         *args[5:8])
                gathered = torch.gather(dense, 1, got[2].long()) > 0
                gathered[:, 0] = True
                assert torch.equal(got[0], gathered)
                if scale == 1e6:
                    assert got[0].all()


def test_sphere_probe_is_one_kernel_a_call(cuda):
    """``ops.rt_probe_mask`` is the probe kernel alone, and the search's
    ``_rt_probe_mask`` (``_rt_probe``, which the three-stage path calls
    too) the projection GEMM and the probe kernel: no copy, memset or other
    kernel (counted on the call captured into a CUDA graph)."""
    from repro_torch.core.juno import _rt_probe, _rt_probe_mask
    from repro_torch.rt import grid_from_arrays
    args = _probe_inputs(5, 128, 16, 48, 16, 8, cuda)
    call = lambda: ops.rt_probe_mask(*args[:-1], scale=1.0)  # noqa: E731
    call()
    torch.cuda.synchronize()
    nodes = _captured_nodes(call)
    assert len(nodes) == 1 and "sphere_probe_kernel" in nodes[0], nodes
    d, (n_cells, cap) = 96, args[5].shape
    host = lambda t: t.cpu().numpy()  # noqa: E731
    grid = grid_from_arrays(dict(
        proj=np.linalg.qr(np.random.default_rng(6).standard_normal((d, 2)))[0]
        .astype(np.float32), lo=np.zeros(2, np.float32),
        hi=np.ones(2, np.float32), boxes=np.zeros((n_cells, 4), np.float32),
        cell_ids=np.full((n_cells, cap), -1, np.int32),
        cell_c0=host(args[5]), cell_c1=host(args[6]),
        slot_reach=host(args[7]), cell_reach=host(args[7]).max(1),
        slot_of=host(args[4]), radius_scale=host(args[8]),
        radius_bias=host(args[9])), cuda, prefix="")
    x = torch.randn((128, d), device=cuda)
    tau = torch.rand((128, 16, 48), device=cuda)
    cids = args[3]
    fn = lambda: _rt_probe_mask(grid, x, tau, cids, 1.0)  # noqa: E731
    fn()
    torch.cuda.synchronize()
    nodes = _captured_nodes(fn)
    assert len(nodes) == 2 and nodes[0] == "KERNEL", nodes
    assert "sphere_probe_kernel" in nodes[1], nodes
    qp, *got = _rt_probe(grid, x, tau, cids, 1.0)
    want = psph.sphere_probe_plain(qp[:, 0], qp[:, 1], tau[:, 0], cids,
                                   grid.slot_of, grid.cell_c0, grid.cell_c1,
                                   grid.slot_reach, grid.radius_scale,
                                   grid.radius_bias)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _close_to_plain(got, want, scale):
    """±inf placement equal, finite sums within RTOL of Σ|terms|."""
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert torch.equal(got[~fin], want[~fin])
    assert ((got - want)[fin].abs() <= RTOL * scale[fin] + ATOL).all()


@pytest.mark.parametrize("radii", ["mixed", "full", "none"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("s", [8, 48])
def test_fused_three_stage_kernel_matches_plain(cuda, radii, metric, s):
    lut, table, codes, valid, cids = _index_form(70 + s, 0.5, s=s, q=8,
                                                 n_probe=6,
                                                 signed=metric == "ip")
    grid = [torch.from_numpy(a).to(cuda)
            for a in synth_grid(s, 4, 16, 8, 6, radii=radii)]
    sph = (*grid[:3], *grid[5:9])
    for cap_c in (1, 40, 5000):
        kw = dict(cap_c=cap_c, metric=metric)
        got = ops.fused_three_stage_scan(lut, table, codes, valid, cids, *sph,
                                         **kw)
        want = pf3.fused_three_stage_plain(lut, table, codes[cids],
                                           valid[cids], *sph, **kw)
        scale = pf3.fused_three_stage_plain(lut.abs(), table, codes[cids],
                                            valid[cids], *sph, **kw)
        torch.cuda.synchronize()
        for i in (0, 2, 4):                        # counts, cand, probe_ok
            assert torch.equal(got[i], want[i])
        _close_to_plain(got[3], want[3], scale[3])
        _close_to_plain(got[1], want[1], scale[1])
        if radii == "full":    # every probe kept: the two-stage kernel's output
            two = ops.fused_two_stage_scan(lut, table, codes, valid, cids,
                                           **kw)
            assert got[4].all()
            for a, b in zip(got[:4], two):
                assert torch.equal(a, b)
        if radii == "none":
            assert torch.equal(got[4][:, 0], torch.ones_like(got[4][:, 0]))
            assert not got[4][:, 1:].any()



def _check_fused(got, lut, table, codes, valid, cids, probe_ok, cap_c,
                 metric, sph=None):
    """The two-stage (``sph`` None) or three-stage kernel's outputs against
    the plain version: counts, cand and probe_ok equal, the sums within
    RTOL of Σ|terms| with ±inf placed alike."""
    if sph is None:
        masked = valid[cids] if probe_ok is None else \
            valid[cids] & probe_ok[..., None]
        want = pfused.fused_two_stage_plain(lut, table, codes[cids], masked,
                                            cap_c=cap_c, metric=metric)
        scale = pfused.fused_two_stage_plain(lut.abs(), table, codes[cids],
                                             masked, cap_c=cap_c)
    else:
        want = pf3.fused_three_stage_plain(lut, table, codes[cids],
                                           valid[cids], *sph, cap_c=cap_c,
                                           metric=metric)
        scale = pf3.fused_three_stage_plain(lut.abs(), table, codes[cids],
                                            valid[cids], *sph, cap_c=cap_c)
    torch.cuda.synchronize()
    for i in range(0, len(want), 2):               # counts, cand, probe_ok
        assert torch.equal(got[i], want[i])
    _close_to_plain(got[3], want[3], scale[3])
    _close_to_plain(got[1], want[1], scale[1])
    return want


# (Q, np, P, S, E): P < 32; P past the count kernel's 4096-point chunk and
# no multiple of the select's window; S = 100 with E = 256; np = 1; Q = 1;
# S not a multiple of 4 (byte-wise code reads); E not a multiple of 16
# (byte-wise table staging)
_EDGE_SHAPES = {"P7": (2, 3, 7, 8, 16), "P4500": (2, 2, 4500, 48, 256),
                "S100": (3, 4, 1500, 100, 256), "np1": (4, 1, 300, 8, 16),
                "Q1": (1, 5, 300, 48, 256), "S7": (3, 4, 200, 7, 32),
                "E20": (3, 4, 200, 12, 20)}


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("shape", list(_EDGE_SHAPES))
def test_fused_kernels_edge_shapes(cuda, metric, shape):
    """Both kernels at the shapes the design's windows, chunks and code
    reads turn on, with C from 1 to np·P (every point a candidate), every
    probe kept, every probe but 0 pruned (mask or sphere test) and a mixed
    sphere verdict."""
    q, n_probe, p, s, e = _EDGE_SHAPES[shape]
    lut, table, codes, valid, cids = _index_form(
        90 + s + p, 0.3, s=s, e=e, p=p, n_clusters=6, q=q, n_probe=n_probe,
        signed=metric == "ip")
    probe0 = torch.zeros((q, n_probe), dtype=torch.bool, device=cuda)
    probe0[:, 0] = True
    grids = {r: [torch.from_numpy(a).to(cuda)
                 for a in synth_grid(s + p, 4, 16, q, n_probe, radii=r)]
             for r in ("mixed", "none")}
    for cap_c in sorted({1, 33, n_probe * p // 2 + 1, n_probe * p}):
        kw = dict(cap_c=cap_c, metric=metric)
        for pok in (None, probe0):
            got = ops.fused_two_stage_scan(lut, table, codes, valid, cids,
                                           probe_ok=pok, **kw)
            _check_fused(got, lut, table, codes, valid, cids, pok, cap_c,
                         metric)
        for grid in grids.values():
            sph = (*grid[:3], *grid[5:9])
            got = ops.fused_three_stage_scan(lut, table, codes, valid, cids,
                                             *sph, **kw)
            _check_fused(got, lut, table, codes, valid, cids, None, cap_c,
                         metric, sph)
        if cap_c == n_probe * p:        # every point is a candidate
            want = torch.arange(n_probe * p, device=cuda, dtype=torch.int32)
            assert torch.equal(got[2], want.expand(q, -1))


def test_fused_kernels_ties_straddle_probes(cuda):
    """Counts of a sparse table tie in bulk, so the θ-ties a query takes
    start in one probe and end in a later one: the kernels take them in
    index order across the probes (each probe's block finds its offsets in
    the histograms of the probes before it)."""
    q, n_probe, p, s, e = 4, 6, 700, 4, 16
    lut, table, codes, valid, cids = _index_form(95, 0.5, s=s, e=e, p=p,
                                                 n_clusters=8, q=q,
                                                 n_probe=n_probe)
    g = torch.Generator(device="cuda").manual_seed(96)
    table *= (torch.rand(table.shape, generator=g, device=cuda) < 0.03
              ).to(torch.int8)
    straddled = 0
    for cap_c in (50, 400, 1000, 1500):
        got = ops.fused_two_stage_scan(lut, table, codes, valid, cids,
                                       cap_c=cap_c)
        want = _check_fused(got, lut, table, codes, valid, cids, None,
                            cap_c, "l2")
        flat = want[0].reshape(q, -1)
        cand = got[2].long()
        assert (cand[:, 1:] > cand[:, :-1]).all()
        theta = torch.sort(flat, dim=1).values[:, -cap_c]
        for row in range(q):
            tied = cand[row][flat[row, cand[row]] == theta[row]]
            left = int((flat[row] == theta[row]).sum()) - tied.numel()
            probes = torch.unique(tied // p)
            straddled += probes.numel() > 1 and left > 0
    assert straddled > 0          # the inputs do test what the name says


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("s", [48, 100, 7])
def test_fused_kernels_packed_valid(cuda, metric, s):
    """The valid slots at the front of each cluster, as a built index lays
    them out: empty, one slot, runs ending inside and past the count
    kernel's first 4096-point chunk, and full clusters (each count lane
    walks its own valid points, so a warp's lanes run out at different
    steps)."""
    q, n_probe, p = 3, 5, 5000
    lut, table, codes, _, cids = _index_form(98 + s, 0.0, s=s, p=p,
                                             n_clusters=6, q=q,
                                             n_probe=n_probe,
                                             signed=metric == "ip")
    fill = torch.tensor([0, 1, 700, 4097, 4999, 5000], device=cuda)
    valid = torch.arange(p, device=cuda)[None, :] < fill[:, None]
    grid = [torch.from_numpy(a).to(cuda)
            for a in synth_grid(s + p, 4, 16, q, n_probe, radii="mixed")]
    sph = (*grid[:3], *grid[5:9])
    for cap_c in (1, 320, n_probe * p):
        kw = dict(cap_c=cap_c, metric=metric)
        got = ops.fused_two_stage_scan(lut, table, codes, valid, cids, **kw)
        _check_fused(got, lut, table, codes, valid, cids, None, cap_c, metric)
        got = ops.fused_three_stage_scan(lut, table, codes, valid, cids,
                                         *sph, **kw)
        _check_fused(got, lut, table, codes, valid, cids, None, cap_c, metric,
                     sph)


def _captured_nodes(call):
    """Every node of one ``call()`` captured into a CUDA graph, in order:
    a kernel node as its function's name, any other node (copy, memset)
    as its type. A capture takes every operation the call puts on the
    stream; a profiler window on the card has come back empty or without
    a call's first kernel (in whole-file runs of this file)."""
    import os
    import re
    import tempfile
    g = torch.cuda.CUDAGraph(keep_graph=True)   # kept for the dump
    g.enable_debug_mode()
    with torch.cuda.graph(g):
        call()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "call.dot")
        g.debug_dump(path)
        with open(path) as fh:
            dot = fh.read()
    # a node's definition runs to the next one's; its first word in
    # capitals is its type
    starts = [m.start() for m in
              re.finditer(r'(?m)^\s*"graph_\d+_node_\d+"\s*\[', dot)]
    nodes = []
    for a, b in zip(starts, starts[1:] + [len(dot)]):
        text = dot[a:b]
        kind = re.search(r"\b([A-Z][A-Z_]{3,})\b", text).group(1)
        name = re.search(
            r"\w*(?:count|select|topk|merge|scan|probe)_kernel\w*", text)
        nodes.append(name.group(0) if kind == "KERNEL" and name else kind)
    return nodes


def test_fused_scans_launch_two_kernels(cuda):
    """A call of either ops scan is its count and select kernels and
    nothing else: no histogram zeroing, no copy of the (Q, 2) projection's
    columns (the nodes of the call captured into a CUDA graph)."""
    lut, table, codes, valid, cids = _index_form(97, 0.5, s=48, q=8,
                                                 n_probe=6)
    grid = [torch.from_numpy(a).to(cuda) for a in synth_grid(97, 4, 16, 8, 6)]
    qp2 = torch.stack(grid[:2], 1)            # q0, q1 as columns, strided
    sph = (qp2[:, 0], qp2[:, 1], grid[2], *grid[5:9])
    calls = {
        "two": lambda: ops.fused_two_stage_scan(lut, table, codes, valid,
                                                cids, cap_c=40),
        "three": lambda: ops.fused_three_stage_scan(lut, table, codes, valid,
                                                    cids, *sph, cap_c=40)}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        nodes = _captured_nodes(call)
        assert len(nodes) == 2, (name, nodes)
        assert "count_kernel" in nodes[0] and "select_kernel" in nodes[1], \
            (name, nodes)
    want = ops.fused_three_stage_scan(lut, table, codes, valid, cids,
                                      *(qp2[:, 0].contiguous(),
                                        qp2[:, 1].contiguous()), *sph[2:],
                                      cap_c=40)
    for a, b in zip(calls["three"](), want):
        assert torch.equal(a, b)


# the autotuner's launch lattice (kernels/autotune.py): every shape gives the
# default's bits from both fused kernels. P past the count kernel's
# 4096-point chunk and the select kernel's widest window where the batch is
# small (Q·np <= 128), 700 otherwise.
def _lattice_case(seed, q, s, n_probe, layout, tables):
    """Index-form inputs: valid slots scattered (a quarter) or packed at
    the front of each cluster, and a dense {-1, 0, +1} table or a sparse
    one whose counts tie in bulk, so θ-ties straddle probes."""
    p = 4500 if q * n_probe <= 128 else 700
    e = 32 if s == 7 else 256
    lut, table, codes, valid, cids = _index_form(
        seed, 0.25, s=s, e=e, p=p, n_clusters=24, q=q, n_probe=n_probe,
        signed=seed % 2 == 1)
    if layout == "packed":
        fill = torch.linspace(0, p, 24, device=valid.device).long()
        valid = torch.arange(p, device=valid.device)[None, :] < fill[:, None]
    if tables == "sparse":
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        table *= (torch.rand(table.shape, generator=g, device=table.device)
                  < 0.03).to(torch.int8)
    return lut, table, codes, valid, cids


@pytest.mark.parametrize("n_probe", [1, 16])
@pytest.mark.parametrize("s", [7, 48, 100])
@pytest.mark.parametrize("q", [1, 8, 32, 128])
def test_launch_lattice_bit_equal_to_default(cuda, q, s, n_probe):
    """Every launch shape the autotuner may pick (the count kernel's
    (threads, points a thread), the select kernel's threads) returns the
    default launch's counts, dist, cand, cand_dist and probe_ok bit for
    bit: at S 7 (the generic path) and the two compiled S, np 1 and 16, C
    from 1 to np·P, probe masks none, half and probe 0 only (the sphere
    test's mixed and none verdicts for the three-stage kernel), scattered
    and packed valid slots, and sparse tables whose θ-ties straddle
    probes."""
    shapes = pat.candidates(pat.backend_name(cuda))
    assert len(shapes) == 6 and shapes[0] == pat.KernelConfig()
    for layout, tables in (("scattered", "dense"), ("packed", "sparse"),
                           ("scattered", "sparse")):
        lut, table, codes, valid, cids = _lattice_case(
            q + s + n_probe, q, s, n_probe, layout, tables)
        p = valid.shape[1]
        half = torch.rand((q, n_probe), device=cuda) < 0.5
        probe0 = torch.zeros((q, n_probe), dtype=torch.bool, device=cuda)
        probe0[:, 0] = True
        grids = [[torch.from_numpy(a).to(cuda)
                  for a in synth_grid(s + q, 4, 16, q, n_probe, radii=r)]
                 for r in ("mixed", "none")]
        for cap_c in sorted({1, 33, n_probe * p // 2 + 1, n_probe * p}):
            kw = dict(cap_c=cap_c, metric="ip" if s == 100 else "l2")
            calls = [lambda cfg, pok=pok: pfused.fused_two_stage(
                lut, table, codes, valid, cids, probe_ok=pok, **kw,
                **cfg.launch()) for pok in (None, half, probe0)]
            calls += [lambda cfg, g=g: pf3.fused_three_stage(
                lut, table, codes, valid, cids, *g[:3], *g[5:8],
                g[8], **kw, **cfg.launch()) for g in grids]
            for call in calls:
                base = call(shapes[0])
                for cfg in shapes[1:]:
                    got = call(cfg)
                    torch.cuda.synchronize()
                    for a, b in zip(got, base):
                        assert torch.equal(a, b), (layout, tables, cap_c,
                                                   cfg)


def test_launch_lattice_two_kernels_a_call(cuda):
    """At every launch shape, an ``ops`` call of either fused scan with
    that config installed is its count and select kernels and nothing
    else (by capture)."""
    lut, table, codes, valid, cids = _index_form(99, 0.5, s=48, q=8,
                                                 n_probe=6)
    grid = [torch.from_numpy(a).to(cuda) for a in synth_grid(99, 4, 16, 8, 6)]
    sph = (*grid[:3], *grid[5:9])
    try:
        for cfg in pat.candidates(pat.backend_name(cuda)):
            for kernel in pat.KERNELS:
                pat.set_config(kernel, cfg)
            for call in (lambda: ops.fused_two_stage_scan(
                    lut, table, codes, valid, cids, cap_c=40),
                    lambda: ops.fused_three_stage_scan(
                        lut, table, codes, valid, cids, *sph, cap_c=40)):
                call()
                torch.cuda.synchronize()
                nodes = _captured_nodes(call)
                assert len(nodes) == 2, (cfg, nodes)
                assert "count_kernel" in nodes[0], (cfg, nodes)
                assert "select_kernel" in nodes[1], (cfg, nodes)
    finally:
        pat.reset()


@pytest.mark.parametrize("knobs", [dict(count_threads=64),
                                   dict(count_threads=128),
                                   dict(count_threads=128,
                                        count_per_thread=32),
                                   dict(count_per_thread=8),
                                   dict(select_threads=1024),
                                   dict(select_threads=0)])
def test_launch_lattice_refuses_unknown_knobs(cuda, knobs):
    """A launch shape off the lattice is refused by the C entry point
    before anything launches: the wrappers raise and count no launch."""
    lut, table, codes, valid, cids = _index_form(98, 0.5, s=48)
    grid = [torch.from_numpy(a).to(cuda) for a in synth_grid(98, 4, 16, 3, 4)]
    launch = dict(pat.KernelConfig().launch(), **knobs)
    _build.reset_launches()
    with pytest.raises(RuntimeError, match="at launch"):
        pfused.fused_two_stage(lut, table, codes, valid, cids, cap_c=10,
                               **launch)
    with pytest.raises(RuntimeError, match="at launch"):
        pf3.fused_three_stage(lut, table, codes, valid, cids, *grid[:3],
                              *grid[5:9], cap_c=10, **launch)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_two_stage"] == 0
    assert _build.LAUNCHES["fused_three_stage"] == 0


def test_autotune_measures_and_caches_on_the_card(cuda, tmp_path):
    """``tune`` on the card times every launch shape (the engines' problem
    shape) and picks one of them; ``ensure_tuned`` writes a cache that
    reads back for this card and build only."""
    timed = pat.measure("fused_two_stage", repeats=3, device=cuda)
    assert [c for c, _ in timed] == pat.candidates(pat.backend_name(cuda))
    assert all(ms > 0 for _, ms in timed)
    path = tmp_path / "autotune.json"
    try:
        got = pat.ensure_tuned(path, repeats=3, device=cuda)
        assert pat.load_cache(path, backend=pat.backend_name(cuda)) == got
        assert pat.load_cache(path, backend=pat.backend_name(cuda),
                              kernels="another build") is None
        assert pat.load_cache(path, backend="cpu") is None
    finally:
        pat.reset()


def test_scans_with_probe_mask(cuda):
    """pq_scan, hit_count and fused_two_stage with a probe_ok mask equal
    their plain versions over ``valid[cids] & probe_ok[..., None]``."""
    lut, table, codes, valid, cids = _index_form(80, 0.5, s=8, e=32)
    pok = torch.rand(cids.shape, device=cuda) < 0.5
    pok[0] = False                                 # a query with no probe
    masked = valid[cids] & pok[..., None]
    got = ops.hit_count_scan(table, codes, valid, cids, probe_ok=pok)
    assert torch.equal(got, phit.hit_count_plain(table, codes[cids], masked))
    got = ops.masked_adc_scan(lut, codes, valid, cids, probe_ok=pok)
    _close_to_plain(got, ppq.pq_scan_plain(lut, codes[cids], masked),
                    ppq.pq_scan_plain(lut.abs(), codes[cids], masked))
    for cap_c in (1, 50):
        got = ops.fused_two_stage_scan(lut, table, codes, valid, cids,
                                       cap_c=cap_c, probe_ok=pok)
        want = pfused.fused_two_stage_plain(lut, table, codes[cids], masked,
                                            cap_c=cap_c)
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
        torch.testing.assert_close(got[3], want[3], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("shape", [(128, 96, 1024), (128, 200, 1024),
                                   (1000, 96, 1024), (17, 40, 37),
                                   (1, 8, 9), (33, 70, 65)])
def test_ivf_filter_kernel_matches_plain(cuda, metric, shape):
    """Ragged tiles in Q, C and D included (17, 37, 40; 33, 65, 70)."""
    nq, d, c = shape
    rng = np.random.default_rng(nq + d + c)
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32))
    cent = torch.from_numpy(rng.standard_normal((c, d)).astype(np.float32))
    q, cent = q.to(cuda), cent.to(cuda)
    csq = torch.sum(cent * cent, -1)
    got = pivf.ivf_filter(q, cent, csq, metric=metric)
    want = pivf.ivf_filter_plain(q, cent, csq, metric=metric)
    torch.cuda.synchronize()
    terms = q.abs() @ cent.abs().T
    mult = 2.0 if metric == "l2" else 1.0
    bound = mult * RTOL * terms
    if metric == "l2":
        bound = bound + torch.finfo(torch.float32).eps * csq.abs()[None]
    assert ((got - want).abs() <= bound).all()
    k = min(16, c - 1)
    key = -got if metric == "l2" else got
    key_p = -want if metric == "l2" else want
    ids = torch.sort(key, dim=1, descending=True, stable=True).indices[:, :k]
    srt, ids_p = torch.sort(key_p, dim=1, descending=True, stable=True)
    near_tie = (srt[:, k - 1] - srt[:, k]).abs() <= bound.max(1).values
    same = (torch.sort(ids, dim=1).values
            == torch.sort(ids_p[:, :k], dim=1).values).all(dim=1)
    assert (same | near_tie).all()


def test_ivf_filter_kernel_refuses_bad_input(cuda):
    x = torch.randn((4, 8), device=cuda)
    with pytest.raises(ValueError):
        pivf.ivf_filter(x, x, torch.zeros(3, device=cuda))       # csq shape
    with pytest.raises(ValueError):
        pivf.ivf_filter(x.T, x, torch.zeros(4, device=cuda))     # layout
    with pytest.raises(ValueError):
        pivf.ivf_filter(x.double(), x.double(),
                        torch.zeros(4, device=cuda, dtype=torch.float64))


def _topk_inputs(cuda, nq, c, d, dup=False):
    rng = np.random.default_rng(7 * nq + 3 * c + d)
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32))
    cent = rng.standard_normal((c, d)).astype(np.float32)
    if dup:     # repeated centroids: exact ties in every row
        cent = cent[rng.integers(0, max(1, c // 3), c)]
    cent = torch.from_numpy(cent).to(cuda)
    return q.to(cuda), cent, torch.sum(cent * cent, -1)


def _sorted_top(m, nprobe, metric):
    """The plain top-nprobe of a given score matrix (stable sort)."""
    key = -m if metric == "l2" else m
    vals, ids = torch.sort(key, dim=1, descending=True, stable=True)
    vals = -vals if metric == "l2" else vals
    return vals[:, :nprobe], ids[:, :nprobe]


def _check_topk(q, cent, csq, nprobe, metric):
    got_s, got_i = pivf.ivf_filter_topk(q, cent, csq, nprobe=nprobe,
                                        metric=metric)
    mat = pivf.ivf_filter(q, cent, csq, metric=metric)
    torch.cuda.synchronize()
    assert got_s.shape == got_i.shape == (q.shape[0], nprobe)
    assert got_s.dtype == torch.float32 and got_i.dtype == torch.int64
    # the selection, exactly: the same scores as the matrix epilogue's
    want_s, want_i = _sorted_top(mat, nprobe, metric)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_s, want_s)
    # against the plain version: scores within the matrix rows' bound,
    # ids equal unless the nprobe-th and next plain scores lie within it
    plain = pivf.ivf_filter_plain(q, cent, csq, metric=metric)
    bound = (2.0 if metric == "l2" else 1.0) * RTOL * (q.abs() @ cent.abs().T)
    if metric == "l2":
        bound = bound + torch.finfo(torch.float32).eps * csq.abs()[None]
    p_s, p_i = pivf.ivf_filter_topk_plain(q, cent, csq, nprobe=nprobe,
                                          metric=metric)
    assert ((got_s - plain.gather(1, got_i)).abs()
            <= bound.gather(1, got_i)).all()
    same = (torch.sort(got_i, 1).values == torch.sort(p_i, 1).values).all(1)
    if nprobe < cent.shape[0]:
        nxt = _sorted_top(plain, nprobe + 1, metric)[0][:, nprobe]
        tie = (p_s[:, -1] - nxt).abs() <= bound.max(1).values
        assert (same | tie).all()
    else:
        assert same.all()
    return got_s, got_i, p_s, p_i


# ragged Q (1, 7, 1000), C (1, 37, 1500) and D (8, 40, 300); every nprobe
# of 1, 16, 32, 129 and C that is at most C
_TOPK_CASES = [(nq, c, d, nprobe) for nq, c, d in (
    (1, 1, 8), (7, 37, 40), (128, 1024, 96), (128, 1024, 200),
    (1000, 1024, 96), (1000, 1500, 300), (7, 1500, 8), (128, 37, 300),
    (1, 1024, 200)) for nprobe in sorted({1, 16, 32, 129, c}) if nprobe <= c]


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("nq,c,d,nprobe", _TOPK_CASES)
def test_ivf_filter_topk_kernel_matches_plain(cuda, metric, nq, c, d, nprobe):
    _check_topk(*_topk_inputs(cuda, nq, c, d), nprobe, metric)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("nprobe", [1, 16, 129])
def test_ivf_filter_topk_exact_ties_index_ascending(cuda, metric, nprobe):
    q, cent, csq = _topk_inputs(cuda, 128, 1024, 96, dup=True)
    got_s, got_i, p_s, p_i = _check_topk(q, cent, csq, nprobe, metric)
    assert torch.equal(got_i, p_i)
    tied = got_s[:, 1:] == got_s[:, :-1]
    assert nprobe == 1 or tied.any()
    assert (got_i[:, 1:][tied] > got_i[:, :-1][tied]).all()


@pytest.mark.parametrize("c,d", [(1024, 96), (10240, 96), (1024, 200)])
def test_ivf_filter_top1_at_the_streaming_builds_shapes(cuda, c, d):
    """One eval batch of the streaming build (8192 rows) at nprobe 1: the
    1M and 10M DEEP-like builds' C and the TTI-like one's D."""
    _check_topk(*_topk_inputs(cuda, 8192, c, d), 1, "l2")


def test_streamed_eval_batch_on_the_card_equals_the_cpu(cuda):
    """One padded eval batch of ``build_streaming`` on the card and on the
    CPU: labels equal away from a tie of the two nearest centroids, the
    density counts equal (pad rows weighted 0) but for the tied rows'
    cells, codes and ‖p‖² as the CPU's up to rounding."""
    from repro_torch.build import pipeline
    from repro_torch.core.pq import PQCodebook
    rng = np.random.default_rng(4)
    n, n_valid, c, d, s, e, g = 8192, 8000, 1024, 96, 48, 256, 64
    pts = rng.standard_normal((n, d)).astype(np.float32)
    cent = rng.standard_normal((c, d)).astype(np.float32)
    ent = (rng.standard_normal((s, e, 2)) * 0.5).astype(np.float32)
    lo = np.full((s, 2), -2.0, np.float32)
    hi = np.full((s, 2), 2.0, np.float32)
    out = {}
    for dev in ("cpu", cuda):
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        cb = PQCodebook(entries=t(ent), entry_sq=t((ent * ent).sum(-1)))
        ct = t(cent)
        out[str(dev)] = [x.cpu() for x in pipeline._encode_batch(
            t(pts), ct, (ct * ct).sum(-1), cb,
            torch.zeros((s, g, g), device=dev), t(lo), t(hi), n_valid)]
    (lc, cc, kc, pc), (lg, cg, kg, pg) = out["cpu"], out[str(cuda)]
    plain = pivf.ivf_filter_plain(torch.from_numpy(pts), torch.from_numpy(
        cent), torch.from_numpy((cent * cent).sum(-1)))
    top2 = torch.sort(plain, 1).values[:, :2]
    tied = (top2[:, 1] - top2[:, 0]) <= 4 * RTOL * (
        torch.from_numpy(np.abs(pts)) @ torch.from_numpy(np.abs(cent)).T
    ).max(1).values
    differ = lc != lg
    assert not (differ & ~tied).any()
    assert float(kc.sum()) == s * n_valid
    assert (kc - kg).abs().sum() <= 2 * s * int(differ[:n_valid].sum())
    same = ~differ
    assert (cc[same] == cg[same]).float().mean() >= 0.999
    torch.testing.assert_close(pg, pc, rtol=RTOL, atol=ATOL)


def test_ivf_filter_topk_counters_reset(cuda):
    """Launches that alternate 1000 and 8 queries (125 and 1 row tiles of
    one counter buffer) each merge once a row tile, so each is right."""
    for nq, nprobe in ((1000, 16), (8, 1), (1000, 32), (8, 129), (1000, 1),
                       (8, 16)):
        for metric in ("l2", "ip"):
            q, cent, csq = _topk_inputs(cuda, nq, 1024, 96)
            _check_topk(q, cent, csq, nprobe, metric)
    assert not pivf._COUNTERS[q.device].any()


def test_ivf_filter_topk_launch_count(cuda):
    _build.reset_launches()
    q, cent, csq = _topk_inputs(cuda, 9, 300, 40)
    pivf.ivf_filter_topk_plain(q, cent, csq, nprobe=8)     # no count
    ops.filter_topk(q, cent, csq, nprobe=8, metric="ip")
    pivf.ivf_filter_topk(q, cent, csq, nprobe=1)
    assert _build.LAUNCHES["ivf_filter"] == 2
    assert sum(_build.LAUNCHES.values()) == 2


def test_ivf_filter_topk_kernel_refuses_bad_input(cuda):
    q, cent, csq = _topk_inputs(cuda, 4, 8, 8)
    for bad in (0, 9):
        with pytest.raises(ValueError, match="nprobe"):
            pivf.ivf_filter_topk(q, cent, csq, nprobe=bad)
    with pytest.raises(ValueError):
        pivf.ivf_filter_topk(q.T, cent, csq, nprobe=2)           # layout
    with pytest.raises(ValueError):
        pivf.ivf_filter_topk(q.double(), cent.double(), csq.double(),
                             nprobe=2)
    with pytest.raises(ValueError, match="unknown metric"):
        pivf.ivf_filter_topk(q, cent, csq, nprobe=2, metric="cos")


# ---------------------------------------------------------------------------
# the paged tier's scan view: a page buffer with local indices
# ---------------------------------------------------------------------------

def _page(codes, valid, cids):
    """The page buffer of ``cids``' distinct clusters, their validity and
    the local indices into it (``serve.paged.PagedIndexData.gather``)."""
    uniq, local = torch.unique(cids, return_inverse=True)
    return codes[uniq].contiguous(), valid[uniq].contiguous(), local


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("case", ["scattered", "one_cluster", "every_cluster"])
@pytest.mark.parametrize("s", [48, 100])
def test_scans_over_a_page_buffer_equal_the_whole_index(cuda, s, case,
                                                        metric):
    """Each scan over a page buffer and local indices returns what it
    returns over the whole ``cluster_codes`` and the true cluster ids,
    bit for bit: one distinct cluster, scattered ones, and every cluster
    of the index probed (U past any cache's rows)."""
    q, n_probe, n_clusters = 8, 6, 40
    lut, table, codes, valid, cids = _index_form(
        80 + s, 0.5, s=s, q=q, n_probe=n_probe, n_clusters=n_clusters,
        signed=metric == "ip")
    if case == "one_cluster":
        cids = torch.full_like(cids, 7)
    elif case == "every_cluster":
        cids = torch.randperm(q * n_probe, device=cuda)[:q * n_probe]
        cids = (cids % n_clusters).reshape(q, n_probe)
    pc, pv, local = _page(codes, valid, cids)
    base = torch.randn((q, n_probe), device=cuda) if metric == "ip" else None
    grid = [torch.from_numpy(a).to(cuda)
            for a in synth_grid(s, 4, 16, q, n_probe, radii="mixed")]
    sph = (*grid[:3], *grid[5:9])
    calls = {
        "pq_topk": lambda c, v, i: ops.masked_adc_topk_scan(
            lut, c, v, i, 50, metric=metric, probe_base=base),
        "hit_topk": lambda c, v, i: ops.hit_count_topk_scan(
            table, c, v, i, 50),
        "fused_two": lambda c, v, i: ops.fused_two_stage_scan(
            lut, table, c, v, i, cap_c=60, metric=metric),
        "fused_three": lambda c, v, i: ops.fused_three_stage_scan(
            lut, table, c, v, i, *sph, cap_c=60, metric=metric)}
    for name, call in calls.items():
        whole, paged = call(codes, valid, cids), call(pc, pv, local)
        torch.cuda.synchronize()
        for a, b in zip(whole, paged, strict=True):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_paged_search_equals_resident_on_the_card(cuda, metric, tmp_path):
    """A small index built on the card, committed to an ``ArtifactStore``
    and served paged with a cache of two rows: every tier, scan and rt,
    returns the resident search's scores and ids bit for bit."""
    from repro_torch import rt
    from repro_torch.build import ArtifactStore
    from repro_torch.core import JunoConfig, build, search
    from repro_torch.data import DEEP_LIKE, TTI_LIKE, make_dataset
    from repro_torch.serve.paged import PagedIndexData, PagedJunoIndex

    spec = DEEP_LIKE if metric == "l2" else TTI_LIKE
    pts, q = make_dataset(spec, 20000, 256, seed=3)
    cfg = JunoConfig(n_clusters=64, n_entries=256, metric=metric)
    index = build(pts, cfg, seed=3)
    grid = rt.build_grid(index, metric=metric)
    store = ArtifactStore(str(tmp_path / "store"))
    store.put("main", index, cfg, rt_grid=grid)
    row = index.cluster_codes[0].numel()
    paged = PagedIndexData(store.path("main", 1), cache_bytes=2 * row)
    pidx = PagedJunoIndex(paged)
    for pf in ("scan", "rt"):
        for mode, fused in (("H", False), ("M", False), ("L", False),
                            ("H2", False), ("H2", True)):
            kw = dict(nprobe=16, k=100, mode=mode, fused=fused,
                      metric=metric, prefilter=pf, batch=128)
            want = search(index, q, rt_grid=grid if pf == "rt" else None,
                          **kw)
            got = pidx.search(q, **kw)
            for a, b in zip(want, got):
                assert torch.equal(a, b), (pf, mode, fused)
    assert paged.cache.evictions > 0 and len(paged.cache) <= 2
