"""The three-stage scan's plain version against ``repro``'s.

``fused_three_stage_plain`` (the sphere test gathered at each probe's grid
slot, probe 0 forced, then the fused two-stage scan over the kept probes)
is held against the reference's host path ``fused_three_stage_host``, its
dense oracle ``ref.fused_three_stage_ref`` and its Pallas kernel in
interpret mode, on the same numpy-seeded inputs. ``probe_ok`` and the
counts must be equal; ``cand`` equal to the host path's (order included)
and, as a set, to the oracle's and the kernel's (both order it by count);
``dist``/``cand_dist`` within rtol 1e-5 (f32 sums over S in another
order; atol 1e-5 for N(0, 1) entries that cancel to near 0). The grids
carry empty cells, pad slots and radii 0, 1e6 and on a disc's boundary
(``_torch_rt_grids.synth_grid``).

The CUDA kernel against this plain version is in
``test_torch_kernels_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rt_grids import synth_grid
from repro.kernels import ref as jref
from repro.kernels.fused_three_stage import (fused_three_stage,
                                             fused_three_stage_host)
from repro_torch.kernels import fused_three_stage as pf3
from repro_torch.kernels import fused_two_stage as pfused
from repro_torch.kernels import ops
from repro_torch.kernels import ref as pref

RTOL = 1e-5
ATOL = 1e-5

# (Q, np, P, S, E, cap_c, g, cap): ragged grids, a prime P, cap_c above W,
# a single query
SHAPES = [
    (4, 2, 17, 6, 8, 9, 3, 8),
    (5, 3, 12, 5, 16, 7, 2, 16),
    (9, 2, 10, 12, 32, 20, 4, 8),
    (2, 1, 8, 4, 8, 50, 3, 8),
    (1, 4, 13, 3, 4, 5, 2, 8),
    (8, 4, 40, 8, 16, 30, 4, 12),
]


def _inputs(seed, q, n_probe, p, s, e, g, cap, valid_p=0.85, radii="mixed"):
    rng = np.random.default_rng(seed)
    lut = rng.standard_normal((q, n_probe, s, e)).astype(np.float32)
    table = rng.integers(-1, 2, (q, n_probe, s, e)).astype(np.int8)
    codes = rng.integers(0, e, (q, n_probe, p, s)).astype(np.uint8)
    valid = rng.random((q, n_probe, p)) < valid_p
    grid = synth_grid(seed + 1, g, cap, q, n_probe, radii=radii)
    # the kernel's operands: the scan's four, then q0, q1, radius, c0, c1,
    # reach, slot_idx (the grid's boxes and cell reach are the TPU walk's)
    return (lut, table, codes, valid, *grid[:3], *grid[5:9]), grid


def _port(args, **kw):
    return pf3.fused_three_stage_plain(*map(torch.from_numpy, args), **kw)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_fused3_plain_matches_host_path(shape, metric):
    args, _ = _inputs(sum(shape), *shape[:5], *shape[6:])
    kw = dict(cap_c=shape[5], metric=metric)
    got = [t.numpy() for t in _port(args, **kw)]
    want = [np.asarray(t) for t in
            fused_three_stage_host(*map(jnp.asarray, args), **kw)]
    for i in (0, 2, 4):                  # counts, cand, probe_ok
        np.testing.assert_array_equal(got[i], want[i])
    assert got[4].dtype == np.bool_ and got[2].dtype == np.int32
    np.testing.assert_allclose(got[3], want[3], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES[:4])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_fused3_plain_matches_oracle_and_interpret_kernel(shape, metric):
    args, grid = _inputs(3 * sum(shape), *shape[:5], *shape[6:])
    kw = dict(cap_c=shape[5], metric=metric)
    got = [t.numpy() for t in _port(args, **kw)]
    oracle = [np.asarray(t) for t in
              jref.fused_three_stage_ref(*map(jnp.asarray, args), **kw)]
    kern_args = (*args[:7], grid[3], grid[4], *args[7:])
    kernel = [np.asarray(t) for t in fused_three_stage(
        *map(jnp.asarray, kern_args), interpret=True, **kw)]
    for other in (oracle, kernel):
        np.testing.assert_array_equal(got[4], other[4])
        np.testing.assert_array_equal(got[0], other[0])
        order = np.argsort(other[2], axis=1)      # count order -> index order
        np.testing.assert_array_equal(got[2], np.take_along_axis(
            other[2], order, axis=1))
        np.testing.assert_allclose(
            got[3], np.take_along_axis(other[3], order, axis=1), rtol=RTOL,
            atol=ATOL)
    # the port's own dense oracle equals the reference's exactly
    mine = [t.numpy() for t in pref.fused_three_stage_ref(
        *map(torch.from_numpy, args), **kw)]
    for i in (0, 2, 4):
        np.testing.assert_array_equal(mine[i], oracle[i])


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_fused3_probe0_backstop(metric):
    """A query whose disc misses every slot still scans probe 0: probe_ok
    is [True, False, ...] and every candidate comes from probe 0."""
    args, _ = _inputs(5, 4, 3, 16, 4, 8, 3, 8, valid_p=1.0, radii="none")
    out = _port(args, cap_c=8, metric=metric)
    pok, cand = out[4].numpy(), out[2].numpy()
    np.testing.assert_array_equal(pok, np.broadcast_to(np.arange(3) == 0,
                                                       (4, 3)))
    assert (cand < 16).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_fused3_full_coverage_equals_two_stage(metric):
    """At cover-all radii every probe is kept and the outputs are the
    two-stage scan's, bit for bit."""
    args, _ = _inputs(6, 6, 3, 20, 6, 16, 3, 8, radii="full")
    got = _port(args, cap_c=25, metric=metric)
    want = pfused.fused_two_stage_plain(*map(torch.from_numpy, args[:4]),
                                        cap_c=25, metric=metric)
    assert got[4].all()
    for a, b in zip(got[:4], want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_ops_fused3_reads_through_cids():
    """The wrapper's index form (codes read through cids, slot_idx of any
    int dtype) equals the plain version over the gathered codes."""
    args, _ = _inputs(7, 3, 4, 12, 8, 16, 3, 8)
    rng = np.random.default_rng(7)
    cl_codes = rng.integers(0, 16, (10, 12, 8)).astype(np.uint8)
    cl_valid = rng.random((10, 12)) < 0.7
    cids = rng.integers(0, 10, (3, 4))
    t = [torch.from_numpy(a) for a in args]
    got = ops.fused_three_stage_scan(
        t[0], t[1], torch.from_numpy(cl_codes), torch.from_numpy(cl_valid),
        torch.from_numpy(cids), *t[4:10], t[10].long(), cap_c=20)
    want = pf3.fused_three_stage_plain(
        t[0], t[1], torch.from_numpy(cl_codes[cids]),
        torch.from_numpy(cl_valid[cids]), *t[4:], cap_c=20)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
