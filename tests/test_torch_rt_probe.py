"""The rt search's probe mask (``ops.rt_probe_mask``, the ``sphere_hits``
kernel's probe entry) against the dense sphere test and the reference.

The probe entry tests only the probed clusters' slots and computes the
query radius itself. Its plain version, which runs here, must give

* ``probe_ok`` equal, bit for bit, to the dense plain table
  (``rt_sphere_hits_ref``) at the same radius gathered at
  ``slot_of[cids]`` with probe 0 forced True, and the slots
  ``slot_of[cids]``;
* the radius of the specification (``_torch_rt_grids.query_radius_spec``,
  numpy): the sum of squares in float64 in s order, rounded once, then
  float32 steps;

on synthetic grids (pads, empty cells, radius scales 0 and 1e6, reaches
on a disc's boundary) and on the grids built from the reference's index
(``test_torch_rt.py``'s ``rt_data``). The search's two rt paths (the
scans' ``_rt_probe_mask``, the three-stage path's ``_rt_probe``) share
that one radius. Nothing here runs a kernel: the CUDA entry's tests are in
``test_torch_kernels_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rt_grids import probe_inputs, query_radius_spec
from repro import rt as jrt
from repro_torch import rt
from repro_torch.core import density as pdensity
from repro_torch.core.ivf import filter_clusters
from repro_torch.core.juno import _rt_probe, _rt_probe_mask
from repro_torch.kernels import ops
from repro_torch.kernels import sphere_hits as psph
from repro_torch.kernels.ref import probe_verdicts, rt_sphere_hits_ref
from test_torch_rt import rt_data  # noqa: F401  (the module fixture)

FULL = 1e6
NPROBE = 16


def _torch(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _dense_gathered(q0, q1, radius, c0, c1, reach, slot):
    return probe_verdicts(rt_sphere_hits_ref(q0, q1, radius, c0, c1, reach),
                          slot)


@pytest.mark.parametrize("scale,boundary", [(0.0, False), (1.0, True),
                                            (FULL, False)])
@pytest.mark.parametrize("seed,g,cap,q,n_probe,s", [
    (0, 4, 16, 128, 16, 48), (1, 3, 5, 17, 8, 100), (2, 8, 24, 64, 40, 7),
    (3, 2, 8, 1, 1, 48)])
def test_plain_probe_equals_dense_table_gathered(seed, g, cap, q, n_probe, s,
                                                 scale, boundary):
    """Pads, an empty and a full cell, caps 16, 5, 24 and 8, radius scales
    0 (the radius is the negative bias: only probe 0 kept unless a reach
    covers it), 1 with a quarter of the queries on a disc's boundary, and
    1e6 (every probe kept)."""
    qp, tau, cids, slot_of, c0, c1, reach, rs, rb = _torch(probe_inputs(
        seed, q, n_probe, s, g, cap, scale=scale, boundary=boundary))
    probe_ok, radius, slot = psph.sphere_probe_plain(
        qp[:, 0], qp[:, 1], tau[:, 0], cids, slot_of, c0, c1, reach, rs, rb,
        scale)
    np.testing.assert_array_equal(
        radius.numpy(), query_radius_spec(tau[:, 0].numpy(), scale, rs, rb))
    assert slot.dtype == torch.int32
    assert torch.equal(slot, slot_of[cids])
    want = _dense_gathered(qp[:, 0], qp[:, 1], radius, c0, c1, reach, slot)
    assert probe_ok.dtype == torch.bool and torch.equal(probe_ok, want)
    assert probe_ok[:, 0].all()
    if scale == FULL:
        assert probe_ok.all()
    if boundary and n_probe > 1:
        # the boundary probes go both ways: the rounding decides them
        kept = probe_ok[:q // 4, 1]
        assert kept.any() and not kept.all()


def test_ops_route_on_the_cpu():
    """``ops.rt_probe_mask`` on CPU tensors runs the plain version: int32
    and int64 ids alike, and strided views (q0/q1 the columns of a (Q, 2)
    tensor, τ's probe-0 row) as their contiguous copies."""
    qp, tau, cids, *grid = _torch(probe_inputs(4, 33, 8, 48, 4, 16,
                                               boundary=True))
    views = (qp[:, 0], qp[:, 1], tau[:, 0])
    assert not any(v.is_contiguous() for v in views)
    want = psph.sphere_probe_plain(*(v.contiguous() for v in views), cids,
                                   *grid, 2.0)
    for ids in (cids, cids.to(torch.int32)):
        got = ops.rt_probe_mask(*views, ids, *grid, scale=2.0)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_kernel_entry_refuses_cpu_tensors():
    """The CUDA entry launches on CUDA tensors only; the wrapper never
    falls back to the plain version."""
    qp, tau, cids, *grid = _torch(probe_inputs(5, 4, 2, 7, 2, 8))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        psph.sphere_probe(qp[:, 0], qp[:, 1], tau[:, 0], cids, *grid)


def _search_inputs(rt_data):
    metric, _, q, idx, grid, port, pgrid = rt_data
    qt = torch.from_numpy(q)
    _, cids = filter_clusters(qt, port.ivf, nprobe=NPROBE, metric=metric)
    res = qt - port.ivf.centroids[cids[:, 0]] if metric == "l2" else qt
    tau = pdensity.predict_threshold(port.density, res.reshape(len(q), -1, 2))
    return qt, tau, cids


@pytest.mark.parametrize("scale", [0.5, 1.0, 4.0, FULL])
def test_probe_mask_on_reference_grid(rt_data, scale):
    """On the grid built from the reference's index: the search's mask
    equals the dense plain table at the search's radius gathered at the
    probed slots, and the three-stage path's ``_rt_probe`` returns that
    mask, that radius (``rt.query_radius``) and those slots."""
    _, _, _, _, _, _, pgrid = rt_data
    qt, tau, cids = _search_inputs(rt_data)
    mask = _rt_probe_mask(pgrid, qt, tau[:, None], cids, scale)
    qp, probe_ok, radius, slot = _rt_probe(pgrid, qt, tau[:, None], cids,
                                           scale)
    assert torch.equal(probe_ok, mask)
    assert torch.equal(radius, rt.query_radius(pgrid, tau, scale))
    assert torch.equal(slot, pgrid.slot_of[cids])
    want = _dense_gathered(qp[:, 0], qp[:, 1], radius, pgrid.cell_c0,
                           pgrid.cell_c1, pgrid.slot_reach, slot)
    assert torch.equal(mask, want)
    torch.testing.assert_close(qp, qt @ pgrid.proj, rtol=1e-6, atol=1e-6)
    assert mask[:, 0].all() and (scale != FULL or mask.all())


@pytest.mark.parametrize("scale", [0.5, 1.0, 4.0, FULL])
def test_radius_definition_and_reference_gap(rt_data, scale):
    """The radius equals the specification bit for bit, and lies within 3
    ulps of max(|scale·radius_scale·√Στ²|, |radius_bias|) of the
    reference's jitted ``repro.rt.query_radius`` on the same τ. Not within
    1 ulp of the result itself: the reference sums τ² in float32 (in
    XLA's order), and where the calibrated negative bias cancels most of
    the radius that gap is many ulps of the result. Measured on these 48
    queries (``gap`` below), rows that differ at all (l2 / ip): scale 0.5
    14 / 14, 1 44 / 45, 4 24 / 14, 1e6 28 / 17; at most 0.75 / 1, 1.5 /
    1.75, 2 / 2 and 2 / 2 ulps of that magnitude."""
    _, _, _, _, grid, _, pgrid = rt_data
    _, tau, _ = _search_inputs(rt_data)
    mine = rt.query_radius(pgrid, tau, scale).numpy()
    rs, rb = pgrid.radius_scale.numpy(), pgrid.radius_bias.numpy()
    np.testing.assert_array_equal(mine, query_radius_spec(tau.numpy(), scale,
                                                          rs, rb))
    ref = np.asarray(jax.jit(jrt.query_radius)(grid, jnp.asarray(tau.numpy()),
                                               scale))
    term = query_radius_spec(tau.numpy(), scale, rs, 0.0)
    unit = np.spacing(np.maximum(np.abs(term), np.abs(rb)))
    gap = np.abs(mine.astype(np.float64) - ref) / unit
    assert gap.max() <= 3.0, gap.max()
