"""The hit counts' top-k (tiers M, L and composed H2) against ``repro``.

``hit_count_topk_plain`` (the port's hit counts, a stable descending sort,
the first k) is held to ``jax.lax.top_k`` over the reference's
``hit_count_ref``, values and positions exactly: counts are integers and
the order is (count desc, position asc). A pure-torch emulation of the
card's top-k kernel (``csrc/hit_count.cu:hit_topk_kernel``: θ and the
per-bin offsets from per-probe histograms, warp segments, ranks within a
bin) must equal the stable sort on the same cases, so that a wrong offset
rule shows here before it shows on the card. On the CPU
``ops.hit_count_topk_scan`` equals ``_top_k`` of ``ops.hit_count_scan``,
and stage B's hit table holds only {-1, 0, +1}, the values the kernels
read by sign. The kernels themselves are held to the plain version in
``test_torch_kernels_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_port
from repro.core import JunoConfig, build
from repro.data import DEEP_LIKE, TTI_LIKE, make_dataset
from repro.kernels import ref as jref
from repro_torch.core import juno as pjuno
from repro_torch.core.ivf import filter_clusters
from repro_torch.kernels import hit_count as phit
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG

# (Q, np, P, S, E, valid share); table kind; k values (None = np*P)
CASES = {
    "mixed": ((3, 4, 50, 8, 16, 0.7), "signed", (1, 10, 100, None)),
    "zeros": ((2, 3, 40, 6, 16, 0.8), "zeros", (1, 10, 100, None)),
    "few_valid": ((2, 3, 40, 6, 16, 0.05), "signed", (10, 100, None)),
    "pruned": ((3, 4, 30, 5, 8, 0.6), "signed", (1, 10, 100, None)),
    "np1": ((3, 1, 120, 8, 16, 0.5), "signed", (1, 10, 100, None)),
    "Q1": ((1, 5, 30, 8, 16, 0.5), "clipped", (1, 10, 100, None)),
}


def _case(name, seed=0):
    (q, n_probe, p, s, e, frac), kind, ks = CASES[name]
    rng = np.random.default_rng(seed + len(name))
    table = rng.integers(-1, 2, (q, n_probe, s, e)).astype(np.int8)
    if kind == "zeros":                 # every valid point ties at 0
        table[:] = 0
    elif kind == "clipped":             # tier L's {0, 1} table
        table = (table >= 0).astype(np.int8)
    codes = rng.integers(0, e, (q, n_probe, p, s)).astype(np.uint8)
    valid = rng.random((q, n_probe, p)) < frac
    if name == "pruned":                # every probe but 0 pruned
        valid[:, 1:] = False
    ks = [n_probe * p if k is None else k for k in ks]
    return table, codes, valid, [k for k in ks if k <= n_probe * p]


def _jax_topk(table, codes, valid, k):
    """``lax.top_k`` over the reference's per-(q, probe) hit counts."""
    q, n_probe = table.shape[:2]
    counts = jnp.stack([jnp.stack([
        jref.hit_count_ref(jnp.asarray(table[i, j]), jnp.asarray(codes[i, j]),
                           jnp.asarray(valid[i, j]))
        for j in range(n_probe)]) for i in range(q)])
    vals, pos = jax.lax.top_k(counts.reshape(q, -1), k)
    return np.asarray(vals), np.asarray(pos)


def emulate_topk_kernel(counts: torch.Tensor, s: int, k: int,
                        n_warps: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """The top-k kernel's placement rule, step for step, over the (Q, np,
    P) int32 counts: each (q, probe) block's histogram of 2S+2 bins (bin 0
    for the invalid sentinel), θ's bin from the query's summed histograms,
    each bin's first place (the query's points in the bins above, then the
    bin's points in the probes before), each warp's segment of the probe
    counted per bin and offset by the warps before, then the segment
    walked in steps of 32 lanes, a point placed at its bin's next place
    plus the lanes before it in its bin. Returns (values (Q, k) f32,
    positions (Q, k) int64)."""
    q, n_probe, p = counts.shape
    nbins = 2 * s + 2
    bins = torch.where(counts == NEG, 0, counts + s + 1).long()
    hist = torch.zeros((q, n_probe, nbins), dtype=torch.int64)
    hist.scatter_add_(2, bins, torch.ones_like(bins))
    vals = torch.full((q, k), float("nan"))
    pos = torch.full((q, k), -1, dtype=torch.int64)
    seg = ((p + n_warps - 1) // n_warps + 31) // 32 * 32
    for qi in range(q):
        tot = hist[qi].sum(0)
        above = 0
        tb = nbins - 1
        while above + int(tot[tb]) < k:   # θ's bin: the k-th point's
            above += int(tot[tb])
            tb -= 1
        above_bin = torch.flip(torch.cumsum(torch.flip(tot, [0]), 0), [0]) - tot
        for probe in range(n_probe):
            pre = hist[qi, :probe].sum(0)
            base = above_bin + pre
            b_row = bins[qi, probe]
            wbase = []
            for w in range(n_warps):        # pass 1 and the warps' prefix
                p0, p1 = min(w * seg, p), min(w * seg + seg, p)
                wbase.append(base.clone())
                seg_hist = torch.bincount(b_row[p0:p1], minlength=nbins)
                base = base + seg_hist
            for w in range(n_warps):        # pass 2
                p0, p1 = min(w * seg, p), min(w * seg + seg, p)
                nxt = wbase[w]
                for j0 in range(p0, p1, 32):
                    lanes = range(j0, min(j0 + 32, p1))
                    step = b_row[j0:min(j0 + 32, p1)]
                    for lane, pt in enumerate(lanes):
                        b = int(step[lane])
                        if b < tb:
                            continue
                        at = int(nxt[b]) + int((step[:lane] == b).sum())
                        if at < k:
                            assert pos[qi, at] == -1, "place taken twice"
                            vals[qi, at] = float(counts[qi, probe, pt])
                            pos[qi, at] = probe * p + pt
                    nxt = nxt + torch.bincount(step, minlength=nbins)
    assert (pos >= 0).all(), "a place below k left empty"
    return vals, pos


@pytest.mark.parametrize("case", list(CASES))
def test_hit_count_topk_plain_matches_jax_top_k(case):
    table, codes, valid, ks = _case(case)
    t = torch.from_numpy
    for k in ks:
        vals, pos = phit.hit_count_topk_plain(t(table), t(codes), t(valid), k)
        want_v, want_p = _jax_topk(table, codes, valid, k)
        assert vals.dtype == torch.float32 and pos.dtype == torch.int64
        np.testing.assert_array_equal(vals.numpy(), want_v.astype(np.float32))
        np.testing.assert_array_equal(pos.numpy(), want_p)


@pytest.mark.parametrize("case", list(CASES))
def test_topk_kernel_placement_rule_matches_stable_sort(case):
    table, codes, valid, ks = _case(case, seed=7)
    t = torch.from_numpy
    counts = phit.hit_count_plain(t(table), t(codes), t(valid))
    for k in ks:
        got = emulate_topk_kernel(counts, table.shape[2], k)
        want = phit.hit_count_topk_plain(t(table), t(codes), t(valid), k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_topk_placement_rule_segments_and_bulk_ties():
    """Probes longer than the eight warps' segments (P = 700: segments of
    96, the last one short), with a sparse table whose counts tie in bulk
    across probes and segments, θ inside a tie run."""
    rng = np.random.default_rng(3)
    q, n_probe, p, s, e = 2, 3, 700, 4, 16
    table = rng.integers(-1, 2, (q, n_probe, s, e)).astype(np.int8)
    table *= (rng.random(table.shape) < 0.1).astype(np.int8)
    codes = rng.integers(0, e, (q, n_probe, p, s)).astype(np.uint8)
    valid = rng.random((q, n_probe, p)) < 0.5
    t = torch.from_numpy
    counts = phit.hit_count_plain(t(table), t(codes), t(valid))
    for k in (5, 333, 1000, 1500, n_probe * p):
        got = emulate_topk_kernel(counts, s, k)
        want = phit.hit_count_topk_plain(t(table), t(codes), t(valid), k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _index_form(seed, p=40, s=8, e=16, n_clusters=10, q=3, n_probe=4):
    rng = np.random.default_rng(seed)
    table = rng.integers(-1, 2, (q, n_probe, s, e)).astype(np.int8)
    cl_codes = rng.integers(0, e, (n_clusters, p, s)).astype(np.uint8)
    cl_valid = rng.random((n_clusters, p)) < 0.7
    cids = rng.integers(0, n_clusters, (q, n_probe))
    probe_ok = rng.random((q, n_probe)) < 0.5
    return [torch.from_numpy(a) for a in (table, cl_codes, cl_valid, cids,
                                          probe_ok)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [1, 17, 160])
def test_ops_hit_count_topk_scan_equals_top_k_of_counts(k, masked):
    table, codes, valid, cids, probe_ok = _index_form(31)
    pok = probe_ok if masked else None
    got = ops.hit_count_topk_scan(table, codes, valid, cids, k, probe_ok=pok)
    counts = ops.hit_count_scan(table, codes, valid, cids, probe_ok=pok)
    want = pjuno._top_k(counts.reshape(counts.shape[0], -1).float(), k, True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_ops_hit_count_topk_scan_refuses_bad_k():
    table, codes, valid, cids, _ = _index_form(32)
    for k in (0, 4 * 40 + 1):
        with pytest.raises(ValueError, match="k="):
            ops.hit_count_topk_scan(table, codes, valid, cids, k)
    with pytest.raises(ValueError, match="CUDA"):
        phit.hit_count_topk(table, codes, valid, cids, 1)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_stage_b_table_holds_signs_only(metric):
    """The kernels read a hit-table entry by its sign: stage B's table
    must hold only -1, 0 and +1 (and tier L's clip only 0 and 1)."""
    spec = DEEP_LIKE if metric == "l2" else TTI_LIKE
    pts, q = make_dataset(spec, 3000, 24, key=jax.random.PRNGKey(41))
    cfg = JunoConfig(n_clusters=16, n_entries=32, metric=metric,
                     calib_queries=16, kmeans_iters=3)
    index = to_port(build(pts, cfg, jax.random.PRNGKey(4)))
    qt = torch.from_numpy(np.array(q)).float()
    base, cids = filter_clusters(qt, index.ivf, nprobe=6, metric=metric)
    _, table, _, _ = pjuno._stage_b(index, qt, base, cids, metric=metric,
                                    thres_scale=1.0)
    assert table.dtype == torch.int8
    assert set(torch.unique(table).tolist()) <= {-1, 0, 1}
    assert {-1, 1} <= set(torch.unique(table).tolist())   # not all zeros
    assert set(torch.unique((table >= 0).to(torch.int8)).tolist()) <= {0, 1}
