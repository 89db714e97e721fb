"""Tier H's top-k (``pq_scan_topk``) against ``repro``.

``pq_scan_topk_plain`` (the port's masked-ADC sums, plus ``probe_base``, a
stable sort, the first k) is held to the reference's tier-H scoring: its
Pallas ``pq_scan`` in interpret mode per (query, probe), plus
``probe_base``, then ``jax.lax.top_k`` of the scores (ip) or of their
negation (l2), as ``repro/core/juno.py`` l.296-299 and l.354 run it. With
an integer-valued LUT every sum is exact, so values and positions must be
equal, ties across probes included; with a float LUT the sums run in
another order, so values lie within rtol 1e-5 and positions are equal up
to score ties. A pure-torch emulation of the card's two-kernel rule
(``csrc/pq_scan.cu``: the order-preserving key, each probe's min(k, P)
best by a radix select over (key, ~position) composites, the query's k
best of those candidates by the same select, each written at its rank)
must equal the stable sort exactly, so that a wrong select or merge rule
shows here before it shows on the card. On the CPU
``ops.masked_adc_topk_scan`` equals ``_top_k`` of ``ops.masked_adc_scan``
plus the offset. The kernels themselves are held to the plain version in
``test_torch_kernels_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_ids_equal_up_to_ties
from repro.kernels.pq_scan import pq_scan as pallas_pq_scan
from repro_torch.core import juno as pjuno
from repro_torch.kernels import ops
from repro_torch.kernels import pq_scan as ppq

# (Q, np, P, S, E, valid share); LUT kind; k values (None = np*P)
CASES = {
    "mixed": ((3, 4, 50, 8, 16, 0.7), "float", (1, 10, 100, None)),
    "integer": ((3, 4, 40, 6, 16, 0.8), "int", (1, 10, 100, None)),
    "few_valid": ((2, 3, 40, 6, 16, 0.05), "float", (10, 100, None)),
    "pruned": ((3, 4, 30, 5, 8, 0.6), "int", (1, 10, 100, None)),
    "np1": ((3, 1, 120, 8, 16, 0.5), "float", (1, 10, 100, None)),
    "Q1": ((1, 5, 30, 8, 16, 0.5), "int", (1, 10, 100, None)),
}


def _case(name, metric, seed=0):
    (q, n_probe, p, s, e, frac), kind, ks = CASES[name]
    rng = np.random.default_rng(seed + len(name) + len(metric))
    if kind == "int":       # exact sums: ties across probes are exact too
        lut = rng.integers(-2 if metric == "ip" else 0, 3,
                           (q, n_probe, s, e)).astype(np.float32)
        base = rng.integers(-3, 4, (q, n_probe)).astype(np.float32)
    elif metric == "ip":    # signed similarities, as an ip LUT holds
        lut = rng.standard_normal((q, n_probe, s, e)).astype(np.float32)
        base = rng.standard_normal((q, n_probe)).astype(np.float32)
    else:                   # non-negative entries, as an l2 LUT holds
        lut = (rng.random((q, n_probe, s, e)) * 4).astype(np.float32)
        base = None
    if metric == "l2":
        base = None         # stage A adds no offset at l2
    codes = rng.integers(0, e, (q, n_probe, p, s)).astype(np.uint8)
    valid = rng.random((q, n_probe, p)) < frac
    if name == "pruned":    # every probe but 0 pruned
        valid[:, 1:] = False
    ks = [n_probe * p if k is None else k for k in ks]
    return lut, codes, valid, base, kind, [k for k in ks if k <= n_probe * p]


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax_topk(lut, codes, valid, base, k, metric):
    """The reference's tier-H scoring: Pallas ``pq_scan`` (interpret
    mode) per (q, probe), ``+ probe_base`` at ip, ``lax.top_k``."""
    q, n_probe = lut.shape[:2]
    scores = jnp.stack([jnp.stack([
        pallas_pq_scan(jnp.asarray(lut[i, j]), jnp.asarray(codes[i, j]),
                       jnp.asarray(valid[i, j]), metric=metric,
                       interpret=True)
        for j in range(n_probe)]) for i in range(q)])
    if base is not None:
        scores = scores + jnp.asarray(base)[..., None]
    flat = scores.reshape(q, -1)
    hb = metric == "ip"
    vals, pos = jax.lax.top_k(flat if hb else -flat, k)
    return np.asarray(vals if hb else -vals), np.asarray(pos)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("case", list(CASES))
def test_pq_scan_topk_plain_matches_jax_top_k(case, metric):
    lut, codes, valid, base, kind, ks = _case(case, metric)
    for k in ks:
        vals, pos = ppq.pq_scan_topk_plain(*_torch(lut, codes, valid), k,
                                           metric=metric,
                                           probe_base=_torch(base)[0])
        want_v, want_p = _jax_topk(lut, codes, valid, base, k, metric)
        assert vals.dtype == torch.float32 and pos.dtype == torch.int64
        assert vals.shape == pos.shape == (lut.shape[0], k)
        fin = np.isfinite(want_v)
        np.testing.assert_array_equal(np.isfinite(vals.numpy()), fin)
        if kind == "int":
            np.testing.assert_array_equal(vals.numpy(), want_v)
            np.testing.assert_array_equal(pos.numpy(), want_p)
        else:
            # sentinel places hold equal ±inf and fill in position order
            np.testing.assert_array_equal(vals.numpy()[~fin], want_v[~fin])
            np.testing.assert_array_equal(pos.numpy()[~fin], want_p[~fin])
            assert_ids_equal_up_to_ties(
                pos.numpy(), want_p, np.where(fin, vals.numpy(), 0),
                np.where(fin, want_v, 0))


_MASK = (1 << 32) - 1


def composites(scores: torch.Tensor, w: torch.Tensor, metric: str) -> list:
    """The kernels' 64-bit composites as Python ints: the order-preserving
    image of each score (negated at l2, -0 folded onto +0) above ~w."""
    v = -scores if metric == "l2" else scores
    b = v.contiguous().view(torch.int32).to(torch.int64) & _MASK
    b = torch.where(((b << 1) & _MASK) == 0, 0, b)
    key = torch.where(b >= 2 ** 31, ~b & _MASK, b | 2 ** 31)
    return [(int(kk) << 32) | (~int(ww) & _MASK)
            for kk, ww in zip(key.tolist(), w.tolist())]


def radix_select(comps: list, need: int) -> tuple[int, int]:
    """``csrc/pq_scan.cu:radix_select``: from the byte that holds the
    highest bit on which two items differ, 8-bit digits down, the need-th
    largest's digit a pass, stopping at the first bin that holds exactly
    the places left. Returns (prefix, mask): the items with
    ``c & mask >= prefix`` are the ``need`` largest."""
    all_, any_ = (1 << 64) - 1, 0
    for c in comps:
        all_ &= c
        any_ |= c
    diff = all_ ^ any_
    if diff == 0:                       # a single item
        return all_, (1 << 64) - 1
    shift = (diff.bit_length() - 1) & ~7
    mask = 0 if shift >= 56 else ((1 << 64) - 1) & ~((1 << (shift + 8)) - 1)
    prefix = all_ & mask
    while True:
        hist = [0] * 256
        for c in comps:
            if c & mask == prefix:
                hist[(c >> shift) & 255] += 1
        above, d = 0, 255
        while above + hist[d] < need:
            above += hist[d]
            d -= 1
        need -= above
        prefix |= d << shift
        mask |= 255 << shift
        if hist[d] == need:
            return prefix, mask
        shift -= 8
        assert shift >= 0


def emulate_topk_kernels(scores: torch.Tensor, valid: torch.Tensor, k: int,
                         metric: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The two kernels' rule over (Q, np, P) f32 scores (the offset
    added) and their (Q, np, P) valid mask: per (q, probe) the min(k, P)
    largest composites of its valid points as candidates when it has that
    many, else every valid point and the largest composites of its invalid
    slots (the lowest positions) for the rest (all P when k >= P); per
    query the k largest candidates, each written at its rank among them.
    Returns (values (Q, k) f32, positions (Q, k) int64)."""
    q, n_probe, p = scores.shape
    kk = min(k, p)
    vals = torch.full((q, k), float("nan"))
    pos = torch.full((q, k), -1, dtype=torch.int64)
    for qi in range(q):
        cand = []                               # (composite, value)
        for probe in range(n_probe):
            w = torch.arange(p) + probe * p
            comps = composites(scores[qi, probe], w, metric)
            ok = valid[qi, probe].tolist()
            if kk == p:
                take = [True] * p
            else:
                mine = [c for c, v in zip(comps, ok) if v]
                if len(mine) >= kk:
                    pre, msk = radix_select(mine, kk)
                    take = [v and c & msk >= pre for c, v in zip(comps, ok)]
                else:
                    rest = [c for c, v in zip(comps, ok) if not v]
                    pre, msk = radix_select(rest, kk - len(mine))
                    take = [v or c & msk >= pre for c, v in zip(comps, ok)]
            took = [(c, float(scores[qi, probe, i]))
                    for i, c in enumerate(comps) if take[i]]
            assert len(took) == kk
            cand += took
        cut = (0, 0) if k == len(cand) else radix_select(
            [c for c, _ in cand], k)
        listed = [(c, v) for c, v in cand if c & cut[1] >= cut[0]]
        assert len(listed) == k
        for c, v in listed:
            rank = sum(o > c for o, _ in listed)
            assert pos[qi, rank] == -1, "place taken twice"
            vals[qi, rank] = v
            pos[qi, rank] = ~c & _MASK
    assert (pos >= 0).all(), "a place below k left empty"
    return vals, pos


def _signed_zeros(lut):
    """Probe 0's entries all -0 and probe 1's all +0: their valid points
    sum to -0 and +0 and tie across the two probes (the kernels fold -0
    onto +0, as a sort compares them)."""
    lut = lut.copy()
    lut[:, 0] = -0.0
    lut[:, 1] = 0.0
    return lut


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("case", list(CASES))
def test_two_kernel_rule_matches_stable_sort(case, metric):
    lut, codes, valid, base, _, ks = _case(case, metric, seed=7)
    if case == "integer":
        lut = _signed_zeros(lut)
    t_lut, t_codes, t_valid, t_base = _torch(lut, codes, valid, base)
    scores = ppq.pq_scan_plain(t_lut, t_codes, t_valid, metric=metric)
    if t_base is not None:
        scores = scores + t_base[..., None]
    p = codes.shape[2]
    for k in sorted(set(ks) | {p - 1, p, p + 1} & set(range(1, max(ks) + 1))):
        got = emulate_topk_kernels(scores, t_valid, k, metric)
        want = ppq.pq_scan_topk_plain(t_lut, t_codes, t_valid, k,
                                      metric=metric, probe_base=t_base)
        assert torch.equal(got[1], want[1]), k
        assert torch.equal(got[0], want[0]), k
        assert torch.equal(torch.signbit(got[0]), torch.signbit(want[0]))


def test_two_kernel_rule_negative_zero_ties():
    """Sums of exactly -0 and +0 tie (by position), at l2 and ip."""
    scores = torch.tensor([[[0.0, -0.0, 1.0, -0.0], [-0.0, 0.0, -1.0, 0.0]]])
    for metric in ("l2", "ip"):
        for k in range(1, 9):
            got = emulate_topk_kernels(scores, scores == scores, k, metric)
            want = ppq._sorted_top(scores.reshape(1, -1), k, metric)
            assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
            assert torch.equal(torch.signbit(got[0]), torch.signbit(want[0]))


def _index_form(seed, metric, p=40, s=8, e=16, n_clusters=10, q=3,
                n_probe=4):
    rng = np.random.default_rng(seed)
    lut = rng.standard_normal((q, n_probe, s, e)).astype(np.float32)
    cl_codes = rng.integers(0, e, (n_clusters, p, s)).astype(np.uint8)
    cl_valid = rng.random((n_clusters, p)) < 0.7
    cids = rng.integers(0, n_clusters, (q, n_probe))
    probe_ok = rng.random((q, n_probe)) < 0.5
    base = (rng.standard_normal((q, n_probe)).astype(np.float32)
            if metric == "ip" else None)
    return _torch(lut, cl_codes, cl_valid, cids, probe_ok, base)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [1, 17, 160])
def test_ops_masked_adc_topk_scan_equals_top_k_of_scores(k, masked, metric):
    lut, codes, valid, cids, probe_ok, base = _index_form(31, metric)
    pok = probe_ok if masked else None
    got = ops.masked_adc_topk_scan(lut, codes, valid, cids, k, metric=metric,
                                   probe_ok=pok, probe_base=base)
    scores = ops.masked_adc_scan(lut, codes, valid, cids, metric=metric,
                                 probe_ok=pok)
    if base is not None:
        scores = scores + base[..., None]
    want = pjuno._top_k(scores.reshape(scores.shape[0], -1), k,
                        metric == "ip")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_ops_masked_adc_topk_scan_refuses_bad_k():
    lut, codes, valid, cids, _, _ = _index_form(32, "l2")
    for k in (0, 4 * 40 + 1):
        with pytest.raises(ValueError, match="k="):
            ops.masked_adc_topk_scan(lut, codes, valid, cids, k)
    with pytest.raises(ValueError, match="CUDA"):
        ppq.pq_scan_topk(lut, codes, valid, cids, 1)
    assert ppq.K_MAX >= 1024
