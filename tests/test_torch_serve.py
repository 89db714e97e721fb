"""The port's serving engine against ``repro.serve.ann.AnnServeEngine``.

Both engines, in the same configuration (``fused`` True or False), get the
same request stream over the same index (built by ``repro``, carried
across bit-exactly); the stream routes to all four tiers. Requests served
by tier M or L (hit counts) must match exactly; the others' ids must match
up to score ties and their scores within rtol 1e-5 (f32 sums over S in
another order). The engines must batch identically: the same
``stats["signatures"]`` lattice points and counts, and the same ticks.
"""
import jax
import numpy as np
import pytest

from _torch_parity import assert_ids_equal_up_to_ties, to_port
from repro.core import JunoConfig, build
from repro.data import DEEP_LIKE, TTI_LIKE, make_dataset
from repro.serve.ann import AnnServeEngine as JaxEngine
from repro_torch.serve.ann import AnnServeEngine


@pytest.fixture(scope="module", params=["l2", "ip"])
def served(request):
    metric = request.param
    spec = DEEP_LIKE if metric == "l2" else TTI_LIKE
    pts, q = make_dataset(spec, 4000, 96, key=jax.random.PRNGKey(31))
    cfg = JunoConfig(n_clusters=16, n_entries=32, metric=metric,
                     calib_queries=16, kmeans_iters=4)
    ref = build(pts, cfg, jax.random.PRNGKey(4))
    return metric, np.asarray(q), ref, to_port(ref)


def _stream(q):
    """A mixed stream: k in {10, 100} (request k 7 and 60 round up),
    recall targets 0.95 (tier H), 0.85 (H2), 0.6 (M) and 0.3 (L), explicit
    and default nprobe, 1 to 40 rows."""
    rng = np.random.default_rng(0)
    out, lo = [], 0
    for i in range(20):
        rows = int(rng.integers(1, 12)) if i != 5 else 40
        rows = min(rows, q.shape[0] - lo) or 1
        out.append(dict(queries=q[lo:lo + rows], k=(7, 10, 60, 100)[i % 4],
                        recall_target=(0.95, 0.85, 0.6, 0.3)[(i // 4 + i) % 4],
                        nprobe=(0, 8)[(i // 3) % 2]))
        lo = (lo + rows) % (q.shape[0] - 1)
    return out


@pytest.mark.parametrize("fused", [True, False])
def test_engine_matches_reference_engine(served, fused):
    metric, q, ref, port = served
    jeng = JaxEngine(ref, metric=metric, fused=fused)
    peng = AnnServeEngine(port, metric=metric, fused=fused)
    stream = _stream(q)
    jreqs = [jeng.submit(**r) for r in stream]
    preqs = [peng.submit(**r) for r in stream]
    tiers = [peng.route(r)[1] for r in preqs]
    assert set(tiers) == ({"H2", "M", "L"} if fused else {"H", "H2", "M", "L"})
    assert jeng.run() == peng.run() == sum(len(r["queries"]) for r in stream)
    assert peng.stats["signatures"] == jeng.stats["signatures"]
    assert peng.stats["ticks"] == jeng.stats["ticks"]
    for jr, pr, tier in zip(jreqs, preqs, tiers):
        assert pr.done and pr.ids.shape == jr.ids.shape
        if tier in ("M", "L"):
            np.testing.assert_array_equal(pr.ids, jr.ids)
            np.testing.assert_array_equal(pr.scores, jr.scores)
        else:
            assert_ids_equal_up_to_ties(pr.ids, jr.ids, pr.scores, jr.scores)
    assert peng.latency_stats()["n"] == len(stream)
    assert peng.queued_rows == 0


@pytest.mark.parametrize("fused", [True, False])
def test_engine_routes_every_tier(served, fused):
    """M and L route to themselves; H folds into H2 only when fused."""
    metric, q, ref, port = served
    peng = AnnServeEngine(port, metric=metric, fused=fused)
    jeng = JaxEngine(ref, metric=metric, fused=fused)
    h = "H2" if fused else "H"
    cases = [(dict(recall_target=0.95), h), (dict(recall_target=0.85), "H2"),
             (dict(recall_target=0.6), "M"), (dict(recall_target=0.3), "L"),
             (dict(mode="H"), h), (dict(mode="M"), "M"), (dict(mode="L"), "L")]
    for kw, tier in cases:
        req = peng.submit(q[:3], k=10, **kw)
        assert peng.route(req) == jeng.route(jeng.submit(q[:3], k=10, **kw))
        assert peng.route(req)[1] == tier
    assert peng.queued_rows == 3 * len(cases)
