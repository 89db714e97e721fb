"""The port's serving engine against ``repro.serve.ann.AnnServeEngine``.

Both engines (fused=True) get the same request stream over the same index
(built by ``repro``, carried across bit-exactly). Each request's ids must
match up to score ties and its scores within rtol 1e-5 (f32 sums over S in
another order), and the engines must batch identically: the same
``stats["signatures"]`` lattice points and counts.
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
    recall targets 0.95 (H tier, folded into H2) and 0.85 (H2), explicit
    and default nprobe, 1 to 40 rows."""
    rng = np.random.default_rng(0)
    out, lo = [], 0
    for i in range(14):
        rows = int(rng.integers(1, 12)) if i != 5 else 40
        rows = min(rows, q.shape[0] - lo) or 1
        out.append(dict(queries=q[lo:lo + rows], k=(7, 10, 60, 100)[i % 4],
                        recall_target=(0.95, 0.85)[i % 2],
                        nprobe=(0, 8)[(i // 3) % 2]))
        lo = (lo + rows) % (q.shape[0] - 1)
    return out


def test_engine_matches_reference_engine(served):
    metric, q, ref, port = served
    jeng = JaxEngine(ref, metric=metric, fused=True)
    peng = AnnServeEngine(port, metric=metric)
    stream = _stream(q)
    jreqs = [jeng.submit(**r) for r in stream]
    preqs = [peng.submit(**r) for r in stream]
    assert jeng.run() == peng.run() == sum(len(r["queries"]) for r in stream)
    assert peng.stats["signatures"] == jeng.stats["signatures"]
    assert peng.stats["ticks"] == jeng.stats["ticks"]
    for jr, pr in zip(jreqs, preqs):
        assert pr.done and pr.ids.shape == jr.ids.shape
        assert_ids_equal_up_to_ties(pr.ids, jr.ids, pr.scores, jr.scores)
    assert peng.latency_stats()["n"] == len(stream)


def test_engine_m_and_l_tiers_raise(served):
    metric, q, _, port = served
    eng = AnnServeEngine(port, metric=metric)
    for kw in (dict(recall_target=0.6), dict(recall_target=0.2),
               dict(mode="M"), dict(mode="L")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            eng.submit(q[:2], **kw)
    assert not eng.queue
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        AnnServeEngine(port, metric=metric, fused=False)
