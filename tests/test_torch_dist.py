"""The port's cluster-sharded index (``repro_torch.dist``) against the
reference and against the port's single-device mutable index.

The reference's multi-device search needs ``XLA_FLAGS`` set before jax is
imported, so here it runs only on a 1-device mesh. The port is held three
ways, every shard on the CPU (``devices=["cpu"] * n``):

* **one shard** against the reference's own ``make_distributed_search``
  on a 1-device mesh, in tiers H, H2, M and L, fused H2 and with the side
  buffer, l2 and ip;
* **2 and 4 shards** against a composition of the reference written here:
  each shard's ``repro.core.juno._search_batch`` /
  ``_search_batch_two_stage`` on the reference index sliced to its
  clusters, the side buffer localised and ``rt_offset`` its first cluster,
  then ``lax.top_k`` over the shard-major concatenation (what the
  reference's ``local_search`` computes), scan and rt, composed, fused and
  three-stage H2, with a side buffer of points owned by several shards
  and with the freshness tiers on; and at full coverage against the
  reference's unsharded ``search``;
* **mutations** against the port's ``MutableJunoIndex`` after the same
  insert / spill / delete / compact sequence (the reference's own tests of
  these fail under jax 0.9), then ``rebuild_shard`` / ``rebuild``, a
  lane-scheduled drain, ``swap_data`` and the rt grid's reaches.

Counts (M, L) and ids beside them are exact; other scores within rtol
1e-5, ids up to score ties. Under rt a query whose probe verdict differs
between the packages on some shard (a probe on its disc's boundary, where
the f32 radius differs by an ulp) is left out: as in ``test_torch_rt.py``
each flipped probe lies within ``MARGIN`` of its disc's boundary, and at
most one query in twenty may flip.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mutable import near_points, port_grid
from _torch_parity import assert_ids_equal_up_to_ties, to_port
from test_torch_rt import MARGIN
from repro import rt as jrt
from repro.core import JunoConfig, build
from repro.core import density as jdensity
from repro.core import juno as jjuno
from repro.core import search as jax_search
from repro.dist.distributed_index import \
    make_distributed_search as jax_make_dsearch
from repro.dist.distributed_index import shard_index as jax_shard_index
from repro_torch.build import rebuild_index
from repro_torch.core import MergeScheduler, MutableJunoIndex, promote_l0
from repro_torch.core import density as pdensity
from repro_torch.core.ivf import filter_clusters
from repro_torch.core.juno import _rt_probe_mask
from repro_torch.data import DEEP_LIKE, TTI_LIKE, make_dataset
from repro_torch.dist import (DistributedMutableIndex,
                              make_distributed_search, shard_index)
from repro_torch.rt import build_grid

C = 16
FULL = 1e6          # rt_scale at which every disc covers every cluster
SPILL_CLUSTERS = (1, 6, 11, 14)   # owned by shards 0..3 (2 shards: 0,0,1,1)
# the reference's per-shard searches, jitted once a configuration
_jax_mask = jax.jit(lambda g, x, t, c, off: jjuno._rt_probe_mask(
    g, x, t, c, 1.0, off))
_jax_radius = jax.jit(lambda g, t: jrt.query_radius(g, t, 1.0))


def _make_env(metric):
    """A reference index of 3000 points in 16 clusters, its rt grid, the
    port's copies, and two mutated pairs (reference, port) of
    ``MutableJunoIndex``: ``side`` (a 32-slot side buffer holding three
    spills into each of four clusters that four shards own, and deletes)
    and ``tiers`` (an 8-slot L0 with ``max_minors=2``: the same spills
    promote one minor generation)."""
    spec = DEEP_LIKE if metric == "l2" else TTI_LIKE
    pts, q = make_dataset(spec, 3000, 24, seed=9)
    cfg = JunoConfig(n_clusters=C, n_entries=32, calib_queries=16,
                     kmeans_iters=4, capacity_mult=1.1, metric=metric)
    ref = build(pts, cfg, jax.random.PRNGKey(2))
    grid = jrt.build_grid(ref, metric=metric, calib_queries=8, points=pts)
    port = to_port(ref)
    states = {}
    for name, cap, minors in (("side", 32, 0), ("tiers", 8, 2)):
        jm = jjuno.MutableJunoIndex(ref, side_capacity=cap)
        pm = MutableJunoIndex(port, side_capacity=cap)
        if minors:
            jm.enable_tiers(minors)
            pm.enable_tiers(minors)
        rng = np.random.default_rng(5)
        new, spilled = [], []
        for c in SPILL_CLUSTERS:
            batch = near_points(np.asarray(ref.ivf.centroids[c]),
                                pm.free_slots(c) + 3, rng)
            ids = jm.insert(batch)
            assert pm.insert(batch) == ids
            new += ids
            spilled.append(batch[-2])
        victims = [new[0], new[-1], int(np.asarray(ref.ivf.point_ids)[6, 0])]
        assert jm.delete(victims) == pm.delete(victims) == 3
        states[name] = (jm, pm)
    side = states["side"][1].side
    owners = set(side.cluster[side.valid].numpy().tolist())
    assert owners == set(SPILL_CLUSTERS)       # points of four shards
    assert len(states["tiers"][1]._minors) == 1
    # the queries, then one spilled point of each of the four clusters
    q = np.concatenate([q, np.stack(spilled)])
    return dict(metric=metric, pts=pts, q=q, ref=ref, port=port, grid=grid,
                pgrid=port_grid(grid), states=states)


@pytest.fixture(scope="module")
def envs():
    """``envs(metric)``: :func:`_make_env`, built once a metric."""
    cache = {}

    def get(metric):
        if metric not in cache:
            cache[metric] = _make_env(metric)
        return cache[metric]
    return get


@pytest.fixture(params=["l2", "ip"])
def env(request, envs):
    return envs(request.param)


def _higher_better(metric, mode):
    return metric == "ip" if mode in ("H", "H2") else True


def _assert_same(metric, mode, ids, ref_ids, scores, ref_scores):
    """Counts and their ids exactly; other scores within rtol 1e-5 and ids
    up to score ties."""
    ids, ref_ids = np.asarray(ids), np.asarray(ref_ids)
    scores, ref_scores = np.asarray(scores), np.asarray(ref_scores)
    if mode in ("M", "L"):
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_array_equal(scores, ref_scores)
    else:
        assert_ids_equal_up_to_ties(ids, ref_ids, scores, ref_scores)


def _assert_same_sets(ids, ref_ids, scores, ref_scores):
    """Scores bit-equal; in each row the ids scored above the row's last
    score equal as sets (equal scores may be ordered either way, and the
    last score's group may be cut at a different member)."""
    ids, ref_ids = np.asarray(ids), np.asarray(ref_ids)
    scores, ref_scores = np.asarray(scores), np.asarray(ref_scores)
    np.testing.assert_array_equal(scores, ref_scores)
    for i, r, s in zip(ids, ref_ids, ref_scores):
        inner = s != s[-1]
        assert set(i[inner]) == set(r[inner])


def _slice(data, lo, hi):
    """The reference index restricted to clusters [lo, hi)."""
    ivf = data.ivf
    return data._replace(
        ivf=ivf._replace(centroids=ivf.centroids[lo:hi],
                         centroid_sq=ivf.centroid_sq[lo:hi],
                         point_ids=ivf.point_ids[lo:hi],
                         valid=ivf.valid[lo:hi]),
        cluster_codes=data.cluster_codes[lo:hi])


def _ref_composed(env, data, side, q, n, local_np, k, *, mode, rt=False,
                  fused=False, fused3=None, rerank=0):
    """The reference's per-shard searches and its shard-major top-k merge
    (``repro/dist/distributed_index.py:local_search``)."""
    metric, n_local = env["metric"], C // n
    keys, gids = [], []
    hb = _higher_better(metric, mode)
    for s in range(n):
        lo = s * n_local
        kw = {}
        if side is not None:
            kw["side"] = side._replace(cluster=side.cluster - lo)
        if rt:
            kw.update(prefilter="rt", rt_grid=env["grid"], rt_scale=1.0,
                      rt_offset=jnp.int32(lo))
        part = _slice(data, lo, lo + n_local)
        if mode == "H2":
            sc, ids = jjuno._search_batch_two_stage(
                part, jnp.asarray(q), nprobe=local_np, k=k, metric=metric,
                thres_scale=1.0, rerank=rerank, fused=fused, fused3=fused3,
                **kw)
        else:
            sc, ids = jjuno._search_batch(
                part, jnp.asarray(q), nprobe=local_np, k=k, mode=mode,
                metric=metric, thres_scale=1.0, **kw)
        keys.append(sc if hb else -sc)
        gids.append(ids)
    sel_key, sel = jax.lax.top_k(jnp.concatenate(keys, axis=1), k)
    out_ids = jnp.take_along_axis(jnp.concatenate(gids, axis=1), sel, axis=1)
    return np.asarray(sel_key if hb else -sel_key), np.asarray(out_ids)


def _rt_flips(env, pdata, jdata, q, n, local_np):
    """Queries with a probe whose rt verdict differs between the packages
    on some shard (each shard's probe mask computed by both, on the same
    local probes looked up at ``cids + lo``). As in ``test_torch_rt.py``,
    each flipped probe must lie within ``MARGIN`` of its disc's boundary,
    and at most one query in twenty may flip."""
    metric, n_local = env["metric"], C // n
    pgrid = env["pgrid"]
    qt = torch.from_numpy(q)
    qp = (qt @ pgrid.proj).double().numpy()
    rows = np.zeros(len(q), bool)
    for s, part in enumerate(shard_index(pdata, ["cpu"] * n)):
        lo = s * n_local
        _, cids = filter_clusters(qt, part.ivf, nprobe=local_np,
                                  metric=metric)
        res = qt - part.ivf.centroids[cids[:, 0]] if metric == "l2" else qt
        tau = pdensity.predict_threshold(part.density,
                                         res.reshape(len(q), -1, 2))
        mine = _rt_probe_mask(pgrid, qt, tau[:, None], cids, 1.0,
                              lo).numpy()
        jtau = jdensity.predict_threshold(
            jdata.density, jnp.asarray(res.numpy()).reshape(len(q), -1, 2),
            1.0)
        theirs = np.asarray(_jax_mask(env["grid"], jnp.asarray(q),
                                      jtau[:, None],
                                      jnp.asarray(cids.numpy()),
                                      jnp.int32(lo)))
        flips = mine != theirs
        if flips.any():
            jr = np.asarray(_jax_radius(env["grid"], jtau), np.float64)
            slot = pgrid.slot_of.long()[cids + lo].numpy()
            d2 = ((qp[:, None, 0] - pgrid.cell_c0.reshape(-1)[slot]
                   .double().numpy()) ** 2
                  + (qp[:, None, 1] - pgrid.cell_c1.reshape(-1)[slot]
                     .double().numpy()) ** 2)
            thr = jr[:, None] + pgrid.slot_reach.reshape(-1)[slot] \
                .double().numpy()
            gap = np.abs(d2 - thr * thr) / np.maximum(
                np.maximum(d2, thr * thr), 1e-30)
            assert (gap[flips] <= MARGIN).all(), gap[flips]
        rows |= flips.any(axis=1)
    assert rows.sum() <= max(1, len(q) // 20), f"{rows.sum()} queries flip"
    return rows


# ---------------------------------------------------------------------------
# one shard against the reference's 1-device mesh
# ---------------------------------------------------------------------------

_ONE = [(mode, np_, k, {}) for mode in ("H", "H2", "M", "L")
        for np_, k in ((4, 10), (8, 50))] + [
    ("H2", 4, 10, {"fused": True}), ("H", 8, 50, {"side": True}),
    ("H2", 8, 50, {"side": True, "fused": True})]
# every case at l2; at ip each tier once, fused H2 and the side buffer
ONE_SHARD = [("l2",) + c for c in _ONE] + [
    ("ip",) + c for c in _ONE if c[1:3] == (8, 50) or c[3]]


@pytest.mark.parametrize("metric,mode,nprobe,k,extra", ONE_SHARD,
                         ids=[f"{m}-{o}-{n}-{k}-{'-'.join(e) or 'plain'}"
                              for m, o, n, k, e in ONE_SHARD])
def test_one_shard_equals_reference_mesh(envs, metric, mode, nprobe, k,
                                         extra):
    env = envs(metric)
    metric, q = env["metric"], env["q"]
    with_side = extra.get("side", False)
    fused = extra.get("fused", False)
    jm, pm = env["states"]["side"]
    jdata, pdata = (jm.data, pm.data) if with_side else (env["ref"],
                                                         env["port"])
    mesh = jax.make_mesh((1,), ("data",))
    jfn = jax_make_dsearch(mesh, nprobe, k, mode=mode, metric=metric,
                           fused=fused, with_side=with_side)
    jargs = (jm.side,) if with_side else ()
    s_r, i_r = jfn(jax_shard_index(jdata, mesh), jnp.asarray(q), *jargs)
    fn = make_distributed_search(["cpu"], nprobe, k, mode=mode, metric=metric,
                                 fused=fused, with_side=with_side)
    pargs = (pm.side,) if with_side else ()
    s_p, i_p = fn(shard_index(pdata, ["cpu"]), q, *pargs)
    assert s_p.shape == i_p.shape == (len(q), k)
    _assert_same(metric, mode, i_p, i_r, s_p, s_r)


# ---------------------------------------------------------------------------
# 2 and 4 shards against the reference's per-shard search and merge
# ---------------------------------------------------------------------------

_SHARDED = [
    (2, dict(mode="H"), "side"), (4, dict(mode="H"), "side"),
    (4, dict(mode="M"), "side"), (2, dict(mode="L"), "tiers"),
    (2, dict(mode="H2"), "side"),
    (4, dict(mode="H2", fused=True, rerank=64), "tiers"),
    (4, dict(mode="H", rt=True), "side"),
    (2, dict(mode="M", rt=True), "tiers"),
    (4, dict(mode="H2", fused=True, rt=True), "side"),
    (2, dict(mode="H2", fused=True, fused3=False, rt=True), "side"),
]
# every case at l2; at ip every tier and form once
SHARDED = [("l2",) + c for c in _SHARDED] + [
    ("ip",) + _SHARDED[i] for i in (2, 3, 4, 6, 8)]


@pytest.mark.parametrize("metric,n,case,state", SHARDED, ids=[
    f"{m}-{n}-{'-'.join(f'{k}{v}' for k, v in c.items())}-{s}"
    for m, n, c, s in SHARDED])
def test_sharded_equals_reference_composition(envs, metric, n, case, state):
    env = envs(metric)
    metric, q = env["metric"], env["q"]
    jm, pm = env["states"][state]
    local_np, k = 8 // n + 1, 20
    s_r, i_r = _ref_composed(env, jm.data, jm.delta_view(), q, n, local_np,
                             k, **case)
    case = dict(case)
    rt = case.pop("rt", False)
    fn = make_distributed_search(["cpu"] * n, local_np, k, metric=metric,
                                 with_side=True,
                                 prefilter="rt" if rt else "scan", **case)
    args = (env["pgrid"],) if rt else ()
    s_p, i_p = fn(shard_index(pm.data, ["cpu"] * n), q, pm.delta_view(),
                  *args)
    keep = (~_rt_flips(env, pm.data, jm.data, q, n, local_np) if rt
            else np.ones(len(q), bool))
    _assert_same(metric, case["mode"], i_p.numpy()[keep], i_r[keep],
                 s_p.numpy()[keep], s_r[keep])


def test_full_coverage_equals_reference_search(env):
    """At ``local_nprobe = C / n`` every cluster is scanned: tier H over 4
    shards equals the reference's unsharded search at nprobe C."""
    metric, q = env["metric"], env["q"]
    s_r, i_r = jax_search(env["ref"], jnp.asarray(q), nprobe=C, k=10,
                          mode="H", metric=metric)
    fn = make_distributed_search(["cpu"] * 4, C // 4, 10, mode="H",
                                 metric=metric)
    s_p, i_p = fn(shard_index(env["port"], ["cpu"] * 4), q)
    _assert_same(metric, "H", i_p, i_r, s_p, s_r)


@pytest.mark.parametrize("mode,fused", [("H", False), ("M", False),
                                        ("H2", True)])
def test_rt_full_radii_equals_scan(env, mode, fused):
    """With ``rt_scale`` large enough to keep every probe, the sharded rt
    search (the three-stage kernel for fused H2) equals the sharded scan:
    the offset reaches the grid for every shard."""
    metric, q = env["metric"], env["q"]
    pm = env["states"]["side"][1]
    kw = dict(mode=mode, metric=metric, fused=fused, with_side=True)
    sharded = shard_index(pm.data, ["cpu"] * 4)
    s_s, i_s = make_distributed_search(["cpu"] * 4, 3, 20, **kw)(
        sharded, q, pm.delta_view())
    s_t, i_t = make_distributed_search(["cpu"] * 4, 3, 20, prefilter="rt",
                                       rt_scale=FULL, **kw)(
        sharded, q, pm.delta_view(), env["pgrid"])
    np.testing.assert_array_equal(i_t.numpy(), i_s.numpy())
    np.testing.assert_array_equal(s_t.numpy(), s_s.numpy())


def test_argument_errors(env):
    with pytest.raises(ValueError, match="requires mode='H2'"):
        make_distributed_search(["cpu"], 4, 10, mode="H", fused=True)
    with pytest.raises(ValueError, match="unknown prefilter"):
        make_distributed_search(["cpu"], 4, 10, prefilter="bvh")
    with pytest.raises(ValueError, match="divide evenly"):
        shard_index(env["port"], ["cpu"] * 3)
    with pytest.raises(ValueError, match="divide evenly"):
        DistributedMutableIndex(env["port"], ["cpu"] * 3)
    fn = make_distributed_search(["cpu"] * 2, 4, 10, prefilter="rt")
    with pytest.raises(ValueError, match="rt grid"):
        fn(shard_index(env["port"], ["cpu"] * 2), env["q"], None)
    with pytest.raises(ValueError, match="2 shards for 4 devices"):
        make_distributed_search(["cpu"] * 4, 4, 10)(
            shard_index(env["port"], ["cpu"] * 2), env["q"])


def test_entry_points_default_to_the_card(env):
    """Without ``devices`` every entry point takes the card, and raises
    where there is none: no shard silently runs on the CPU."""
    if torch.cuda.is_available():
        assert DistributedMutableIndex(env["port"]).devices == [
            torch.device("cuda")]
        return
    for call in (lambda: make_distributed_search(None, 4, 10),
                 lambda: shard_index(env["port"]),
                 lambda: DistributedMutableIndex(env["port"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("state", ["side", "tiers"])
def test_live_points_of_a_shard_match_reference(env, state):
    """``live_points(clusters=range)`` over one shard's rows lists what the
    reference's lists for that range over the whole storage: in-cluster
    points in slot order, then the delta tiers' points, cluster by
    cluster."""
    from repro.build.rebuild import live_points as jax_live_points
    from repro_torch.build.rebuild import live_points
    jm, pm = env["states"][state]
    lo, hi = 4, 8
    host = [np.asarray(a) for a in (jm.data.ivf.point_ids, jm.data.ivf.valid,
                                    jm.data.cluster_codes)]
    want = jax_live_points(jm, *host, clusters=range(lo, hi))
    got = live_points(pm, *(a[lo:hi] for a in host), clusters=range(lo, hi))
    flat = [(c, pid, code) for c in range(lo, hi) for pid, code in want[c]]
    assert [int(c) for c in got[0]] == [c for c, _, _ in flat]
    assert got[1].tolist() == [pid for _, pid, _ in flat]
    np.testing.assert_array_equal(got[2], np.stack([c for _, _, c in flat]))
    assert not any(want[c] for c in range(C) if not lo <= c < hi)


# ---------------------------------------------------------------------------
# the mutable index against the port's single-device one
# ---------------------------------------------------------------------------

def _assert_same_bookkeeping(dmi, mid):
    assert dmi._loc == mid._loc
    assert dmi._free == mid._free
    assert dmi._side_free == mid._side_free
    assert dmi._next_id == mid._next_id
    for f in ("codes", "cluster", "ids", "valid"):
        np.testing.assert_array_equal(getattr(dmi.side, f).numpy(),
                                      getattr(mid.side, f).numpy(), f)
    for f in ("point_ids", "valid"):
        np.testing.assert_array_equal(getattr(dmi.data.ivf, f).numpy(),
                                      getattr(mid.data.ivf, f).numpy(), f)
    np.testing.assert_array_equal(dmi.data.cluster_codes.numpy(),
                                  mid.data.cluster_codes.numpy())


def _assert_full_coverage_equal(env, dmi, mid, q, mode="H"):
    """``dmi``'s search at full coverage against ``mid``'s at nprobe C."""
    metric = env["metric"]
    fn = dmi.searcher(C // dmi.n_shards, 10, mode=mode, metric=metric)
    s_d, i_d = fn(dmi.shards, q, dmi.delta_view())
    s_m, i_m = mid.search(q, nprobe=C, k=10, mode=mode, metric=metric)
    if mode == "H":
        assert_ids_equal_up_to_ties(i_d.numpy(), i_m.numpy(), s_d.numpy(),
                                    s_m.numpy())
    else:
        _assert_same_sets(i_d, i_m, s_d, s_m)
    return s_d.numpy(), i_d.numpy()


def _mutate(dmi, mid, index, rng):
    """The same inserts (filling and spilling four clusters of four
    shards), deletes (build, inserted and side points) and compact (the
    freed slots take spills) on both, each step's state compared."""
    per = {}
    for c in SPILL_CLUSTERS:
        batch = near_points(index.ivf.centroids.numpy()[c],
                            mid.free_slots(c) + 2, rng)
        per[c] = dmi.insert(batch)
        assert mid.insert(batch) == per[c]
    _assert_same_bookkeeping(dmi, mid)
    victims = [int(p) for p in index.ivf.point_ids[[1, 6, 14], :2]
               .reshape(-1)] + [per[11][0], per[14][-1]]
    assert dmi.delete(victims) == mid.delete(victims) == len(victims)
    _assert_same_bookkeeping(dmi, mid)
    assert dmi.compact() == mid.compact() > 0
    _assert_same_bookkeeping(dmi, mid)


@pytest.mark.parametrize("n", [2, 4])
def test_mutations_equal_single_device(env, n):
    """insert / spill / delete / compact: bookkeeping, side buffer and
    storage equal to ``MutableJunoIndex``'s; full-coverage search equal
    (H up to ties, M's counts exactly); the caller's index untouched."""
    port = env["port"]
    dmi = DistributedMutableIndex(port, ["cpu"] * n, side_capacity=16)
    mid = MutableJunoIndex(port, side_capacity=16)
    _assert_same_bookkeeping(dmi, mid)
    before = port.ivf.valid.clone()
    _mutate(dmi, mid, port, np.random.default_rng(n))
    assert torch.equal(port.ivf.valid, before)
    for mode in ("H", "M"):
        _assert_full_coverage_equal(env, dmi, mid, env["q"], mode)
    assert dmi.merge_lanes() == [(s * C // n, (s + 1) * C // n)
                                 for s in range(n)]


def test_rebuild_shard_drains_and_keeps_results(env):
    """``rebuild_shard`` on each shard drains the side points it owns into
    freed slots; scores bit-equal before and after (ids up to exactly
    equal scores), storage equal to the single-device rebuild at the same
    capacity, and later inserts placed and found."""
    port, q = env["port"], env["q"]
    dmi = DistributedMutableIndex(port, ["cpu"] * 4, side_capacity=16)
    mid = MutableJunoIndex(port, side_capacity=16)
    rng = np.random.default_rng(11)
    cents = port.ivf.centroids.numpy()
    for c in SPILL_CLUSTERS:
        batch = near_points(cents[c], dmi.free_slots(c) + 2, rng)
        assert dmi.insert(batch) == mid.insert(batch)
    rows = [int(p) for p in port.ivf.point_ids[[1, 6, 11, 14], :3]
            .reshape(-1)]
    dmi.delete(rows)
    mid.delete(rows)
    assert dmi.side_fill == 8
    s0, i0 = _assert_full_coverage_equal(env, dmi, mid, q)
    drained = [dmi.rebuild_shard(s) for s in range(4)]
    assert drained == [2, 2, 2, 2] and dmi.side_fill == 0
    fn = dmi.searcher(C // 4, 10, mode="H", metric=env["metric"])
    s1, i1 = (t.numpy() for t in fn(dmi.shards, q, dmi.delta_view()))
    np.testing.assert_array_equal(s1, s0)
    assert_ids_equal_up_to_ties(i1, i0, s1, s0, rtol=0.0, atol=0.0)
    mid.swap_data(rebuild_index(mid))
    for f in ("point_ids", "valid"):
        np.testing.assert_array_equal(getattr(dmi.data.ivf, f).numpy(),
                                      getattr(mid.data.ivf, f).numpy())
    np.testing.assert_array_equal(dmi.data.cluster_codes.numpy(),
                                  mid.data.cluster_codes.numpy())
    assert dmi._loc == mid._loc and dmi._free == mid._free
    more = near_points(cents[6], 1, rng)      # the cluster's free slot
    ids = dmi.insert(more)
    assert dmi._loc[ids[0]][0] == 6 and dmi.side_fill == 0
    _, got = fn(dmi.shards, more, dmi.delta_view())
    # a point is its own nearest neighbour under l2 (not so under ip)
    assert ids[0] in got[0].tolist() or env["metric"] == "ip"


def test_rebuild_escalates_stuck_spills(env):
    """Spills into full clusters (no deletes) do not fit the fixed
    capacity: ``rebuild`` grows it through ``rebuild_index`` and
    ``swap_data``, the side buffer ends empty, the spilled points are
    found, and the id watermark survives the swap."""
    port = env["port"]
    dmi = DistributedMutableIndex(port, ["cpu"] * 2, side_capacity=16)
    rng = np.random.default_rng(13)
    c = int(np.argmin([dmi.free_slots(c) for c in range(C)]))
    batch = near_points(port.ivf.centroids.numpy()[c],
                        dmi.free_slots(c) + 4, rng, scale=0.02)
    ids = dmi.insert(batch)
    assert dmi.side_fill == 4
    cap = dmi.data.ivf.point_ids.shape[1]
    assert dmi.rebuild() == 4 and dmi.side_fill == 0
    assert dmi.data.ivf.point_ids.shape[1] > cap
    assert all(p.cluster_codes.shape[1] > cap for p in dmi.shards)
    fn = dmi.searcher(C // 2, 10, mode="H", metric=env["metric"])
    _, got = fn(dmi.shards, batch, dmi.delta_view())
    assert all(ids[j] in got[j].tolist() for j in range(len(ids))) \
        or env["metric"] == "ip"
    assert all(dmi._loc[i][0] == c for i in ids)
    more = dmi.insert(batch[:1])
    assert more[0] == max(ids) + 1 and dmi.side_fill == 0


def test_swap_data_keeps_the_watermark(env):
    """``swap_data`` of an index without the newest ids keeps the id
    counter, so ids are never reused; the rt grid is dropped."""
    port = env["port"]
    dmi = DistributedMutableIndex(port, ["cpu"] * 4, side_capacity=8,
                                  rt_grid=env["pgrid"])
    ids = dmi.insert(near_points(port.ivf.centroids.numpy()[3], 3,
                                 np.random.default_rng(1)))
    dmi.swap_data(port)
    assert dmi.rt_grid is None and dmi.side_fill == 0
    assert dmi._next_id == ids[-1] + 1
    assert dmi.insert(port.ivf.centroids.numpy()[:1] + 0.001) == [ids[-1] + 1]


def test_lane_drain_equals_single_device(env):
    """With the tiers on, ``MergeScheduler`` takes the index's merge lanes
    and a lane-scheduled drain moves what the single-device drain moves:
    tiers empty, storage and bookkeeping equal, results equal."""
    port, q = env["port"], env["q"]
    dmi = DistributedMutableIndex(port, ["cpu"] * 4, side_capacity=8)
    mid = MutableJunoIndex(port, side_capacity=8)
    for m in (dmi, mid):
        m.enable_tiers(2)
    rng = np.random.default_rng(7)
    cents = port.ivf.centroids.numpy()
    for c in SPILL_CLUSTERS:
        batch = near_points(cents[c], mid.free_slots(c) + 3, rng)
        assert dmi.insert(batch) == mid.insert(batch)
    promote_l0(dmi)
    promote_l0(mid)
    assert len(dmi._minors) == len(mid._minors) == 2
    victims = [int(p) for p in port.ivf.point_ids[list(SPILL_CLUSTERS), :4]
               .reshape(-1)]
    assert dmi.delete(victims) == mid.delete(victims)
    _assert_full_coverage_equal(env, dmi, mid, q)
    sch = MergeScheduler(dmi, clusters_per_step=1)
    assert sch._lanes == dmi.merge_lanes()
    moved = sch.drain()
    assert moved == MergeScheduler(mid, clusters_per_step=1).drain() >= 12
    assert dmi.delta_fill == mid.delta_fill == 0
    _assert_same_bookkeeping(dmi, mid)
    _assert_full_coverage_equal(env, dmi, mid, q)


def test_rt_grid_from_replicated_parts_equals_unsharded(env):
    """``ensure_rt_grid`` builds the grid from the replicated parts alone
    (no global view of the shards), equal to one built from the unsharded
    index, field by field."""
    metric, port = env["metric"], env["port"]
    dmi = DistributedMutableIndex(port, ["cpu"] * 4)
    got = dmi.ensure_rt_grid(metric=metric, calib_queries=16)
    want = build_grid(port, metric=metric, calib_queries=16)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f).numpy(), f)
    assert dmi.ensure_rt_grid(metric=metric) is got


def test_rt_reaches_grow_as_single_device(env):
    """Inserts into a sharded index with a grid grow the touched clusters'
    reaches exactly as ``MutableJunoIndex``'s do, and an rt search over
    the shards keeps the fresh points."""
    port, pgrid = env["port"], env["pgrid"]
    dmi = DistributedMutableIndex(port, ["cpu"] * 4, side_capacity=16,
                                  rt_grid=pgrid)
    mid = MutableJunoIndex(port, side_capacity=16, rt_grid=pgrid)
    rng = np.random.default_rng(3)
    far = (port.ivf.centroids.numpy()[[2, 9]]
           + 30 * rng.standard_normal((2, port.ivf.centroids.shape[1]))
           ).astype(np.float32)
    assert dmi.insert(far) == mid.insert(far)
    for f in pgrid._fields:
        np.testing.assert_array_equal(getattr(dmi.rt_grid, f).numpy(),
                                      getattr(mid.rt_grid, f).numpy(), f)
    assert not torch.equal(dmi.rt_grid.slot_reach, pgrid.slot_reach)
    assert dmi.rt_mutations == mid.rt_mutations
