"""Shared helpers of the ``tests/test_torch_*.py`` parity tests.

They hold ``repro_torch`` against the JAX reference ``repro``: inputs are
made with numpy from a seed and handed to both, and indexes cross over as
the flat arrays ``repro.build.store`` writes.
"""
import jax
import numpy as np

from repro.build.store import _flatten_index
from repro.core.juno import JunoConfig as JaxConfig
from repro_torch.build.pipeline import StreamDraws
from repro_torch.build.store import index_from_arrays
from repro_torch.core.juno import BuildDraws


def port_config(cfg: JaxConfig):
    """The port's JunoConfig with the same field values."""
    from repro_torch.core.juno import JunoConfig
    return JunoConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def to_port(jax_index, device="cpu"):
    """Carry a ``repro`` index across to ``repro_torch`` (bit-exact)."""
    return index_from_arrays(_flatten_index(jax_index), device)


def jax_build_draws(key, n: int, d: int, cfg: JaxConfig) -> BuildDraws:
    """The draws ``repro.core.build(points, cfg, key)`` makes, replayed with
    ``jax.random`` along the reference's key-split structure
    (core/juno.py:141-156,214-218, core/kmeans.py:102,129, core/pq.py:50)."""
    k_ivf, k_pq, k_cal = jax.random.split(key, 3)
    t_max = cfg.max_train_points if cfg.max_train_points > 0 else n
    sub = n > t_max
    n_train = t_max if sub else n
    choice = jax.random.choice
    ivf_train = choice(k_ivf, n, (t_max,), replace=False) if sub else None
    ivf_init = choice(k_ivf, n_train, (cfg.n_clusters,),
                      replace=n_train < cfg.n_clusters)
    pq_train = (choice(jax.random.fold_in(k_pq, 1), n, (t_max,),
                       replace=False) if sub else None)
    keys = jax.random.split(k_pq, d // cfg.sub_dim)
    pq_init = np.stack([np.asarray(choice(k, n_train, (cfg.n_entries,),
                                          replace=n_train < cfg.n_entries))
                        for k in keys])
    k_choice, k_noise = jax.random.split(k_cal)
    nq = min(cfg.calib_queries, n)
    as_np = lambda a: None if a is None else np.asarray(a)  # noqa: E731
    return BuildDraws(
        ivf_train_idx=as_np(ivf_train), ivf_init_idx=np.asarray(ivf_init),
        pq_train_idx=as_np(pq_train), pq_init_idx=pq_init,
        calib_idx=np.asarray(choice(k_choice, n, (nq,), replace=False)),
        calib_noise=np.asarray(jax.random.normal(k_noise, (nq, d))))


def jax_stream_draws(key, n: int, d: int, cfg: JaxConfig) -> StreamDraws:
    """The draws ``repro.build.build_streaming(source, cfg, key=key)``
    makes over an N-row source, replayed with ``jax.random``
    (build/pipeline.py:293-296,309-337): the reservoir's seed, then the
    in-memory build's draws at ``n = fill``, whose training sets are the
    whole sample."""
    k_ivf = jax.random.split(key, 3)[0]
    seed = int(np.asarray(jax.random.randint(jax.random.fold_in(k_ivf, 17),
                                             (), 0, 2 ** 31 - 1)))
    t_max = cfg.max_train_points if cfg.max_train_points > 0 else 200_000
    return StreamDraws(reservoir_seed=seed,
                       build=jax_build_draws(key, min(n, t_max), d, cfg))


def jax_kv_draws(key, n_heads: int, n_sub: int, n_points: int,
                 n_entries: int) -> np.ndarray:
    """The k-means init draws ``repro.models.juno_attention.build_kv_index``
    makes with ``key``, replayed with ``jax.random`` along its key-split
    structure (one key a head, split into one a subspace, each a
    ``core/kmeans.py:102`` choice): (H, S_sub, E) point indices."""
    choice = jax.random.choice
    return np.stack([
        np.stack([np.asarray(choice(k2, n_points, (n_entries,),
                                    replace=n_points < n_entries))
                  for k2 in jax.random.split(kk, n_sub)])
        for kk in jax.random.split(key, n_heads)])


def assert_ids_equal_up_to_ties(ids, ref_ids, scores, ref_scores, *,
                                rtol=1e-5, atol=1e-6):
    """Scores within tolerance; ids equal except inside runs of tied scores.

    ids/ref_ids (Q, k) ints, scores/ref_scores (Q, k) floats. A position
    whose ids differ must sit next to a reference score that equals its own
    within the tolerance: only then may the two sides order a tie
    differently (f32 sums over S run in a different order in the port).
    """
    ids, ref_ids = np.asarray(ids), np.asarray(ref_ids)
    scores, ref_scores = np.asarray(scores), np.asarray(ref_scores)
    np.testing.assert_allclose(scores, ref_scores, rtol=rtol, atol=atol)
    close = lambda a, b: (a == b) | (np.abs(a - b) <= atol + rtol * np.abs(b))  # noqa: E731
    tie_prev = np.zeros(ref_scores.shape, bool)
    tie_prev[:, 1:] = close(ref_scores[:, 1:], ref_scores[:, :-1])
    tie_next = np.zeros(ref_scores.shape, bool)
    tie_next[:, :-1] = tie_prev[:, 1:]
    bad = (ids != ref_ids) & ~(tie_prev | tie_next)
    assert not bad.any(), (
        f"{int(bad.sum())} ids differ outside score ties, first at "
        f"{np.argwhere(bad)[:5].tolist()}")


def jax_token_draws(batch: int, seq: int, step: int, seed: int = 0,
                    shard: int = 0) -> np.ndarray:
    """The (batch, seq + 1) f32 uniform draws
    ``repro.data.tokens.make_batch`` makes for (seed, step, shard),
    replayed with ``jax.random`` (data/tokens.py:16-20), for the port's
    ``make_batch(u=...)``."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                step), shard)
    return np.asarray(jax.random.uniform(key, (batch, seq + 1)))


def port_model_config(cfg):
    """The port's ModelConfig (and its nested MoE/MLA/SSM configs) with
    the field values of a ``repro.models.config.ModelConfig``."""
    import dataclasses
    from repro_torch.models import config as C
    nested = {"moe": C.MoEConfig, "mla": C.MLAConfig, "ssm": C.SSMConfig}
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name in nested and v is not None:
            v = nested[f.name](**dataclasses.asdict(v))
        kw[f.name] = v
    return C.ModelConfig(**kw)


def to_numpy_tree(tree):
    """A ``repro`` parameter or cache pytree as a tree of numpy arrays."""
    return jax.tree.map(np.asarray, tree)
