"""Shared helpers of the ``tests/test_torch_*.py`` parity tests.

They hold ``repro_torch`` against the JAX reference ``repro``: inputs are
made with numpy from a seed and handed to both, and indexes cross over as
the flat arrays ``repro.build.store`` writes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as RC
from repro.build.store import _flatten_index
from repro.core.juno import JunoConfig as JaxConfig
from repro.models import get_model as r_get_model
from repro.models import params as RPm
from repro.models import transformer as RT
from repro.models import whisper as RW
from repro_torch.build.pipeline import StreamDraws
from repro_torch.build.store import index_from_arrays
from repro_torch.core.juno import BuildDraws
from repro_torch.models import transformer as PT
from repro_torch.models import whisper as PW


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


def jax_normal_draws(cfg, batch: int, step: int, seed: int = 0,
                     shard: int = 0) -> np.ndarray:
    """The (batch, n_context_tokens, d_model) f32 N(0, 1) draws of the
    ``frames`` (an encoder-decoder's, key folded with 1) or ``context`` (a
    VLM's, folded with 2) that ``repro.data.tokens.make_batch`` makes,
    replayed with ``jax.random`` (data/tokens.py:27-36), for the port's
    ``make_batch(normal=...)``."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                step), shard)
    kf = jax.random.fold_in(key, 1 if cfg.encoder_decoder else 2)
    return np.asarray(jax.random.normal(
        kf, (batch, cfg.n_context_tokens, cfg.d_model), jax.numpy.float32))


class Recorder:
    """Wraps a decode: the tokens, positions and logits of every tick."""

    def __init__(self, decode):
        self.decode, self.ticks = decode, []

    def __call__(self, params, cache, token, pos):
        logits, cache = self.decode(params, cache, token, pos)
        self.ticks.append((token.clone(), pos.clone(), logits.clone()))
        return logits, cache


def engine_requests(mod, spec, vocab: int, seed: int = 7) -> list:
    """``mod.Request``s of (prompt length, max_new) ``spec``, the prompt
    ids from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, n).tolist(),
                        max_new=m) for i, (n, m) in enumerate(spec)]


def engine_lockstep(arch: str, dtype: str, spec, *, n_slots: int,
                    max_seq: int, tol: float, seed: int = 0):
    """``repro_torch.serve.engine.ServeEngine`` and the reference's on the
    same SMOKE model of ``arch`` (the reference's ``init_params`` at
    PRNGKey(seed) carried across) and the same queued requests ``spec``,
    ticked in lockstep. Every request's ``out`` must equal the
    reference's, except at a near-tie: the port's top-2 logit gap at that
    tick below ``2 tol`` times its largest logit (if both sides are within
    ``tol`` of the true logits and pick different tokens, the gap is at
    most that). After a divergence that request's stream is not compared.

    Returns (reference requests, port requests, reference engine, port
    engine, the port's :class:`Recorder`, the divergences: rid ->
    (output index, tick, slot, position, gap))."""
    from repro.serve import engine as RE
    from repro_torch.models import get_model, params_from_reference
    from repro_torch.serve import engine as PE

    rc = dataclasses.replace(RC.get_smoke_config(arch), dtype=dtype)
    pc = port_model_config(rc)
    rm, pm = r_get_model(rc), get_model(pc)
    rp = ref_smoke_params(arch, seed)
    pp = params_from_reference(to_numpy_tree(rp), pc, "cpu")
    rec = Recorder(pm.decode)
    ref = RE.ServeEngine(rm, rp, n_slots=n_slots, max_seq=max_seq)
    port = PE.ServeEngine(pm._replace(decode=rec), pp, n_slots=n_slots,
                          max_seq=max_seq, device="cpu")
    r_reqs = engine_requests(RE, spec, rc.vocab_size)
    p_reqs = engine_requests(PE, spec, pc.vocab_size)
    for r, p in zip(r_reqs, p_reqs):
        ref.submit(r)
        port.submit(p)
    diverged: dict = {}
    ticks = 0
    while ref.queue or any(s is not None for s in ref.slot_req):
        before = [len(p.out) for p in p_reqs]
        n_ref, n_port = ref.step(), port.step()
        assert n_ref == n_port, (ticks, n_ref, n_port)
        logits = rec.ticks[-1][2]
        for r, p, n0 in zip(r_reqs, p_reqs, before):
            assert r.slot == p.slot and r.done == p.done and r.fed == p.fed
            assert len(r.out) == len(p.out), (p.rid, r.out, p.out)
            if len(p.out) == n0 or p.rid in diverged:
                continue
            if r.out[-1] != p.out[-1]:
                row = logits[p.slot]
                top2 = torch.topk(row, 2).values
                gap = float(top2[0] - top2[1])
                limit = 2 * tol * float(row.abs().max())
                assert gap < limit, (
                    f"request {p.rid} tick {ticks}: {p.out[-1]} against the "
                    f"reference's {r.out[-1]} at a top-2 gap of {gap}")
                diverged[p.rid] = (len(p.out) - 1, ticks, p.slot,
                                   int(rec.ticks[-1][1][p.slot]), gap)
        ticks += 1
        assert ticks < 1000
    assert not port.queue and all(s is None for s in port.slot_req)
    np.testing.assert_array_equal(port.pos, ref.pos)
    return r_reqs, p_reqs, ref, port, rec, diverged


_SMOKE_PARAMS: dict = {}


def ref_smoke_params(arch: str, seed: int = 0) -> dict:
    """The reference's SMOKE parameters of ``arch`` (f32), one jitted
    ``init_params`` at PRNGKey(seed), made once a process."""
    if (arch, seed) not in _SMOKE_PARAMS:
        schema = r_get_model(RC.get_smoke_config(arch)).schema
        _SMOKE_PARAMS[arch, seed] = jax.jit(
            lambda k: RPm.init_params(schema, k))(jax.random.PRNGKey(seed))
    return _SMOKE_PARAMS[arch, seed]


def family_batches(rc, toks: np.ndarray, seq: int, ctx: np.ndarray):
    """The same batch for both packages: tokens[:, :seq], their targets,
    and a Whisper's ``frames`` or a VLM's ``context`` from ``ctx``."""
    br = {"tokens": jnp.asarray(toks[:, :seq]),
          "targets": jnp.asarray(toks[:, 1:seq + 1])}
    bp = {"tokens": torch.from_numpy(toks[:, :seq]),
          "targets": torch.from_numpy(toks[:, 1:seq + 1])}
    name = ("frames" if rc.encoder_decoder else "context"
            if rc.cross_attn_period else None)
    if name:
        br[name] = jnp.asarray(ctx, rc.dtype)
        bp[name] = torch.from_numpy(ctx).to(getattr(torch, rc.dtype))
    return br, bp, name


def ref_hidden(rc, p, batch):
    """The reference's final hidden states of a batch (Whisper: the
    decoder's over the encoded frames)."""
    if rc.encoder_decoder:
        return RW.decoder_forward(rc, p, batch["tokens"],
                                  RW.encode(rc, p, batch["frames"]))
    return RT.forward(rc, p, batch["tokens"], context=batch.get("context"))


def port_hidden(pc, p, batch):
    """:func:`ref_hidden` on the port."""
    if pc.encoder_decoder:
        return PW.decoder_forward(pc, p, batch["tokens"],
                                  PW.encode(pc, p, batch["frames"]))
    return PT.forward(pc, p, batch["tokens"], context=batch.get("context"))
