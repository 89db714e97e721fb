"""The port's autotune layer (``repro_torch.kernels.autotune``) against
``repro.kernels.autotune``'s tests: cache round-trips, fail-closed loads,
result parity.

The tuner picks launch parameters, never results: every knob it searches
(the two-stage core's launch shape on the card) is result-invariant, so a
tuned config must give the default's bits from both fused scans. The CPU's
plain versions have no knob (the reference's ``topc_impl`` is not ported):
they equal the reference's host paths under either of its θ-selections
(counts, cand and ``probe_ok`` equal; ``dist`` within rtol 1e-5, atol
1e-5, the reference test's tolerance: f32 sums over S in another order).
The JSON cache is keyed on (schema, backend, the kernels' build tag) and
fails closed: a corrupt, stale, foreign-backend, other-build or
schema-drifted file returns ``None`` (retune), never a misapplied config.
The launch shapes themselves run only on the card:
``test_torch_kernels_gpu.py``.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.kernels.fused_three_stage import fused_three_stage_host
from repro.kernels.fused_two_stage import fused_two_stage_host
from repro_torch.core import JunoConfig, build
from repro_torch.data import DEEP_LIKE, make_dataset
from repro_torch.kernels import autotune, ops
from repro_torch.kernels.autotune import (KERNELS, KernelConfig,
                                          active_config, backend_name,
                                          candidates, ensure_tuned,
                                          load_cache, save_cache, set_config)
from repro_torch.kernels.fused_three_stage import fused_three_stage_plain
from repro_torch.kernels.fused_two_stage import fused_two_stage_plain
from repro_torch.obs import Observability
from repro_torch.serve.ann import AnnServeEngine

CPU = "cpu"
CUDA = "cuda:NVIDIA H100 80GB HBM3"     # a card backend's key, for the lattice


@pytest.fixture(autouse=True)
def _reset_active():
    autotune.reset()
    yield
    autotune.reset()


# ---------------------------------------------------------------------------
# config + candidate enumeration
# ---------------------------------------------------------------------------
def test_default_config_valid():
    cfg = KernelConfig()
    assert cfg.validate()
    assert active_config("fused_two_stage") == cfg
    assert active_config("fused_three_stage") == cfg
    # the default is today's untuned launch, and the launch is the config
    assert cfg.launch() == dict(count_threads=256, count_per_thread=16,
                                select_threads=256)
    assert cfg.launch() == dataclasses.asdict(cfg)


@pytest.mark.parametrize("bad", [
    dict(count_threads=0), dict(count_threads=True), dict(count_threads=384),
    dict(count_threads=128), dict(count_per_thread=16.0),
    dict(select_threads=64), dict(select_threads=True),
    dict(select_threads="256"), dict(count_threads=128, count_per_thread=32),
])
def test_config_validate_rejects(bad):
    assert not dataclasses.replace(KernelConfig(), **bad).validate()


def test_set_config_rejects_unknown_kernel():
    with pytest.raises(ValueError):
        set_config("fused_four_stage", KernelConfig())


def test_set_config_rejects_invalid_config():
    with pytest.raises(ValueError):
        set_config("fused_two_stage",
                   dataclasses.replace(KernelConfig(), select_threads=1024))


def test_candidates_deduped_and_deterministic():
    """The search space collapses to the backend's effective knobs, keeps
    the first representative per effective key (deterministic tie-break),
    and always starts with the default config."""
    for backend in [CPU, CUDA]:
        cs = candidates(backend)
        assert cs == candidates(backend)            # deterministic
        keys = [autotune._effective_key(c, backend) for c in cs]
        assert len(keys) == len(set(keys))          # deduped
        assert cs[0] == KernelConfig()              # the default path first
        assert all(c.validate() for c in cs)
    assert candidates(CPU) == [KernelConfig()]      # no CPU knob
    assert len(candidates(CUDA)) == (len(autotune.COUNT_SHAPES)
                                     * len(autotune.SELECT_THREADS))
    assert backend_name("cpu") == CPU


# ---------------------------------------------------------------------------
# cache round-trip: deterministic across runs
# ---------------------------------------------------------------------------
def test_cache_round_trip_deterministic(tmp_path):
    path = tmp_path / "autotune.json"
    configs = {"fused_two_stage": KernelConfig(count_threads=512,
                                               count_per_thread=8),
               "fused_three_stage": KernelConfig(select_threads=512)}
    save_cache(configs, path, backend=CPU)
    blob1 = path.read_bytes()
    loaded = load_cache(path, backend=CPU)
    assert loaded == configs
    save_cache(loaded, path, backend=CPU)            # save→load→save
    assert path.read_bytes() == blob1                # byte-identical
    assert blob1.endswith(b"\n")
    assert json.loads(blob1)["kernels"] == autotune.kernels_tag()


def test_ensure_tuned_uses_cache_without_retuning(tmp_path, monkeypatch):
    """A valid cache short-circuits measurement entirely: ensure_tuned
    must install the cached configs and never call tune()."""
    path = tmp_path / "autotune.json"
    configs = {k: KernelConfig(select_threads=128) for k in KERNELS}
    save_cache(configs, path, backend=CPU)

    def boom(*a, **k):
        raise AssertionError("tune() ran despite a valid cache")
    monkeypatch.setattr(autotune, "tune", boom)
    got = ensure_tuned(path, device="cpu")
    assert got == configs
    for k in KERNELS:
        assert active_config(k) == configs[k]


def test_default_cache_path_honours_env(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "a.json"))
    assert autotune.default_cache_path() == tmp_path / "a.json"
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
    assert autotune.default_cache_path().parts[-2:] == ("repro_torch",
                                                       "autotune.json")


# ---------------------------------------------------------------------------
# fail-closed loads: never misuse a stale/foreign/corrupt cache
# ---------------------------------------------------------------------------
def _valid_blob():
    return {"schema": autotune.SCHEMA_VERSION, "backend": CPU,
            "kernels": autotune.kernels_tag(),
            "configs": {k: dataclasses.asdict(KernelConfig())
                        for k in KERNELS}}


def _corruptions():
    blob = _valid_blob()
    out = {"truncated-json": json.dumps(blob)[:-9],
           "not-a-dict": json.dumps([1, 2, 3]),
           "empty": ""}
    b = _valid_blob(); b["schema"] = autotune.SCHEMA_VERSION + 1
    out["schema-bump"] = json.dumps(b)
    b = _valid_blob(); b["backend"] = CUDA
    out["foreign-backend"] = json.dumps(b)
    b = _valid_blob(); b["kernels"] = "libfused_two_stage-000000000000"
    out["other-kernels-tag"] = json.dumps(b)
    b = _valid_blob(); del b["kernels"]
    out["no-kernels-tag"] = json.dumps(b)
    b = _valid_blob(); b["configs"]["fused_four_stage"] = \
        dataclasses.asdict(KernelConfig())
    out["unknown-kernel"] = json.dumps(b)
    b = _valid_blob(); b["configs"][KERNELS[0]]["count_threads"] = -4
    out["invalid-field-value"] = json.dumps(b)
    b = _valid_blob(); b["configs"][KERNELS[0]]["count_per_thread"] = 8
    out["off-lattice-shape"] = json.dumps(b)
    b = _valid_blob(); b["configs"][KERNELS[0]]["block_q"] = \
        b["configs"][KERNELS[0]].pop("count_threads")
    out["field-set-drift"] = json.dumps(b)
    b = _valid_blob(); b["configs"][KERNELS[0]]["select_threads"] = "256"
    out["wrong-field-type"] = json.dumps(b)
    b = _valid_blob(); b["configs"][KERNELS[0]]["topc_impl"] = "sort"
    out["extra-field"] = json.dumps(b)
    return out


@pytest.mark.parametrize("name", sorted(_corruptions()))
def test_load_fails_closed(tmp_path, name):
    path = tmp_path / "autotune.json"
    path.write_text(_corruptions()[name])
    assert load_cache(path, backend=CPU) is None


def test_load_refuses_another_backend_and_build(tmp_path):
    """A cache written for the card is not the CPU's, nor the card's once
    the kernels' sources change."""
    path = tmp_path / "autotune.json"
    save_cache({k: KernelConfig() for k in KERNELS}, path, backend=CUDA)
    assert load_cache(path, backend=CUDA) is not None
    assert load_cache(path, backend=CPU) is None
    assert load_cache(path, backend=CUDA, kernels="another build") is None


def test_load_missing_file_is_none(tmp_path):
    assert load_cache(tmp_path / "nope.json", backend=CPU) is None


def test_ensure_tuned_retunes_on_corrupt_cache(tmp_path, monkeypatch):
    """Corrupt cache → retune and REWRITE, never silently reuse."""
    path = tmp_path / "autotune.json"
    path.write_text("{not json")
    calls = []

    def fake_tune(kernel, **kw):
        calls.append(kernel)
        return KernelConfig()
    monkeypatch.setattr(autotune, "tune", fake_tune)
    got = ensure_tuned(path, device="cpu")
    assert sorted(calls) == sorted(KERNELS)
    assert load_cache(path, backend=CPU) == got       # rewritten, valid now


def test_tune_raises_when_a_candidate_fails(monkeypatch):
    """A candidate that fails to launch stops the pass: it is never
    skipped, so no winner is picked among the rest. The card's lattice is
    measured on the CPU's problem (the CPU has one candidate), and every
    shape but the default fails."""
    real = autotune.run_fn
    lattice = candidates(CUDA)
    monkeypatch.setattr(autotune, "candidates", lambda backend=None: lattice)

    def failing(kernel, config, problem, **kw):
        if config != KernelConfig():
            def launch():
                raise RuntimeError("fused_two_stage: CUDA error 1 at launch")
            return launch
        return real(kernel, config, problem, **kw)
    monkeypatch.setattr(autotune, "run_fn", failing)
    with pytest.raises(RuntimeError, match="at launch"):
        autotune.tune("fused_two_stage", repeats=1, device="cpu")


def test_winner_breaks_ties_by_canonical_order():
    a, b, c = candidates(CUDA)[:3]
    assert autotune.winner([(a, 1.0), (b, 0.5), (c, 0.5)]) == b
    assert autotune.winner([(a, 0.5), (b, 0.5)]) == a


# ---------------------------------------------------------------------------
# tuned vs default: knobs must not change results
# ---------------------------------------------------------------------------
def _problem():
    rng = np.random.default_rng(0)
    q, n_probe, p, s, e, cap_c = 5, 3, 24, 6, 16, 12
    lut = rng.standard_normal((q, n_probe, s, e)).astype(np.float32)
    table = rng.integers(-1, 2, (q, n_probe, s, e)).astype(np.int8)
    codes = rng.integers(0, e, (q, n_probe, p, s)).astype(np.uint8)
    valid = rng.random((q, n_probe, p)) < 0.85
    return lut, table, codes, valid, cap_c


def _grid(q, n_probe):
    rng = np.random.default_rng(1)
    g, cap = 3, 8
    c0 = rng.random((g * g, cap)).astype(np.float32)
    c1 = rng.random((g * g, cap)).astype(np.float32)
    reach = np.abs(rng.normal(0, 0.2, (g * g, cap))).astype(np.float32)
    reach[:, cap // 2:] = -np.inf
    return (rng.random(q).astype(np.float32), rng.random(q).astype(np.float32),
            rng.random(q).astype(np.float32), c0, c1, reach,
            rng.integers(0, g * g * cap, (q, n_probe)).astype(np.int32))


def _index_form(codes, valid):
    """The per-probe codes as an index of Q·np clusters, each probed once."""
    q, n_probe, p, s = codes.shape
    cids = torch.arange(q * n_probe).reshape(q, n_probe)
    return (torch.from_numpy(codes.reshape(q * n_probe, p, s)),
            torch.from_numpy(valid.reshape(q * n_probe, p)), cids)


def _assert_same(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _assert_as_reference(got, ref):
    """counts, cand (and probe_ok) equal; dist and cand_dist within the
    reference test's tolerance."""
    for i in range(0, len(ref), 2):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
    for i in (1, 3):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_tuned_configs_bit_identical_two_stage(metric):
    """Every candidate config the tuner may pick, on either backend, gives
    the default's bits through ``ops`` (which reads the active config);
    the plain version equals the reference's host path under either of
    its θ-selections."""
    lut, table, codes, valid, cap_c = _problem()
    tl, tt = torch.from_numpy(lut), torch.from_numpy(table)
    cc, cv, cids = _index_form(codes, valid)
    kw = dict(cap_c=cap_c, metric=metric)
    base = ops.fused_two_stage_scan(tl, tt, cc, cv, cids, **kw)
    for cfg in candidates(CPU) + candidates(CUDA):
        set_config("fused_two_stage", cfg)
        _assert_same(ops.fused_two_stage_scan(tl, tt, cc, cv, cids, **kw),
                     base)
    got = fused_two_stage_plain(tl, tt, torch.from_numpy(codes),
                                torch.from_numpy(valid), **kw)
    _assert_same(got, base)
    for impl in ("sort", "topk"):
        _assert_as_reference(got, fused_two_stage_host(
            lut, table, codes, valid, **kw, topc_impl=impl))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_tuned_configs_bit_identical_three_stage(metric):
    """Same invariance for the three-stage scan, probe verdicts included."""
    lut, table, codes, valid, cap_c = _problem()
    grid = _grid(*lut.shape[:2])
    tl, tt = torch.from_numpy(lut), torch.from_numpy(table)
    tg = [torch.from_numpy(a) for a in grid]
    cc, cv, cids = _index_form(codes, valid)
    kw = dict(cap_c=cap_c, metric=metric)
    base = ops.fused_three_stage_scan(tl, tt, cc, cv, cids, *tg, **kw)
    for cfg in candidates(CPU) + candidates(CUDA):
        set_config("fused_three_stage", cfg)
        _assert_same(ops.fused_three_stage_scan(tl, tt, cc, cv, cids, *tg,
                                                **kw), base)
    got = fused_three_stage_plain(tl, tt, torch.from_numpy(codes),
                                  torch.from_numpy(valid), *tg, **kw)
    _assert_same(got, base)
    for impl in ("sort", "topk"):
        _assert_as_reference(got, fused_three_stage_host(
            lut, table, codes, valid, *grid, **kw, topc_impl=impl))


@pytest.mark.parametrize("kernel", KERNELS)
def test_ops_reads_the_active_config_every_call(kernel, monkeypatch):
    """The dispatchers read the config on every call (the port traces
    nothing): a config set between two calls reaches the second's launch.
    The card's wrapper is stood in for by the plain version, so the route
    runs on the CPU."""
    seen = []
    plain = getattr(ops, f"{kernel}_plain")

    def spy(lut, table, codes, valid, cids, *rest, probe_ok=None,
            count_threads, count_per_thread, select_threads, **kw):
        seen.append((count_threads, count_per_thread, select_threads))
        return plain(lut, table, codes[cids], valid[cids], *rest, **kw)
    monkeypatch.setattr(ops, "_on_cuda", lambda *a: True)
    monkeypatch.setattr(ops, kernel, spy)
    lut, table, codes, valid, cap_c = _problem()
    args = [torch.from_numpy(lut), torch.from_numpy(table),
            *_index_form(codes, valid)]
    if kernel == "fused_three_stage":
        args += [torch.from_numpy(a) for a in _grid(*lut.shape[:2])]
    scan = getattr(ops, f"{kernel}_scan")
    scan(*args, cap_c=cap_c)
    set_config(kernel, KernelConfig(count_threads=512, count_per_thread=8,
                                    select_threads=128))
    scan(*args, cap_c=cap_c)
    assert seen == [(256, 16, 256), (512, 8, 128)]


@pytest.fixture(scope="module")
def engine_index():
    pts, q = make_dataset(DEEP_LIKE, 3000, 64, seed=5)
    cfg = JunoConfig(n_clusters=16, n_entries=32, calib_queries=16,
                     kmeans_iters=4)
    return np.asarray(q), build(pts, cfg, seed=3, device="cpu")


@pytest.mark.parametrize("prefilter", ["scan", "rt"])
def test_autotune_preserves_signature_lattice(engine_index, prefilter):
    """Engine-level pin (the reference's ``test_recall_matrix.py``):
    installing configs must not widen the engine's signature lattice,
    since no knob is part of a dispatch key. The same request mix served
    under default and under non-default configs gives an IDENTICAL
    signature Counter, ``juno_engine_jit_retraces_total`` and identical
    ids and scores (every knob is result-invariant)."""
    q, idx = engine_index
    nprobe = 8
    waves = [(q[:8], dict(k=10, mode="H2", nprobe=nprobe)),
             (q[8:24], dict(k=10, mode="H", nprobe=nprobe)),
             (q[24:28], dict(k=10, mode="H2", nprobe=4))]

    def serve(configs):
        autotune.reset()
        try:
            for kernel, cfg in configs.items():
                set_config(kernel, cfg)
            eng = AnnServeEngine(idx, metric="l2", fused=True,
                                 prefilter=prefilter,
                                 batch_buckets=(8, 16, 32),
                                 obs=Observability())
            reqs = [eng.submit(qs, **kw) for qs, kw in waves]
            eng.run()
            retraces = eng.obs.registry.snapshot()[
                "juno_engine_jit_retraces_total"]
            return (dict(eng.stats["signatures"]), retraces,
                    [(np.asarray(r.ids), np.asarray(r.scores)) for r in reqs])
        finally:
            autotune.reset()

    base_sigs, base_n, base_res = serve({})
    tuned = {"fused_two_stage": KernelConfig(count_threads=512,
                                             count_per_thread=8),
             "fused_three_stage": KernelConfig(count_threads=512,
                                               count_per_thread=8,
                                               select_threads=128)}
    tuned_sigs, tuned_n, tuned_res = serve(tuned)
    assert tuned_sigs == base_sigs and tuned_n == base_n
    assert base_sigs and all(len(key) == 4 for key in base_sigs)
    assert {kw["k"] for _, kw in waves} == {key[0] for key in base_sigs}
    for (ai, as_), (bi, bs) in zip(base_res, tuned_res):
        np.testing.assert_array_equal(ai, bi)
        np.testing.assert_array_equal(as_, bs)


# ---------------------------------------------------------------------------
# the measured search itself
# ---------------------------------------------------------------------------
@pytest.mark.autotune
def test_measured_tune_round_trips(tmp_path):
    """End-to-end on the CPU: tune both kernels on the bundled problems,
    cache, reload; the reloaded configs validate, match what was tuned,
    and a second ensure_tuned() installs them without retuning."""
    path = tmp_path / "autotune.json"
    got = ensure_tuned(path, repeats=3, device="cpu")
    assert sorted(got) == sorted(KERNELS)
    for cfg in got.values():
        assert cfg.validate()
    assert load_cache(path, backend=CPU) == got
    autotune.reset()
    again = ensure_tuned(path, repeats=3, device="cpu")
    assert again == got
    for k in KERNELS:
        assert active_config(k) == got[k]
