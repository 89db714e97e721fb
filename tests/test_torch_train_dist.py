"""The port's checkpoints, fault tolerance, gradient compression and
trainer CLI (``repro_torch.dist``, ``repro_torch.launch.train``) against
``repro``'s, on the CPU.

* checkpoints cross both ways bit-equal: the reference's ``save`` read by
  the port's ``restore`` and the port's by the reference's, for a
  ``TrainState`` after a step (params, m, v, step), bf16/int8/bool/f16
  leaves and an int8-compressed gradient tree, with the reference tests'
  ``keep``, overwrite and missing-directory cases;
* ``run_with_restart``: a fault at step 7 with checkpoints every 5 steps
  replays to parameters and moments ``torch.equal`` to an uninterrupted
  run;
* ``StepWatchdog``: the reference's verdicts on the same step times;
* compression: bf16 codes bit-equal; int8 codes, scales and residuals
  equal to the reference's over 20 error-feedback steps (the residual is
  a fused multiply-add in the jitted reference: the port rounds it once,
  as ``train/optimizer.py`` does);
* the CLI with ``--device cpu --smoke``: resume, the no-op resume, and a
  resume from a checkpoint the reference wrote.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_model_config, to_numpy_tree
from repro import configs as RC
from repro import train as RTr
from repro.dist import checkpoint as r_ckpt
from repro.dist import compression as r_comp
from repro.dist.fault_tolerance import StepWatchdog as RWatchdog
from repro.models import get_model as r_get_model
from repro.train import optimizer as RO
from repro_torch import train as PTr
from repro_torch.data.tokens import make_batch
from repro_torch.dist import checkpoint as p_ckpt
from repro_torch.dist import compression as p_comp
from repro_torch.dist.fault_tolerance import StepWatchdog, run_with_restart
from repro_torch.launch import train as p_cli
from repro_torch.models import get_model, train_state_from_reference

ARCH = "phi4_mini_3_8b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: SMOKE-sized tensors
    gain nothing from more, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    """A leaf as numpy, bf16 kept as ml_dtypes' bfloat16 (raw bits)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(jnp.bfloat16)
        return x.numpy()
    return np.asarray(x)


def _assert_trees_equal(got, want):
    g, w = p_ckpt.tree_flatten(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = _np(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                      b.reshape(-1).view(np.uint8))


_STATE: dict = {}


def ref_state():
    """The reference's SMOKE TrainState after one AdamW update on random
    gradients (m, v and step non-zero), and the port's copy of it."""
    if not _STATE:
        rc = RC.get_smoke_config(ARCH)
        state = RTr.init_train_state(r_get_model(rc), jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)
        grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(
            p.shape).astype(np.float32)), state.params)
        params, opt, _ = RO.adamw_update(RO.AdamWConfig(), state.params,
                                         grads, state.opt)
        state = RTr.TrainState(params, opt)
        _STATE["ref"] = state
        _STATE["port"] = train_state_from_reference(
            to_numpy_tree(state), port_model_config(rc), "cpu")
    return _STATE["ref"], _STATE["port"]


MIXED = {
    "w32": np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4),
    "w16": np.linspace(-3, 3, 8).astype(jnp.bfloat16),
    "q": np.arange(-8, 8, dtype=np.int8).reshape(4, 4),
    "mask": np.asarray([True, False, True]),
    "nested": {"step": np.int32(41), "scale": np.float16(0.5)},
}


def _mixed(kind: str):
    if kind == "ref":
        return jax.tree.map(jnp.asarray, MIXED)

    def one(a):
        a = np.asarray(a)
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree.map(one, MIXED)


@pytest.mark.parametrize("tree", ["train_state", "mixed", "int8_grads"])
def test_reference_checkpoint_restores_in_port(tree, tmp_path):
    if tree == "train_state":
        r_tree, like = ref_state()
    elif tree == "mixed":
        r_tree, like = _mixed("ref"), _mixed("port")
    else:
        g = {"w": jnp.linspace(-2, 2, 64).reshape(8, 8)}
        r_tree, _ = r_comp.compress_int8(g)
        like, _ = p_comp.compress_int8({"w": torch.zeros(8, 8)})
    r_ckpt.save(str(tmp_path), 41, r_tree)
    got, step = p_ckpt.restore(str(tmp_path), like, device="cpu")
    assert step == 41 and p_ckpt.latest_step(str(tmp_path)) == 41
    assert type(got) is type(like)
    _assert_trees_equal(got, r_tree)


@pytest.mark.parametrize("tree", ["train_state", "mixed", "int8_grads"])
def test_port_checkpoint_restores_in_reference(tree, tmp_path):
    if tree == "train_state":
        r_like, p_tree = ref_state()
    elif tree == "mixed":
        r_like, p_tree = _mixed("ref"), _mixed("port")
    else:
        p_tree, _ = p_comp.compress_int8(
            {"w": torch.linspace(-2, 2, 64).reshape(8, 8)})
        r_like, _ = r_comp.compress_int8({"w": jnp.zeros((8, 8))})
    p_ckpt.save(str(tmp_path), 7, p_tree)
    got, step = r_ckpt.restore(str(tmp_path), r_like)
    assert step == 7 and r_ckpt.latest_step(str(tmp_path)) == 7
    _assert_trees_equal(p_tree, got)
    # the manifests are the same JSON
    r_ckpt.save(str(tmp_path / "r"), 7, got)
    with open(tmp_path / "step_00000007" / "manifest.json") as a, \
            open(tmp_path / "r" / "step_00000007" / "manifest.json") as b:
        assert a.read() == b.read()


def test_checkpoint_keep_overwrite_and_missing(tmp_path):
    """The reference tests' corners, on the port: ``keep=2`` leaves the two
    newest, a re-saved step replaces the old one (the reference reads it),
    a missing directory raises and has no latest step."""
    for s in [1, 2, 3, 4, 5]:
        p_ckpt.save(str(tmp_path), s, {"x": torch.zeros(2)}, keep=2)
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000004", "step_00000005"]
    assert p_ckpt.latest_step(str(tmp_path)) == 5
    p_ckpt.save(str(tmp_path), 2, {"x": torch.zeros(3)})
    p_ckpt.save(str(tmp_path), 2, {"x": torch.ones(3)})
    got, step = p_ckpt.restore(str(tmp_path), {"x": torch.zeros(3)}, step=2,
                               device="cpu")
    assert step == 2 and torch.equal(got["x"], torch.ones(3))
    r_got, _ = r_ckpt.restore(str(tmp_path), {"x": jnp.zeros((3,))}, step=2)
    np.testing.assert_array_equal(np.asarray(r_got["x"]), np.ones(3))
    with pytest.raises(FileNotFoundError):
        p_ckpt.restore(str(tmp_path / "nope"), {"x": torch.zeros(1)},
                       device="cpu")
    assert p_ckpt.latest_step(str(tmp_path / "nope")) is None
    with pytest.raises(ValueError, match="leaves"):
        p_ckpt.restore(str(tmp_path), {"x": torch.zeros(3), "y": None,
                                       "z": torch.zeros(1)}, device="cpu")
    if not torch.cuda.is_available():          # device=None is cuda
        with pytest.raises(RuntimeError, match="no CUDA device"):
            p_ckpt.restore(str(tmp_path), {"x": torch.zeros(3)})


def test_train_restart_is_exact(tmp_path):
    """Crash at step 7, restore from the step-5 checkpoint, replay: params,
    m, v and step ``torch.equal`` to an uninterrupted run of 10 steps."""
    cfg = port_model_config(RC.get_smoke_config(ARCH))
    model = get_model(cfg)
    train_step = PTr.make_train_step(model, PTr.TrainConfig(PTr.AdamWConfig(
        lr=1e-3, warmup_steps=3)))

    def step_fn(state, step):
        batch = make_batch(cfg, batch=2, seq=16, step=step, seed=3,
                           device="cpu")
        return train_step(state, batch)

    def init():
        return PTr.init_train_state(model, torch.Generator().manual_seed(0),
                                    device="cpu")

    ref = init()
    for s in range(10):
        ref, _ = step_fn(ref, s)

    cdir = str(tmp_path)
    crashed = {"done": False}

    def injector(step):
        if step == 7 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("simulated node failure")

    like = init()

    def restore_fn():
        if p_ckpt.latest_step(cdir) is None:
            return None, 0
        return p_ckpt.restore(cdir, like, device="cpu")

    final, step = run_with_restart(
        step_fn, init(), 10, save_fn=lambda st, s: p_ckpt.save(cdir, s, st),
        restore_fn=restore_fn, ckpt_every=5, fault_injector=injector)
    assert crashed["done"] and step == 10
    assert sorted(os.listdir(cdir)) == ["step_00000005", "step_00000010"]
    got, want = p_ckpt.tree_flatten(final), p_ckpt.tree_flatten(ref)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(final.opt.step) == 10


SEQUENCES = [
    [1.0] * 6 + [2.0, 2.0, 1.0],
    [5.0, 1.0, 1.2, 0.9, 3.0, 1.0, 2.5, 2.6, 2.7, 1.0, 0.5, 1.1],
    list(np.random.default_rng(0).lognormal(0.0, 0.6, 200)),
]


@pytest.mark.parametrize("seq", range(len(SEQUENCES)))
@pytest.mark.parametrize("slack,warmup", [(2.0, 3), (1.5, 2), (1.1, 0)])
def test_watchdog_verdicts_match_reference(seq, slack, warmup):
    r, p = RWatchdog(slack, warmup), StepWatchdog(slack, warmup)
    verdicts = [(r.check(t), p.check(t)) for t in SEQUENCES[seq]]
    assert [a for a, _ in verdicts] == [b for _, b in verdicts]
    assert r.baseline == p.baseline
    if seq == 0 and (slack, warmup) == (1.5, 2):
        assert [b for _, b in verdicts][-3:] == ["slow", "sick", "ok"]


def test_compression_bf16_matches_reference():
    rng = np.random.default_rng(0)
    g = {"a": rng.standard_normal(1000).astype(np.float32) * 3,
         "b": {"c": np.full((4, 4), 1e-3, np.float32)},
         "n": np.arange(5, dtype=np.int32)}
    r = r_comp.compress_bf16(jax.tree.map(jnp.asarray, g))
    p = p_comp.compress_bf16(jax.tree.map(torch.from_numpy, g))
    assert p["n"].dtype == torch.int32
    _assert_trees_equal(p, r)
    r_dec = r_comp.decompress_bf16(r)
    p_dec = p_comp.decompress_bf16(p)
    _assert_trees_equal(p_dec, r_dec)
    np.testing.assert_allclose(p_dec["a"].numpy(), g["a"], rtol=2 ** -8)


def test_compression_int8_matches_reference_with_error_feedback():
    """20 error-feedback steps on the same gradients: codes, scales and
    residuals equal to the reference's, and the accumulated decompressed
    signal within 1 % of the accumulated true one (the EF guarantee)."""
    rng = np.random.default_rng(1)
    base = {"w": rng.standard_normal(256).astype(np.float32),
            "z": {"b": rng.standard_normal((8, 8)).astype(np.float32)}}
    r_err = p_err = None
    acc_true = acc_dec = 0.0
    comp_r = jax.jit(r_comp.compress_int8)
    for i in range(20):
        gi = jax.tree.map(lambda a, i=i: a * np.float32(1.0 + 0.1 * i), base)
        r_c, r_err = comp_r(jax.tree.map(jnp.asarray, gi), r_err)
        p_c, p_err = p_comp.compress_int8(jax.tree.map(torch.from_numpy, gi),
                                          p_err)
        for k in ("w", "z"):
            rc, pc = (r_c[k], p_c[k]) if k == "w" else (r_c[k]["b"],
                                                        p_c[k]["b"])
            assert isinstance(pc, p_comp.Int8Leaf)
            np.testing.assert_array_equal(pc.q.numpy(), np.asarray(rc.q))
            np.testing.assert_array_equal(pc.scale.numpy(),
                                          np.asarray(rc.scale))
        _assert_trees_equal(p_err, r_err)
        acc_true = acc_true + gi["w"]
        acc_dec = acc_dec + p_comp.decompress_int8(p_c)["w"].numpy()
    rel = np.linalg.norm(acc_dec - acc_true) / np.linalg.norm(acc_true)
    assert rel < 0.01, rel


def test_cli_trains_resumes_and_noops(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    base = ["--smoke", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--ckpt-dir", ck]
    losses = p_cli.main(base + ["--steps", "8", "--ckpt-every", "3"])
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert sorted(os.listdir(ck)) == ["step_00000003", "step_00000006",
                                      "step_00000008"]
    out = capsys.readouterr().out
    assert "step     7 loss" in out and "final loss" in out
    more = p_cli.main(base + ["--steps", "12", "--resume"])
    assert len(more) == 4
    assert "resumed from step 8" in capsys.readouterr().out
    assert p_cli.main(base + ["--steps", "12", "--resume"]) == []
    out = capsys.readouterr().out
    assert "resumed from step 12" in out
    assert "nothing to do: resumed at step 12 >= --steps 12" in out


def test_cli_resumes_from_a_reference_checkpoint(tmp_path, capsys):
    """The reference's checkpoint writer (its CLI's) writes a SMOKE
    TrainState as step 3; the port's CLI resumes from it (the same state
    tree, read across packages) and trains on."""
    ck = str(tmp_path / "ck")
    r_state, _ = ref_state()
    r_ckpt.save(ck, 3, r_state)
    common = ["--smoke", "--batch", "2", "--seq", "16", "--ckpt-dir", ck]
    losses = p_cli.main(common + ["--steps", "5", "--resume", "--device",
                                  "cpu"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert len(losses) == 2 and all(np.isfinite(losses))
    p_state, step = p_ckpt.restore(ck, PTr.TrainState(
        *r_state), step=3, device="cpu")
    assert step == 3
    _assert_trees_equal(p_state, r_state)
