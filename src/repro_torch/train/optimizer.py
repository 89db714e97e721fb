"""AdamW from scratch, with the reference's formula and rounding.

Port of ``repro/train/optimizer.py``. The optimizer state mirrors the
parameter tree leaf for leaf (``m``, ``v``) beside an int32 ``step``.

Rounding. The reference's update is one jitted XLA computation, and on
its CPU backend XLA rewrites and contracts it: a division by a constant
becomes a multiplication by its f32 reciprocal (the warmup's
``step / warmup_steps``), ``(m / b1c) / (sqrt(v / b2c) + eps)`` becomes
``m / (b1c * (sqrt(v / b2c) + eps))``, and each ``a * b + c`` (the two
moments, the decay term, the parameter's step) is a fused multiply-add,
rounded once. The port computes the same expression and rounds each
fused step once, through f64 (the product of two f32 values is exact
there; the sum is rounded to f64, then to f32, as
``core/density.py:polyval`` does for ``jnp.polyval``), and takes the
square root through f64 (correctly rounded; torch's f32 ``sqrt`` on the
CPU is not). Given the same gradients and the same global norm the
update is then bit-equal to the jitted reference on the CPU. The global
norm itself is a sum whose order XLA chooses, so it agrees to a few ulps
only (ROADMAP queue 3).

Two forms share that arithmetic: :func:`adamw_update` returns new
tensors; :func:`adamw_update_` writes the new values into ``params``,
``m`` and ``v`` (and the step) in place, a bounded slab at a time, so
that a model whose state fills the card can take a step. The two are
bit-equal.

Sharded state. The state mirrors the parameter tree leaf for leaf, so a
parameter's DTensor placements apply to its ``m`` and ``v`` identically
(:func:`init_opt_state`): each rank updates its own shard (the update is
elementwise, on the local tensors); the global norm sums each leaf's
local sum of squares over the mesh dims it is sharded on.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..dist import sharding as shmod
from ..models.params import tree_leaves, tree_map, tree_unflatten

# elements updated at a time by the in-place form (its f64 temporaries
# are a few times this many 8-byte words)
SLAB = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


class OptState(NamedTuple):
    """``m`` and ``v``: f32 trees shaped like the parameters; ``step``: a
    0-dim int32 tensor, the number of updates taken."""

    m: dict
    v: dict
    step: torch.Tensor


def _local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if shmod.is_dtensor(x) else x


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    """A leaf's sum of squares in f32 (a DTensor's over every rank: its
    local sums reduced over the mesh dims it is sharded on)."""
    if not shmod.is_dtensor(x):
        return torch.sum(torch.square(x.float()))
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if any(isinstance(p, Partial) for p in x.placements):
        x = x.redistribute(x.device_mesh, [
            Replicate() if isinstance(p, Partial) else p
            for p in x.placements])
    s = torch.sum(torch.square(x.to_local().float()))
    pl = [Partial() if isinstance(p, Shard) else Replicate()
          for p in x.placements]
    return DTensor.from_local(s, x.device_mesh, pl,
                              run_check=False).full_tensor()


def init_opt_state(params) -> OptState:
    """Zero moments beside the parameters, on their device (DTensors with
    the parameters' placements for a sharded tree)."""
    dev = tree_leaves(params)[0].device
    return OptState(m=tree_map(torch.zeros_like, params),
                    v=tree_map(torch.zeros_like, params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def opt_state_schema(schema) -> OptState:
    """The optimizer state's Spec tree (the dry run's abstract state): m
    and v zero-initialised leaf for leaf like ``schema``, in its dtypes
    and pspecs, and a ``()`` int32 step."""
    from ..models.params import P, Spec
    z = tree_map(lambda s: Spec(s.shape, "zeros", s.dtype, s.pspec), schema)
    return OptState(m=z, v=z, step=Spec((), "zeros", torch.int32, P()))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares (f32), the leaves
    summed in sorted-key order as the reference's ``jax.tree.leaves``; the
    root correctly rounded."""
    total = sum(_sum_sq(x) for x in tree_leaves(tree))
    return torch.sqrt(total.double()).float()


class _Scalars(NamedTuple):
    lr: float
    b1c: float
    b2c: float


def _schedule(cfg: AdamWConfig, step: int) -> _Scalars:
    """The update's scalars at ``step`` (counting this update), each an f32
    value as the jitted reference computes it: the warmup's division by a
    constant as a product with its f32 reciprocal, ``b ** step`` correctly
    rounded (XLA's f32 power is, for every step we tried)."""
    f32 = np.float32
    stepf = f32(step)
    warm = np.minimum(f32(1.0), stepf * (f32(1.0) / f32(max(
        cfg.warmup_steps, 1))))
    lr = f32(cfg.lr) * warm
    b1c = f32(1.0) - f32(np.float64(f32(cfg.b1)) ** step)
    b2c = f32(1.0) - f32(np.float64(f32(cfg.b2)) ** step)
    return _Scalars(float(lr), float(b1c), float(b2c))


def _clip_scale(cfg: AdamWConfig, gnorm: torch.Tensor) -> torch.Tensor:
    # a division, not ``clip / t`` (torch computes that as a reciprocal
    # times clip, rounded twice)
    clip = torch.full_like(gnorm, cfg.grad_clip)
    return torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)


def _fma(a: float, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once: the product exact in f64, the sum
    rounded to f64, then to f32. ``a`` is a Python float holding an f32
    value; ``c`` is promoted to f64 as it is read."""
    t = b.double()
    t.mul_(a)
    t.add_(c)
    return t.float()


def _leaf(cfg: AdamWConfig, sc: _Scalars, scale: torch.Tensor, p, g, m, v):
    """One leaf's (or slab's) update -> (new p, new m, new v), new tensors.
    Scalars enter as the f32 values the reference computes (a Python
    float converts to f32 exactly)."""
    f32 = np.float32
    g = g.float() * scale
    m_new = _fma(float(f32(cfg.b1)), m, g * float(f32(1 - cfg.b1)))
    v_new = _fma(float(f32(cfg.b2)), v, g * float(f32(1 - cfg.b2)) * g)
    # the square root correctly rounded (through f64: torch's f32 sqrt on
    # the CPU is not)
    root = torch.sqrt((v_new / sc.b2c).double()).float()
    den = (root + float(f32(cfg.eps))) * sc.b1c
    pf = p.float()
    delta = _fma(float(f32(cfg.weight_decay)), pf, m_new / den)
    p_new = _fma(-sc.lr, delta, pf)
    return p_new.to(p.dtype), m_new, v_new


def _host_step(step: torch.Tensor) -> int:
    """The number of updates taken, on the host. A fake tensor (the dry
    run's abstract state, ``launch/dryrun.py``) holds no value: it counts
    as 0, so that the abstract step takes the schedule's first update."""
    from torch._subclasses.fake_tensor import is_fake
    return 0 if is_fake(step) else int(step)


def _prepare(cfg: AdamWConfig, grads, state: OptState):
    step = _host_step(state.step) + 1
    gnorm = global_norm(grads)
    return step, gnorm, _clip_scale(cfg, gnorm), _schedule(cfg, step)


def _metrics(gnorm: torch.Tensor, sc: _Scalars) -> dict:
    return {"grad_norm": gnorm,
            "lr": torch.tensor(sc.lr, dtype=torch.float32)}


def adamw_update(cfg: AdamWConfig, params, grads, state: OptState):
    """The plain form: returns ``(new_params, new_state, metrics)`` as new
    tensors; the inputs are left as they were. ``metrics``: ``grad_norm``
    (f32, before the clip) and ``lr`` (f32, after the warmup)."""
    step, gnorm, scale, sc = _prepare(cfg, grads, state)
    out = [_wrap(p, _leaf(cfg, sc, scale, *map(_local, _aligned(p, g, m,
                                                                 v))))
           for p, g, m, v in zip(
               *map(tree_leaves, (params, grads, state.m, state.v)))]
    new_p, new_m, new_v = (tree_unflatten(params, col) for col in zip(*out))
    new_step = torch.full_like(state.step, step)
    return new_p, OptState(new_m, new_v, new_step), _metrics(gnorm, sc)


def _aligned(p, g, m, v):
    """(p, g, m, v) with a DTensor gradient in its parameter's layout."""
    if shmod.is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        g = g.redistribute(p.device_mesh, p.placements)
    return p, g, m, v


def _wrap(p, new: tuple) -> tuple:
    """Local results as DTensors in ``p``'s layout, for a DTensor p."""
    if not shmod.is_dtensor(p):
        return new
    from torch.distributed.tensor import DTensor
    return tuple(DTensor.from_local(t, p.device_mesh, p.placements,
                                    run_check=False) for t in new)


def _slabs(x: torch.Tensor) -> list:
    if not x.is_contiguous():
        raise ValueError("adamw_update_: params, m and v must be "
                         "contiguous to be updated in place")
    return list(x.view(-1).split(SLAB))


@torch.no_grad()
def adamw_update_(cfg: AdamWConfig, params, grads, state: OptState) -> dict:
    """The in-place form of :func:`adamw_update`, bit-equal to it.

    The new parameters, ``m`` and ``v`` are written into the tensors of
    ``params``, ``state.m`` and ``state.v`` (which must be contiguous), and
    ``state.step`` is incremented, all in place: callers holding those
    tensors see the new values, as :func:`repro_torch.models.transformer.
    decode` updates its cache. ``grads`` is only read. Each leaf is updated
    ``SLAB`` elements at a time, so the temporaries stay small beside a
    state that fills the card. Returns the metrics.
    """
    step, gnorm, scale, sc = _prepare(cfg, grads, state)
    for leaves in zip(*map(tree_leaves, (params, grads, state.m, state.v))):
        p, g, m, v = map(_local, _aligned(*leaves))
        for ps, gs, ms, vs in zip(_slabs(p), g.reshape(-1).split(SLAB),
                                  _slabs(m), _slabs(v)):
            for dst, new in zip((ps, ms, vs),
                                _leaf(cfg, sc, scale, ps, gs, ms, vs)):
                dst.copy_(new)
    state.step.fill_(step)
    return _metrics(gnorm, sc)
