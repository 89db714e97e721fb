"""Process-global activation-sharding registry.

Port of ``repro/dist/sharding.py``. The model code never takes a mesh
argument: :func:`enable` registers a ``DeviceMesh`` (named dims) plus the
batch/SP policy once, and the helpers below start to act. While disabled
(single-device runs, every entry point that registers nothing) every
helper is an exact identity, so the unsharded path is untouched, bit for
bit.

Under a mesh the model's parameters are DTensors (``models.params.
distribute``) and its activations travel between the helpers as DTensors:

* :func:`constrain` is the reference's ``with_sharding_constraint``: a
  ``DTensor.redistribute`` to the placements of a pspec, normalised to the
  tensor's shape (:func:`_norm_entry`); autograd moves the gradient back
  to the input's layout (from ``Partial`` a reduce-scatter or all-reduce);
* :func:`local` runs a function on the local shards (``to_local``) and
  wraps its outputs (``from_local``). An input replicated on a mesh dim
  over which another input is sharded gets its gradient back as
  ``Partial`` there: each rank's contribution is summed. This is how the
  steps DTensor has no sharding rule for run (the flash attention's
  chunk loop, the MoE dispatch's indexed writes, the SSD scan, the
  embedding gather, the loss): on local shards, with the collectives
  explicit at their edges;
* :func:`sp_gather` / :func:`sp_scatter` are the reference's custom-vjp
  pair, here a ``torch.autograd.Function`` whose backward redistributes
  the gradient to the other layout.

Sequence parallelism (SP) follows the Korthikanti schedule: activations
stay SEQ-SHARDED over "model" between blocks; :func:`col_parallel_qkv` /
:func:`fused_mlp` gather the sequence once (forward all-gather, backward
reduce-scatter) and :func:`row_parallel` / :func:`fused_mlp` outputs
return seq-sharded (forward reduce-scatter of the partial sums).

All constraints are shape-aware: a mesh axis is dropped for a dimension
it does not divide (batch=1 cells, kv-heads < model axis), exactly like
``launch.mesh.normalize_pspec``.
"""
from __future__ import annotations

from typing import Callable

import torch

_MESH = None
_BATCH_AXES: tuple | None = None
_SP: bool = False
_MODEL_AXIS: int = 1
_PLACEMENTS: dict = {}       # (entries, shape) -> placements on _MESH


def enable(batch_axes, *, sp: bool = False, model_axis: int | None = None,
           mesh=None) -> None:
    """Register activation shardings for subsequent model calls.

    batch_axes: mesh axis names the batch dim is sharded over, e.g.
    ``("data",)`` or ``("pod", "data")``. ``sp=True`` additionally shards
    the sequence dim of (B, T, D) activations over "model" between
    blocks. ``model_axis`` defaults to the mesh's "model" dim size.
    ``mesh``: a ``torch.distributed.device_mesh.DeviceMesh`` with named
    dims.
    """
    global _MESH, _BATCH_AXES, _SP, _MODEL_AXIS
    if mesh is None:
        raise ValueError("enable() requires a mesh")
    _PLACEMENTS.clear()
    if not mesh.mesh_dim_names:
        raise ValueError("enable(): the mesh's dims need names")
    _MESH = mesh
    _BATCH_AXES = tuple(batch_axes)
    _SP = bool(sp)
    if model_axis is None:
        model_axis = _sizes(mesh).get("model", 1)
    _MODEL_AXIS = int(model_axis)


def disable() -> None:
    global _MESH, _BATCH_AXES, _SP, _MODEL_AXIS
    _MESH, _BATCH_AXES, _SP, _MODEL_AXIS = None, None, False, 1
    _PLACEMENTS.clear()


def batch_axes():
    """The registered batch axes, or None while disabled."""
    return _BATCH_AXES


def model_axis() -> int:
    """Size of the tensor/expert-parallel axis (1 while disabled or when
    the registered mesh has no "model" axis)."""
    return _MODEL_AXIS


def mesh():
    """The registered mesh, or None while disabled."""
    return _MESH


def _sizes(m) -> dict:
    from ..launch.mesh import axis_sizes
    return axis_sizes(m)


# --------------------------------------------------------------------------
# shape-aware constraint core
# --------------------------------------------------------------------------


def _norm_entry(entry, dim: int, sizes: dict):
    """Drop axis names the mesh lacks or whose product doesn't divide dim."""
    names = entry if isinstance(entry, tuple) else (
        () if entry is None else (entry,))
    names = tuple(n for n in names if n in sizes)
    while names:
        total = 1
        for n in names:
            total *= sizes[n]
        if dim % total == 0:
            break
        names = names[:-1]
    if not names:
        return None
    return names if len(names) > 1 else names[0]


def placements(entries, shape) -> tuple:
    """The registered mesh's placements of a (shape, pspec entries) leaf,
    each entry normalised by :func:`_norm_entry`."""
    key = (tuple(entries), tuple(shape))
    if key not in _PLACEMENTS:
        from ..launch.mesh import placements as to_placements
        sizes = _sizes(_MESH)
        _PLACEMENTS[key] = to_placements(_MESH, tuple(
            _norm_entry(e, d, sizes) for e, d in zip(entries, shape)))
    return _PLACEMENTS[key]


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def as_dtensor(x):
    """x as a DTensor on the registered mesh: a plain tensor is taken as
    the same global value on every rank (replicated)."""
    from torch.distributed.tensor import DTensor, Replicate
    if is_dtensor(x):
        return x
    return DTensor.from_local(x, _MESH, [Replicate()] * _MESH.ndim,
                              run_check=False)


def relayout(x, pl):
    """x redistributed to placements ``pl`` (differentiable)."""
    x = as_dtensor(x)
    if tuple(x.placements) == tuple(pl):
        return x
    return x.redistribute(_MESH, pl)


def constrain(x, *entries):
    """``with_sharding_constraint(x, P(*entries))`` on the registered mesh;
    identity when disabled or when x's rank doesn't match."""
    if _MESH is None or getattr(x, "ndim", None) != len(entries):
        return x
    return relayout(x, placements(entries, x.shape))


def replicated(tree):
    """Every leaf of a tree of dicts gathered whole on every rank (the
    FSDP all-gather of a parameter; its gradient comes back reduced to
    the parameter's own layout)."""
    if isinstance(tree, dict):
        return {k: replicated(v) for k, v in tree.items()}
    if _MESH is None or not isinstance(tree, torch.Tensor):
        return tree
    return constrain(tree, *([None] * tree.ndim))


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def local(fn: Callable, *args, out=None):
    """``fn(*args)`` on the local shards of the DTensors in ``args`` (a
    DTensor, a tree of dicts/tuples of them, or anything else, passed as
    is); tensor outputs come back as DTensors with placements ``out`` (one
    tuple for every output, or one a top-level output; default: the first
    DTensor argument's).

    ``fn`` must compute each rank's part of the global result from its
    shards alone. Gradients: an input ``Replicate`` on a mesh dim over
    which some input is ``Shard`` returns ``Partial`` there (each rank's
    contribution differs and the sum is the gradient), reduced by the
    layout change that made the input (a reduce-scatter back to a
    seq-sharded layout), or, for a leaf, to its own layout (the gradient
    all-reduce of a replicated parameter); otherwise an input's gradient
    has its own placements.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    dts = [a for a in _flat(args) if is_dtensor(a)]
    m = dts[0].device_mesh
    sharded = [any(isinstance(t.placements[i], Shard) for t in dts)
               for i in range(m.ndim)]

    def unwrap(a):
        if not is_dtensor(a):
            return a
        gp = [Partial() if sharded[i] and isinstance(p, Replicate) else p
              for i, p in enumerate(a.placements)]
        if a.requires_grad and a.grad_fn is None and gp != list(
                a.placements):
            # a leaf (a parameter) gets its gradient in its own layout
            a = _Relayout.apply(a, a.placements, a.placements)
        return a.to_local(grad_placements=gp)
    res = fn(*_map(unwrap, args))
    if out is None:
        out = dts[0].placements

    def wrap(o, pl):
        if not isinstance(o, torch.Tensor):
            return o
        return DTensor.from_local(o, m, pl, run_check=False)
    if isinstance(res, tuple) and out and isinstance(out[0], tuple):
        return tuple(_map(lambda o, pl=pl: wrap(o, pl), r)
                     for r, pl in zip(res, out))
    return _map(lambda o: wrap(o, out), res)


def batch_mean(fn: Callable, *args):
    """The mean over the global batch of a per-row mean: ``fn`` computes
    its mean on each rank's shards (equal batch shards, the first DTensor
    argument's dim 0), the shards' means are averaged. Returns a plain
    0-dim tensor, the same on every rank (differentiable)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    first = next(a for a in _flat(args) if is_dtensor(a))
    m = first.device_mesh
    n = 1
    for i, p in enumerate(first.placements):
        if isinstance(p, Shard):
            n *= m.size(i)
    pl = tuple(Partial() if isinstance(p, Shard) else Replicate()
               for p in first.placements)
    return local(lambda *a: fn(*a) / n, *args, out=pl).full_tensor()


def _seq_axis():
    return "model" if _SP else None


# --------------------------------------------------------------------------
# a dim split over "model" inside a function that :func:`local` runs
# (serving: the decode cache's sequence, an SSM's heads and channels)
# --------------------------------------------------------------------------


def shard_range(x, dim: int) -> tuple[int, int]:
    """(start, size) of this rank's part of the DTensor ``x`` along ``dim``,
    in the global tensor's indices (the mesh dims that split ``dim`` taken
    major first, as ``models.params.local_shard`` cuts; even parts)."""
    from torch.distributed.tensor import Shard
    m = x.device_mesh
    coord = m.get_coordinate()
    parts, idx = 1, 0
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            idx = idx * m.size(i) + coord[i]
            parts *= m.size(i)
    size = x.shape[dim] // parts
    return idx * size, size


def model_reduce(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """A local tensor all-reduced (``op``: "sum" or "max") over the
    registered mesh's "model" dim: inside a function :func:`local` runs,
    whose rows are split over "model"."""
    import torch.distributed._functional_collectives as funcol
    i = _MESH.mesh_dim_names.index("model")
    return funcol.all_reduce(t, op, (_MESH, i))


def split_softmax(s: torch.Tensor) -> torch.Tensor:
    """``torch.softmax(s, -1)`` of rows split over "model" along the last
    dim, on this rank's part (inside a function :func:`local` runs): the
    parts' max and their sums of exponentials are reduced over "model"
    (the flash-decode combine), so each rank holds its part of the
    softmax over the whole row."""
    mx = model_reduce(s.amax(-1, keepdim=True), "max")
    e = torch.exp(s - mx)
    return e / model_reduce(e.sum(-1, keepdim=True))


# --------------------------------------------------------------------------
# activation constraints
# --------------------------------------------------------------------------


def constrain_act(x):
    """Canonical (B, T, D) activation layout: batch-sharded, and (under SP)
    seq-sharded over "model" between blocks."""
    return constrain(x, _BATCH_AXES, _seq_axis(), None)


def constrain_batch(x, *rest):
    """Shard dim 0 over the batch axes; trailing dims per ``rest``."""
    return constrain(x, _BATCH_AXES, *rest)


def rows(x):
    """x batch-sharded and whole along every other dim (serving's one-token
    activations, gathered over "model")."""
    if _MESH is None:
        return x
    return constrain(x, _BATCH_AXES, *([None] * (x.ndim - 1)))


def constrain_heads(x):
    """(B, T, H, hd) with heads sharded over "model" (head parallelism)."""
    return constrain(x, _BATCH_AXES, None, "model", None)


def seq_all_gather(x):
    """Force a full (replicated-seq) view of a possibly seq-sharded (B, T,
    D) activation: in front of mixers that need the whole sequence (SSM,
    MLA, hybrid)."""
    return constrain(x, _BATCH_AXES, None, None)


# --------------------------------------------------------------------------
# SP gather/scatter pair (layout only: values are untouched)
# --------------------------------------------------------------------------


class _Relayout(torch.autograd.Function):
    """Forward: redistribute to ``fwd``; backward: the gradient
    redistributed to ``bwd`` (the reference's ``custom_vjp`` pairs). From
    a ``Partial`` gradient to a seq-sharded layout that is one
    reduce-scatter, not an all-reduce and a slice."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return relayout(x, fwd)

    @staticmethod
    def backward(ctx, ct):
        return relayout(ct, ctx.bwd), None, None


def _rows(x, seq):
    return placements((_BATCH_AXES, seq, None), x.shape)


def sp_gather(x):
    """Seq-sharded -> full sequence (forward all-gather over "model",
    backward reduce-scatter). Identity unless SP is enabled."""
    if _MESH is None or not _SP:
        return x
    return _Relayout.apply(as_dtensor(x), _rows(x, None), _rows(x, "model"))


def sp_scatter(x):
    """Full sequence -> seq-sharded (the transpose of sp_gather)."""
    if _MESH is None or not _SP:
        return x
    return _Relayout.apply(as_dtensor(x), _rows(x, "model"), _rows(x, None))


# --------------------------------------------------------------------------
# parallel projection helpers (column/row parallel + fused MLP); each is
# the plain product for a plain tensor (also under a mesh, inside a
# function :func:`local` runs)
# --------------------------------------------------------------------------


def _col(x, *ws, fn=None):
    """x (B, T, D) [batch-sharded, the whole sequence] @ each w (D, F) ->
    a tuple of (B, T, F) column-sharded over "model" (each w gathered over
    the data axes, FSDP, kept split over "model"), in one pass on local
    shards; with ``fn``, ``fn(*products)`` (elementwise) instead."""
    ws = [constrain(w, None, "model") for w in ws]
    outs = tuple(placements((_BATCH_AXES, None, "model"),
                            tuple(x.shape[:-1]) + (w.shape[-1],))
                 for w in ws)

    def run(a, *wl):
        ys = tuple(a @ w for w in wl)
        return fn(*ys) if fn is not None else ys
    if fn is not None:
        if len(set(outs)) != 1:
            raise ValueError(f"products laid out apart: {outs}")
        return local(run, x, *ws, out=outs[0])
    return local(run, x, *ws, out=outs)


def _row(h, w):
    """h (B, T, F) column-sharded over "model" @ w (F, D) -> (B, T, D), the
    local products a partial sum over "model", reduced by the caller's
    constraint (a reduce-scatter under SP, else an all-reduce)."""
    from torch.distributed.tensor import Partial, Shard
    w = constrain(w, "model", None)
    shape = tuple(h.shape[:-1]) + (w.shape[-1],)
    pl = list(placements((_BATCH_AXES, None, None), shape))
    names = _MESH.mesh_dim_names
    if "model" in names:
        i = names.index("model")
        if isinstance(w.placements[i], Shard):
            pl[i] = Partial()
    return local(torch.matmul, h, w, out=tuple(pl))


def col_parallel(xg, w):
    """xg (B, T, D), batch-sharded with the whole sequence, @ w (D, F):
    (B, T, F) column-sharded over "model" (w gathered over the data axes,
    FSDP)."""
    return _col(constrain(xg, _BATCH_AXES, None, None), w)[0]


def col_parallel_qkv(x, wq, wk, wv):
    """x (B, T, D), possibly seq-sharded under SP -> (q2, k2, v2) each (B,
    T, heads·hd) column-sharded over "model". The internal sp_gather is
    the single forward all-gather of the Korthikanti schedule."""
    if _MESH is None or not is_dtensor(x):
        return x @ wq, x @ wk, x @ wv
    xg = constrain(sp_gather(x), _BATCH_AXES, None, None)
    return _col(xg, wq, wk, wv)


def row_parallel(o2, wo):
    """o2 (B, T, heads·hd) model-sharded on the contracting dim -> (B, T,
    D): the partial sums reduced by the output constraint (seq-sharded
    under SP: a reduce-scatter)."""
    if _MESH is None or not is_dtensor(o2):
        return o2 @ wo
    o2 = constrain(o2, _BATCH_AXES, None, "model")
    return constrain_act(_row(o2, wo))


def fused_mlp(x, w_gate, w_in, w_out):
    """SwiGLU with column-parallel up projections and a row-parallel down
    projection; one sp_gather in, seq-sharded out (SP)."""
    from ..models.layers import silu, swiglu
    if _MESH is None or not is_dtensor(x):
        return swiglu(x, w_gate, w_in, w_out)
    xg = constrain(sp_gather(x), _BATCH_AXES, None, None)
    h = _col(xg, w_gate, w_in, fn=lambda g, u: silu(g) * u)
    return constrain_act(_row(h, w_out))


# --------------------------------------------------------------------------
# head-parallel attention on local shards
# --------------------------------------------------------------------------


def split_heads(x2, n_heads: int, head_dim: int, fn=None):
    """(B, T, n·hd) -> (B, T, n, hd), on local shards: a column split over
    "model" that falls on head boundaries stays split (heads over
    "model"), any other is gathered first. ``fn`` (optional, per head:
    RoPE) is applied to the heads in the same pass."""
    from torch.distributed.tensor import Shard
    pl = list(x2.placements)
    names = _MESH.mesh_dim_names
    i = names.index("model") if "model" in names else None
    if i is not None and isinstance(pl[i], Shard) and \
            n_heads % _MESH.size(i) != 0:
        x2 = constrain(x2, _BATCH_AXES, None, None)
        pl = list(x2.placements)
    def run(t):
        t = t.reshape(t.shape[0], t.shape[1], -1, head_dim)
        return t if fn is None else fn(t)
    return local(run, x2, out=tuple(pl))


def merge_heads(o):
    """(B, T, H, hd) -> (B, T, H·hd) on local shards (heads split over
    "model" stay a column split)."""
    return local(lambda t: t.reshape(t.shape[0], t.shape[1], -1), o)


def head_attention(fn: Callable, q, k, v):
    """``fn(q, k, v)`` (an attention over (B, T, H, hd) heads) on local
    shards. q's heads may be split over "model"; k/v's either split the
    same way (each rank's query heads' KV heads are its own) or
    replicated (KV heads < the model axis), and then each rank slices the
    KV heads its query heads read. Returns the output with q's layout."""
    from torch.distributed.tensor import Shard
    names = _MESH.mesh_dim_names
    i = names.index("model") if "model" in names else None
    h, kvh = q.shape[2], k.shape[2]
    q_split = i is not None and isinstance(q.placements[i], Shard)
    kv_split = i is not None and isinstance(k.placements[i], Shard)
    if not q_split or kv_split:
        return local(fn, q, k, v, out=q.placements)
    g = h // kvh
    hl = h // _MESH.size(i)
    if hl % g and g % hl:
        raise ValueError(f"{hl} query heads a rank against groups of {g}")
    r = _MESH.get_local_rank(names[i])
    lo, n = (r * hl) // g, max(1, hl // g)

    def run(ql, kl, vl):
        return fn(ql, kl[:, :, lo:lo + n], vl[:, :, lo:lo + n])
    return local(run, q, k, v, out=q.placements)
